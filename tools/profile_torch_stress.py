#!/usr/bin/env python3
"""Where a dense-stress frame of the PyTorch port spends its time (GPU).

    python3 tools/profile_torch_stress.py [--frames 10] [--model pinnsf_m]
        [--compute_dtype bfloat16]
    python3 tools/profile_torch_stress.py --train [--steps 2]
    python3 tools/profile_torch_stress.py --metrics [--steps 20]
    python3 tools/profile_torch_stress.py --gen [--frames 10]

Builds the dense-stress scene of ``chip_smoke.py`` (12,685 agents, 4,096
obstacles, trained ``pinnsf_bm``; ``--model`` another zoo name with
seeded weights at the paper's widths and ``pred_acc`` clamped to ±5, as
``chip_smoke.Clamped``; ``--compute_dtype bfloat16`` its interaction
MLPs in bfloat16), warms up, then traces ``--frames``
rollout frames with ``torch.profiler`` for each selection route (K2 with
K1 fallback; K1 alone).  Prints per route: wall ms/frame of the frame loop, device
busy ms/frame (kernel time on the single stream over the traced span,
which also holds the initial feature pass), the device's idle share of
that span, and the top kernels by device time.  Needs a CUDA device.

``--train``: the same for finetune steps (loss, backward, Adam) at
``chip_smoke.py``'s two training shapes — the dense-N step (phase 9) and
the paper-shape step (phase 10) — per step instead of per frame, plus the
untraced wall split into forward, backward and optimizer.

``--metrics``: the same for ``ot_with_time_mask`` and
``mmd_with_time_mask`` on ``chip_smoke.py``'s phase-12 frames (12,685
agents), per frame; and for pretrain steps (``--steps`` batches of 128
seeded rows through the paper-width ``pinnsf_bm`` with live dropout),
per step.

``--gen``: the same for ``--frames`` frames of the two synthetic-crowd
generators on ``chip_smoke.py``'s phase-14 GC schedule (750-frame
capacity, seed 666): the social-force ``simulate`` (10 sub-steps a frame)
and ``simulate_mlapm``, per frame, with the kernel launches a frame.
Every frame steps all slots, so the first frames cost what any frame
does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_rows(prof):
    """``(busy µs, [(µs, kernel name, calls)])`` of a trace, kernels only
    (an aten op also carries its kernels' time)."""
    from torch.autograd import DeviceType

    rows, busy_us = [], 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.self_device_time_total > 0:
            busy_us += e.self_device_time_total
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    return busy_us, rows


def train_steps(steps: int, top: int) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.data import make_time_indexed, to_channeled
    from piml_tpu_torch.engine import training_rollout_loss
    from piml_tpu_torch.models import PRETRAINED, load_fixture
    from piml_tpu_torch.scene import Scene
    from piml_tpu_torch.train.trainer import make_optimizer

    dev = torch.device(chip_smoke.DEVICE)
    cfg = PIMLConfig(**chip_smoke.TRAIN_CFG,
                     ft_batch_size=chip_smoke.TRAIN_CHANNELS)
    model = chip_smoke.finetune_model(cfg, dev)
    data = make_time_indexed(cfg, Scene.load(
        os.path.join(ROOT, "repro_work", "gc_sf_repro.npy"), device=dev))
    paper = to_channeled(data, chip_smoke.TRAIN_FRAMES, "slice")
    paper = paper.slice_channels(np.arange(chip_smoke.PAPER_WINDOWS)
                                 + cfg.skip_frames)
    pmodel = chip_smoke.finetune_model(cfg, dev, load_fixture(PRETRAINED))
    shapes = {
        "dense_n": (chip_smoke.Clamped(model), model,
                    chip_smoke.dense_batch(dev), cfg),
        "paper": (pmodel, pmodel, paper,
                  cfg.replace(ft_batch_size=chip_smoke.PAPER_WINDOWS)),
    }
    for label, (fn, module, batch, c) in shapes.items():
        opt = make_optimizer(c, module.parameters(), finetune=True)

        def step(split=None):
            t = [time.perf_counter()]
            out = training_rollout_loss(fn, c, batch)
            for part in (lambda: out.loss.backward(), opt.step):
                if split is not None:
                    torch.cuda.synchronize()
                    t.append(time.perf_counter())
                part()
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            if split is not None:
                split.append(np.diff(t))

        split = []
        step(split)                                   # warm-up
        step(split)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            total = time.perf_counter() - t0
        busy_us, rows = device_rows(prof)
        fwd, bwd, adam = (float(x) for x in split[-1])
        print(json.dumps({
            "train_step": label, "steps": steps,
            "wall_s_per_step_untraced": fwd + bwd + adam,
            "forward_s": fwd, "backward_s": bwd, "optimizer_s": adam,
            "wall_s_per_step_profiled": total / steps,
            "device_busy_s_per_step": busy_us / 1e6 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / total,
            "top_kernels": [dict(name=k[:80], ms_per_step=us / 1e3 / steps,
                                 calls_per_step=n / steps)
                            for us, k, n in rows[:top]],
        }))


def traced(fn, reps):
    """Wall seconds of ``reps`` calls of ``fn`` under the profiler, and
    the trace's device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                               # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return total, device_rows(prof)


def metrics_and_pretrain(steps: int, top: int) -> None:
    import torch

    import chip_smoke
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.data import PointwiseData
    from piml_tpu_torch.metrics import mmd_with_time_mask, ot_with_time_mask
    from piml_tpu_torch.train.trainer import Trainer, make_optimizer
    from piml_tpu_torch.utils import MetricLogger

    dev = torch.device(chip_smoke.DEVICE)
    n, frames = chip_smoke.N_AGENTS, chip_smoke.OT_FRAMES
    g = torch.Generator().manual_seed(chip_smoke.SEED + 2)
    p = torch.rand((frames, n, 2), generator=g) * 200.0
    q = (p + 0.5 * torch.randn(p.shape, generator=g)).to(dev)
    p, ones = p.to(dev), torch.ones((frames, n), device=dev)

    def report(label, unit, count, total, rows):
        busy_us, kernels = rows
        print(json.dumps({
            label: count, f"wall_ms_per_{unit}_profiled": total / count * 1e3,
            f"device_busy_ms_per_{unit}": busy_us / 1e3 / count,
            "device_idle_share": 1.0 - busy_us / 1e6 / total,
            "top_kernels": [dict(name=k[:80], ms=us / 1e3 / count,
                                 calls=c / count)
                            for us, k, c in kernels[:top]]}))

    for label, fn in (("ot_frames", ot_with_time_mask),
                      ("mmd_frames", mmd_with_time_mask)):
        total, rows = traced(lambda: fn(p, q, ones, "sum"), 1)
        report(label, "frame", frames, total, rows)

    cfg = PIMLConfig(**chip_smoke.CLI_CFG)
    rows = 128 * steps
    data = PointwiseData(
        ped_features=torch.randn((rows, cfg.topk_ped, 6), generator=g),
        obs_features=torch.randn((rows, cfg.topk_obs, 6), generator=g),
        self_features=torch.randn((rows, 7), generator=g),
        labels=torch.randn((rows, 6 + cfg.topk_ped), generator=g).clamp(0, 1),
        meta_data={"time_unit": 0.08})
    data = PointwiseData(**{k: (v.to(dev) if torch.is_tensor(v) else v)
                            for k, v in vars(data).items()})
    trainer = Trainer(cfg, MetricLogger(stream=open(os.devnull, "w")))
    trainer.init_params(data)
    opt = make_optimizer(cfg, trainer.model.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)

    def pretrain_steps():
        for i in range(steps):
            sl = slice(128 * i, 128 * (i + 1))
            loss, _ = trainer._pointwise_loss_terms(
                data.ped_features[sl], data.obs_features[sl],
                data.self_features[sl], data.labels[sl], gen)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    total, rows = traced(pretrain_steps, 1)
    report("pretrain_steps", "step", steps, total, rows)


def generators(frames: int, top: int) -> None:
    import torch

    import chip_smoke
    from piml_tpu_torch.gen import (SCENARIOS, SFParams, simulate,
                                    simulate_mlapm)
    from piml_tpu_torch.models import MLAPMParams

    dev = torch.device(chip_smoke.DEVICE)
    sched, obs = SCENARIOS["GC"](chip_smoke.GEN_FRAMES,
                                 seed=chip_smoke.GEN_SEED, device=dev)
    runs = {
        "socialforce": lambda: simulate(SFParams(), sched, obs, frames,
                                        device=dev),
        "mlapm": lambda: simulate_mlapm(MLAPMParams.gc_paper(), sched,
                                        frames, device=dev),
    }
    for label, fn in runs.items():
        total, (busy_us, rows) = traced(fn, 1)
        print(json.dumps({
            "generator": label, "frames": frames,
            "slots": int(sched.position.shape[0]),
            "obstacles": int(len(obs)),
            "wall_ms_per_frame_profiled": total / frames * 1e3,
            "device_busy_ms_per_frame": busy_us / 1e3 / frames,
            "device_idle_share": 1.0 - busy_us / 1e6 / total,
            "kernels_per_frame": sum(c for _, _, c in rows) / frames,
            "top_kernels": [dict(name=k[:80], ms_per_frame=us / 1e3 / frames,
                                 calls_per_frame=c / frames)
                            for us, k, c in rows[:top]]}))


def stress_model(name: str, compute_dtype: str, dev):
    """The dense-stress model: the trained ``pinnsf_bm`` weights, or
    seeded weights of ``name`` behind ``chip_smoke.Clamped``."""
    import torch

    import chip_smoke
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.models import ModelSpec, build_model, load_fixture

    spec = ModelSpec.from_config(PIMLConfig(
        model=name, dataset_name="gc2344", dropout=0.0,
        compute_dtype=compute_dtype))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(chip_smoke.SEED)
        model = build_model(spec)
    if name == "pinnsf_bm":
        model.load_state_dict(load_fixture())
        return model.to(dev).eval()
    return chip_smoke.Clamped(model.to(dev).eval())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--model", default="pinnsf_bm")
    ap.add_argument("--compute_dtype", default="")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_stress: needs a CUDA device")
    sys.path.insert(0, ROOT)
    if args.train:
        train_steps(args.steps, args.top)
        return
    if args.metrics:
        metrics_and_pretrain(max(args.steps, 20), args.top)
        return
    if args.gen:
        generators(args.frames, args.top)
        return
    import chip_smoke
    from piml_tpu_torch.physics import NeighborConfig

    dev = torch.device("cuda:0")
    sc = chip_smoke.stress_scene(dev)
    model = stress_model(args.model, args.compute_dtype, dev)
    for label, ncfg in (("k2_banded", NeighborConfig()),
                        ("k1_dense", NeighborConfig(use_grid_topk=False))):
        chip_smoke.stress_rollout(model, sc, ncfg, 3)            # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, wall = chip_smoke.stress_rollout(model, sc, ncfg, args.frames)
            total = time.perf_counter() - t0
        busy_us, rows = device_rows(prof)
        per_frame = lambda us: us / 1e3 / args.frames
        print(json.dumps({
            "route": label, "model": args.model,
            "compute_dtype": args.compute_dtype or "float32",
            "frames": args.frames,
            "wall_ms_per_frame_profiled": wall / args.frames * 1e3,
            "device_busy_ms_per_frame": per_frame(busy_us),
            "device_idle_share": 1.0 - busy_us / 1e6 / total,
            "traced_s": total,
            "top_kernels": [dict(name=k[:80], ms_per_frame=per_frame(us),
                                 calls_per_frame=c / args.frames)
                            for us, k, c in rows[:args.top]],
        }))


if __name__ == "__main__":
    main()
