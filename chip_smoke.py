#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``piml_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. build the CUDA kernels from ``piml_tpu_torch/csrc`` (timed);
2. K1 (dense top-k) against its plain PyTorch version at the rollout
   shapes: the 12,685-agent self pass (k = 6) and the 4,096-obstacle pass
   (k = 10) — bitwise equal; median milliseconds from CUDA events;
3. K2 (banded top-k) against its plain version at the same shapes —
   bitwise equal, same exactness flag, and equal to K1 on every
   in-threshold slot when exact;
4. the dense-stress rollout (N = 12,685, M = 4,096, 50 frames after a
   3-frame warm-up, default ``NeighborConfig``, trained ``pinnsf_bm``
   weights): ms/frame, K2 launches and fallbacks, every live position
   finite;
5. the same rollout with ``use_grid_topk=False``: K1 launches, and the
   same trajectories bit for bit (an exact K2 pass gives K1's features);
6. one frame of ``relative_features`` at N = 12,685 and five rollout
   frames, through the kernels and through the plain versions — bitwise
   equal;
7. the GC window (``repro_work/gc_sf_repro.npy``): ``make_time_indexed``
   and ``evaluate_rollouts`` on the GPU, and a 60-frame slice on the GPU
   against the same slice on the CPU.

The line before the last holds the kernels' record as JSON, and the last
line is ``{"ok": true, "device": {...}}``.  Launch counts are zeroed just
before phase 4 and read just after phase 5: they count only the main
path's launches.  It needs no network and starts no process besides
``nvidia-smi`` and the ``nvcc`` build.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
N_AGENTS = 12685
N_OBSTACLES = 4096
STRESS_FRAMES = 50
WARMUP_FRAMES = 3
SEED = 1
DEVICE = "cuda:0"
GC_SLICE_FRAMES = 60


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_route():
    """Route the kernel wrappers to their plain versions on the card (for
    the comparisons only: the wrappers themselves never fall back)."""
    from piml_tpu_torch.ops import banded, pairwise

    with mock.patch.object(pairwise, "pairwise_topk_cuda",
                           pairwise.pairwise_topk_plain), \
            mock.patch.object(banded, "banded_topk_cuda",
                              banded.banded_topk_plain):
        yield


def assert_equal(a, b, what):
    import torch

    if not torch.equal(a, b):
        diff = (a.float() - b.float()).abs()
        raise AssertionError(f"{what}: not bitwise equal (max |diff| "
                             f"{diff[torch.isfinite(diff)].max().item()})")


def max_abs_err(a, b):
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max().item()) if fin.any() else 0.0


def stress_scene(device):
    """The dense-stress frame (bench.py's ``bench_dense_stress`` setup):
    agents and obstacles uniform over 200 m × 200 m, seeded."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    pos = torch.rand((N_AGENTS, 2), generator=g) * 200.0
    vel = torch.randn((N_AGENTS, 2), generator=g)
    wp = torch.rand((1, N_AGENTS, 2), generator=g) * 200.0
    obstacles = torch.rand((N_OBSTACLES, 2), generator=g) * 200.0
    return {k: v.to(device) for k, v in dict(
        pos=pos, vel=vel, acc=torch.zeros_like(pos), wp=wp, dest=wp[0],
        obstacles=obstacles,
        ds=torch.full((N_AGENTS, 1), 1.34)).items()}


def trained_model(device):
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.models import ModelSpec, build_model, load_fixture

    cfg = PIMLConfig(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
                     skip_frames=25, time_unit=0.08)
    model = build_model(ModelSpec.from_config(cfg))
    model.load_state_dict(load_fixture())
    return cfg, model.to(device).eval()


def stress_rollout(model, sc, ncfg, frames):
    """Initial features, then ``frames`` closed-loop steps; returns the
    recorded outputs and the wall seconds of the loop."""
    import torch

    from piml_tpu_torch.engine import EngineConfig, SpawnFrame, init_state, \
        rollout
    from piml_tpu_torch.physics import relative_features

    n = sc["pos"].shape[0]
    dev = sc["pos"].device
    with torch.inference_mode():
        pf, of, df = relative_features(sc["pos"], sc["vel"], sc["acc"],
                                       sc["dest"], sc["obstacles"], ncfg)
        sf = torch.cat([df, sc["vel"], sc["acc"], sc["ds"]], dim=-1)
    state = init_state(sc["pos"], sc["vel"], sc["acc"], sc["dest"],
                       torch.zeros(n, dtype=torch.int32, device=dev),
                       pf, of, sf)
    z2 = torch.zeros((frames, n, 2), device=dev)
    spawns = SpawnFrame(new=torch.zeros((frames, n), device=dev), p=z2, v=z2,
                        a=z2, dest=z2,
                        dest_idx=torch.zeros((frames, n), dtype=torch.int32,
                                             device=dev),
                        hist_v=z2)
    ecfg = EngineConfig(neighbor=ncfg, time_unit=0.08, lagged=True,
                        retire_on_arrival=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = rollout(model, ecfg, state, spawns, sc["wp"],
                      torch.ones(n, dtype=torch.int32, device=dev),
                      sc["obstacles"], sc["ds"])
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "piml_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke: piml_tpu_torch/ not found beside the "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, ROOT)

    import piml_tpu_torch  # noqa: F401  (sets allow_tf32 = False)
    from piml_tpu_torch import _build
    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.physics import NeighborConfig, heading_direction, \
        relative_features

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 1. build ----------------------------------------------------------
    _build.LIBRARY.get()
    say("build", seconds=_build.LIBRARY.build_seconds,
        library=os.path.relpath(str(_build.LIBRARY.path), ROOT))

    sc = stress_scene(dev)
    ncfg = NeighborConfig()
    heading = heading_direction(sc["vel"], time_axis=False)
    thr_p = pairwise.cos_threshold(ncfg.sight_angle_ped)
    thr_o = pairwise.cos_threshold(ncfg.sight_angle_obs)
    record = {}

    # ---- 2. K1 against its plain version -----------------------------------
    rows = pairwise.pack_rows(sc["pos"], heading)
    passes = {
        "agents": (pairwise.pack_cols(sc["pos"]), ncfg.topk_ped, thr_p, True),
        "obstacles": (pairwise.pack_cols(sc["obstacles"]), ncfg.topk_obs,
                      thr_o, False),
    }
    k1 = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    for name, (cols, k, thr, selfp) in passes.items():
        got = pairwise.pairwise_topk_cuda(rows, cols, k, thr, selfp)
        ref = pairwise.pairwise_topk_plain(rows, cols, k, thr, selfp)
        torch.cuda.synchronize()
        assert_equal(got[0], ref[0], f"K1 {name} dist")
        assert_equal(got[1], ref[1], f"K1 {name} idx")
        ms = cuda_ms(lambda: pairwise.pairwise_topk_cuda(rows, cols, k, thr,
                                                         selfp), 20)
        plain_ms = cuda_ms(lambda: pairwise.pairwise_topk_plain(
            rows, cols, k, thr, selfp), 5)
        k1["ms"] += ms
        k1["plain_ms"] += plain_ms
        k1[f"ms_{name}"] = ms
        k1[f"plain_ms_{name}"] = plain_ms
        k1["max_abs_err"] = max(k1["max_abs_err"],
                                max_abs_err(got[0], ref[0]))
        say("k1", which=name, shape=[N_AGENTS, cols.shape[1]], k=k,
            bitwise_equal=True, ms=ms, plain_ms=plain_ms)
    record["k1"] = k1

    # ---- 3. K2 against its plain version -----------------------------------
    k2 = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    g_p, w_p = banded.banded_params(N_AGENTS, N_AGENTS, ncfg.topk_ped,
                                    fine=True)
    g_o, w_o = banded.banded_params(N_AGENTS, N_OBSTACLES, ncfg.topk_obs,
                                    fine=True)
    k2_passes = {
        "agents": dict(k=ncfg.topk_ped, angle_threshold=ncfg.sight_angle_ped,
                       dist_threshold=ncfg.dist_threshold_ped, grid_dim=g_p,
                       window=w_p),
        "obstacles": dict(k=ncfg.topk_obs,
                          angle_threshold=ncfg.sight_angle_obs,
                          objects=sc["obstacles"], same_objects=False,
                          dist_threshold=ncfg.dist_threshold_obs,
                          grid_dim=g_o, window=w_o),
    }
    for name, kw in k2_passes.items():
        captured = {}
        real = banded.banded_topk

        def capture(*args):
            captured["args"] = args
            return real(*args)

        with mock.patch.object(banded, "banded_topk", capture):
            got = banded.topk_neighbors_banded(sc["pos"], heading, **kw)
        with plain_route():
            ref = banded.topk_neighbors_banded(sc["pos"], heading, **kw)
        torch.cuda.synchronize()
        assert_equal(got[0], ref[0], f"K2 {name} dist")
        assert_equal(got[1], ref[1], f"K2 {name} idx")
        if bool(got[2]) != bool(ref[2]):
            raise AssertionError(f"K2 {name}: exact flags differ")
        if bool(got[2]):
            objects = kw.get("objects")
            d1, i1 = pairwise.topk_neighbors_pallas(
                sc["pos"], heading, kw["k"], kw["angle_threshold"],
                objects=objects, same_objects=objects is None)
            thr = kw["dist_threshold"]
            in_thr = d1 <= thr
            if not torch.equal(got[0] <= thr, in_thr):
                raise AssertionError(f"K2 {name}: in-threshold slots "
                                     "differ from K1")
            assert_equal(got[0][in_thr], d1[in_thr], f"K2 vs K1 {name} dist")
            assert_equal(got[1][in_thr], i1[in_thr], f"K2 vs K1 {name} idx")
        args = captured["args"]
        out_k, out_p = (banded.banded_topk_cuda(*args),
                        banded.banded_topk_plain(*args))
        assert_equal(out_k[0], out_p[0], f"K2 {name} raw dist")
        assert_equal(out_k[1], out_p[1], f"K2 {name} raw idx")
        ms = cuda_ms(lambda: banded.banded_topk_cuda(*args), 50)
        plain_ms = cuda_ms(lambda: banded.banded_topk_plain(*args), 10)
        k2["ms"] += ms
        k2["plain_ms"] += plain_ms
        k2[f"ms_{name}"] = ms
        k2[f"plain_ms_{name}"] = plain_ms
        k2["max_abs_err"] = max(k2["max_abs_err"],
                                max_abs_err(out_k[0], out_p[0]))
        say("k2", which=name, grid_dim=kw["grid_dim"], window=kw["window"],
            exact=bool(got[2]), bitwise_equal=True, ms=ms, plain_ms=plain_ms)
    record["k2"] = k2

    # ---- 4./5. the main path: dense-stress rollouts -------------------------
    cfg, model = trained_model(dev)
    pairwise.KERNEL.launches = 0
    banded.KERNEL.launches = 0
    banded.KERNEL.fallbacks = 0
    stress_rollout(model, sc, ncfg, WARMUP_FRAMES)   # first-call costs
    outs, wall = stress_rollout(model, sc, ncfg, STRESS_FRAMES)
    live = outs.mask == 1
    if not torch.isfinite(outs.p[live]).all():
        raise AssertionError("dense stress: non-finite live positions")
    k2_launches, fallbacks = banded.KERNEL.launches, banded.KERNEL.fallbacks
    k1_default = pairwise.KERNEL.launches
    say("dense_stress", frames=STRESS_FRAMES, agents=N_AGENTS,
        obstacles=N_OBSTACLES, ms_per_frame=wall / STRESS_FRAMES * 1e3,
        k2_launches=k2_launches, k2_fallbacks=fallbacks,
        k1_launches=k1_default, live_final=int(live[-1].sum()))
    if k2_launches == 0:
        raise AssertionError("dense stress: K2 never launched")

    ncfg_k1 = ncfg._replace(use_grid_topk=False)
    stress_rollout(model, sc, ncfg_k1, WARMUP_FRAMES)
    outs1, wall1 = stress_rollout(model, sc, ncfg_k1, STRESS_FRAMES)
    if not torch.isfinite(outs1.p[outs1.mask == 1]).all():
        raise AssertionError("dense stress (K1): non-finite live positions")
    launches = {"k1": pairwise.KERNEL.launches, "k2": banded.KERNEL.launches}
    say("dense_stress_k1", frames=STRESS_FRAMES,
        ms_per_frame=wall1 / STRESS_FRAMES * 1e3,
        k1_launches=launches["k1"] - k1_default)
    if launches["k1"] - k1_default == 0:
        raise AssertionError("use_grid_topk=False: K1 never launched")
    # an exact K2 pass gives K1's features, so the two routes' rollouts are
    # the same trajectories, bit for bit
    if not torch.allclose(outs.p, outs1.p, rtol=0, atol=0, equal_nan=True):
        raise AssertionError("dense stress: the K2 and K1 routes' "
                             "trajectories differ")
    say("main_path_counts", **launches, k2_fallbacks=fallbacks,
        routes_bitwise_equal=True)

    # ---- 6. kernels vs plain versions through relative_features ------------
    for label, cfg_n in (("default", ncfg), ("use_grid_topk=False", ncfg_k1)):
        with torch.inference_mode():
            got = relative_features(sc["pos"], sc["vel"], sc["acc"],
                                    sc["dest"], sc["obstacles"], cfg_n)
            with plain_route():
                ref = relative_features(sc["pos"], sc["vel"], sc["acc"],
                                        sc["dest"], sc["obstacles"], cfg_n)
        for a, b, what in zip(got, ref, ("ped", "obs", "dest")):
            assert_equal(a, b, f"relative_features[{label}] {what}")
        say("relative_features", route=label, bitwise_equal=True,
            shapes=[list(t.shape) for t in got])
    short, _ = stress_rollout(model, sc, ncfg, 5)
    with plain_route():
        short_ref, _ = stress_rollout(model, sc, ncfg, 5)
    assert_equal(short.p, short_ref.p, "5-frame rollout positions")
    say("rollout_kernel_vs_plain", frames=5, bitwise_equal=True)

    # ---- 7. GC window ------------------------------------------------------
    from piml_tpu_torch.data import make_time_indexed
    from piml_tpu_torch.engine import evaluate_rollouts
    from piml_tpu_torch.scene import Scene, codec

    scene_path = os.path.join(ROOT, "repro_work", "gc_sf_repro.npy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = make_time_indexed(cfg, Scene.load(scene_path, device=dev))
    t1 = time.perf_counter()
    metrics = evaluate_rollouts(model, cfg, [data])
    t2 = time.perf_counter()
    for key in ("loss", "mse", "mae", "collision", "hard_collision"):
        if not math.isfinite(getattr(metrics, key)):
            raise AssertionError(f"GC window: {key} is not finite")
    say("gc_window", frames=data.num_frames, agents=data.num_pedestrians,
        obstacles=int(data.obstacles.shape[0]),
        make_time_indexed_s=t1 - t0, eval_s=t2 - t1,
        metrics=dict(loss=metrics.loss, mse=metrics.mse, mae=metrics.mae,
                     collision=metrics.collision,
                     hard_collision=metrics.hard_collision))

    # the same 60-frame slice on the card and on the CPU (the CPU side is
    # the path the tests hold to the JAX package)
    arrays = codec.decode(scene_path)
    for key in ("position", "velocity", "acceleration", "destination",
                "dest_idx", "mask_p", "mask_v", "mask_a"):
        arrays[key] = arrays[key][:GC_SLICE_FRAMES]
    cpu_model = trained_model("cpu")[1]
    m_gpu = evaluate_rollouts(
        model, cfg, [make_time_indexed(cfg, Scene.from_arrays(arrays, dev))])
    m_cpu = evaluate_rollouts(
        cpu_model, cfg, [make_time_indexed(cfg, Scene.from_arrays(arrays))])
    for key in ("mse", "mae", "collision", "hard_collision"):
        a, b = getattr(m_gpu, key), getattr(m_cpu, key)
        if abs(a - b) > 1e-4 * max(abs(b), 1e-12):
            raise AssertionError(f"GC slice {key}: GPU {a} vs CPU {b}")
    say("gc_slice_gpu_vs_cpu", frames=GC_SLICE_FRAMES, mse=[m_gpu.mse, m_cpu.mse],
        mae=[m_gpu.mae, m_cpu.mae],
        collision=[m_gpu.collision, m_cpu.collision])

    kernels = [
        dict(name="pairwise_topk (K1)", route="cuda",
             source="piml_tpu_torch/csrc/pairwise_topk.cu",
             replaces="piml_tpu/ops/pairwise.py:91",
             launches=launches["k1"], **record["k1"]),
        dict(name="banded_topk (K2)", route="cuda",
             source="piml_tpu_torch/csrc/banded_topk.cu",
             replaces="piml_tpu/ops/banded.py:116",
             launches=launches["k2"], **record["k2"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
