#!/usr/bin/env python3
"""Where a dense-stress frame of the PyTorch port spends its time (GPU).

    python3 tools/profile_torch_stress.py [--frames 10]

Builds the dense-stress scene of ``chip_smoke.py`` (12,685 agents, 4,096
obstacles, trained ``pinnsf_bm``), warms up, then traces ``--frames``
rollout frames with ``torch.profiler`` for each selection route (K2 with
K1 fallback; K1 alone).  Prints per route: wall ms/frame of the frame loop, device
busy ms/frame (kernel time on the single stream over the traced span,
which also holds the initial feature pass), the device's idle share of
that span, and the top kernels by device time.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_stress: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from piml_tpu_torch.physics import NeighborConfig

    dev = torch.device("cuda:0")
    sc = chip_smoke.stress_scene(dev)
    _, model = chip_smoke.trained_model(dev)
    for label, ncfg in (("k2_banded", NeighborConfig()),
                        ("k1_dense", NeighborConfig(use_grid_topk=False))):
        chip_smoke.stress_rollout(model, sc, ncfg, 3)            # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, wall = chip_smoke.stress_rollout(model, sc, ncfg, args.frames)
            total = time.perf_counter() - t0
        rows = []
        busy_us = 0.0
        for e in prof.key_averages():
            # kernels only: an aten op also carries its kernels' time
            if e.device_type != DeviceType.CUDA:
                continue
            dev_us = e.self_device_time_total
            if dev_us > 0:
                busy_us += dev_us
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        per_frame = lambda us: us / 1e3 / args.frames
        print(json.dumps({
            "route": label, "frames": args.frames,
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
