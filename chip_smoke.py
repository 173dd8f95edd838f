#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``piml_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. build the CUDA kernels from ``piml_tpu_torch/csrc`` (timed);
2. K1 (dense top-k) against its plain PyTorch version at the rollout
   shapes: the 12,685-agent self pass (k = 6) and the 4,096-obstacle pass
   (k = 10) — bitwise equal; milliseconds from CUDA events around a queued
   run of launches (``queued_ms``) beside each pass's bound
   (``kernel_bound``);
3. K2 (banded top-k) against its plain version at the same shapes —
   bitwise equal, same exactness flag, and equal to K1 on every
   in-threshold slot when exact; times beside the bounds;
3b. both kernels bitwise against their plain versions on edge cases
   (``kernel_edge_cases``): a unit lattice (ties across K1's column
   slices), duplicate positions, absent rows and columns, N not a multiple
   of 32 or 128, a table narrower than one slice, k = 1 and 16, C = 3 with
   per-channel and shared tables, an overflowed K2 window;
3c. the contact-count kernel (``contact_counts_check``): the form of
   ``torch.linalg.vector_norm`` over (dx, dy) on the card, on millions of
   pairs, against the kernel's ``sqrtf(dx·dx + dy·dy)``; the counts for
   two thresholds in one launch, bitwise equal to the plain version at
   (frames, N) = (2, 12685), (20, 12685), (32, 337) and (320, 337), with
   NaN and infinite rows, coincident agents, N = 0, 1 and N not a
   multiple of the 64-row tile, pairs planted one ulp either side of 0.5
   and 0.25 m, one threshold, a threshold of 0; the dense and GC shapes'
   times beside their bounds;
3d. the force-law kernel (``mlapm_force_check``) for the raw, GC, UCY and
   UCY-intent laws: bitwise equal to the plain version on 2,000 isolated
   pairs (one term a row) and at N = 1, 2; at N = 7 ... 12,685 every row
   within the rounding bound of summing its terms in another order, NaN
   and infinite entries on the same places (absent slots, zero and NaN
   velocities, coincident agents, a NaN and an infinite goal); two calls
   bitwise equal, one launch a call; the GC law's time at the dense shape
   beside its bound and the plain version's;
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
   and ``evaluate_rollouts`` (with OT and MMD) on the GPU; the whole
   750-frame window against the JAX package's numbers
   (``piml_tpu_torch/fixtures/gc_window_jax.npz``, see
   ``gc_window_vs_fixture``: each metric and each recorded frame's median
   position gap within three times the JAX package's own spread under
   1e-4 m moves of the scene); and a 60-frame slice on the GPU against the
   same slice on the CPU (MAE, OT, MMD and the rest to rtol 1e-4);
8. K2 with its channel axis on the stress scene at C = 2 (the second
   channel a seeded jitter of the first), agent and obstacle pass: the
   batched launch bitwise equal to its plain version and to two
   single-channel launches; ``queued_ms`` of both, and the bounds;
9. the dense-N finetune step (``bench.py:493`` ``bench_train_step_denseN``:
   C = 2 windows × T = 10 frames, 12,685 live agents over 200 m,
   64 obstacles, ``pinnsf_bm`` finetune model with ``pred_acc`` clamped
   to ±5, the bench's loss weights, dropout 0): three Adam steps whose
   feature passes launch the channel-batched K2 on every frame; s/step,
   peak memory, launches (K2's and the contact kernel's: one a frame and
   one for the labels), fallbacks, finite losses; then one step through
   the kernels and through the plain versions (loss to rtol 1e-6,
   gradients to relative L2 1e-5: the index-gather backward accumulates
   with atomics);
10. the paper-shape finetune step (``bench.py:352``: 32 windows × 10
    frames of the GC scene, pretrained weights): loss and gradients on the
    GPU against the CPU path (rtol 1e-4, relative L2 1e-3); s/step;
11. ``Trainer.finetune``: 2 epochs on GC windows from the pretrained
    weights, validated on a held-out frame range, checkpoints in a
    temporary directory; finite losses, and the reloaded best checkpoint
    gives the best validation loss again;
12. OT and MMD at dense N (``bench.py:617`` ``bench_dense_metrics``:
    5 frames of 12,685 agents uniform over 200 m, ``q = p + N(0, 0.5²)``):
    every frame's banded Sinkhorn exact and equal to the streaming kernel
    (rel 1e-4); a far cloud (300 m away) fails the proof and falls back to
    the streaming value bit for bit; streaming MMD equal to dense MMD on
    4,096 agents, against q and against the far cloud (rel 1e-4 /
    abs 1e-6); ms/frame of ``ot_with_time_mask``
    and ``mmd_with_time_mask``, iterations per frame, peak memory;
13. the CLI pipeline, ``piml_tpu_torch.exp.main.run``, on scenes cut from
    the committed GC scenes (frames 0-300 / 300-450 / 450-600 of
    ``gc_sf_repro.npy`` to pretrain, of ``gc_mlapm_repro.npy`` to
    finetune) with the paper's hyper-parameters for 2 epochs: finite
    losses, finite test OT / MMD for the pretrained and the finetuned
    model, checkpoints on disk; a rerun with 3 epochs resumes at epoch 2
    and its epoch-2 pretrain records equal an uninterrupted 3-epoch
    pretrain's bit for bit.  s/epoch, rows/s, test eval seconds;
14. the discovery loop (``discovery_loop``):
    a. generation at the reference's size: the GC scenario, 750 frames,
       seed 666, with ``simulate`` (default ``SFParams``, 10 sub-steps a
       frame) and with ``simulate_mlapm`` (``MLAPMParams.gc_paper()``),
       through ``to_scene``, ``Scene.save`` and ``Scene.load``: s/scene,
       frames/s, slots, peak memory; every active position finite; the
       reloaded scene equal to the saved one; a 20-frame prefix of each
       engine on the same schedule on the CPU, positions within 1e-4 m
       and active masks equal;
    b. ``piml_loop``, 2 iterations of 2 epochs on frame ranges of the
       social-force scene (``LOOP_SPLITS``), ``pinnsf_bm`` at the paper's
       widths with analytic message supervision, dropout 0.5, the phase-13
       hyper-parameters otherwise, regenerating 750-frame GC scenes from
       the vector fit: finite fits, ``iter_flag`` set on iteration 1, the
       regenerated scenes load; pretrain s/epoch, extracted edges and
       edges/s, fit and regeneration seconds.  Then both extractions
       (``prepare_symbolic_regression_data``,
       ``prepare_vector_regression_data``) of iteration 1's parameters on
       ``EXTRACT_ROWS`` training rows, on the card and on the CPU: the
       same kept rows, values to rtol 1e-4 and angles to atol 1e-4 (an
       angle of a vector collinear with its base may flip sign with the
       rounding of a zero cross product; such angles are counted).

15. the model zoo:
    a. every registry name and both finetune swaps, seeded, at the paper's
       widths, on 4,096 pointwise rows of the GC window: the card against
       the CPU (rtol 1e-4 / atol 1e-5 on every output that is not None);
       ``pinnsf_m`` and ``pinnsf_bm`` with ``compute_dtype="bfloat16"``:
       float32 outputs, ``pred_acc`` within ``0.03 · max(|pred|, 1)`` of
       the CPU's float32 forward, both forwards' ms;
    b. ``exp.main.run`` on phase 13's scenes: ``pinnsf_m`` for 2 epochs
       with the first values of
       ``configs/exp_configs/0206-pinnsf_m-gcdata2104-ps.yaml`` and its
       finetune; ``pinnsf_res`` for 1 epoch with its corrector finetune
       (both Adam groups step); ``base`` for 1 epoch with
       ``configs/exp_configs/base_gcdata_ps_no_ft.yaml``'s values: finite
       losses and test OT / MMD, checkpoints on disk, s/epoch;
    c. the dense stress with 15b's ``pinnsf_m`` weights, 20 frames after
       a 3-frame warm-up: K2 launches and fallbacks, finite live
       positions, ms/frame; 5 frames through the kernels and the plain
       versions, bitwise equal; the same 20 frames in bfloat16: ms/frame,
       finite positions, the position gap to float32 after 5 frames;
    d. phase 9's dense-N step with a ``pinnsf_m`` finetune model, 2 Adam
       steps: s/step, peak memory, channel-batched K2 launches, finite
       losses.
16. the data and experiment layers, on phase 13's cut scenes:
    a. ``RatioSplitDataset``, ``SceneListSplitDataset`` and
       ``OnlyTrainingDataset`` on the card against the CPU
       (``rows_gap``), ``Scene.pad_agents`` / ``pad_time`` bit for bit;
    b. ``run_staged_experiment`` (phase 13's hyper-parameters, 2 epochs)
       as ``pretrain`` → ``finetune`` → ``evaluate`` on one state file
       against one ``all`` call on another (``staged_experiment``);
    c. ``exp.grid``: a two-entry YAML grid of 1-epoch
       ``python3 -m piml_tpu_torch.exp.main`` runs through ``task_queue``,
       in subprocesses, both exiting 0; wall seconds, rows/s, peak memory;
17. the one-chip scale ceiling (``scale_ceiling``): 1,048,576 agents, the
    trained ``pinnsf_bm``, 3 frames after a warm-up frame: ms/frame, peak
    memory, K2 launches, fallbacks and half-grid calls a frame, no K1
    launch for agents; the half-grid K2 pass bitwise against its plain
    version on 16 tiles and against K1 on 4,096 sampled rows; one frame
    through the old route (K1 as the fallback).
18. the parallel layer (``parallel_layer``): four ranks of one process
    group share the card over gloo (``parallel.spawn_local``; the kernels
    are built before they start), all at full width: (a) sharded K2 at the
    dense stress padded to 12,688 agents, each rank's launch bitwise
    against the plain version, the gathered agent features bitwise the
    single-device pass's and the obstacle features the dense pass's, each
    rank's pass timed alone, a forced-fallback frame; (b) the
    agent-sharded eval rollout of the trained ``pinnsf_bm``, 10 frames,
    bit for bit the single-device rollout with the same obstacle
    selection; (c) phase 9's channel-DP step, 2 channels padded to 4,
    against the single-device step; (d) sharded OT and MMD, 5 frames at
    12,685 agents, against the single-device metrics; (e) tensor
    parallelism on a 2 × 2 (dp, tp) mesh, the forward and one dp × tp
    step, with ``pinnsf_bm`` at its published widths.  Times of ranks that
    share one card are no multi-card speed.
19. the paper reproduction (``paper_reproduction``):
    ``python3 -m piml_tpu_torch.exp.repro --smoke --root DIR`` in a
    subprocess, its five stages (social-force and MLAPM generation of the
    100-frame GC scenario, the GC experiment's pretrain and finetune of
    ``pinnsf_bm`` at its published widths for 3 epochs, symbolic
    regression without the GP search, the sweep's grid expansion) on a
    root whose paper YAMLs name phase 13's cut scenes: every stage rc 0,
    100 frames, a finite finetuned ``finetune_test``, extracted edges; the
    same command again skips all five.  Each stage's wall seconds and the
    K1 / K2 launches of every process of the run (0: under the 2^21 gate).

The line before the last holds the kernels' record as JSON (per kernel
and per pass: ms, plain ms, ``bound_ms``, ``bound_by``, ``share`` of the
bound, ``library_ms`` null: no single PyTorch call computes a
field-of-view top-k), and the last line is
``{"ok": true, "device": {...}}``.  Launch counts are zeroed just
before each main path (phases 4-5, phase 9, phases 15c and 15d, phase
17, and on every rank phase 18b) and read just after it: they count only
the main paths' launches.  Phases 12-13 run no kernel of the port, and
phase 14 none but the force law's (every MLAPM frame, counted over the
phase and required): dense-N OT and MMD are torch ops, and the CLI
pipeline's and the discovery loop's GC scenes (at most ~340 agents,
4,094 obstacle points) stay below the 2^21 pair gate that routes the
feature pass to K1 / K2; phase 14 reads both counts after its run to
show it; phase 16's runs
are below that gate too, and so are phase 19's, whose child processes
each append their counts to a log at exit.  It needs no network and
starts no process besides ``nvidia-smi``, the ``nvcc`` builds, phase
16's two CLI runs, phase 18's four rank processes and phase 19's two
reproduction runs (with their children), each of which it waits for.
"""

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_CHANNELS = 2          # dense-N finetune step (bench.py:493)
TRAIN_FRAMES = 10
TRAIN_STEPS = 3
TRAIN_OBSTACLES = 64
PAPER_WINDOWS = 32          # paper-shape step (bench.py:352)
FT_WINDOWS = (25, 125)      # Trainer.finetune: training windows' first
FT_VALID_FRAMES = (600, 700)  # frames, and the held-out validation frames
OT_FRAMES = 5               # OT / MMD at dense N (bench.py:617)
OT_MMD_SUBSET = 4096        # agents of the streaming-vs-dense MMD check
# the CLI pipeline: frame ranges of the committed scenes per split, and
# the paper's hyper-parameters (tools/run_gc_experiment.py:37-59)
CLI_SPLITS = {"train": (0, 300), "valid": (300, 450), "test": (450, 600)}
CLI_EPOCHS = 2
CLI_CFG = dict(model="pinnsf_bm", dataset_name="gc2344", batch_size=128,
               ft_batch_size=32, learning_rate=2e-4, weight_decay=1e-6,
               finetune_lr_decay=0.02, valid_steps=10, skip_frames=25,
               collision_pred_weight=5e-2, collision_loss_weight=200.0,
               collision_focus_weight=1.0, hard_collision_penalty=2.0,
               val_coll_weight=30.0, time_decay=0.9, reg_weight=1e-2,
               collision_loss_version="v2", dropout=0.5, shuffle=True,
               patience=20, ft_patience=5, compat_swapped_patience=True)
# the discovery loop (phase 14): the GC scenario at the reference's size,
# the frame ranges of its social-force scene the loop pretrains on, and
# the rows of the card-vs-CPU extraction check
GEN_FRAMES = 750
GEN_SEED = 666
GEN_PREFIX = 20
LOOP_SPLITS = {"train": (0, 500), "valid": (500, 750)}
LOOP_EPOCHS = 2
LOOP_CFG = dict(CLI_CFG, pinnsf_interaction="loss",
                compat_unweighted_coll_pred=False, dropout=0.5)
EXTRACT_ROWS = 4096
# the model zoo (phase 15): every registry name and both finetune swaps at
# the paper's widths on ZOO_ROWS pointwise rows of the GC scene; the CLI
# pipeline with pinnsf_m (the first value of each list of
# configs/exp_configs/0206-pinnsf_m-gcdata2104-ps.yaml), pinnsf_res (the
# same, ft_lr_decay2 = 1 so that the corrector group trains) and base
# (configs/exp_configs/base_gcdata_ps_no_ft.yaml); then pinnsf_m on the
# dense stress and the dense-N finetune step
ZOO_NAMES = ("base", "base1", "base2", "base3", "base4", "base5", "base6",
             "base7", "base_nd", "base_test", "pinnsf", "pinnsf2",
             "pinnsf_polar", "pinnsf_bottleneck", "pinnsf_pb", "pinnsf_pbc",
             "pinnsf_bm", "pinnsf_m", "pinnsf_res")
ZOO_ROWS = 4096
ZOO_EPOCHS = 2
ZOO_STRESS_FRAMES = 20
ZOO_TRAIN_STEPS = 2
M_CFG = dict(model="pinnsf_m", dataset_name="gc2344", pinnsf_interaction="sim",
             collision_pred_weight=5e-2, reg_weight=1e-2, teacher_weight=0.0,
             collision_loss_weight=100.0, hard_collision_penalty=1.0,
             collision_focus_weight=1.0, val_coll_weight=30.0, time_decay=0.9,
             learning_rate=2e-4, finetune_lr_decay=0.02, batch_size=128,
             ft_batch_size=32, weight_decay=1e-6, dropout=0.5, patience=20,
             ft_patience=5, valid_steps=10, collision_threshold=0.5)
BASE_CFG = dict(model="base", learning_rate=5e-4, batch_size=128,
                weight_decay=1e-6, dropout=0.5, patience=30,
                sight_angle_ped=100.0, sight_angle_obs=100.0,
                dist_threshold_ped=10.0, dist_threshold_obs=10.0,
                correction_hidden_layers=1)
# the bench's finetune hyper-parameters (bench.py:382, :520)
TRAIN_CFG = dict(model="pinnsf_bm", dataset_name="gc2344", dropout=0.0,
                 skip_frames=25, valid_steps=TRAIN_FRAMES,
                 learning_rate=2e-4, weight_decay=1e-6,
                 finetune_lr_decay=0.02, collision_pred_weight=5e-2,
                 collision_loss_weight=200.0, collision_focus_weight=1.0,
                 hard_collision_penalty=2.0, time_decay=0.9, reg_weight=1e-2,
                 collision_loss_version="v2", time_unit=0.08)


# clock cycles (~17 ms) that hold the stream while queued_ms queues its run
QUEUE_CYCLES = 30_000_000


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` by CUDA events, after one warm-up
    (the end-to-end metrics of phase 12: the host's dispatch counts)."""
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


def queued_ms(fn, reps):
    """Milliseconds a kernel pass ``fn()`` takes on the card: CUDA events
    around a run of ``reps`` calls, over the count, after one warm-up.  The
    run is queued behind a sleep kernel (``QUEUE_CYCLES``), so the card
    runs the calls back to back and the host's launch overhead does not
    show in the device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_route():
    """Route the kernel wrappers to their plain versions on the card (for
    the comparisons only: the wrappers themselves never fall back)."""
    from piml_tpu_torch.ops import banded, contacts, pairwise

    def banded_plain(*args):   # the plain version takes no cell offsets
        return banded.banded_topk_plain(*args[:-1])

    def contacts_plain(position, thresholds):
        return tuple(contacts.contact_counts_plain(position, thr)
                     for thr in thresholds)

    with mock.patch.object(pairwise, "pairwise_topk_cuda",
                           pairwise.pairwise_topk_plain), \
            mock.patch.object(banded, "banded_topk_cuda", banded_plain), \
            mock.patch.object(contacts, "contact_counts_cuda",
                              contacts_plain):
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


# the H100 SXM's published peaks: HBM3 bandwidth, and the f32 rate of
# operations that are not fused: the 67 TFLOP/s f32 peak counts a
# multiply-add as two operations, and under --fmad=false each of a pair's
# operations is an instruction of its own (132 SMs × 128 lanes × 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
# a pair's least work: dx, dy, dx², dy², their sum and the compare with the
# row's k-th distance (the sqrt and field-of-view gate follow only for
# pairs that can rank)
OPS_PER_PAIR = 6


def kernel_bound(nbytes, pairs):
    """The least time the card could take: bytes over the memory rate or
    the pairs' operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_PAIR * pairs / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_pairs=pairs)


def k1_bound(rows, cols, k):
    """K1's bound on these inputs: rows (32-byte records, whole sectors),
    the table (x, y, valid) and outputs moved once; one pair per valid row
    and valid column."""
    pairs = int((rows[:, 4] > 0.5).sum()) * int((cols[2] > 0.5).sum())
    nbytes = 4 * (rows.numel() + cols.numel()) + 8 * rows.shape[0] * k
    return kernel_bound(nbytes, pairs)


def k2_bound(args):
    """K2's bound on these packed arguments: window starts, geometry, rows,
    the three table rows the kernel reads (x, y, object id: its ranges come
    from the cell offsets, so it never reads valid, cx or cy), the offsets
    and the outputs, moved once; the in-box pairs of ``box_ranges``."""
    from piml_tpu_torch.ops import banded

    ws, geo, rows, cols, window, grid_dim, k = args[:7]
    offsets = args[9]
    ranges = banded.box_ranges(ws, geo, rows, offsets, window, grid_dim)
    pairs = int((ranges[..., 1] - ranges[..., 0]).sum())
    table = cols.numel() // cols.shape[-2] * 3
    nbytes = (4 * (ws.numel() + geo.numel() + rows.numel() + table)
              + 8 * offsets.numel() + 8 * (rows.numel() // 8) * k)
    return kernel_bound(nbytes, pairs)


def banded_args(selector, *args, **kw):
    """Run a banded selector: ``(the packed arguments it handed to
    banded_topk, its result)``.  The kernel takes them all, the plain
    version all but the last (the cell offsets)."""
    from piml_tpu_torch.ops import banded

    captured = {}
    real = banded.banded_topk

    def capture(*a):
        captured["args"] = a
        return real(*a)

    with mock.patch.object(banded, "banded_topk", capture):
        out = selector(*args, **kw)
    return captured["args"], out


def pass_record(ms, plain_ms, bound):
    """One kernel pass's times beside its bound."""
    return dict(ms=ms, plain_ms=plain_ms, **bound,
                share=bound["bound_ms"] / ms)


def kernel_record(passes, max_err):
    """A kernel's line in the record: its single-frame passes summed (the
    ``batched_*`` passes apart), each pass's ``ms_<pass>`` and
    ``plain_ms_<pass>``, and each pass in full under ``passes``."""
    single = [p for name, p in passes.items()
              if not name.startswith("batched_")]
    by = max(single, key=lambda p: p["bound_ms"])["bound_by"]
    ms = sum(p["ms"] for p in single)
    bound = sum(p["bound_ms"] for p in single)
    flat = {}
    for name, p in passes.items():
        flat[f"ms_{name}"] = p["ms"]
        flat[f"plain_ms_{name}"] = p["plain_ms"]
    return dict(ms=ms, plain_ms=sum(p["plain_ms"] for p in single),
                max_abs_err=max_err, bound_ms=bound, bound_by=by,
                share=bound / ms, library_ms=None, **flat, passes=passes)


def kernel_edge_cases(dev):
    """Phase 3b: both kernels bit for bit against their plain versions on
    inputs that test the slices' merge and K2's box ranges: agents on a
    unit lattice (distances tie in groups; ties break by id across
    slices), duplicate positions, absent rows and columns with N not a
    multiple of 32 or 128, a table narrower than one slice, k = 1 and
    k = 16, C = 3 with per-channel and with shared tables, and a K2 tile
    whose window overflows (exact is False)."""
    import numpy as np
    import torch

    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.physics import heading_direction

    rs = np.random.RandomState(SEED + 3)
    checks = []

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def head(vel):
        return heading_direction(t(vel), time_axis=False)

    def spread(n, extent):
        return (rs.rand(n, 2) * extent).astype(np.float32), rs.randn(n, 2)

    def k1(name, pos, vel, k, angle, objects=None):
        rows = pairwise.pack_rows(t(pos), head(vel))
        cols = pairwise.pack_cols(t(pos if objects is None else objects))
        thr = pairwise.cos_threshold(angle)
        selfp = objects is None
        got = pairwise.pairwise_topk_cuda(rows, cols, k, thr, selfp)
        ref = pairwise.pairwise_topk_plain(rows, cols, k, thr, selfp)
        torch.cuda.synchronize()
        assert_equal(got[0], ref[0], f"K1 {name} dist")
        assert_equal(got[1], ref[1], f"K1 {name} idx")
        checks.append(dict(kernel="k1", case=name, n=rows.shape[0],
                           m=cols.shape[1], k=k,
                           slices=pairwise.column_slices(cols.shape[1])[0],
                           finite=int(torch.isfinite(got[0]).sum())))

    def k2(name, pos, vel, k, angle, **kw):
        batched = np.ndim(pos) == 3
        if batched:
            sel = banded.topk_neighbors_banded_batched
        else:
            sel = banded.topk_neighbors_banded
            kw["same_objects"] = kw.get("objects") is None
        args, out = banded_args(sel, t(pos), head(vel), k, angle, **kw)
        got = banded.banded_topk_cuda(*args)
        ref = banded.banded_topk_plain(*args[:-1])
        torch.cuda.synchronize()
        assert_equal(got[0], ref[0], f"K2 {name} dist")
        assert_equal(got[1], ref[1], f"K2 {name} idx")
        exact = out[2].tolist()
        checks.append(dict(kernel="k2", case=name,
                           rows=list(args[2].shape[:-1]),
                           m_band=args[3].shape[-1], k=args[6],
                           grid_dim=args[5], window=args[4], exact=exact,
                           in_box_pairs=k2_bound(args)["bound_pairs"]))
        return exact

    xs, ys = np.meshgrid(np.arange(64), np.arange(64))
    grid = np.stack([xs.ravel(), ys.ravel()], 1)     # 4,096 agents, 1 m
    east = np.tile([[1.0, 0.0]], (grid.shape[0], 1))
    for k, angle in ((6, 90.0), (6, 180.0), (1, 90.0), (16, 180.0)):
        k1(f"lattice k={k} {angle:g} deg", grid, east, k, angle)
        k2(f"lattice k={k} {angle:g} deg", grid, east, k, angle)
    base, _ = spread(700, 30.0)
    dup, dvel = np.repeat(base, 3, axis=0), rs.randn(2100, 2)
    for angle in (90.0, 180.0):
        k1(f"duplicates {angle:g} deg", dup, dvel, 6, angle)
        k2(f"duplicates {angle:g} deg", dup, dvel, 6, angle)
    pos, vel = spread(1000, 40.0)                     # N % 32 = 8
    pos[rs.rand(1000) < 0.2] = np.nan
    obs, _ = spread(1500, 40.0)
    obs[rs.rand(1500) < 0.2] = np.nan
    k1("absent agents", pos, vel, 6, 90.0)
    k1("absent obstacles", pos, vel, 10, 90.0, objects=obs)
    k1("M=100 < one slice", pos, vel, 10, 90.0, objects=obs[:100])
    k1("M=5, k=5", pos, vel, 5, 90.0, objects=obs[:5])
    k2("absent agents", pos, vel, 6, 90.0, dist_threshold=4.0)
    k2("absent obstacles", pos, vel, 10, 90.0, objects=t(obs))
    k2("M=100", pos, vel, 10, 90.0, objects=t(obs[:100]))
    p3 = np.stack([spread(1500, 50.0)[0] for _ in range(3)])
    v3 = rs.randn(3, 1500, 2)
    k2("C=3 per-channel tables", p3, v3, 6, 90.0, dist_threshold=4.0)
    k2("C=3 shared table", p3, v3, 10, 90.0, objects=t(obs))
    pos = (rs.rand(600, 2) * 0.5 + 100.0).astype(np.float32)
    pos[:60] = rs.rand(60, 2) * 100.0
    if k2("window overflow", pos, np.tile([[1.0, 0.0]], (600, 1)), 6, 90.0,
          grid_dim=16, window=128):
        raise AssertionError("K2 edge cases: the overflowed window was "
                             "reported exact")
    say("kernel_edge_cases", bitwise_equal=True, cases=checks)
    return checks


def norm_forms(dev, pairs):
    """How ``torch.linalg.vector_norm`` computes ``|p_j − p_i|`` over a
    trailing dim of 2 on the card, as the plain contact counts call it:
    mismatches of each candidate form on ``pairs`` random pairs (at
    coordinates up to 2 m, where distances near the thresholds are
    common).  ``sqrt(dx·dx + dy·dy)`` rounds each product; the multiply-add
    forms round ``dx·dx`` (or ``dy·dy``) and then the exact sum, emulated
    in f64 (one more rounding, off in a vanishing share of pairs)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    side = int(math.isqrt(pairs))
    p = torch.rand((side, 2), generator=g, device=dev) * 2.0
    rel = p[None, :, :] - p[:, None, :]
    norm = torch.linalg.vector_norm(rel, dim=-1)
    dx, dy = rel[..., 0], rel[..., 1]
    forms = {
        "sqrt(dx*dx+dy*dy)": torch.sqrt(dx * dx + dy * dy),
        "sqrt(fma(dy,dy,dx*dx))": torch.sqrt(
            (dy.double() * dy.double() + (dx * dx).double()).float()),
        "sqrt(fma(dx,dx,dy*dy))": torch.sqrt(
            (dx.double() * dx.double() + (dy * dy).double()).float()),
    }
    return side * side, {name: int((f != norm).sum())
                         for name, f in forms.items()}


def contact_counts_check(dev):
    """Phase 3c: the contact-count kernel bit for bit against its plain
    version (one call per threshold) on the main path's shapes and on edge
    cases, after checking that the kernel's form of the distance is the
    one ``vector_norm`` takes on the card; ``queued_ms`` of the dense and
    GC shapes beside the bound of their pair tests."""
    import numpy as np
    import torch

    from piml_tpu_torch.ops import contacts

    pairs, forms = norm_forms(dev, 1 << 24)
    say("contact_norm_form", pairs=pairs, mismatches=forms)
    if forms["sqrt(dx*dx+dy*dy)"]:
        raise AssertionError(f"vector_norm is not sqrt(dx*dx+dy*dy) on the "
                             f"card: mismatches {forms}")

    rs = np.random.RandomState(SEED + 7)
    checks = []

    def check(name, pos, thresholds=(0.5, 0.25)):
        pos = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
        got = contacts.contact_counts_cuda(pos, thresholds)
        ref = [contacts.contact_counts_plain(pos, thr) for thr in thresholds]
        torch.cuda.synchronize()
        for g_, r_, thr in zip(got, ref, thresholds):
            assert_equal(g_, r_, f"contacts {name} thr={thr}")
        checks.append(dict(case=name, frames=pos.shape[0], n=pos.shape[1],
                           thresholds=list(thresholds),
                           contacts=[float(c.sum()) for c in got]))
        return pos

    def uniform(frames, n, extent):
        return (rs.rand(frames, n, 2) * extent).astype(np.float32)

    # the main path's shapes: the dense frames and labels over 200 m, the
    # GC scene's channels and labels on a concourse-sized patch
    dense2 = check("dense frame", uniform(2, N_AGENTS, 200.0))
    dense20 = check("dense labels", uniform(20, N_AGENTS, 200.0))
    gc32 = check("GC frame", uniform(32, 337, 20.0))
    gc320 = check("GC labels", uniform(320, 337, 20.0))
    # edge cases
    pos = uniform(3, 1000, 8.0)
    pos[:, rs.rand(1000) < 0.2] = np.nan
    pos[0, 5, 1] = np.nan                      # one coordinate absent
    pos[1, 7] = np.inf
    pos[1, 8] = (np.inf, 2.0)
    pos[2, 9] = -np.inf
    pos[:, 20:40] = pos[:, 40:60]              # coincident distinct agents
    pos[:, 60:63] = pos[:, 63:64]
    check("NaN, inf and coincident rows", pos)
    for n in (0, 1, 2, 63, 65, 97, 337):
        check(f"N={n}", uniform(3, n, 2.0))
    # pairs one ulp either side of each threshold, axis-aligned and
    # diagonal (0.3, 0.4 → 0.5; 0.15, 0.2 → 0.25): one pair a frame, agent
    # 0 at the origin so that every difference is exact, beside a crowd
    # 10 m away
    planted = []
    for thr in (np.float32(0.5), np.float32(0.25)):
        for u in (-2, -1, 0, 1, 2):
            d = thr
            for _ in range(abs(u)):
                d = np.nextafter(d, np.float32(u))
            planted += [(d, np.float32(0.0)), (np.float32(0.0), d)]
            for fx, fy in ((0.6, 0.8), (0.8, 0.6)):
                y = np.float32(fy * thr)
                for _ in range(abs(u)):
                    y = np.nextafter(y, np.float32(u))
                planted.append((np.float32(fx * thr), y))
    frames = uniform(len(planted), 66, 30.0) + np.float32(10.0)
    frames[:, 0] = 0.0
    frames[:, 1] = planted
    near = check("planted pairs at 0-2 ulp", frames)
    check("one threshold", uniform(2, 777, 6.0), (0.5,))
    check("thresholds 0.3 and 0", uniform(2, 500, 3.0), (0.3, 0.0))
    say("contact_counts_cases", bitwise_equal=True, cases=checks,
        planted_pairs=len(planted), planted_hits=[
            float(c[:, 0].sum())
            for c in contacts.contact_counts_cuda(near, (0.5, 0.25))])

    passes = {}
    for name, pos in (("dense_frame", dense2), ("dense_labels", dense20),
                      ("gc_frame", gc32), ("gc_labels", gc320)):
        ms = queued_ms(lambda: contacts.contact_counts_cuda(
            pos, (0.5, 0.25)), 20)
        plain_ms = queued_ms(lambda: [contacts.contact_counts_plain(pos, t)
                                      for t in (0.5, 0.25)], 3)
        frames, n = pos.shape[0], pos.shape[1]
        # positions read once, two f32 counts written a row
        bound = kernel_bound(16 * frames * n, frames * n * n)
        passes[name] = pass_record(ms, plain_ms, bound)
        say("contact_counts", which=name, frames=frames, n=n,
            slices=contacts.column_slices(n)[0], **passes[name])
    return passes


# the force law's kernel (phase 3d): crowd sizes from one agent to the
# dense shape, the isolated pairs of its bitwise case, and the laws of
# tests/test_torch_gen.py (the GC law at its published constants)
MLAPM_SIZES = (1, 2, 7, 63, 64, 65, 337, 3000, N_AGENTS)
MLAPM_PAIRS = 2000
MLAPM_LAWS = {
    "raw": dict(version="raw", A=4.0, B=-2.0),
    "GC": dict(version="GC"),
    "UCY": dict(version="UCY", tau=5 / 6, A=10.67, B=-3.33, C=0.0, D=0.0,
                theta=10.0, ucy_gate_compat=True),
    "UCY-intent": dict(version="UCY", tau=5 / 6, A=10.67, B=-3.33, C=0.0,
                       D=0.0, theta=10.0, ucy_gate_compat=False),
}
F32_ULP = 2.0 ** -24


def mlapm_inputs(rs, n, extent):
    """A crowd of ``n`` slots at the dense cell's density (at least 3 m
    across): 15 % absent (NaN), every ninth velocity 0, one velocity with
    a NaN component, two coincident agents, one NaN goal and one goal with
    an infinite coordinate (its goal direction is (NaN, −0): the cross
    product is NaN, the y force finite)."""
    import numpy as np

    p = (rs.rand(n, 2) * extent).astype(np.float32)
    p[rs.rand(n) < 0.15] = np.nan
    v = (rs.randn(n, 2) * 1.34).astype(np.float32)
    v[::9] = 0.0
    dest = (rs.rand(n, 2) * extent).astype(np.float32)
    if n >= 5:
        p[:4] = (rs.rand(4, 2) * extent).astype(np.float32)
        p[1] = p[0]
        v[2, 0] = np.nan
        dest[3] = np.nan
        dest[4] = (np.inf, dest[4, 1])
    return p, v, dest


def isolated_pairs(rs, pairs):
    """``pairs`` pairs of agents 0-2 m apart on a grid 60 m wide:
    a far pair's exponential underflows to 0 for the raw, GC and
    UCY-intent laws, so each row's sum has one term and any order gives
    its bits.  Coincident pairs, pairs on the goal's line (cross product
    0), absent members, zero velocities, NaN and infinite goals."""
    import numpy as np

    side = math.ceil(math.sqrt(pairs))
    k = np.arange(pairs)
    centre = np.stack([k % side, k // side], 1).astype(np.float32) * 60.0
    off = ((rs.rand(pairs, 2) - 0.5) * 2.8).astype(np.float32)
    off[::17] = 0.0                                        # coincident
    on_line = np.arange(5, pairs, 13)
    off[on_line, 1] = 0.0
    p = np.empty((2 * pairs, 2), np.float32)
    p[0::2], p[1::2] = centre, centre + off
    v = (rs.randn(2 * pairs, 2) * 1.34).astype(np.float32)
    v[::11] = 0.0
    dest = np.repeat(centre, 2, 0) + (
        (rs.rand(2 * pairs, 2) - 0.5) * 20).astype(np.float32)
    dest[2 * on_line] = centre[on_line] + np.float32(5.0)  # e = (1, 0)
    dest[2 * on_line, 1] = centre[on_line, 1]
    dest[7::97] = np.nan
    dest[9::89, 0] = np.inf
    p[np.arange(3, 2 * pairs, 41)] = np.nan
    return p, v, dest


def mlapm_force_check(dev):
    """Phase 3d: the force-law kernel against its plain version on the
    card.  Isolated pairs (one term a row) and N = 1, 2 are bit for bit:
    each pair term has the plain version's bits.  Elsewhere only the order
    of the sum over ``j`` differs, so each row's gap is held to the worst
    case of rounding two sums of the same N terms in any two orders and
    subtracting each from the goal term ``g``: ``2·γ_{N+1}·(Σ_j |t_ij| +
    |g_i|)``, ``γ_m = m·u / (1 − m·u)``, ``u = 2^-24``.  NaN and infinite
    entries fall on the same places; two calls give the same bits; each
    call counts one launch.  ``queued_ms`` of the GC law at the dense
    shape beside ``benchmark/yardstick/pair_law.py``'s 44 FLOP a pair at
    67 TFLOP/s, and the plain version's."""
    import numpy as np
    import torch

    from benchmark.yardstick import pair_law
    from piml_tpu_torch.models import MLAPMParams, mlapm
    from piml_tpu_torch.ops import mlapm as mlapm_ops

    rs = np.random.RandomState(SEED + 17)

    def run(params, p, v, dest):
        p, v, dest = (torch.as_tensor(a, device=dev) for a in (p, v, dest))
        ds = torch.full((p.shape[0],), 1.34, device=dev)
        launches = mlapm_ops.KERNEL.launches
        got = mlapm.mlapm_force(params, p, v, ds, dest)
        again = mlapm.mlapm_force(params, p, v, ds, dest)
        ref = mlapm._force(params, p, v, ds, dest, 0.3)
        torch.cuda.synchronize()
        if mlapm_ops.KERNEL.launches != launches + 2:
            raise AssertionError("mlapm: not one launch a call")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError("mlapm: two calls differ")
        for what, f in (("NaN", torch.isnan), ("inf", torch.isinf)):
            if not torch.equal(f(got), f(ref)):
                raise AssertionError(f"mlapm: {what} entries differ")
        return (p, v, ds, dest), got, ref

    cases = []
    for law, kw in MLAPM_LAWS.items():
        params = MLAPMParams(**kw)
        if law != "UCY":   # far pairs of the compat law push with A
            p, v, dest = isolated_pairs(rs, MLAPM_PAIRS)
            _, got, ref = run(params, p, v, dest)
            fin = torch.isfinite(ref)
            if not torch.equal(got[fin], ref[fin]):
                raise AssertionError(f"mlapm {law} isolated pairs: not "
                                     f"bitwise equal")
            cases.append(dict(law=law, n=2 * MLAPM_PAIRS, case="isolated",
                              bitwise_equal=True,
                              nan_rows=int(torch.isnan(ref).any(1).sum())))
        for n in MLAPM_SIZES:
            extent = max(3.0, 200.0 * math.sqrt(n / N_AGENTS))
            args, got, ref = run(params, *mlapm_inputs(rs, n, extent))
            fin = torch.isfinite(ref)
            gap = (got - ref).abs()
            if n <= 2:
                if not torch.equal(got[fin], ref[fin]):
                    raise AssertionError(f"mlapm {law} N={n}: not bitwise "
                                         f"equal")
            ed, goal = mlapm._goal(params, *args)
            scale = mlapm._pair_terms(params, args[0], args[1], ed,
                                      0.3).abs().sum(dim=1) + goal.abs()
            m = (n + 1) * F32_ULP
            tol = 2 * m / (1 - m) * scale
            ratio = float((gap[fin] / tol[fin]).max()) if fin.any() else 0.0
            if not ratio <= 1.0:
                raise AssertionError(f"mlapm {law} N={n}: a row's gap is "
                                     f"{ratio} of its bound")
            rel = gap[fin] / ref[fin].abs().clamp_min(1e-30)
            cases.append(dict(
                law=law, n=n, splits=mlapm_ops.column_splits(n)[0],
                max_gap_over_bound=ratio,
                max_abs_gap=float(gap[fin].max()) if fin.any() else 0.0,
                median_rel_gap=float(rel.median()) if fin.any() else 0.0,
                nan_entries=int(torch.isnan(ref).sum())))
            del args, got, ref, gap, scale, tol
    say("mlapm_force_cases", cases=cases)

    n = N_AGENTS
    params = MLAPMParams.gc_paper()
    p, v, dest = (torch.as_tensor(a, device=dev)
                  for a in mlapm_inputs(rs, n, 200.0))
    ds = torch.full((n,), 1.34, device=dev)
    ms = queued_ms(lambda: mlapm.mlapm_force(params, p, v, ds, dest), 20)
    plain_ms = queued_ms(lambda: mlapm._force(params, p, v, ds, dest, 0.3),
                         2)
    bound = dict(bound_ms=pair_law.frame_flops(n) / 67e12 * 1e3,
                 bound_by="operations", bound_pairs=n * n)
    passes = {"gc_dense": pass_record(ms, plain_ms, bound)}
    say("mlapm_force", which="gc_dense", n=n,
        splits=mlapm_ops.column_splits(n)[0], **passes["gc_dense"])
    return passes


def k2_pass_kwargs(sc, ncfg):
    """The rollout's two K2 passes at the dense-stress shape."""
    from piml_tpu_torch.ops import banded

    n = sc["pos"].shape[0]
    g_p, w_p = banded.banded_params(n, n, ncfg.topk_ped, fine=True)
    g_o, w_o = banded.banded_params(n, sc["obstacles"].shape[0],
                                    ncfg.topk_obs, fine=True)
    return {
        "agents": dict(k=ncfg.topk_ped, angle_threshold=ncfg.sight_angle_ped,
                       dist_threshold=ncfg.dist_threshold_ped, grid_dim=g_p,
                       window=w_p),
        "obstacles": dict(k=ncfg.topk_obs,
                          angle_threshold=ncfg.sight_angle_obs,
                          objects=sc["obstacles"], same_objects=False,
                          dist_threshold=ncfg.dist_threshold_obs,
                          grid_dim=g_o, window=w_o),
    }


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


def finetune_model(cfg, device, pretrained=None):
    """A seeded ``pinnsf_bm`` finetune model (random weights, or the
    ``pretrained`` state dict)."""
    import torch

    from piml_tpu_torch.models import ModelSpec, build_finetune_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = build_finetune_model(ModelSpec.from_config(cfg))
    if pretrained is not None:
        model.load_state_dict(pretrained)
    return model.to(device)


class Clamped:
    """The bench's clamp of ``pred_acc`` to ±5: untrained weights would
    fling agents out of the banded kernel's density regime."""

    def __init__(self, model):
        self.model = model

    def parameters(self):
        return self.model.parameters()

    def __call__(self, pf, of, sf, rng=None):
        import torch

        out = self.model(pf, of, sf, rng)
        return out._replace(pred_acc=torch.clamp(out.pred_acc, -5.0, 5.0))


def dense_batch(device):
    """``bench_train_step_denseN``'s batch: C windows of N live agents
    uniform over 200 m drifting at their initial velocity, 64 obstacles,
    frame-0 features from the channel-batched feature pass."""
    import torch

    from piml_tpu_torch.data import ChanneledData
    from piml_tpu_torch.physics import (NeighborConfig, heading_direction,
                                        relative_features)

    C, T, n = TRAIN_CHANNELS, TRAIN_FRAMES, N_AGENTS
    g = torch.Generator().manual_seed(11)
    pos0 = (torch.rand((C, n, 2), generator=g) * 200.0).to(device)
    vel0 = torch.randn((C, n, 2), generator=g).to(device)
    wp = (torch.rand((1, n, 2), generator=g) * 200.0).to(device)
    obstacles = (torch.rand((TRAIN_OBSTACLES, 2), generator=g)
                 * 200.0).to(device)
    acc0 = torch.zeros_like(pos0)
    dest0 = wp[0].expand(C, n, 2)
    ds = torch.full((n,), 1.34, device=device)
    with torch.no_grad():
        pf0, of0, df0 = relative_features(
            pos0, vel0, acc0, dest0, obstacles, NeighborConfig(),
            heading=heading_direction(vel0, time_axis=False), batched=True)
    sf0 = torch.cat([df0, vel0, acc0, ds[None, :, None].expand(C, n, 1)],
                    dim=-1)

    def tile_t(x):
        return x[:, None].expand((C, T) + x.shape[1:])

    drift = torch.arange(T, device=device, dtype=torch.float32) * 0.08
    pos = pos0[:, None] + vel0[:, None] * drift[None, :, None, None]
    ones = torch.ones((C, T, n), device=device)
    labels = torch.cat([pos, tile_t(vel0), tile_t(acc0),
                        torch.zeros((C, T, n, 1), device=device)], dim=-1)
    return ChanneledData(
        ped_features=tile_t(pf0), obs_features=tile_t(of0),
        self_features=tile_t(sf0), labels=labels, mask_p=ones, mask_v=ones,
        mask_a=ones, mask_p_pred=ones, mask_v_pred=ones, mask_a_pred=ones,
        position=pos, velocity=tile_t(vel0), acceleration=tile_t(acc0),
        destination=tile_t(dest0),
        dest_idx=torch.zeros((C, T, n), dtype=torch.int32, device=device),
        abnormal_mask=torch.ones(n, device=device),
        dest_num=torch.ones(n, dtype=torch.int32, device=device),
        waypoints=wp, obstacles=obstacles, desired_speed=ds,
        meta_data={"time_unit": 0.08})


def loss_and_grads(model, cfg, batch, fn=None):
    """One forward and backward of the training loss: ``(loss terms,
    {name: gradient})``."""
    from piml_tpu_torch.engine import training_rollout_loss

    model.zero_grad(set_to_none=True)
    out = training_rollout_loss(fn or model, cfg, batch)
    out.loss.backward()
    return ({k: float(v.detach()) for k, v in out._asdict().items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def grad_rel_l2(got, ref):
    """Relative L2 distance of two gradient dicts: over all parameters
    together, and the worst single tensor."""
    num = sum(float(((got[k].cpu() - ref[k].cpu()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].cpu() ** 2).sum()) for k in ref)
    worst = max(float((got[k].cpu() - ref[k].cpu()).norm())
                / max(float(ref[k].cpu().norm()), 1e-30) for k in ref)
    return math.sqrt(num / max(den, 1e-30)), worst


def stress_rollout(model, sc, ncfg, frames, mesh=None):
    """Initial features, then ``frames`` closed-loop steps; returns the
    recorded outputs and the wall seconds of the loop.  ``mesh``: the pair
    pass agent-sharded over its ``"ap"`` axis (``shard_agents``)."""
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
                        retire_on_arrival=True,
                        shard_agents=mesh is not None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = rollout(model, ecfg, state, spawns, sc["wp"],
                      torch.ones(n, dtype=torch.int32, device=dev),
                      sc["obstacles"], sc["ds"], mesh=mesh)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def dense_metrics(dev, n_agents):
    """Phase 12: OT and MMD at dense N (``bench.py:617``
    ``bench_dense_metrics``): ``OT_FRAMES`` frames of ``n_agents`` agents
    uniform over 200 m × 200 m, ``q = p + N(0, 0.5²)``, full masks."""
    import torch

    from piml_tpu_torch.metrics import (mmd_masked, mmd_masked_chunked,
                                        mmd_with_time_mask, ot_with_time_mask,
                                        sinkhorn_banded,
                                        sinkhorn_banded_or_dense,
                                        sinkhorn_masked_chunked)

    g = torch.Generator().manual_seed(SEED + 2)
    p = torch.rand((OT_FRAMES, n_agents, 2), generator=g) * 200.0
    q = p + 0.5 * torch.randn(p.shape, generator=g)
    far = torch.rand((n_agents, 2), generator=g) * 200.0 + 300.0
    p, q, far = p.to(dev), q.to(dev), far.to(dev)
    ones = torch.ones((OT_FRAMES, n_agents), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    iterations, costs = [], []
    for t in range(OT_FRAMES):
        cost, exact, its = sinkhorn_banded(p[t], q[t], ones[t], ones[t],
                                           with_iterations=True)
        dense = sinkhorn_masked_chunked(p[t], q[t], ones[t], ones[t])
        c, d = float(cost), float(dense)
        if not bool(exact):
            raise AssertionError(f"dense OT frame {t}: banded not exact")
        if abs(c - d) > 1e-4 * abs(d):
            raise AssertionError(f"dense OT frame {t}: banded {c} vs "
                                 f"streaming {d}")
        iterations.append(int(its))
        costs.append([c, d])
    _, far_exact = sinkhorn_banded(p[0], far, ones[0], ones[0])
    if bool(far_exact):
        raise AssertionError("far-cloud OT: the banded proof held")
    got = sinkhorn_banded_or_dense(p[0], far, ones[0], ones[0])
    assert_equal(got, sinkhorn_masked_chunked(p[0], far, ones[0], ones[0]),
                 "far-cloud OT fallback vs streaming")
    # MMD of q = p + noise is float32 rounding noise around 0, so the
    # subset is also held against the far cloud, where MMD is O(1)
    sub = slice(0, min(OT_MMD_SUBSET, n_agents))
    mmd_pairs = {}
    for name, target in (("near", q[0]), ("far", far)):
        mmd_args = (p[0, sub], target[sub], ones[0, sub], ones[0, sub])
        m_stream, m_dense = (float(mmd_masked_chunked(*mmd_args)),
                             float(mmd_masked(*mmd_args)))
        if abs(m_stream - m_dense) > 1e-4 * abs(m_dense) + 1e-6:
            raise AssertionError(f"MMD subset ({name}): streaming "
                                 f"{m_stream} vs dense {m_dense}")
        mmd_pairs[name] = [m_stream, m_dense]
    ot_ms = cuda_ms(lambda: ot_with_time_mask(p, q, ones, "sum"), 1)
    mmd_ms = cuda_ms(lambda: mmd_with_time_mask(p, q, ones, "sum"), 3)
    rec = dict(frames=OT_FRAMES, agents=n_agents,
               ot_ms_per_frame=ot_ms / OT_FRAMES,
               mmd_ms_per_frame=mmd_ms / OT_FRAMES,
               sinkhorn_iterations=iterations, banded_vs_streaming=costs,
               far_cloud_exact=False, far_cloud_fallback_bitwise=True,
               mmd_subset=mmd_pairs,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                   dev))
    say("dense_ot_mmd", **rec)
    return rec


def cut_cli_scenes(tmp):
    """The CLI pipeline's scenes (``CLI_SPLITS`` of the committed GC
    scenes) written with ``Scene.save``; returns the pretrain and finetune
    data configs."""
    from piml_tpu_torch.scene import Scene, crop

    configs = {}
    for name, file in (("pretrain", "gc_sf_repro.npy"),
                       ("finetune", "gc_mlapm_repro.npy")):
        src = Scene.load(os.path.join(ROOT, "repro_work", file),
                         device="cpu")
        lines = []
        for split, (a, b) in CLI_SPLITS.items():
            path = os.path.join(tmp, f"{name}_{split}.npy")
            crop(src, a, b).save(path)
            lines.append(f"{split}:\n  - {path}\n")
        configs[name] = os.path.join(tmp, f"{name}.yaml")
        with open(configs[name], "w") as f:
            f.write("".join(lines))
    return configs


def cli_pipeline(dev, tmp):
    """Phase 13: ``piml_tpu_torch.exp.main.run`` on scenes cut from the
    committed GC scenes (``CLI_SPLITS``) and written with ``Scene.save``:
    pretrain, test, finetune, test, all with resumable checkpoints; then a
    rerun with one more epoch, which resumes both loops at epoch
    ``CLI_EPOCHS``, against an uninterrupted pretrain of that many epochs
    plus one."""
    import io
    import re

    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.data import PointwiseDataset
    from piml_tpu_torch.exp.main import run
    from piml_tpu_torch.train.trainer import (MetricLogger, Trainer,
                                              checkpoint_path)

    configs = cut_cli_scenes(tmp)
    cfg = PIMLConfig(**CLI_CFG, epochs=CLI_EPOCHS, finetune_flag=True,
                     resume=True, data_config=configs["pretrain"],
                     ft_data_config=configs["finetune"],
                     save_dir=os.path.join(tmp, "ck"), exp_name="cli",
                     model_name_suffix="smoke")

    def logged(epochs, jsonl):
        stream = io.StringIO()
        logger = MetricLogger(jsonl_path=jsonl, stream=stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = run(cfg.replace(epochs=epochs), logger, device=dev)
        torch.cuda.synchronize()
        logger.close()
        with open(jsonl) as f:
            stamped = [json.loads(line) for line in f]
        return results, stamped, stream.getvalue(), time.perf_counter() - t0

    results, recs, text, wall = logged(CLI_EPOCHS,
                                       os.path.join(tmp, "run.jsonl"))
    rows = [int(x) for x in re.findall(r"train (\d+), valid (\d+)",
                                       text)[0]]
    pre = [r for r in recs if "acc_pred" in r]
    pre_val = [r for r in recs if "val_mse" in r and "val_coll" not in r]
    ft_val = [r for r in recs if "val_coll" in r]
    tests = [r for r in recs if "test_ot" in r]
    losses = [v for r in recs for k, v in r.items() if "loss" in k]
    if len(pre) != CLI_EPOCHS or len(ft_val) != CLI_EPOCHS + 1 \
            or len(tests) != 2:
        raise AssertionError(f"CLI: {len(pre)} pretrain epochs, "
                             f"{len(ft_val)} validations, {len(tests)} tests")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"CLI: losses {losses}")
    for r in tests:
        if not (math.isfinite(r["test_ot"]) and math.isfinite(r["test_mmd"])):
            raise AssertionError(f"CLI: test OT / MMD {r}")
    files = [checkpoint_path(cfg, False), checkpoint_path(cfg, True)]
    files += [os.path.join(f + "_resume", f"step_{CLI_EPOCHS - 1}.pt")
              for f in files]
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        raise AssertionError(f"CLI: checkpoints missing: {missing}")
    pre_s = [pre[0]["time"]] + [b["time"] - a["time"]
                                for a, b in zip(pre, pre[1:])]
    ft_s = [b["ts"] - a["ts"] for a, b in zip(ft_val, ft_val[1:])]
    last_pre = pre_val[-1]["ts"]
    rec = dict(
        scenes={k: v for k, v in CLI_SPLITS.items()},
        train_rows=rows[0], valid_rows=rows[1], wall_s=wall,
        pretrain_s_per_epoch=pre_s,
        pretrain_rows_per_s=[rows[0] / s for s in pre_s],
        finetune_s_per_epoch=ft_s,
        test_eval_s=[tests[0]["ts"] - last_pre,
                     tests[1]["ts"] - ft_val[-1]["ts"]],
        pretrain_val=[r["val_loss"] for r in pre_val],
        finetune_val=[r["val_loss"] for r in ft_val],
        test=[{k: r[k] for k in ("test_mae", "test_ot", "test_mmd",
                                 "test_coll")} for r in tests],
        results=results)

    # resume: one more epoch, from the checkpoints of the run above
    _, again, _, again_wall = logged(CLI_EPOCHS + 1,
                                     os.path.join(tmp, "again.jsonl"))
    resumed = [r for r in again if "epoch" in r and "acc_pred" in r
               or "val_mse" in r and "val_coll" not in r]
    ft_epochs = [r["epoch"] for r in again if "coll_loss" in r]
    if [r["epoch"] for r in resumed] != [CLI_EPOCHS] * 2 \
            or ft_epochs != [CLI_EPOCHS]:
        raise AssertionError(f"CLI resume: pretrain records {resumed}, "
                             f"finetune epochs {ft_epochs}")
    whole_cfg = cfg.replace(epochs=CLI_EPOCHS + 1, resume=False,
                            save_dir=os.path.join(tmp, "whole"))
    synthetic = PointwiseDataset(device=dev)
    synthetic.load_data(cfg.data_config)
    whole_cfg = synthetic.build_dataset(whole_cfg)
    whole_log = MetricLogger(stream=io.StringIO())
    Trainer(whole_cfg, whole_log).train_pointwise(synthetic.train_data,
                                                  synthetic.valid_data)
    whole = [r for r in whole_log.records if r.get("epoch") == CLI_EPOCHS]

    def strip(r):
        return {k: v for k, v in r.items() if k not in ("time", "ts")}

    if [strip(r) for r in resumed] != [strip(r) for r in whole]:
        raise AssertionError(f"CLI resume: {resumed} vs uninterrupted "
                             f"{whole}")
    rec.update(resume_wall_s=again_wall, resumed_epoch=CLI_EPOCHS,
               resumed_equals_uninterrupted=True,
               resumed_records=[strip(r) for r in resumed])
    say("cli_pipeline", **rec)
    return rec


GC_FIXTURE = os.path.join(ROOT, "piml_tpu_torch", "fixtures",
                          "gc_window_jax.npz")
# the GC window is held to three times the JAX package's own spread under
# 1e-4 m moves of the scene (tests/test_torch_engine.py gives the numbers)
SPREAD_FACTOR = 3


def gc_window_vs_fixture(model, cfg, data, metrics, scene_path):
    """Phase 7's whole 750-frame window against the JAX package's numbers
    (``piml_tpu_torch/fixtures/gc_window_jax.npz``, written by
    ``tools/make_gc_window_fixture.py``): each metric's relative gap within
    ``SPREAD_FACTOR`` times the JAX package's own largest deviation under
    1e-4 m moves of the scene's positions, the median position gap at each
    recorded frame likewise, and the first recorded frame (60) within
    1e-3 m for every agent (the CPU path is within 1e-4 m there,
    ``tests/test_torch_engine.py``; the card's matmuls round in their own
    order)."""
    import hashlib

    import numpy as np

    from piml_tpu_torch.engine import engine_config, eval_rollout

    fx = np.load(GC_FIXTURE)
    with open(scene_path, "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != str(fx["scene_sha256"]):
            raise AssertionError("GC fixture: the scene file changed")
    gaps, limits = {}, {}
    for name, ref, spread in zip(fx["metric_names"], fx["metrics"],
                                 fx["spread"]):
        name = str(name)
        gaps[name] = abs(getattr(metrics, name) - ref) / abs(ref)
        limits[name] = SPREAD_FACTOR * float(spread)
    res = eval_rollout(model, engine_config(cfg, retire=True,
                                            track_collisions=False,
                                            track_labels=False),
                       data, cfg.skip_frames)
    frames = {}
    for i, frame in enumerate(fx["frames"].tolist()):
        pos = res.position[frame].cpu().numpy()
        ref = fx["position"][i]
        both = np.isfinite(pos).all(-1) & np.isfinite(ref).all(-1)
        dist = np.linalg.norm(pos[both] - ref[both], axis=-1)
        frames[frame] = dict(
            median_m=float(np.median(dist)), max_m=float(dist.max()),
            limit_median_m=SPREAD_FACTOR * float(fx["spread_median"][i]),
            agents=int(both.sum()),
            masks_equal=bool((res.mask_p[frame].cpu().numpy()
                              == fx["mask"][i]).all()))
    say("gc_window_vs_jax_fixture", relative_gaps=gaps, limits=limits,
        positions=frames, spread_factor=SPREAD_FACTOR)
    bad = [k for k in gaps if not gaps[k] <= limits[k]]
    bad += [f for f, r in frames.items()
            if not r["median_m"] <= r["limit_median_m"]]
    first = frames[int(fx["frames"][0])]
    if bad or not first["max_m"] <= 1e-3 or not first["masks_equal"]:
        raise AssertionError(f"GC window vs the JAX fixture: {bad}, first "
                             f"frame {first}")


# what a v2.2 file carries; the decoder re-derives the waypoint table,
# dest_num and dest_idx from the destination track
SCENE_FIELDS = ("position", "velocity", "acceleration", "destination",
                "obstacles", "mask_p", "mask_v", "mask_a")


def generate_gc(dev, tmp):
    """Phase 14a: the GC scenario with both engines at the reference's
    size, saved and reloaded; a 20-frame prefix of each held to the CPU
    path on the same schedule.  Returns the scenes' paths."""
    import torch

    from piml_tpu_torch.gen import (SCENARIOS, SFParams, simulate,
                                    simulate_mlapm, to_scene)
    from piml_tpu_torch.models import MLAPMParams
    from piml_tpu_torch.scene import Scene

    engines = {
        "socialforce": lambda sched, obs, frames, device: simulate(
            SFParams(), sched, obs, frames, device=device),
        "mlapm": lambda sched, obs, frames, device: simulate_mlapm(
            MLAPMParams.gc_paper(), sched, frames, device=device),
    }
    paths = {}
    for engine, run in engines.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        sched, obs = SCENARIOS["GC"](GEN_FRAMES, seed=GEN_SEED, device=dev)
        t1 = time.perf_counter()
        ps, _, act = run(sched, obs, GEN_FRAMES, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scene = to_scene(SFParams(), sched, obs, ps, act, device=dev,
                         meta={"source": f"chip_smoke {engine} GC",
                               "seed": GEN_SEED})
        t3 = time.perf_counter()
        paths[engine] = os.path.join(tmp, f"gc_{engine}.npy")
        scene.save(paths[engine])
        back = Scene.load(paths[engine], device=dev)
        t4 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(dev) - base
        live = ps[act == 1]
        if not torch.isfinite(live).all():
            raise AssertionError(f"GC {engine}: non-finite active positions")
        for key in SCENE_FIELDS:
            if not torch.equal(torch.nan_to_num(getattr(back, key), 7.0),
                               torch.nan_to_num(getattr(scene, key), 7.0)):
                raise AssertionError(f"GC {engine}: reloaded {key} differs")
        # the same schedule's first frames on the CPU (the path the tests
        # hold to the JAX package); the run is causal, so its prefix is a
        # run of its own
        ps_c, _, act_c = run(sched.to("cpu"), obs, GEN_PREFIX, "cpu")
        gap = float((ps[:GEN_PREFIX].cpu() - ps_c).abs().nan_to_num().max())
        if not (torch.equal(act[:GEN_PREFIX].cpu(), act_c) and gap <= 1e-4
                and torch.equal(ps[:GEN_PREFIX].isnan().cpu(), ps_c.isnan())):
            raise AssertionError(f"GC {engine}: the card's first "
                                 f"{GEN_PREFIX} frames differ from the "
                                 f"CPU's (max |dp| {gap})")
        say("generate_gc", engine=engine, frames=GEN_FRAMES, seed=GEN_SEED,
            slots=int(sched.position.shape[0]),
            agents=scene.num_pedestrians,
            obstacles=int(scene.obstacles.shape[0]),
            schedule_s=t1 - t0, simulate_s=t2 - t1, to_scene_s=t3 - t2,
            save_load_s=t4 - t3, s_per_scene=t4 - t0,
            frames_per_s=GEN_FRAMES / (t2 - t1),
            peak_bytes_above_earlier_phases=peak,
            active_agent_frames=int(act.sum()),
            prefix_frames=GEN_PREFIX, prefix_max_abs_dp_m=gap,
            prefix_masks_equal=True, reload_equal=True)
    return paths


def _angles_close(got, ref, cols):
    """Angles to atol 1e-4, but for sign flips of vectors collinear with
    their base (|θ| at the acos clamp and one side 0 or of the other's
    magnitude); returns the count of such flips."""
    import numpy as np

    g, r = got[:, cols], ref[:, cols]
    bad = np.abs(g - r) > 1e-4
    mag = np.maximum(np.abs(g), np.abs(r))
    at_clamp = np.minimum(mag, np.pi - mag) < 2e-3
    flip = at_clamp & ((g == 0) | (r == 0) | (np.abs(np.abs(g) - mag) < 1e-4))
    if (bad & ~flip).any():
        raise AssertionError(f"angles differ: {g[bad & ~flip][:5]} vs "
                             f"{r[bad & ~flip][:5]}")
    return int((bad & flip).sum())


def _values_close(got, ref, what, angle_cols=()):
    import numpy as np

    if got.shape != ref.shape:
        raise AssertionError(f"{what}: kept rows {got.shape} vs {ref.shape}")
    other = [c for c in range(got.shape[1]) if c not in angle_cols]
    if not np.allclose(got[:, other], ref[:, other], rtol=1e-4, atol=1e-6):
        raise AssertionError(f"{what}: card and CPU differ (max |diff| "
                             f"{np.abs(got[:, other] - ref[:, other]).max()})")
    return _angles_close(got, ref, list(angle_cols)) if angle_cols else 0


def discovery_loop(dev, tmp, scene_path):
    """Phase 14b: the closed loop on frame ranges of the generated
    social-force GC scene, then both extractions on the card against the
    CPU."""
    import io

    import numpy as np
    import torch
    import yaml

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.data import PointwiseData, PointwiseDataset
    from piml_tpu_torch.exp import iterate
    from piml_tpu_torch.models import ModelSpec, build_model
    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.scene import Scene, crop
    from piml_tpu_torch.sr import (prepare_symbolic_regression_data,
                                   prepare_vector_regression_data)
    from piml_tpu_torch.train.trainer import (MetricLogger, checkpoint_path,
                                              load_params)

    src = Scene.load(scene_path, device="cpu")
    config = os.path.join(tmp, "loop.yaml")
    with open(config, "w") as f:
        for split, (a, b) in LOOP_SPLITS.items():
            path = os.path.join(tmp, f"loop_{split}.npy")
            crop(src, a, b).save(path)
            f.write(f"{split}:\n  - {path}\n")
    work = os.path.join(tmp, "loop")
    os.makedirs(work)
    cfg = PIMLConfig(**LOOP_CFG, epochs=LOOP_EPOCHS,
                     save_dir=os.path.join(work, "ck"), exp_name="loop",
                     model_name_suffix="smoke")
    flags = []
    run_iteration = iterate.run_iteration

    def spy(cfg_it, *args, **kw):
        flags.append(cfg_it.iter_flag)
        return run_iteration(cfg_it, *args, **kw)

    logger = MetricLogger(stream=io.StringIO())
    pairwise.KERNEL.launches = 0
    banded.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(iterate, "run_iteration", spy):
        results = iterate.piml_loop(
            cfg, config, iterations=2, logger=logger, regen_scenario="GC",
            regen_frames=GEN_FRAMES, work_dir=work, vector_fit=True,
            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k1=pairwise.KERNEL.launches, k2=banded.KERNEL.launches)

    fits = [{k: v for k, v in dataclasses.asdict(r).items()
             if k.startswith(("fit_", "vec_"))} for r in results]
    if flags != [False, True]:
        raise AssertionError(f"loop: iter_flag per iteration {flags}")
    if not all(v is not None and math.isfinite(v)
               for fit in fits for v in fit.values()):
        raise AssertionError(f"loop: fits {fits}")
    regen = [r for r in logger.records if "regen_s" in r]
    with open(regen[0]["regenerated"]) as f:
        written = yaml.safe_load(f)
    if set(written) != {"train", "valid"}:
        raise AssertionError(f"loop: regenerated data config {written}")
    # a scene file ends at its last agent's last frame
    regen_scenes = [Scene.load(os.path.join(work, f"regen_iter0_{s}.npy"),
                               device=dev) for s in ("train", "valid")]
    regen_shapes = [[s.num_steps, s.num_pedestrians] for s in regen_scenes]
    if any(not (1 < t <= GEN_FRAMES and n >= 1) for t, n in regen_shapes):
        raise AssertionError(f"loop: regenerated scenes {regen_shapes}")

    # per iteration: pretrain s/epoch, extraction and fit records
    per_it, cur = [], []
    for r in logger.records:
        cur.append(r)
        if "iteration" in r:
            per_it.append(cur)
            cur = []
    iters = []
    for recs in per_it:
        times = [r["time"] for r in recs if "train_loss" in r]
        ext = [r for r in recs if "extract_edges" in r][0]
        iters.append(dict(
            pretrain_s_per_epoch=[times[0]] + [b - a for a, b in
                                               zip(times, times[1:])],
            extract_edges=ext["extract_edges"],
            vector_edges=ext["vector_edges"], extract_s=ext["extract_s"],
            edges_per_s=ext["extract_edges"] / ext["extract_s"],
            fit_s=ext["fit_s"]))

    # both extractions of iteration 1's parameters, card against CPU
    ds = PointwiseDataset(device=dev)
    ds.load_data(config)
    cfg1 = ds.build_dataset(cfg.replace(
        model_name_suffix=f"{cfg.model_name_suffix}_iter1"))
    model = build_model(ModelSpec.from_config(cfg1))
    model.load_state_dict(load_params(checkpoint_path(cfg1, False)))
    rows = PointwiseData(
        ped_features=ds.train_data.ped_features[:EXTRACT_ROWS],
        obs_features=ds.train_data.obs_features[:EXTRACT_ROWS],
        self_features=ds.train_data.self_features[:EXTRACT_ROWS],
        labels=ds.train_data.labels[:EXTRACT_ROWS],
        meta_data=ds.train_data.meta_data)
    rows_cpu = PointwiseData(**{k: (v.cpu() if torch.is_tensor(v) else v)
                                for k, v in vars(rows).items()})
    gpu = (prepare_symbolic_regression_data(model.to(dev), rows),
           prepare_vector_regression_data(model, rows))
    cpu = (prepare_symbolic_regression_data(model.cpu(), rows_cpu),
           prepare_vector_regression_data(model, rows_cpu))
    flips = _values_close(gpu[0][0], cpu[0][0], "SR features", (1, 3, 4))
    flips += _values_close(gpu[0][1], cpu[0][1], "SR labels", (1,))
    for g, c, what in zip(gpu[1], cpu[1], ("dr", "dv", "F")):
        _values_close(g, c, f"vector {what}")
    say("discovery_loop", iterations=2, epochs=LOOP_EPOCHS,
        splits={k: list(v) for k, v in LOOP_SPLITS.items()},
        widths=[cfg.encoder_hidden_size, cfg.processor_hidden_layers,
                cfg.decoder_hidden_size],
        wall_s=wall, iter0_train_rows=len(ds.train_data),
        per_iteration=iters, fits=fits,
        val_loss=[r.val_loss for r in results], iter_flags=flags,
        regen_s=regen[0]["regen_s"], regen_frames=GEN_FRAMES,
        regen_scenes_frames_agents=regen_shapes,
        regen_config=sorted(written), kernel_launches=launches,
        extract_check_rows=len(rows), extract_check_edges=len(gpu[0][0]),
        extract_check_vector_edges=len(gpu[1][0]),
        extract_card_vs_cpu="same kept rows, rtol 1e-4, angles atol 1e-4",
        collinear_angle_flips=flips,
        extract_max_abs_label_diff=float(np.abs(gpu[0][1][:, 0]
                                                - cpu[0][1][:, 0]).max()))


def outputs_gap(got, ref, what):
    """The largest |card − CPU| over a ``ModelOutput``'s fields; raises
    unless the same fields are None, every output is float32 with the same
    non-finite entries, and the rest agree to rtol 1e-4 / atol 1e-5."""
    import torch

    worst = 0.0
    for field in ref._fields:
        g, r = getattr(got, field), getattr(ref, field)
        if (g is None) != (r is None):
            raise AssertionError(f"{what} {field}: None on one side only")
        if r is None:
            continue
        g = g.cpu()
        fin = torch.isfinite(r)
        err = max_abs_err(g, r)
        if g.dtype != torch.float32 or not (
                math.isfinite(err)
                and torch.allclose(g[fin], r[fin], rtol=1e-4, atol=1e-5)):
            raise AssertionError(f"{what} {field}: card vs CPU max |diff| "
                                 f"{err} ({g.dtype})")
        worst = max(worst, err)
    return worst


def zoo_forwards(dev, data):
    """Phase 15a: every registry name and both finetune swaps, seeded, at
    the paper's widths, on ``ZOO_ROWS`` pointwise rows of the GC window:
    the card against the CPU; then ``pinnsf_m`` and ``pinnsf_bm`` with
    ``compute_dtype="bfloat16"`` on the card against the CPU's float32
    forward (``0.03 · max(|pred_acc|, 1)``, the bound of the JAX
    package's bfloat16 test), and both forwards' milliseconds."""
    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.data import to_pointwise
    from piml_tpu_torch.models import (ModelSpec, build_finetune_model,
                                       build_model)

    rows = to_pointwise(data)
    pick = torch.linspace(0, len(rows) - 1, ZOO_ROWS).long().to(dev)
    args = [rows.ped_features[pick], rows.obs_features[pick],
            rows.self_features[pick]]
    args_cpu = [a.cpu() for a in args]
    gaps, kept = {}, {}
    for name, finetune in ([(n, False) for n in ZOO_NAMES]
                           + [("base", True), ("pinnsf_res", True)]):
        spec = ModelSpec.from_config(PIMLConfig(
            model=name, dataset_name="gc2344", dropout=0.0))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            model = (build_finetune_model if finetune else build_model)(
                spec).eval()
        label = f"{name} (finetune)" if finetune else name
        with torch.no_grad():
            ref = model(*args_cpu)
            got = model.to(dev)(*args)
        torch.cuda.synchronize()
        gaps[label] = outputs_gap(got, ref, f"zoo {label}")
        if name in ("pinnsf_m", "pinnsf_bm") and not finetune:
            kept[name] = (spec, model, ref)
    bf16 = {}
    for name, (spec, model, ref) in kept.items():
        m16 = build_model(dataclasses.replace(spec, compute_dtype="bfloat16"))
        m16.load_state_dict(model.state_dict())
        m16 = m16.to(dev).eval()
        with torch.no_grad():
            out = m16(*args)
            ms32 = cuda_ms(lambda: model(*args), 10)
            ms16 = cuda_ms(lambda: m16(*args), 10)
        if any(x is not None and x.dtype != torch.float32 for x in out):
            raise AssertionError(f"bf16 {name}: outputs "
                                 f"{[None if x is None else x.dtype for x in out]}")
        scale = max(float(ref.pred_acc.abs().max()), 1.0)
        gap = max_abs_err(out.pred_acc.cpu(), ref.pred_acc)
        if not gap <= 0.03 * scale:
            raise AssertionError(f"bf16 {name}: pred_acc {gap} from the "
                                 f"float32 forward (scale {scale})")
        bf16[name] = dict(max_abs_gap_to_f32=gap, scale=scale,
                          gap_share_of_scale=gap / scale, forward_ms_f32=ms32,
                          forward_ms_bf16=ms16)
    say("zoo_forwards", rows=ZOO_ROWS, models=len(gaps),
        card_vs_cpu="rtol 1e-4, atol 1e-5", max_abs_err=gaps, bf16=bf16)


def zoo_pipeline(dev, tmp):
    """Phase 15b: ``exp.main.run`` on the CLI pipeline's scenes with
    ``pinnsf_m`` (``ZOO_EPOCHS``, finetune), ``pinnsf_res`` (1 epoch,
    finetune: the corrector swap and its two Adam groups, both of which
    must step) and ``base`` (1 epoch, no finetune).  Finite losses and
    test OT / MMD, checkpoints on disk.  Returns the ``pinnsf_m`` config
    and its pretrained weights."""
    import io

    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.exp.main import run
    from piml_tpu_torch.train import trainer as trainer_mod
    from piml_tpu_torch.train.trainer import (MetricLogger, checkpoint_path,
                                              load_params)

    configs = cut_cli_scenes(tmp)
    out = {}
    for label, kw, epochs, finetune in (
            ("pinnsf_m", M_CFG, ZOO_EPOCHS, True),
            ("pinnsf_res", dict(M_CFG, model="pinnsf_res", ft_lr_decay2=1.0),
             1, True),
            ("base", BASE_CFG, 1, False)):
        cfg = PIMLConfig(**kw, epochs=epochs, finetune_flag=finetune,
                         data_config=configs["pretrain"],
                         ft_data_config=configs["finetune"],
                         save_dir=os.path.join(tmp, label), exp_name="zoo",
                         model_name_suffix=label)
        jsonl = os.path.join(tmp, f"{label}.jsonl")
        logger = MetricLogger(jsonl_path=jsonl, stream=io.StringIO())
        optimizers = []
        make_optimizer = trainer_mod.make_optimizer

        def spy(*a, **k):
            optimizers.append(make_optimizer(*a, **k))
            return optimizers[-1]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(trainer_mod, "make_optimizer", spy):
            results = run(cfg, logger, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logger.close()
        with open(jsonl) as f:
            recs = [json.loads(line) for line in f]
        pre = [r for r in recs if "acc_pred" in r]
        ft_val = [r for r in recs if "val_coll" in r]
        tests = [r for r in recs if "test_ot" in r]
        losses = [v for r in recs for k, v in r.items() if "loss" in k]
        if (len(pre) != epochs or len(tests) != 1 + finetune
                or finetune and len(ft_val) != epochs + 1):
            raise AssertionError(f"zoo {label}: {len(pre)} pretrain epochs, "
                                 f"{len(ft_val)} validations, {len(tests)} "
                                 "tests")
        if not all(math.isfinite(v) for v in losses) or not all(
                math.isfinite(r["test_ot"]) and math.isfinite(r["test_mmd"])
                for r in tests):
            raise AssertionError(f"zoo {label}: losses {losses}, tests "
                                 f"{tests}")
        files = [checkpoint_path(cfg, False)] + (
            [checkpoint_path(cfg, True)] if finetune else [])
        missing = [f for f in files if not os.path.isfile(f)]
        if missing:
            raise AssertionError(f"zoo {label}: checkpoints missing: "
                                 f"{missing}")
        rec = dict(epochs=epochs, finetune=finetune, wall_s=wall,
                   pretrain_s_per_epoch=[pre[0]["time"]] + [
                       b["time"] - a["time"] for a, b in zip(pre, pre[1:])],
                   finetune_s_per_epoch=[b["ts"] - a["ts"] for a, b in
                                         zip(ft_val, ft_val[1:])],
                   pretrain_val=[r["val_loss"] for r in recs
                                 if "val_mse" in r and "val_coll" not in r],
                   finetune_val=[r["val_loss"] for r in ft_val],
                   test=[{k: r[k] for k in ("test_mae", "test_ot",
                                            "test_mmd", "test_coll")}
                         for r in tests], results=results)
        if label == "pinnsf_res":
            groups = optimizers[-1].param_groups
            stepped = [all(int(optimizers[-1].state[p]["step"]) > 0
                           for p in g["params"]) for g in groups]
            if len(groups) != 2 or not all(stepped):
                raise AssertionError(f"zoo pinnsf_res: {len(groups)} "
                                     f"groups, stepped {stepped}")
            rec["finetune_groups"] = [dict(lr=g["lr"],
                                           weight_decay=g["weight_decay"],
                                           tensors=len(g["params"]))
                                      for g in groups]
        out[label] = rec
        if label == "pinnsf_m":
            m_cfg = cfg
            m_weights = load_params(checkpoint_path(cfg, False))
    say("zoo_pipeline", scenes={k: list(v) for k, v in CLI_SPLITS.items()},
        **out)
    return m_cfg, m_weights


def zoo_stress(dev, sc, ncfg, cfg, weights):
    """Phase 15c: the dense stress with the ``pinnsf_m`` weights of phase
    15b: a warm-up, then ``ZOO_STRESS_FRAMES`` frames (the main path,
    counted); 5 frames through the kernels and the plain versions, bitwise
    equal; then the same frames with ``compute_dtype="bfloat16"``
    (counted apart) and its largest position gap to the float32 run after
    5 frames.  Returns the main path's launch counts."""
    import torch

    from piml_tpu_torch.models import ModelSpec, build_model
    from piml_tpu_torch.ops import banded, pairwise

    def loaded(spec):
        model = build_model(spec)
        model.load_state_dict(weights)
        return model.to(dev).eval()

    def counted(model):
        pairwise.KERNEL.launches = 0
        banded.KERNEL.launches = 0
        banded.KERNEL.fallbacks = 0
        stress_rollout(model, sc, ncfg, WARMUP_FRAMES)
        outs, wall = stress_rollout(model, sc, ncfg, ZOO_STRESS_FRAMES)
        counts = dict(k1=pairwise.KERNEL.launches, k2=banded.KERNEL.launches,
                      k2_fallbacks=banded.KERNEL.fallbacks)
        if not torch.isfinite(outs.p[outs.mask == 1]).all():
            raise AssertionError("pinnsf_m dense stress: non-finite live "
                                 "positions")
        if counts["k2"] == 0:
            raise AssertionError("pinnsf_m dense stress: K2 never launched")
        return outs, wall, counts

    spec = ModelSpec.from_config(cfg)
    model = loaded(spec)
    outs, wall, counts = counted(model)
    short, _ = stress_rollout(model, sc, ncfg, 5)
    with plain_route():
        short_ref, _ = stress_rollout(model, sc, ncfg, 5)
    assert_equal(short.p, short_ref.p, "pinnsf_m 5-frame rollout positions")
    outs16, wall16, counts16 = counted(
        loaded(dataclasses.replace(spec, compute_dtype="bfloat16")))
    gap5 = max_abs_err(outs16.p[5], outs.p[5])
    say("zoo_dense_stress", model="pinnsf_m", frames=ZOO_STRESS_FRAMES,
        agents=N_AGENTS, obstacles=N_OBSTACLES,
        ms_per_frame=wall / ZOO_STRESS_FRAMES * 1e3, **counts,
        live_final=int((outs.mask[-1] == 1).sum()),
        kernel_vs_plain_5_frames_bitwise=True,
        bf16=dict(ms_per_frame=wall16 / ZOO_STRESS_FRAMES * 1e3, **counts16,
                  max_abs_position_gap_after_5_frames_m=gap5))
    return counts


def zoo_dense_step(dev):
    """Phase 15d: the dense-N finetune step of phase 9 with a seeded
    ``pinnsf_m`` finetune model (``pred_acc`` clamped to ±5):
    ``ZOO_TRAIN_STEPS`` Adam steps whose feature passes launch the
    channel-batched K2 on every frame.  Returns the launch counts."""
    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.engine import training_rollout_loss
    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.train.trainer import make_optimizer

    cfg = PIMLConfig(**dict(TRAIN_CFG, model="pinnsf_m"),
                     ft_batch_size=TRAIN_CHANNELS)
    batch = dense_batch(dev)
    model = finetune_model(cfg, dev)
    clamped = Clamped(model)
    opt = make_optimizer(cfg, model, finetune=True)
    pairwise.KERNEL.launches = 0
    banded.KERNEL.launches = 0
    banded.KERNEL.fallbacks = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, step_losses = [], []
    for _ in range(ZOO_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = training_rollout_loss(clamped, cfg, batch)
        opt.zero_grad(set_to_none=True)
        out.loss.backward()
        opt.step()
        step_losses.append(out.loss.item())
        step_s.append(time.perf_counter() - t0)
    counts = dict(k1=pairwise.KERNEL.launches, k2=banded.KERNEL.launches,
                  k2_fallbacks=banded.KERNEL.fallbacks)
    say("zoo_dense_finetune_step", model="pinnsf_m", channels=TRAIN_CHANNELS,
        frames=TRAIN_FRAMES, agents=N_AGENTS, s_per_step=step_s,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
        losses=step_losses, **counts)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError(f"pinnsf_m dense finetune: losses {step_losses}")
    if counts["k2"] < ZOO_TRAIN_STEPS * TRAIN_FRAMES:
        raise AssertionError("pinnsf_m dense finetune: K2 was not launched "
                             f"on every frame ({counts['k2']} launches)")
    return counts


# the data and experiment layers (phase 16): the 150-frame scenes of
# phase 13's cut, the staged runner's epochs and the grid's two entries
STAGED_EPOCHS = 2
GRID_LEARNING_RATES = [2e-4, 1e-4]
# the one-chip scale ceiling (phase 17): tools/rollout_scaling.py:29-60
SCALE_AGENTS = 1_048_576
SCALE_FRAMES = 3
SCALE_TILES = 16            # tiles of the half-grid pass held to its plain
SCALE_SAMPLE_ROWS = 4096    # rows of the half-grid selection held to K1


def rows_gap(got, ref, what):
    """Pointwise rows built on the card against the same rows built on the
    CPU: the same count; self features and labels to rtol 1e-4 / atol
    1e-5; neighbour and obstacle features by each row's sum over its slots
    (unchanged when tied neighbours trade places) to atol 1e-4.  Rows
    outside that (a neighbour that ties with the k-th one, or sits at the
    distance threshold, kept on one side only) are counted; at most 0.5 %
    may differ.  Returns that count."""
    import torch

    if len(got) != len(ref) or len(ref) == 0:
        raise AssertionError(f"{what}: {len(got)} rows vs {len(ref)}")
    for key in ("self_features", "labels"):
        if not torch.allclose(getattr(got, key).cpu(), getattr(ref, key),
                              rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{what} {key}: card vs CPU")
    tied = torch.zeros(len(ref), dtype=torch.bool)
    for key in ("ped_features", "obs_features"):
        a = getattr(got, key).cpu().sum(dim=-2)
        b = getattr(ref, key).sum(dim=-2)
        tied |= ((a - b).abs() > 1e-4).any(dim=-1)
    if int(tied.sum()) > 0.005 * len(ref):
        raise AssertionError(f"{what}: {int(tied.sum())} of {len(ref)} rows "
                             "differ")
    return int(tied.sum())


def data_layers(dev, tmp):
    """Phase 16a: the split orchestrators and ``Scene`` padding on the card
    against the CPU, on the 150-frame scenes of phase 13's cut:
    ``RatioSplitDataset`` on one scene, ``SceneListSplitDataset`` on
    three, ``OnlyTrainingDataset`` with channeled validation windows
    (``finetune_flag``); row counts, test frames and the ratio split's
    frame indices equal, rows by ``rows_gap``; the padded scene bit for
    bit."""
    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.data import (OnlyTrainingDataset, RatioSplitDataset,
                                     SceneListSplitDataset,
                                     split_train_val_test)
    from piml_tpu_torch.scene import Scene

    configs = cut_cli_scenes(tmp)
    path = {f"{name}_{split}": os.path.join(tmp, f"{name}_{split}.npy")
            for name in ("pretrain", "finetune") for split in CLI_SPLITS}
    cfg = PIMLConfig(**CLI_CFG)
    only_yaml = os.path.join(tmp, "only.yaml")
    with open(only_yaml, "w") as f:
        f.write(f"train:\n  - {path['finetune_valid']}\n"
                f"valid:\n  - {path['pretrain_valid']}\n"
                f"test:\n  - {path['pretrain_test']}\n")
    cases = {
        "ratio": (RatioSplitDataset, path["pretrain_test"], cfg),
        "scene_list": (SceneListSplitDataset,
                       [path["pretrain_valid"], path["pretrain_test"],
                        path["finetune_test"]], cfg),
        "only_training": (OnlyTrainingDataset, only_yaml,
                          cfg.replace(finetune_flag=True)),
    }
    rec, cards = {}, {}
    for name, (cls, arg, c) in cases.items():
        built, secs = [], []
        for device in (dev, "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = cls(device=device)
            ds.load_data(arg)
            ds.build_dataset(c)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            built.append(ds)
        card, cpu = built
        cards[name] = card
        tied = {"train": rows_gap(card.train_data, cpu.train_data,
                                  f"{name} train")}
        if name == "only_training":
            windows = [(a.num_channels, b.num_channels)
                       for a, b in zip(card.valid_data, cpu.valid_data)]
            if not windows or any(a != b for a, b in windows):
                raise AssertionError(f"{name}: valid windows {windows}")
        else:
            tied["valid"] = rows_gap(card.valid_data, cpu.valid_data,
                                     f"{name} valid")
        frames = [t.num_frames for t in card.test_data]
        if frames != [t.num_frames for t in cpu.test_data] or not frames:
            raise AssertionError(f"{name}: test frames {frames}")
        for a, b in zip(card.test_data, cpu.test_data):
            if not torch.allclose(a.self_features.cpu(), b.self_features,
                                  rtol=1e-4, atol=1e-5):
                raise AssertionError(f"{name}: test views differ")
        rec[name] = dict(train_rows=len(card.train_data), test_frames=frames,
                         rows_with_tied_slots=tied, card_s=secs[0],
                         cpu_s=secs[1])
    ratio = cards["ratio"]
    n = ratio.scene.num_steps
    idx = split_train_val_test(n, cfg.train_ratio, cfg.val_ratio,
                               cfg.test_ratio, cfg.seed, shuffle=cfg.shuffle)
    if ratio.test_data[0].num_frames != len(idx[2]):
        raise AssertionError("ratio split: the test tail is not the split's")
    scene = Scene.load(path["pretrain_test"], device=dev)
    cpu_scene = Scene.load(path["pretrain_test"], device="cpu")
    for label, pad in (("pad_agents", lambda x: x.pad_agents(
            x.num_pedestrians + 29)), ("pad_time", lambda x: x.pad_time(
                x.num_steps + 17))):
        a, b = pad(scene), pad(cpu_scene)
        for key in SCENE_FIELDS + ("waypoints", "dest_idx", "dest_num"):
            if not torch.equal(torch.nan_to_num(getattr(a, key).cpu()),
                               torch.nan_to_num(getattr(b, key))):
                raise AssertionError(f"{label} {key}: card vs CPU")
        rec[label] = list(a.position.shape)
    rec["ratio_split_sizes"] = [len(x) for x in idx]
    say("data_layers", config=configs["pretrain"].rsplit(os.sep, 1)[-1],
        bitwise_padding=True, **rec)
    return configs


def staged_experiment(dev, tmp, configs):
    """Phase 16b: ``run_staged_experiment`` with phase 13's
    hyper-parameters (``pinnsf_bm`` at the paper's widths,
    ``STAGED_EPOCHS`` epochs) as three calls, ``pretrain`` → ``finetune``
    → ``evaluate``, on one state file, then one ``all`` call on another.
    The pretrain's numbers and the pretrained model's test metrics must be
    the same bit for bit, as phase 13's resumed rerun; the finetune's
    gradients gather neighbour rows by indexing, whose backward on CUDA
    accumulates in no fixed order, so the finetune's numbers are held to
    rtol 1e-4 (the CPU path's tolerance against the JAX package) and
    whether they came out bit for bit is printed."""
    import io
    import re

    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.exp.experiment import run_staged_experiment
    from piml_tpu_torch.train.trainer import MetricLogger

    base = PIMLConfig(**CLI_CFG, epochs=STAGED_EPOCHS, finetune_flag=True,
                      data_config=configs["pretrain"],
                      ft_data_config=configs["finetune"], exp_name="staged",
                      model_name_suffix="smoke")
    torch.cuda.reset_peak_memory_stats(dev)
    runs, walls, text = {}, {}, io.StringIO()
    for label, stages in (("staged", ("pretrain", "finetune", "evaluate")),
                          ("all", ("all",))):
        cfg = base.replace(save_dir=os.path.join(tmp, label))
        state = os.path.join(tmp, f"{label}.json")
        for stage in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label] = run_staged_experiment(
                cfg, stage, state, MetricLogger(stream=text), device=dev)
            torch.cuda.synchronize()
            walls[f"{label}_{stage}"] = time.perf_counter() - t0
    staged, whole = runs["staged"], runs["all"]
    if set(staged) != set(whole):
        raise AssertionError(f"staged {sorted(staged)} vs all "
                             f"{sorted(whole)}")
    exact = ("pretrain", "gt_test", "pretrain_test")
    bitwise, worst = {}, 0.0
    for section in exact + ("finetune", "finetune_test"):
        a, b = staged[section], whole[section]
        keys = [k for k in a if not k.endswith("wall_s")]
        bitwise[section] = all(a[k] == b[k] for k in keys)
        for k in keys:
            if not math.isfinite(a[k]):
                raise AssertionError(f"staged {section} {k}: {a[k]}")
            gap = abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
            if section not in exact:
                worst = max(worst, gap)
            if gap > (0.0 if section in exact else 1e-4):
                raise AssertionError(f"staged vs all {section} {k}: "
                                     f"{a[k]} vs {b[k]}")
    rows = int(re.findall(r"pretrain rows: train=(\d+)", text.getvalue())[0])
    pre_s = staged["pretrain"]["wall_s"]
    say("staged_experiment", epochs=STAGED_EPOCHS, stage_wall_s=walls,
        pretrain_rows=rows, pretrain_rows_per_s=rows * STAGED_EPOCHS / pre_s,
        finetune_wall_s=staged["finetune"]["wall_s"],
        bitwise_equal=bitwise, finetune_max_rel_gap=worst,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
        finetune_test=staged["finetune_test"],
        pretrain_test=staged["pretrain_test"])


def grid_sweep(dev, tmp, configs):
    """Phase 16c: ``exp.grid.yaml_to_grid_params`` expands a YAML of phase
    13's hyper-parameters with two learning rates into two commands of
    ``python3 -m piml_tpu_torch.exp.main`` (1 epoch, finetune on), and
    ``task_queue`` runs them in subprocesses: both must exit 0 and log
    their epochs."""
    import io

    import yaml

    from piml_tpu_torch.exp.grid import task_queue, yaml_to_grid_params

    jsonl = os.path.join(tmp, "grid.jsonl")
    spec = {k: v for k, v in CLI_CFG.items() if k != "learning_rate"}
    spec.update(epochs=1, finetune_flag=1, data_config=configs["pretrain"],
                ft_data_config=configs["finetune"],
                save_dir=os.path.join(tmp, "grid"), exp_name="grid",
                jsonl_log=jsonl, learning_rate=GRID_LEARNING_RATES)
    grid_yaml = os.path.join(tmp, "grid.yaml")
    with open(grid_yaml, "w") as f:
        yaml.safe_dump(spec, f)
    cmds = yaml_to_grid_params(grid_yaml)
    logs = [os.path.join(tmp, f"grid_{i}.log") for i in range(len(cmds))]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ok = task_queue([f"{c} > {log} 2>&1" for c, log in zip(cmds, logs)],
                        num_retries=1, interval=0.0, env=env)
    wall = time.perf_counter() - t0
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    pre = [r for r in recs if "acc_pred" in r]
    tests = [r for r in recs if "test_ot" in r]
    if ok != 1 or len(cmds) != 2 or len(pre) != 2 or len(tests) != 4:
        tails = []
        for log in logs:
            if os.path.exists(log):
                with open(log) as f:
                    tails.append(f.read()[-2000:])
        raise AssertionError(f"grid: task_queue gave {ok}, {len(cmds)} "
                             f"commands, {len(pre)} pretrain epochs, "
                             f"{len(tests)} tests; logs: {tails}")
    say("grid_sweep", commands=len(cmds), exit_ok=True, wall_s=wall,
        learning_rates=GRID_LEARNING_RATES,
        test_mae=[r["test_mae"] for r in tests])


def scale_ceiling(dev, model):
    """Phase 17: the one-chip scale ceiling (``tools/rollout_scaling.py``
    :29-60, ``bench.py:689``): ``SCALE_AGENTS`` agents uniform over
    ``200 · sqrt(N / 12,685)`` m, 4,096 obstacle points, the trained
    ``pinnsf_bm``, ``retire_on_arrival``, no contact counts;
    ``SCALE_FRAMES`` frames after one warm-up frame.  Past
    ``DENSE_COLUMN_CEILING`` the agent pass's fallback is the half-grid K2
    pass, so K1 must not launch for agents.  Then: the half-grid pass's
    kernel against its plain version on ``SCALE_TILES`` contiguous tiles
    (the plain version of all 8,192 tiles would build multi-GB
    ``(T, W)`` temporaries; it takes the tiles' window starts and rows, so
    it is the same function); its selection against K1 on the first
    ``SCALE_SAMPLE_ROWS`` agents over all columns (equal on every
    in-threshold slot where the pass is exact); and one frame through the
    old route, K1 as the fallback.  Returns the launch counts and the
    half-grid pass's record."""
    import torch

    from piml_tpu_torch.engine import (EngineConfig, SpawnFrame, init_state,
                                       rollout)
    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.physics import (NeighborConfig, features,
                                        heading_direction, relative_features)

    n = SCALE_AGENTS
    extent = 200.0 * math.sqrt(n / N_AGENTS)
    g = torch.Generator().manual_seed(SEED + 4)
    pos = (torch.rand((n, 2), generator=g) * extent).to(dev)
    vel = torch.randn((n, 2), generator=g).to(dev)
    wp = (torch.rand((1, n, 2), generator=g) * extent).to(dev)
    obstacles = (torch.rand((N_OBSTACLES, 2), generator=g) * extent).to(dev)
    acc = torch.zeros_like(pos)
    ds = torch.full((n, 1), 1.34, device=dev)
    ncfg = NeighborConfig()
    ecfg = EngineConfig(neighbor=ncfg, time_unit=0.08, lagged=True,
                        retire_on_arrival=True)
    heading = heading_direction(vel, time_axis=False)
    with torch.inference_mode():
        pf, of, df = relative_features(pos, vel, acc, wp[0], obstacles, ncfg)
    state = init_state(pos, vel, acc, wp[0],
                       torch.zeros(n, dtype=torch.int32, device=dev), pf, of,
                       torch.cat([df, vel, acc, ds], dim=-1))
    dest_num = torch.ones(n, dtype=torch.int32, device=dev)

    def frames(count):
        z2 = torch.zeros((count, n, 2), device=dev)
        spawns = SpawnFrame(
            new=torch.zeros((count, n), device=dev), p=z2, v=z2, a=z2,
            dest=z2, dest_idx=torch.zeros((count, n), dtype=torch.int32,
                                          device=dev), hist_v=z2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = rollout(model, ecfg, state, spawns, wp, dest_num,
                          obstacles, ds)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    frames(1)                                   # warm-up
    k = banded.KERNEL
    pairwise.KERNEL.launches = 0
    k.launches = k.fallbacks = k.wide_calls = k.wide_relaxed = 0
    torch.cuda.reset_peak_memory_stats(dev)
    outs, wall = frames(SCALE_FRAMES)
    counts = dict(k2=k.launches, k2_fallbacks=k.fallbacks,
                  wide_calls=k.wide_calls, wide_relaxed=k.wide_relaxed,
                  k1=pairwise.KERNEL.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    live = outs.mask == 1
    # every agent-pass fallback is a half-grid call, so the obstacle pass
    # fell back (k2_fallbacks - wide_calls) times, one K1 launch each
    k1_agents = counts["k1"] - (counts["k2_fallbacks"] - counts["wide_calls"])
    say("scale_ceiling", agents=n, extent_m=extent, obstacles=N_OBSTACLES,
        frames=SCALE_FRAMES, ms_per_frame=wall / SCALE_FRAMES * 1e3,
        max_memory_allocated_bytes=peak,
        per_frame={key: v / SCALE_FRAMES for key, v in counts.items()},
        k1_agent_launches=k1_agents, live_final=int(live[-1].sum()))
    if not torch.isfinite(outs.p[live]).all():
        raise AssertionError("scale ceiling: non-finite live positions")
    # the fine grid's windows overflow on a few tiles of this scene, so the
    # agent pass falls back to the half grid on every frame
    if counts["k2"] == 0 or counts["wide_calls"] == 0 or k1_agents != 0:
        raise AssertionError(f"scale ceiling: launches {counts}")

    # the half-grid pass: kernel against its plain version on a run of
    # tiles, its time beside its bound, its selection against K1
    args, (d_w, i_w) = banded_args(
        features._banded_wide_fallback, pos, heading, ncfg.topk_ped,
        ncfg.sight_angle_ped, ncfg.dist_threshold_ped)
    exact = k.wide_relaxed == counts["wide_relaxed"]
    # single-frame launches carry a channel axis of one
    ws, geo, rows = args[:3]
    t0 = ws.shape[-1] // 2
    t1 = t0 + SCALE_TILES
    rows_sl = slice(t0 * banded.TILE_N, t1 * banded.TILE_N)
    sub = (ws[:, t0:t1].contiguous(), geo,
           rows[:, rows_sl].contiguous()) + tuple(args[3:])
    full = banded.banded_topk_cuda(*args)
    part = banded.banded_topk_plain(*sub[:-1])
    torch.cuda.synchronize()
    assert_equal(full[0][:, rows_sl], part[0], "half-grid K2 dist")
    assert_equal(full[1][:, rows_sl], part[1], "half-grid K2 idx")
    ms = queued_ms(lambda: banded.banded_topk_cuda(*args), 10)
    ms_sub = queued_ms(lambda: banded.banded_topk_cuda(*sub), 10)
    plain_sub = queued_ms(lambda: banded.banded_topk_plain(*sub[:-1]), 2)
    # the plain version runs on the compared tiles only, so its time is
    # that run's, beside the kernel's on the same tiles
    bound = k2_bound(args)
    record = dict(ms=ms, **bound, share=bound["bound_ms"] / ms,
                  grid_dim=args[5], window=args[4], tiles=ws.shape[-1],
                  compared_tiles=[t0, t1], ms_compared_tiles=ms_sub,
                  plain_ms_compared_tiles=plain_sub, exact=exact,
                  max_abs_err=max_abs_err(full[0][:, rows_sl], part[0]))
    m = SCALE_SAMPLE_ROWS
    thr = pairwise.cos_threshold(ncfg.sight_angle_ped)
    k1_rows = pairwise.pack_rows(pos, heading)[:m].contiguous()
    d1, i1 = pairwise.pairwise_topk_cuda(k1_rows, pairwise.pack_cols(pos),
                                         ncfg.topk_ped, thr, True)
    torch.cuda.synchronize()
    in_thr = d1 <= ncfg.dist_threshold_ped
    same_slots = torch.equal(d_w[:m] <= ncfg.dist_threshold_ped, in_thr) \
        and torch.equal(i_w[:m][in_thr], i1[in_thr]) \
        and torch.equal(d_w[:m][in_thr], d1[in_thr])
    differing = int(((d_w[:m] != d1) | (i_w[:m] != i1)).any(dim=1).sum())
    if exact and not same_slots:
        raise AssertionError("half-grid pass: in-threshold slots differ "
                             "from K1's")

    # the old route: K1 as the agent pass's fallback at every N
    with mock.patch.object(features, "DENSE_COLUMN_CEILING", 1 << 62):
        pairwise.KERNEL.launches = 0
        _, old_wall = frames(1)
        old_k1 = pairwise.KERNEL.launches
    say("scale_ceiling_half_grid", bitwise_equal_plain_on_tiles=True,
        in_threshold_slots_equal_k1=same_slots, sample_rows=m,
        rows_differing_from_k1_any_slot=differing, **record)
    say("scale_ceiling_old_route", ms_per_frame=old_wall * 1e3,
        k1_launches=old_k1, new_route_ms_per_frame=wall / SCALE_FRAMES * 1e3)
    return dict(counts, half_grid=record)

# the parallel layer (phase 18): ranks sharing the one card over gloo, the
# dense stress padded to a multiple of them, the sharded rollout's frames,
# and the rows of the tensor-parallel forward (pinnsf_bm at its published
# widths, 128 / 128 / 64, which the tp axis divides)
RANKS = 4
SHARD_FRAMES = 10
TP_ROWS = 4096


def padded_stress(dev):
    """The dense-stress frame with absent agents appended up to a multiple
    of ``RANKS`` (``data.views.pad_agents``'s fills)."""
    import torch

    sc = stress_scene(dev)
    extra = -N_AGENTS % RANKS

    def pad(x, value, axis=0):
        shape = list(x.shape)
        shape[axis] = extra
        return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                        device=x.device)], dim=axis)

    return dict(sc, pos=pad(sc["pos"], math.nan), vel=pad(sc["vel"], 0.0),
                acc=pad(sc["acc"], 0.0), dest=pad(sc["dest"], math.nan),
                ds=pad(sc["ds"], 0.0), wp=pad(sc["wp"], math.nan, axis=1))


def ot_frames(dev):
    """Phase 12's OT frames (``dense_metrics``' first draws), and a far
    cloud a frame for MMD, 300 m away (the MMD of ``q = p + noise`` is
    float32 rounding noise around 0, as phase 12 notes)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 2)
    p = torch.rand((OT_FRAMES, N_AGENTS, 2), generator=g) * 200.0
    q = p + 0.5 * torch.randn(p.shape, generator=g)
    far = torch.rand(p.shape, generator=g) * 200.0 + 300.0
    return (p.to(dev), q.to(dev), far.to(dev),
            torch.ones((OT_FRAMES, N_AGENTS), device=dev))


def tp_models(dev):
    """Phase 18e's seeded ``pinnsf_bm`` at phase 9's configuration (the
    published widths): the pretrain model with its forward's inputs, and
    the finetune model."""
    import torch

    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.models import ModelSpec, build_model

    cfg = PIMLConfig(**TRAIN_CFG, ft_batch_size=TRAIN_CHANNELS)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = build_model(ModelSpec.from_config(cfg))
    g = torch.Generator().manual_seed(SEED + 5)
    rows = (torch.randn((TP_ROWS, 6, 6), generator=g),
            torch.randn((TP_ROWS, 10, 6), generator=g),
            torch.cat([torch.randn((TP_ROWS, 6), generator=g),
                       torch.ones((TP_ROWS, 1))], dim=-1))
    return (cfg, model.to(dev).eval(), [x.to(dev) for x in rows],
            finetune_model(cfg, dev))


def dense_obstacle_features(pos, vel, acc, obstacles, ncfg):
    """One frame's obstacle features through the dense selection
    (``nearby_in_sight``, the JAX package's matmul expansion), assembled as
    ``relative_features`` assembles them: the selection every rank of the
    agent-sharded route makes for its agents."""
    import torch

    from piml_tpu_torch.physics.features import (heading_direction,
                                                 nearby_in_sight)

    v0 = torch.where(torch.isnan(vel), 0.0, vel)
    a0 = torch.where(torch.isnan(acc), 0.0, acc)
    state = torch.cat([pos, v0, a0], dim=-1)
    k = min(ncfg.topk_obs, obstacles.shape[0])
    d, i = nearby_in_sight(pos, obstacles,
                           heading_direction(v0, time_axis=False), k,
                           ncfg.sight_angle_obs)
    z = torch.zeros_like(obstacles)
    rel = torch.cat([obstacles, z, z], dim=-1)[i] - state[:, None, :]
    keep = (d <= ncfg.dist_threshold_obs)[..., None]
    return torch.where(keep & torch.isfinite(rel), rel, 0.0)


@contextlib.contextmanager
def dense_obstacle_selection():
    """The single-device rollout's per-step features with the obstacles
    selected densely (``dense_obstacle_features``) in place of K2's pass:
    the agent-sharded route's obstacle selection on one device."""
    import importlib

    rollout_mod = importlib.import_module("piml_tpu_torch.engine.rollout")
    real = rollout_mod.relative_features

    def features(p, v, a, dest, obstacles, ncfg, **kw):
        ped, _, dest_f = real(p, v, a, dest, obstacles, ncfg, **kw)
        return ped, dense_obstacle_features(p, v, a, obstacles, ncfg), dest_f

    with mock.patch.object(rollout_mod, "relative_features", features):
        yield


def dp_step_model(dev):
    """Phase 9's configuration, seeded finetune model and its optimizer."""
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.train.trainer import make_optimizer

    cfg = PIMLConfig(**TRAIN_CFG, ft_batch_size=TRAIN_CHANNELS)
    model = finetune_model(cfg, dev)
    return cfg, model, make_optimizer(cfg, model.parameters(), finetune=True)


def parallel_rank(rank, device, setup=None):
    """One rank of phase 18 (``parallel_layer``); returns its results on
    the CPU.  ``setup``: a callable run first on the rank."""
    import torch
    import torch.distributed as dist

    from piml_tpu_torch import parallel
    from piml_tpu_torch.ops import banded, pairwise
    from piml_tpu_torch.parallel import agent_shard, tensor_parallel
    from piml_tpu_torch.physics import NeighborConfig
    from piml_tpu_torch.train.trainer import make_optimizer

    if setup is not None:
        setup()
    out = {}
    mesh = parallel.make_mesh(RANKS, "ap", device=device.type)
    sc = padded_stress(device)
    ncfg = NeighborConfig()
    frame = (sc["pos"], sc["vel"], sc["acc"], sc["dest"], sc["obstacles"])

    # a. the sharded K2 pass: this rank's launch against the plain version
    fb0 = banded.KERNEL.fallbacks
    args, feats = banded_args(agent_shard.sharded_banded_features, *frame,
                              ncfg, mesh)
    exact_fallbacks = banded.KERNEL.fallbacks - fb0
    out_k = banded.banded_topk_cuda(*args)
    out_p = banded.banded_topk_plain(*args[:-1])
    torch.cuda.synchronize()
    assert_equal(out_k[0], out_p[0], f"rank {rank}: sharded K2 dist")
    assert_equal(out_k[1], out_p[1], f"rank {rank}: sharded K2 idx")
    for r in range(RANKS):          # one rank on the card at a time
        dist.barrier()
        if r == rank:
            ms = queued_ms(lambda: banded.banded_topk_cuda(*args), 50)
            plain_ms = queued_ms(
                lambda: banded.banded_topk_plain(*args[:-1]), 10)
        dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        agent_shard.sharded_banded_features(*frame, ncfg, mesh)
    torch.cuda.synchronize()
    caller_ms = (time.perf_counter() - t0) / 5 * 1e3
    # a forced fallback: the last rank's proof fails, so every rank takes
    # the ring pass
    real = banded.topk_neighbors_banded

    def unproven(*a, **kw):
        d, i, _ = real(*a, **kw)
        return d, i, torch.zeros((), dtype=torch.bool, device=d.device)

    fb0 = banded.KERNEL.fallbacks
    with mock.patch.object(banded, "topk_neighbors_banded",
                           unproven if rank == RANKS - 1 else real):
        forced = agent_shard.sharded_banded_features(*frame, ncfg, mesh)
    forced_fallbacks = banded.KERNEL.fallbacks - fb0
    ring = agent_shard.sharded_relative_features(*frame, ncfg, mesh)
    for a_, b_, what in zip(forced, ring, ("ped", "obs", "dest")):
        assert_equal(a_, b_, f"rank {rank}: forced fallback vs ring {what}")
    out["a"] = dict(pass_record(ms, plain_ms, k2_bound(args)),
                    max_abs_err=max_abs_err(out_k[0], out_p[0]),
                    rows=int(args[2].shape[-2]), caller_ms=caller_ms,
                    exact_fallbacks=exact_fallbacks,
                    forced_fallbacks=forced_fallbacks,
                    features=[t.cpu() for t in feats], ring=ring[0].cpu())

    # b. the agent-sharded eval rollout (the main path's run: counts zeroed
    # just before it, read just after)
    _, model = trained_model(device)
    stress_rollout(model, sc, ncfg, WARMUP_FRAMES, mesh)
    pairwise.KERNEL.launches = 0
    banded.KERNEL.launches = 0
    banded.KERNEL.fallbacks = 0
    banded.KERNEL.sharded_calls = 0
    outs, wall = stress_rollout(model, sc, ncfg, SHARD_FRAMES, mesh)
    out["b"] = dict(p=outs.p.cpu(), mask=outs.mask.cpu(),
                    ms_per_frame=wall / SHARD_FRAMES * 1e3,
                    k2_launches=banded.KERNEL.launches,
                    k2_fallbacks=banded.KERNEL.fallbacks,
                    sharded_calls=banded.KERNEL.sharded_calls,
                    k1_launches=pairwise.KERNEL.launches)

    # c. channel-DP dense-N step: 2 channels padded to 4, one a rank
    cfg9, model9, opt = dp_step_model(device)
    batch9 = dense_batch(device)
    dp_mesh = parallel.make_mesh(RANKS, "dp", device=device.type)
    step = parallel.make_dp_finetune_step(cfg9, Clamped(model9), opt, dp_mesh)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    terms = step(batch9)
    torch.cuda.synchronize()
    out["c"] = dict(s_per_step=time.perf_counter() - t0,
                    max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                        device),
                    terms={k: float(v) for k, v in terms._asdict().items()},
                    params={k: v.detach().cpu()
                            for k, v in model9.state_dict().items()},
                    grads={k: v.grad.cpu()
                           for k, v in model9.named_parameters()})

    # d. sharded OT and MMD
    p, q, far, ones = ot_frames(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ot = float(parallel.sharded_ot_with_time_mask(p, q, ones, mesh, "ap",
                                                  "sum"))
    t1 = time.perf_counter()
    mmd = float(parallel.sharded_mmd_with_time_mask(p, far, ones, mesh, "ap",
                                                    "sum"))
    t2 = time.perf_counter()
    its = [parallel.sharded_sinkhorn(p[t], q[t], ones[t], ones[t], mesh,
                                     with_iterations=True)[1]
           for t in range(OT_FRAMES)]
    out["d"] = dict(ot=ot, mmd=mmd, sinkhorn_iterations=its,
                    ot_ms_per_frame=(t1 - t0) / OT_FRAMES * 1e3,
                    mmd_ms_per_frame=(t2 - t1) / OT_FRAMES * 1e3)

    # e. tensor parallelism on a 2 × 2 (dp, tp) mesh
    tp_mesh = parallel.make_mesh((2, 2), ("dp", "tp"), device=device.type)
    cfg_tp, model_tp, rows, ft_tp = tp_models(device)
    with torch.no_grad():
        fwd = parallel.make_tp_apply(model_tp, tp_mesh)(*rows).pred_acc
    tp_ft, _ = tensor_parallel.shard_params_tp(ft_tp, tp_mesh)
    opt = make_optimizer(cfg_tp, tp_ft.parameters(), finetune=True)
    step = parallel.make_tp_dp_finetune_step(cfg_tp, Clamped(tp_ft), opt,
                                             tp_mesh)
    terms = step(batch9)
    out["e"] = dict(forward=fwd.cpu(), loss=float(terms.loss),
                    params={k: v.cpu() for k, v in
                            tensor_parallel.gather_params_tp(tp_ft).items()})
    return out


def one_step(cfg, model, opt, batch):
    """One single-device finetune step of the clamped ``model``."""
    from piml_tpu_torch.engine import training_rollout_loss

    out = training_rollout_loss(Clamped(model), cfg, batch)
    opt.zero_grad(set_to_none=True)
    out.loss.backward()
    opt.step()
    return out


def close_params(got, ref, rtol, atol, what):
    """Every parameter of ``got`` within ``rtol`` / ``atol`` of ``ref``;
    returns the largest absolute gap."""
    import torch

    worst = 0.0
    for name, t in ref.items():
        g = got[name].to(t.device)
        if not torch.allclose(g, t, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: parameter {name} differs (max "
                                 f"{float((g - t).abs().max())})")
        worst = max(worst, float((g - t).abs().max()))
    return worst


def parallel_layer(dev, setup=None):
    """Phase 18: the parallel layer, ``RANKS`` ranks on the one card over
    gloo (``parallel.spawn_local``; NCCL refuses ranks that share a
    device).  Times of time-sliced ranks on one card are no multi-card
    speed.  Each check holds the ranks' results against the single-device
    path on the card, computed here:

    a. sharded K2 at the dense stress (12,685 agents padded to 12,688,
       4,096 obstacle points): each rank's launch bitwise against the plain
       version on its shard; the gathered agent features bitwise equal to
       the single-device pass's (both proofs hold: K2's features are then
       the dense selection's); the gathered obstacle features (each rank's
       dense pass on its agents, as in JAX) bitwise equal to the dense pass
       on the whole frame (``dense_obstacle_features``); each rank's pass
       in ms (one rank on the card at a time), bound and share; a frame
       whose last rank's proof is forced to fail, where every rank takes
       the ring pass (one fallback each, bitwise the ring pass's output);
    b. the agent-sharded eval rollout of the trained ``pinnsf_bm``,
       ``SHARD_FRAMES`` frames after ``WARMUP_FRAMES``, against the
       single-device rollout with the same obstacle selection
       (``dense_obstacle_selection``; agents through K2): masks equal and
       positions bit for bit on every frame (largest gap 0 m); ms/frame,
       K2 launches, fallbacks and sharded calls per rank (counts zeroed
       just before the run);
    c. phase 9's channel-DP dense-N step, 2 channels padded to 4 (two
       inert), one a rank: loss and updated parameters against the
       single-device step on the unpadded batch (rtol 1e-4, atol 1e-5:
       tests/test_sharding.py:71-75), the summed gradients to relative L2
       1e-4 per tensor; s/step and peak memory per rank;
    d. sharded OT on phase 12's frames and MMD against a far cloud
       (``ot_frames``), against the single-device metrics (rel 1e-4; MMD
       abs 1e-6), Sinkhorn iterations, ms/frame;
    e. ``pinnsf_bm``'s tensor-parallel forward at its published widths on
       ``TP_ROWS`` rows against the replicated forward (rtol 1e-5, atol
       1e-6), and one dp × tp (2 × 2) step against the single-device step
       (loss rtol 2e-4, parameters rtol 5e-4 / atol 5e-5:
       tests/test_tensor_parallel.py).

    Returns the record of the sharded K2 pass for the kernels line."""
    import torch

    from piml_tpu_torch import parallel
    from piml_tpu_torch.metrics import mmd_with_time_mask, ot_with_time_mask
    from piml_tpu_torch.ops import banded
    from piml_tpu_torch.physics import NeighborConfig, relative_features

    def bitwise(got, ref, what):
        """``got`` equal to ``ref`` bit for bit, NaN where ``ref`` is NaN;
        raises with the count and the largest gap."""
        same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
        if not bool(same.all()):
            gap = torch.nan_to_num((got - ref).abs(), nan=math.inf)
            raise AssertionError(f"{what}: {int((~same).sum())} of "
                                 f"{same.numel()} values differ (largest "
                                 f"gap {float(gap.max())})")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = parallel.spawn_local(parallel_rank, RANKS, "gloo", str(dev),
                                   args=(setup,), timeout=900)
    spawn_s = time.perf_counter() - t0
    r0 = results[0]

    # a
    sc = padded_stress(dev)
    ncfg = NeighborConfig()
    launches = banded.KERNEL.launches
    with torch.inference_mode():
        ref = relative_features(sc["pos"], sc["vel"], sc["acc"], sc["dest"],
                                sc["obstacles"], ncfg)
    one_device_launches = banded.KERNEL.launches - launches
    dense_obs = dense_obstacle_features(sc["pos"], sc["vel"], sc["acc"],
                                        sc["obstacles"], ncfg)
    for r, res in enumerate(results):
        a = res["a"]
        if a["exact_fallbacks"] or a["forced_fallbacks"] != 1:
            raise AssertionError(f"rank {r}: fallbacks {a['exact_fallbacks']}"
                                 f" / forced {a['forced_fallbacks']}")
        assert_equal(a["features"][0].to(dev), ref[0],
                     f"rank {r}: gathered sharded K2 agent features")
        bitwise(a["features"][1].to(dev), dense_obs,
                f"rank {r}: gathered sharded obstacle features vs the "
                "dense pass")
    # the dense selection against K2's (direct differencing): rounding at
    # |p| ~ 200 m moves a few obstacles across the 4 m threshold
    obs_rows = int((dense_obs != ref[1]).any(-1).any(-1).sum())
    ring_rows = int((r0["a"]["ring"].to(dev) != ref[0]).any(-1)
                    .any(-1).sum())
    passes = [res["a"] for res in results]
    say("parallel_sharded_k2", ranks=RANKS, agents=N_AGENTS,
        rows_per_rank=r0["a"]["rows"],
        ms=[p["ms"] for p in passes], plain_ms=[p["plain_ms"] for p in passes],
        bound_ms=[p["bound_ms"] for p in passes],
        bound_by=[p["bound_by"] for p in passes],
        share=[p["share"] for p in passes],
        caller_ms=[p["caller_ms"] for p in passes],
        bitwise_equal_plain=True, agent_features_bitwise_single_device=True,
        obstacle_features_bitwise_dense_pass=True,
        dense_obstacle_rows_differing_from_k2=obs_rows,
        ring_rows_differing_from_k2=ring_rows,
        forced_fallback_every_rank=True, spawn_s=spawn_s)

    # b
    _, model = trained_model(dev)
    with dense_obstacle_selection():
        ref_roll, ref_wall = stress_rollout(model, sc, ncfg, SHARD_FRAMES)
    live = ref_roll.mask[-1] == 1
    for r, res in enumerate(results):
        b = res["b"]
        counts = {k: b[k] for k in ("k2_launches", "k2_fallbacks",
                                    "sharded_calls", "k1_launches")}
        # one sharded K2 launch a frame, and the initial frame's features
        # on one device (its agent and obstacle K2 passes)
        if (b["sharded_calls"] != SHARD_FRAMES or b["k1_launches"]
                or b["k2_launches"] != SHARD_FRAMES + one_device_launches):
            raise AssertionError(f"rank {r}: sharded rollout {counts}")
        if not torch.equal(b["mask"].to(dev), ref_roll.mask):
            raise AssertionError(f"rank {r}: sharded rollout masks differ")
        # the same selections on both sides (18a: agents bit for bit K2's,
        # obstacles bit for bit the dense pass's), so every position of
        # every frame is bit for bit one device's: largest gap 0 m
        bitwise(b["p"].to(dev), ref_roll.p,
                f"rank {r}: sharded rollout positions")
    say("parallel_sharded_rollout", frames=SHARD_FRAMES,
        ms_per_frame=[res["b"]["ms_per_frame"] for res in results],
        single_device_dense_obstacles_ms_per_frame=(ref_wall / SHARD_FRAMES
                                                    * 1e3),
        k2_launches=[res["b"]["k2_launches"] for res in results],
        k2_fallbacks=[res["b"]["k2_fallbacks"] for res in results],
        sharded_calls=[res["b"]["sharded_calls"] for res in results],
        positions_bitwise_single_device=True, largest_gap_m=0.0,
        live_agents=int(live.sum()))

    # c
    cfg9, model9, opt = dp_step_model(dev)
    loss = one_step(cfg9, model9, opt, dense_batch(dev)).loss.item()
    got = r0["c"]
    if abs(got["terms"]["loss"] - loss) > 1e-4 * abs(loss):
        raise AssertionError(f"DP step loss {got['terms']['loss']} vs "
                             f"{loss}")
    worst_c = close_params(got["params"], model9.state_dict(), 1e-4, 1e-5,
                           "DP step")
    # the summed gradients against one device's (other summation orders)
    rel_c, worst_grad_c = grad_rel_l2(
        got["grads"], {n: p.grad for n, p in model9.named_parameters()})
    if not worst_grad_c <= 1e-4:
        raise AssertionError(f"DP step gradients differ ({worst_grad_c})")
    say("parallel_dp_step", channels=TRAIN_CHANNELS, padded_to=RANKS,
        loss=[got["terms"]["loss"], loss],
        max_param_gap=worst_c, grad_rel_l2=rel_c,
        grad_rel_l2_worst_tensor=worst_grad_c,
        s_per_step=[res["c"]["s_per_step"] for res in results],
        max_memory_allocated_bytes=[res["c"]["max_memory_allocated_bytes"]
                                    for res in results])

    # d
    p, q, far, ones = ot_frames(dev)
    ot_ref = float(ot_with_time_mask(p, q, ones, "sum"))
    mmd_ref = float(mmd_with_time_mask(p, far, ones, "sum"))
    d = r0["d"]
    if abs(d["ot"] - ot_ref) > 1e-4 * abs(ot_ref):
        raise AssertionError(f"sharded OT {d['ot']} vs {ot_ref}")
    if abs(d["mmd"] - mmd_ref) > 1e-4 * abs(mmd_ref) + 1e-6:
        raise AssertionError(f"sharded MMD {d['mmd']} vs {mmd_ref}")
    say("parallel_ot_mmd", frames=OT_FRAMES, ot=[d["ot"], ot_ref],
        mmd=[d["mmd"], mmd_ref], sinkhorn_iterations=d["sinkhorn_iterations"],
        ot_ms_per_frame=[res["d"]["ot_ms_per_frame"] for res in results],
        mmd_ms_per_frame=[res["d"]["mmd_ms_per_frame"] for res in results])

    # e
    cfg_tp, model_tp, rows, ft_tp = tp_models(dev)
    with torch.no_grad():
        fwd = model_tp(*rows).pred_acc
    e = r0["e"]
    if not torch.allclose(e["forward"].to(dev), fwd, rtol=1e-5, atol=1e-6):
        raise AssertionError("TP forward differs from the replicated one")
    from piml_tpu_torch.train.trainer import make_optimizer

    opt = make_optimizer(cfg_tp, ft_tp.parameters(), finetune=True)
    loss = one_step(cfg_tp, ft_tp, opt, dense_batch(dev)).loss.item()
    if abs(e["loss"] - loss) > 2e-4 * abs(loss):
        raise AssertionError(f"dp x tp loss {e['loss']} vs {loss}")
    worst_e = close_params(e["params"], ft_tp.state_dict(), 5e-4, 5e-5,
                           "dp x tp step")
    say("parallel_tp", mesh=[2, 2], rows=TP_ROWS,
        forward_max_gap=float((e["forward"].to(dev) - fwd).abs().max()),
        loss=[e["loss"], loss], max_param_gap=worst_e)

    rec = dict(passes[0])
    for key in ("features", "ring"):
        rec.pop(key)
    rec.update(ms_ranks=[p["ms"] for p in passes],
               plain_ms_ranks=[p["plain_ms"] for p in passes],
               # the sharded caller's own launches; the rollout's initial
               # frame runs the single-device K2 passes on every rank
               launches_ranks=[res["b"]["k2_launches"] - one_device_launches
                               for res in results],
               launches_initial_frame_ranks=[one_device_launches] * RANKS,
               max_abs_err=max(p["max_abs_err"] for p in passes))
    return rec



# the paper reproduction (phase 19): the stages of piml_tpu_torch.exp.repro
# and, in every process it starts, a sitecustomize that appends the
# process's K1 / K2 launch counts to the file named by LAUNCH_LOG_ENV
REPRO_STAGES = ("pure_sf", "pretrain", "finetune", "mlapm_sim", "sr_grid")
REPRO_TIMEOUT = 600
LAUNCH_LOG_ENV = "PIML_CHIP_SMOKE_LAUNCH_LOG"
LAUNCH_SITECUSTOMIZE = """\
import atexit, importlib.machinery, importlib.util, json, os, sys

def _launches():
    ops = [sys.modules.get("piml_tpu_torch.ops." + m)
           for m in ("pairwise", "banded")]
    with open(os.environ["%s"], "a") as f:
        f.write(json.dumps({"argv": sys.argv,
                            "k1": ops[0].KERNEL.launches if ops[0] else 0,
                            "k2": ops[1].KERNEL.launches if ops[1] else 0})
                + "\\n")

atexit.register(_launches)
# the sitecustomize this one shadows, if the installation has one
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path
                      if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
""" % LAUNCH_LOG_ENV


def repro_root(tmp):
    """Phase 19's root: paper YAMLs (``gc_{pretrain,finetune}_paper.yaml``,
    ``gc_symbolic.yaml``) that name phase 13's cut of the committed GC
    scenes, the sweep YAML, and the launch-counting sitecustomize.
    Returns the environment of the run and the launch log's path."""
    import shutil

    configs = cut_cli_scenes(tmp)
    data_dir = os.path.join(tmp, "configs", "data_configs")
    grid_dir = os.path.join(tmp, "configs", "exp_configs")
    os.makedirs(data_dir)
    os.makedirs(grid_dir)
    shutil.copy(configs["pretrain"],
                os.path.join(data_dir, "gc_pretrain_paper.yaml"))
    shutil.copy(configs["finetune"],
                os.path.join(data_dir, "gc_finetune_paper.yaml"))
    # the extraction set: the finetune's real-data stand-in
    with open(os.path.join(data_dir, "gc_symbolic.yaml"), "w") as f:
        f.write("".join(f"{split}:\n  - "
                        f"{os.path.join(tmp, 'finetune_' + split + '.npy')}\n"
                        for split in ("train", "valid")))
    shutil.copy(os.path.join(ROOT, "configs", "exp_configs",
                             "piml-gcdata.yaml"), grid_dir)
    site = os.path.join(tmp, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_SITECUSTOMIZE)
    log = os.path.join(tmp, "launches.jsonl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((site, ROOT)),
               **{LAUNCH_LOG_ENV: log})
    return env, log


def paper_reproduction(tmp, smi):
    """Phase 19: ``python3 -m piml_tpu_torch.exp.repro --smoke --root
    tmp`` in a subprocess, all five stages at the smoke budget (100
    generated frames, 3 epochs, no GP search; ``pinnsf_bm`` at its
    published widths), on :func:`repro_root`: every stage rc 0, both
    generated scenes 100 frames, a finite finetuned ``finetune_test``,
    extracted edges; then the same command again, which must skip all five
    stages.  Each stage's wall seconds and the K1 / K2 launches of every
    process of the run (0 expected: the scenes are under the 2^21 pair
    gate) are printed."""
    env, log = repro_root(tmp)
    cmd = [sys.executable, "-m", "piml_tpu_torch.exp.repro", "--smoke",
           "--root", tmp]

    def repro():
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=REPRO_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"repro: rc {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        return proc.stdout, wall

    out, wall = repro()
    with open(os.path.join(tmp, "repro_smoke_torch.json")) as f:
        state = json.load(f)
    failed = {k: state.get(k, {}).get("tail") for k in REPRO_STAGES
              if state.get(k, {}).get("rc") != 0}
    if failed:
        raise AssertionError(f"repro: stages failed: {failed}")
    frames = {k: state[k]["frames"] for k in ("pure_sf", "mlapm_sim")}
    if set(frames.values()) != {100}:
        raise AssertionError(f"repro: generated frames {frames}")
    ft_test = state["finetune"]["finetune_test"]
    if not all(math.isfinite(v) for v in ft_test.values()):
        raise AssertionError(f"repro: finetune_test {ft_test}")
    with open(os.path.join(tmp, "sr_gc_torch.json")) as f:
        sr = json.load(f)
    if not sr["edges"] > 0:
        raise AssertionError(f"repro: symbolic regression {sr}")
    with open(log) as f:
        procs = [json.loads(line) for line in f]
    again, again_wall = repro()
    skipped = again.count("cached (rc=0), skipping")
    if skipped != len(REPRO_STAGES):
        raise AssertionError(f"repro rerun: {skipped} stages skipped\n"
                             f"{again[-3000:]}")
    launches = {"k1": sum(p["k1"] for p in procs),
                "k2": sum(p["k2"] for p in procs)}
    print(smi)
    say("paper_reproduction", wall_s=wall, rerun_wall_s=again_wall,
        stage_wall_s={k: state[k]["wall_s"] for k in REPRO_STAGES},
        processes=len(procs), rerun_skipped=skipped, frames=frames,
        n_pedestrians={k: state[k]["n_pedestrians"]
                       for k in ("pure_sf", "mlapm_sim")},
        pretrain=state["pretrain"]["pretrain"],
        finetune=state["finetune"]["finetune"],
        pretrain_test=state["finetune"]["pretrain_test"],
        finetune_test=ft_test, gt_test=state["finetune"]["gt_test"],
        sr_edges=sr["edges"], family_fit=sr["family_fit"],
        grid_commands=state["sr_grid"].get("grid_commands"))
    say("paper_reproduction_launches", **launches,
        per_process=[dict(p, argv=" ".join(p["argv"][:3])) for p in procs])
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "piml_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke: piml_tpu_torch/ not found beside the "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, ROOT)

    import numpy as np

    import piml_tpu_torch  # noqa: F401  (sets allow_tf32 = False)
    from piml_tpu_torch import _build
    from piml_tpu_torch.engine import training_rollout_loss
    from piml_tpu_torch.ops import banded, contacts, pairwise
    from piml_tpu_torch.ops import mlapm as mlapm_ops
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
    k1_passes, k1_err = {}, 0.0
    for name, (cols, k, thr, selfp) in passes.items():
        got = pairwise.pairwise_topk_cuda(rows, cols, k, thr, selfp)
        ref = pairwise.pairwise_topk_plain(rows, cols, k, thr, selfp)
        torch.cuda.synchronize()
        assert_equal(got[0], ref[0], f"K1 {name} dist")
        assert_equal(got[1], ref[1], f"K1 {name} idx")
        ms = queued_ms(lambda: pairwise.pairwise_topk_cuda(
            rows, cols, k, thr, selfp), 20)
        plain_ms = queued_ms(lambda: pairwise.pairwise_topk_plain(
            rows, cols, k, thr, selfp), 5)
        k1_passes[name] = pass_record(ms, plain_ms,
                                      k1_bound(rows, cols, k))
        k1_err = max(k1_err, max_abs_err(got[0], ref[0]))
        say("k1", which=name, shape=[N_AGENTS, cols.shape[1]], k=k,
            slices=pairwise.column_slices(cols.shape[1])[0],
            bitwise_equal=True, **k1_passes[name])
    record["k1"] = kernel_record(k1_passes, k1_err)

    # ---- 3. K2 against its plain version -----------------------------------
    k2_passes, k2_err = {}, 0.0
    k2_kwargs = k2_pass_kwargs(sc, ncfg)
    for name, kw in k2_kwargs.items():
        args, got = banded_args(banded.topk_neighbors_banded, sc["pos"],
                                heading, **kw)
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
        out_k, out_p = (banded.banded_topk_cuda(*args),
                        banded.banded_topk_plain(*args[:-1]))
        assert_equal(out_k[0], out_p[0], f"K2 {name} raw dist")
        assert_equal(out_k[1], out_p[1], f"K2 {name} raw idx")
        ms = queued_ms(lambda: banded.banded_topk_cuda(*args), 50)
        plain_ms = queued_ms(
            lambda: banded.banded_topk_plain(*args[:-1]), 10)
        k2_passes[name] = pass_record(ms, plain_ms, k2_bound(args))
        k2_err = max(k2_err, max_abs_err(out_k[0], out_p[0]))
        say("k2", which=name, grid_dim=kw["grid_dim"], window=kw["window"],
            exact=bool(got[2]), bitwise_equal=True, **k2_passes[name])

    # ---- 3b. both kernels on edge cases ------------------------------------
    kernel_edge_cases(dev)

    # ---- 3c. the contact-count kernel --------------------------------------
    contact_passes = contact_counts_check(dev)

    # ---- 3d. the force-law kernel ------------------------------------------
    mlapm_passes = mlapm_force_check(dev)

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
    for key in ("loss", "mse", "mae", "ot", "mmd", "collision",
                "hard_collision"):
        if not math.isfinite(getattr(metrics, key)):
            raise AssertionError(f"GC window: {key} is not finite")
    say("gc_window", frames=data.num_frames, agents=data.num_pedestrians,
        obstacles=int(data.obstacles.shape[0]),
        make_time_indexed_s=t1 - t0, eval_s=t2 - t1,
        metrics=dict(loss=metrics.loss, mse=metrics.mse, mae=metrics.mae,
                     ot=metrics.ot, mmd=metrics.mmd,
                     collision=metrics.collision,
                     hard_collision=metrics.hard_collision))
    gc_window_vs_fixture(model, cfg, data, metrics, scene_path)

    # the same 60-frame slice on the card and on the CPU (the CPU side is
    # the path the tests hold to the JAX package)
    arrays = codec.decode(scene_path)
    for key in ("position", "velocity", "acceleration", "destination",
                "dest_idx", "mask_p", "mask_v", "mask_a"):
        arrays[key] = arrays[key][:GC_SLICE_FRAMES]
    cpu_model = trained_model("cpu")[1]
    m_gpu = evaluate_rollouts(
        model, cfg, [make_time_indexed(cfg, Scene.from_arrays(arrays, dev))],
        test_flag=True)
    m_cpu = evaluate_rollouts(
        cpu_model, cfg,
        [make_time_indexed(cfg, Scene.from_arrays(arrays, device="cpu"))],
        test_flag=True)
    for key in ("mse", "mae", "ot", "mmd", "collision", "hard_collision"):
        a, b = getattr(m_gpu, key), getattr(m_cpu, key)
        if abs(a - b) > 1e-4 * max(abs(b), 1e-12):
            raise AssertionError(f"GC slice {key}: GPU {a} vs CPU {b}")
    say("gc_slice_gpu_vs_cpu", frames=GC_SLICE_FRAMES,
        **{key: [getattr(m_gpu, key), getattr(m_cpu, key)]
           for key in ("mse", "mae", "ot", "mmd", "collision")})

    # ---- 8. K2 with a channel axis -----------------------------------------
    g = torch.Generator().manual_seed(SEED + 1)
    jitter = [0.05 * torch.randn((N_AGENTS, 2), generator=g) for _ in "pv"]
    pos2 = torch.stack([sc["pos"], sc["pos"] + jitter[0].to(dev)])
    head2 = heading_direction(
        torch.stack([sc["vel"], sc["vel"] + jitter[1].to(dev)]),
        time_axis=False)
    for name, kw in k2_kwargs.items():
        kw = dict(kw)
        kw.pop("same_objects", None)
        args, got = banded_args(banded.topk_neighbors_banded_batched, pos2,
                                head2, **kw)
        with plain_route():
            ref = banded.topk_neighbors_banded_batched(pos2, head2, **kw)
        objects = kw.pop("objects", None)
        singles = [banded.topk_neighbors_banded(
            pos2[c], head2[c], objects=objects, same_objects=objects is None,
            **kw) for c in range(2)]
        torch.cuda.synchronize()
        for j, what in enumerate(("dist", "idx", "exact")):
            assert_equal(got[j], ref[j], f"batched K2 {name} {what}")
            for c in range(2):
                assert_equal(got[j][c], singles[c][j],
                             f"batched K2 {name} {what} vs channel {c}")
        ms = queued_ms(lambda: banded.banded_topk_cuda(*args), 50)
        plain_ms = queued_ms(
            lambda: banded.banded_topk_plain(*args[:-1]), 10)
        k2_passes[f"batched_{name}"] = pass_record(ms, plain_ms,
                                                   k2_bound(args))
        say("k2_batched", which=name, channels=2,
            exact=got[2].tolist(), bitwise_equal_plain=True,
            bitwise_equal_single_launches=True,
            **k2_passes[f"batched_{name}"])
    record["k2"] = kernel_record(k2_passes, k2_err)

    # ---- 9. the dense-N finetune step --------------------------------------
    from piml_tpu_torch.config import PIMLConfig
    from piml_tpu_torch.train.trainer import make_optimizer

    cfg9 = PIMLConfig(**TRAIN_CFG, ft_batch_size=TRAIN_CHANNELS)
    batch9 = dense_batch(dev)
    model9 = finetune_model(cfg9, dev)
    clamped = Clamped(model9)
    opt = make_optimizer(cfg9, model9.parameters(), finetune=True)
    pairwise.KERNEL.launches = 0
    banded.KERNEL.launches = 0
    banded.KERNEL.fallbacks = 0
    contacts.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, step_losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = training_rollout_loss(clamped, cfg9, batch9)
        opt.zero_grad(set_to_none=True)
        out.loss.backward()
        opt.step()
        step_losses.append(out.loss.item())
        step_s.append(time.perf_counter() - t0)
    ft_launches = dict(k1=pairwise.KERNEL.launches, k2=banded.KERNEL.launches,
                       k2_fallbacks=banded.KERNEL.fallbacks,
                       contacts=contacts.KERNEL.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    say("dense_finetune_step", channels=TRAIN_CHANNELS, frames=TRAIN_FRAMES,
        agents=N_AGENTS, obstacles=TRAIN_OBSTACLES, s_per_step=step_s,
        max_memory_allocated_bytes=peak, losses=step_losses, **ft_launches)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError(f"dense finetune: losses {step_losses}")
    if ft_launches["k2"] < TRAIN_STEPS * TRAIN_FRAMES:
        raise AssertionError("dense finetune: K2 was not launched on every "
                             f"frame ({ft_launches['k2']} launches)")
    # every frame counts its contacts, and the loss its labels', in one
    # launch each (the checkpoint's recompute launches again)
    if ft_launches["contacts"] < TRAIN_STEPS * (TRAIN_FRAMES + 1):
        raise AssertionError("dense finetune: the contact kernel was not "
                             "launched on every frame "
                             f"({ft_launches['contacts']} launches)")
    terms_k, grads_k = loss_and_grads(model9, cfg9, batch9, clamped)
    with plain_route():
        terms_p, grads_p = loss_and_grads(model9, cfg9, batch9, clamped)
    rel, worst = grad_rel_l2(grads_k, grads_p)
    say("dense_finetune_kernel_vs_plain", loss=[terms_k["loss"],
                                                terms_p["loss"]],
        grad_rel_l2=rel, grad_rel_l2_worst_tensor=worst)
    if abs(terms_k["loss"] - terms_p["loss"]) > 1e-6 * abs(terms_p["loss"]):
        raise AssertionError("dense finetune: kernel and plain losses "
                             f"differ ({terms_k['loss']} vs {terms_p['loss']})")
    if not rel <= 1e-5:
        raise AssertionError(f"dense finetune: gradients differ ({rel})")

    # ---- 10. the paper-shape finetune step ----------------------------------
    from piml_tpu_torch.data import ChanneledData, to_channeled
    from piml_tpu_torch.models import PRETRAINED, load_fixture

    cfg10 = PIMLConfig(**TRAIN_CFG, ft_batch_size=PAPER_WINDOWS,
                       remat_features=False)
    # the first 32 windows with predictable agents (skip_frames = 25)
    batch10 = to_channeled(data, TRAIN_FRAMES, "slice").slice_channels(
        list(range(cfg10.skip_frames, cfg10.skip_frames + PAPER_WINDOWS)))
    pre = load_fixture(PRETRAINED)
    model10 = finetune_model(cfg10, dev, pre)
    opt10 = make_optimizer(cfg10, model10.parameters(), finetune=True)
    terms_g, grads_g = loss_and_grads(model10, cfg10, batch10)
    batch_cpu = ChanneledData(**{
        k: (v.cpu() if torch.is_tensor(v) else v)
        for k, v in vars(batch10).items()})
    terms_c, grads_c = loss_and_grads(finetune_model(cfg10, "cpu", pre),
                                      cfg10, batch_cpu)
    rel10, worst10 = grad_rel_l2(grads_g, grads_c)
    for key, ref_v in terms_c.items():
        if abs(terms_g[key] - ref_v) > 1e-4 * abs(ref_v) + 1e-6:
            raise AssertionError(f"paper step {key}: GPU {terms_g[key]} vs "
                                 f"CPU {ref_v}")
    if not worst10 <= 1e-3:
        raise AssertionError(f"paper step: gradients differ ({worst10})")
    times10 = []
    for _ in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = training_rollout_loss(model10, cfg10, batch10)
        opt10.zero_grad(set_to_none=True)
        out.loss.backward()
        opt10.step()
        torch.cuda.synchronize()
        times10.append(time.perf_counter() - t0)
    say("paper_finetune_step", windows=PAPER_WINDOWS, frames=TRAIN_FRAMES,
        agents=data.num_pedestrians, loss=[terms_g["loss"], terms_c["loss"]],
        grad_rel_l2=rel10, grad_rel_l2_worst_tensor=worst10,
        s_per_step=times10[1:], first_step_s=times10[0])

    # ---- 11. Trainer.finetune ----------------------------------------------
    from piml_tpu_torch.data import channel_batches
    from piml_tpu_torch.engine import evaluate_rollouts as evaluate
    from piml_tpu_torch.train.trainer import (MetricLogger, Trainer,
                                              checkpoint_path, load_params)

    arrays = codec.decode(scene_path)
    for key in ("position", "velocity", "acceleration", "destination",
                "dest_idx", "mask_p", "mask_v", "mask_a"):
        arrays[key] = arrays[key][slice(*FT_VALID_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        cfg11 = PIMLConfig(**TRAIN_CFG, ft_batch_size=PAPER_WINDOWS,
                           epochs=2, save_dir=tmp, exp_name="chip_smoke",
                           model_name_suffix="ft", patience=5)
        valid = make_time_indexed(cfg11, Scene.from_arrays(arrays, dev))
        windows = to_channeled(data, TRAIN_FRAMES, "slice").slice_channels(
            list(range(*FT_WINDOWS)))
        batches = channel_batches([windows], cfg11.ft_batch_size,
                                  np.random.RandomState(cfg11.seed),
                                  shuffle=True)
        logger = MetricLogger(stream=open(os.devnull, "w"))
        t0 = time.perf_counter()
        state = Trainer(cfg11, logger).finetune(batches, [valid],
                                                pretrained=pre)
        torch.cuda.synchronize()
        ft_s = time.perf_counter() - t0
        train_l = [r["train_loss"] for r in logger.records
                   if "train_loss" in r]
        val_l = [r["val_loss"] for r in logger.records if "val_loss" in r]
        fresh = finetune_model(cfg11, dev,
                               load_params(checkpoint_path(cfg11, True)))
        again = evaluate(fresh, cfg11, [valid], test_flag=False).loss
    say("trainer_finetune", epochs=len(train_l), batches=len(batches),
        train_loss=train_l, val_loss=val_l, best_val=state.best_val,
        reloaded_val=again, seconds=ft_s)
    if len(train_l) != 2 or not all(math.isfinite(x)
                                     for x in train_l + val_l):
        raise AssertionError(f"finetune: losses {train_l} / {val_l}")
    if abs(again - state.best_val) > 1e-6 * abs(state.best_val):
        raise AssertionError(f"finetune: reloaded best checkpoint gives "
                             f"{again}, best was {state.best_val}")

    # ---- 12. OT and MMD at dense N ------------------------------------------
    dense_metrics(dev, N_AGENTS)

    # ---- 13. the CLI pipeline -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cli_pipeline(dev, tmp)

    # ---- 14. the discovery loop -----------------------------------------------
    gen_launches = mlapm_ops.KERNEL.launches
    with tempfile.TemporaryDirectory() as tmp:
        scenes = generate_gc(dev, tmp)
        discovery_loop(dev, tmp, scenes["socialforce"])
    gen_launches = mlapm_ops.KERNEL.launches - gen_launches
    if not gen_launches:
        raise AssertionError("discovery loop: the MLAPM kernel never "
                             "launched")

    # ---- 15. the model zoo ----------------------------------------------------
    zoo_forwards(dev, data)
    with tempfile.TemporaryDirectory() as tmp:
        m_cfg, m_weights = zoo_pipeline(dev, tmp)
    zoo_roll = zoo_stress(dev, sc, ncfg, m_cfg, m_weights)
    zoo_ft = zoo_dense_step(dev)

    # ---- 16. the data and experiment layers -------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        configs = data_layers(dev, tmp)
        staged_experiment(dev, tmp, configs)
        grid_sweep(dev, tmp, configs)

    # ---- 17. the one-chip scale ceiling -------------------------------------
    scale = scale_ceiling(dev, model)

    # ---- 18. the parallel layer: ranks sharing the card --------------------
    shard = parallel_layer(dev)

    # ---- 19. the paper reproduction, one command ----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        paper_reproduction(tmp, smi)

    kernels = [
        dict(name="pairwise_topk (K1)", route="cuda",
             source="piml_tpu_torch/csrc/pairwise_topk.cu",
             replaces="piml_tpu/ops/pairwise.py:91",
             launches=(launches["k1"] + zoo_roll["k1"] + zoo_ft["k1"]
                       + scale["k1"]),
             launches_default_rollout=k1_default,
             launches_k1_route=launches["k1"] - k1_default,
             launches_pinnsf_m_rollout=zoo_roll["k1"],
             launches_pinnsf_m_finetune=zoo_ft["k1"],
             launches_scale_ceiling=scale["k1"], **record["k1"]),
        dict(name="banded_topk (K2)", route="cuda",
             source="piml_tpu_torch/csrc/banded_topk.cu",
             replaces="piml_tpu/ops/banded.py:116",
             launches=(launches["k2"] + ft_launches["k2"] + zoo_roll["k2"]
                       + zoo_ft["k2"] + scale["k2"]),
             launches_rollout=launches["k2"],
             launches_finetune=ft_launches["k2"],
             launches_pinnsf_m_rollout=zoo_roll["k2"],
             launches_pinnsf_m_finetune=zoo_ft["k2"],
             launches_scale_ceiling=scale["k2"],
             launches_wide_fallback=scale["wide_calls"],
             half_grid_pass=scale["half_grid"], **record["k2"]),
        dict(name="contact_counts", route="cuda",
             source="piml_tpu_torch/csrc/contact_counts.cu",
             replaces="none: XLA's pair tensor in "
                      "piml_tpu/physics/features.py "
                      "collision_detection_single_frame",
             launches_finetune=ft_launches["contacts"], library_ms=None,
             passes=contact_passes),
        dict(name="mlapm_force", route="cuda",
             source="piml_tpu_torch/csrc/mlapm_force.cu",
             replaces="none: XLA fuses the law's pair arithmetic in "
                      "piml_tpu/models/mlapm.py mlapm_force",
             launches_generate_gc=gen_launches, library_ms=None,
             passes=mlapm_passes),
        dict(name="banded_topk (K2), agent-sharded caller", route="cuda",
             source="piml_tpu_torch/csrc/banded_topk.cu",
             replaces="piml_tpu/parallel/agent_shard.py:286",
             launches=sum(shard["launches_ranks"]), library_ms=None,
             **shard),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
