"""Evaluation scoring, back to back: the program's test-time evaluation of
a model on a dense scene.

One unit is one call of ``piml_tpu_torch.engine.simulator.evaluate_rollouts
(model, cfg, [scene], test_flag=True)``: the closed-loop rollout from the
configuration's ``skip_frames`` to the scene's end, then its scores (MSE,
MAE, Sinkhorn OT, MMD, both contact totals), ending in their host read.
The traffic names the scene (``"source": "uniform"``): ``states`` scenes
drawn from the seed, each ``agents`` agents uniform over a square of side
``extent`` with ``obstacles`` points, one uniform waypoint an agent, the
ground truth each agent drifting at its normal initial velocity
(``inputs.dense_windows``' truth) over ``skip_frames + scored_frames``
frames; unit ``i`` scores scene ``i mod states``.

``check_units`` units of the window, a uniform sample drawn from the
seed, are scored again by the plain reference from the same scene: the
rollout by ``reference/crowd.py``, the scores by ``reference/scoring.py``;
``yardstick/compare_scores.py`` compares them.  The control
(``reference_scores(..., tf32=True)``) is the reference with the model's
matrix products in TF32.  ``python3 -m benchmark.calibrate_scoring`` takes
the readings that the limits are set from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers.common import clamped, kernel_counts, neighbor, ref_spec
from benchmark.reference import crowd, scene as ref_scene, scoring
from benchmark.yardstick import compare_scores


def dense_scenes(tr: dict, seed: int, device, frames: int,
                 time_unit: float) -> list:
    """``tr["states"]`` scenes as ``inputs.decode_scene`` gives them: every
    agent present in every frame, velocity constant (0 in the last frame,
    as a finite difference leaves it), acceleration 0."""
    g = inputs.card_generator(seed, device, 5)
    n, ext, T = tr["agents"], float(tr["extent"]), frames
    out = []
    for _ in range(tr["states"]):
        pos0 = torch.rand((n, 2), generator=g, device=device) * ext
        vel0 = torch.randn((n, 2), generator=g, device=device)
        wp = torch.rand((1, n, 2), generator=g, device=device) * ext
        obstacles = torch.rand((tr["obstacles"], 2), generator=g,
                               device=device) * ext
        drift = torch.arange(T, device=device, dtype=torch.float32) * time_unit
        pos = pos0[None] + vel0[None] * drift[:, None, None]
        vel = vel0[None].repeat(T, 1, 1)
        vel[-1] = 0.0
        ones = np.ones((T, n), np.float32)
        mask_v, mask_a = ones.copy(), ones.copy()
        mask_v[-1] = 0.0
        mask_a[-2:] = 0.0
        host = {k: v.cpu().numpy() for k, v in dict(
            position=pos, velocity=vel, waypoints=wp,
            obstacles=obstacles).items()}
        out.append(dict(
            meta_data={"time_unit": time_unit}, position=host["position"],
            velocity=host["velocity"],
            acceleration=np.zeros((T, n, 2), np.float32),
            destination=np.broadcast_to(host["waypoints"][0],
                                        (T, n, 2)).copy(),
            waypoints=host["waypoints"], dest_idx=np.zeros((T, n), np.int64),
            dest_num=np.ones(n, np.int64), obstacles=host["obstacles"],
            mask_p=ones.copy(), mask_v=mask_v, mask_a=mask_a))
    return out


class Session:
    kind = "sim"

    def __init__(self, ctx):
        from piml_tpu_torch.config import PIMLConfig
        from piml_tpu_torch.data import make_time_indexed
        from piml_tpu_torch.models import ModelSpec, build_model
        from piml_tpu_torch.scene import Scene

        self.ctx = ctx
        tr, conf, dev = ctx.traffic, ctx.config, ctx.device
        if tr["source"] != "uniform":
            raise ValueError(f"eval_scoring: source {tr['source']!r}")
        self.settings = dict(conf["settings"])
        self.cfg = PIMLConfig(**self.settings)
        self.scored = tr["scored_frames"]
        frames = self.cfg.skip_frames + self.scored
        self.weights = inputs.load_weights(conf, "rollout", ctx.seed, dev)
        model = build_model(ModelSpec.from_config(self.cfg))
        model.load_state_dict(self.weights)
        self.model = clamped(model.to(dev).eval(), conf.get("clamp"))
        self.arrays = dense_scenes(tr, ctx.seed, dev, frames,
                                   self.cfg.time_unit)
        self.scenes = [make_time_indexed(self.cfg, Scene.from_arrays(a, dev))
                       for a in self.arrays]
        self.rng = inputs.host_rng(ctx.seed, 4)
        self.sample, self.seen = [], 0
        self.keep = tr["check_units"]
        self.recording = False
        self.time_backward = False
        self.failed = 0
        self.slice_units = tr["slice_units"]
        for _ in range(tr["warmup_units"]):
            self._unit(record=False)
        self.counter0 = kernel_counts()

    # -- the timed unit -----------------------------------------------------

    def _unit(self, record: bool):
        from piml_tpu_torch.engine import simulator

        i = self.seen
        s = i % len(self.scenes)
        got = simulator.evaluate_rollouts(self.model, self.cfg,
                                          [self.scenes[s]], test_flag=True)
        self.seen += 1
        if record:
            self._reservoir(i, s, dataclasses.asdict(got))

    def _reservoir(self, i, s, got):
        item = (i, s, got)
        if len(self.sample) < self.keep:
            self.sample.append(item)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.sample[j] = item

    def unit(self) -> dict:
        self._unit(record=not self.recording)
        return {"frames": self.scored}

    # -- readings -----------------------------------------------------------

    def counters(self) -> dict:
        now = kernel_counts()
        return {k: now[k] - self.counter0[k] for k in now}

    def window_flops(self):
        return None

    def slice_selection_seconds(self, peaks: dict):
        return None

    def backward_seconds(self):
        return None

    # -- correctness --------------------------------------------------------

    def check(self) -> dict:
        """Free the program's state, then score each sampled unit with the
        reference and compare."""
        sample = sorted(self.sample, key=lambda x: x[0])
        self.model = self.scenes = self.sample = None
        if self.ctx.dev.cuda:
            torch.cuda.empty_cache()
        return compare_scores.score_numbers(self.reference_scores(sample))

    def reference_scores(self, sample, tf32: bool = False):
        """``(program, reference)`` scores per sampled unit; ``tf32``: the
        control, the reference's model in TF32."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.no_grad():
                for _, s, got in sample:
                    yield got, self._reference_unit(s)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _reference_unit(self, s: int) -> dict:
        ctx, dev = self.ctx, self.ctx.device
        skip, T = self.cfg.skip_frames, self.scored
        nb = neighbor(self.settings)
        tk = inputs.tracks_on(self.arrays[s], dev)
        tm = ref_scene.scene_terms(tk, skip)
        w = slice(skip, skip + T)
        ds = tm["desired_speed"][:, None]
        # the first frame's features are the scene view's, which the
        # program takes for all frames at once on the plain route: the
        # reference's expansion arithmetic at any size (``on_card`` False)
        st = crowd.initial_state(
            tk["position"][skip], tk["velocity"][skip],
            tk["acceleration"][skip], tk["destination"][skip],
            tk["dest_idx"][skip], tk["obstacles"], ds, tk["velocity"][skip],
            nb, False, tm["heading"][skip])
        sp = crowd.spawns_from_track(
            tk["position"][w], tk["velocity"][w], tk["acceleration"][w],
            tk["destination"][w], tk["dest_idx"][w], tk["velocity"][w],
            tk["mask_p"][w], tm["mask_p_pred"][w])
        sim = dict(time_unit=self.cfg.time_unit, retire=True,
                   track_collisions=False, track_labels=False,
                   collision_threshold=self.cfg.collision_threshold,
                   neighbor=nb)
        _, rec = crowd.rollout(self.weights, ref_spec(ctx.config), sim, st,
                               sp, tk["waypoints"], tk["dest_num"],
                               tk["obstacles"], ds, ctx.on_card)
        position = torch.cat([tk["position"][:skip], rec.p])
        return scoring.scores(position, tm["mask_p_pred"], tk["position"],
                              tk["waypoints"], tk["dest_num"], skip,
                              self.cfg.collision_threshold)
