"""Closed-loop rollout episodes, back to back.

One unit is one episode: one call of the program's rollout entry over
``frames`` frames, ending in a synchronize.  The traffic names the scene:

- ``"source": "uniform"``: ``states`` crowds drawn from the seed
  (``inputs.dense_crowds``); episode ``i`` starts from crowd ``i mod
  states`` through ``piml_tpu_torch.engine.rollout.rollout`` with no
  teleport-in, retiring agents on arrival;
- ``"source": "scene"``: the recorded scene ``scene`` cut to
  ``scene_frames``; episode ``i`` rolls out ``frames`` frames from the
  ``i``-th start of a fixed grid (every ``start_stride`` frames from
  ``start_min``), visited in an order drawn from the seed, through
  ``piml_tpu_torch.engine.simulator.eval_rollout`` on
  ``data.views.slice_frames`` of the scene's time-indexed view, with
  ground-truth teleport-in and retirement.

``check_episodes`` episodes of the window, a uniform sample drawn from
the seed (reservoir sampling), are rolled out again by the reference
from the same inputs and compared frame by frame.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import torch

from benchmark import inputs
from benchmark.drivers.common import clamped, kernel_counts, neighbor, ref_spec
from benchmark.reference import crowd, scene as ref_scene
from benchmark.yardstick import compare, flops, selection


class Session:
    kind = "sim"

    def __init__(self, ctx):
        from piml_tpu_torch.config import PIMLConfig
        from piml_tpu_torch.models import ModelSpec, build_model

        self.ctx = ctx
        tr, conf = ctx.traffic, ctx.config
        dev = ctx.device
        self.frames = tr["frames"]
        self.settings = dict(conf["settings"])
        self.cfg = PIMLConfig(**self.settings)
        self.weights = inputs.load_weights(conf, "rollout", ctx.seed, dev)
        model = build_model(ModelSpec.from_config(self.cfg))
        model.load_state_dict(self.weights)
        self.model = clamped(model.to(dev).eval(), conf.get("clamp"))
        self.rng = inputs.host_rng(ctx.seed, 4)
        self.sample, self.seen = [], 0
        self.keep = tr["check_episodes"]
        self.live = torch.zeros((), dtype=torch.float64, device=dev)
        self.recording, self.recorded = False, []
        self.time_backward = False
        self.failed = 0
        self.slice_units = tr["slice_episodes"]
        if tr["source"] == "uniform":
            self._setup_uniform()
        else:
            self._setup_scene()
        for _ in range(tr["warmup_episodes"]):
            self._episode(record=False)
        self.counter0 = kernel_counts()

    # -- set-up -------------------------------------------------------------

    def _setup_uniform(self):
        from piml_tpu_torch.engine import EngineConfig, SpawnFrame, init_state
        from piml_tpu_torch.data.views import neighbor_config
        from piml_tpu_torch.physics import relative_features

        ctx, tr, dev = self.ctx, self.ctx.traffic, self.ctx.device
        self.crowds = inputs.dense_crowds(tr, ctx.seed, dev)
        c = self.crowds
        n, T = tr["agents"], self.frames
        self.ncfg = neighbor_config(self.cfg)
        self.ecfg = EngineConfig(neighbor=self.ncfg, time_unit=self.cfg.time_unit,
                                 lagged=self.cfg.compat_lagged_euler,
                                 retire_on_arrival=True)
        ds = c["desired_speed"][:, None]
        acc0 = torch.zeros((n, 2), device=dev)
        self.states = []
        with torch.inference_mode():
            for s in range(tr["states"]):
                pos, vel, dest = c["pos"][s], c["vel"][s], c["waypoints"][s, 0]
                pf, of, df = relative_features(pos, vel, acc0, dest,
                                               c["obstacles"], self.ncfg)
                sf = torch.cat([df, vel, acc0, ds], dim=-1)
                self.states.append(init_state(
                    pos, vel, acc0, dest,
                    torch.zeros(n, dtype=torch.int32, device=dev),
                    pf, of, sf))
            z2 = torch.zeros((T, n, 2), device=dev)
            self.spawns = SpawnFrame(
                new=torch.zeros((T, n), device=dev), p=z2, v=z2, a=z2, dest=z2,
                dest_idx=torch.zeros((T, n), dtype=torch.int32, device=dev),
                hist_v=z2)
        self.dest_num = torch.ones(n, dtype=torch.int32, device=dev)
        self.ds = ds
        self.order = None

    def _setup_scene(self):
        from piml_tpu_torch.data import make_time_indexed
        from piml_tpu_torch.engine.simulator import engine_config
        from piml_tpu_torch.scene import Scene

        ctx, tr, dev = self.ctx, self.ctx.traffic, self.ctx.device
        arrays = inputs.decode_scene(tr["scene"], tr.get("scene_frames"),
                                     self.cfg.time_unit)
        self.arrays = arrays
        self.data = make_time_indexed(self.cfg, Scene.from_arrays(arrays, dev))
        self.ecfg = engine_config(self.cfg, retire=True, track_collisions=False,
                                  track_labels=False)
        last = self.data.num_frames - self.frames
        starts = list(range(tr["start_min"], last + 1, tr["start_stride"]))
        random.Random(ctx.seed).shuffle(starts)
        self.order = starts

    # -- the timed unit -----------------------------------------------------

    def _episode(self, record: bool):
        i = self.seen
        if self.order is None:
            from piml_tpu_torch.engine import rollout

            s = i % len(self.states)
            final, outs = rollout(self.model, self.ecfg, self.states[s],
                                  self.spawns, self.crowds["waypoints"][s],
                                  self.dest_num, self.crowds["obstacles"],
                                  self.ds)
            last_p = final.p
        else:
            from piml_tpu_torch.data.views import slice_frames
            from piml_tpu_torch.engine import eval_rollout

            s = self.order[i % len(self.order)]
            res = eval_rollout(self.model, self.ecfg,
                               slice_frames(self.data, s, s + self.frames), 0)
            outs = SimpleNamespace(p=res.position, a=res.acceleration,
                                   mask=res.mask_p)
            last_p = None
        self.seen += 1
        if record:
            self.live += outs.mask.sum(dtype=torch.float64)
            self._reservoir(i, s, outs)
        if self.recording:
            self.recorded.append((outs.p, last_p, s))
        return outs

    def _reservoir(self, i, s, outs):
        item = (i, s, outs.p, outs.a)
        if len(self.sample) < self.keep:
            self.sample.append(item)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.sample[j] = item

    def unit(self) -> dict:
        self._episode(record=not self.recording)
        return {"frames": self.frames}

    # -- readings -----------------------------------------------------------

    def counters(self) -> dict:
        now = kernel_counts()
        return {k: now[k] - self.counter0[k] for k in now}

    def window_flops(self) -> float:
        nb = neighbor(self.settings)
        return flops.forward(self.ctx.config["widths"], nb["topk_ped"],
                             nb["topk_obs"], float(self.live))

    def slice_selection_seconds(self, peaks: dict):
        """The least time of the slice's selection passes: each step
        selects for the next frame's positions."""
        nb = neighbor(self.settings)
        obstacles = (self.crowds["obstacles"] if self.order is None
                     else self.data.obstacles)
        costs = []
        for p, last_p, _ in self.recorded:
            frames = list(p[1:]) + ([last_p] if last_p is not None else [])
            for pos in frames:
                costs += selection.frame_costs(pos, obstacles, nb)
        if not costs:
            return None
        return selection.least_seconds(costs, peaks)

    def backward_seconds(self):
        return None

    # -- correctness --------------------------------------------------------

    def check(self) -> dict:
        """Free the program's state, then roll out each sampled episode
        with the reference and compare every frame."""
        sample = sorted(self.sample)
        self.model = self.states = self.data = self.recorded = None
        self.sample = None
        if self.ctx.dev.cuda:
            torch.cuda.empty_cache()
        return compare.rollout_numbers(self.reference_pairs(sample))

    def reference_pairs(self, sample, tf32: bool = False):
        ctx = self.ctx
        spec = ref_spec(ctx.config)
        sim = dict(time_unit=self.cfg.time_unit, retire=True,
                   track_collisions=False, track_labels=False,
                   collision_threshold=self.cfg.collision_threshold,
                   neighbor=neighbor(self.settings))
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.no_grad():
                for _, s, p, a in sample:
                    ref = self._reference_episode(spec, sim, s)
                    yield {"p": p, "a": a}, ref
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _reference_episode(self, spec, sim, s):
        ctx, dev, T = self.ctx, self.ctx.device, self.frames
        nb = sim["neighbor"]
        if self.order is None:
            c = self.crowds
            n = c["pos"].shape[1]
            pos, vel = c["pos"][s], c["vel"][s]
            acc0 = torch.zeros((n, 2), device=dev)
            ds = c["desired_speed"][:, None]
            st = crowd.initial_state(pos, vel, acc0, c["waypoints"][s, 0],
                                     torch.zeros(n, dtype=torch.int32,
                                                 device=dev),
                                     c["obstacles"], ds, vel, nb, ctx.on_card)
            z2 = torch.zeros((T, n, 2), device=dev)
            sp = crowd.Spawn(torch.zeros((T, n), device=dev), z2, z2, z2, z2,
                             torch.zeros((T, n), dtype=torch.int32, device=dev),
                             z2)
            _, rec = crowd.rollout(self.weights, spec, sim, st, sp,
                                   c["waypoints"][s],
                                   torch.ones(n, dtype=torch.int32, device=dev),
                                   c["obstacles"], ds, ctx.on_card)
        else:
            if not hasattr(self, "tracks"):
                self.tracks = inputs.tracks_on(self.arrays, dev)
                self.terms = ref_scene.scene_terms(self.tracks,
                                                   self.cfg.skip_frames)
            tk, tm = self.tracks, self.terms
            w = slice(s, s + T)
            ds = tm["desired_speed"][:, None]
            st = crowd.initial_state(
                tk["position"][s], tk["velocity"][s], tk["acceleration"][s],
                tk["destination"][s], tk["dest_idx"][s], tk["obstacles"], ds,
                tk["velocity"][s], nb, ctx.on_card, tm["heading"][s])
            sp = crowd.spawns_from_track(
                tk["position"][w], tk["velocity"][w], tk["acceleration"][w],
                tk["destination"][w], tk["dest_idx"][w], tk["velocity"][w],
                tk["mask_p"][w], tm["mask_p_pred"][w])
            _, rec = crowd.rollout(self.weights, spec, sim, st, sp,
                                   tk["waypoints"], tk["dest_num"],
                                   tk["obstacles"], ds, ctx.on_card)
        return {"p": rec.p, "a": rec.a}
