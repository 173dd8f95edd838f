"""The social-force generator's episodes, back to back, on the Grand Central
scenario.

One unit is one episode: one call of ``piml_tpu_torch.gen.socialforce
.simulate(SFParams(...), schedule, obstacles, frames)`` with the
configuration's knobs, ending in a synchronize (what ``exp/generate.py
--scenario GC --engine socialforce`` calls).  The traffic's keys:
``scenario`` ("GC"), ``schedule_frames`` (the length of the run each
schedule is drawn for), ``capacity`` (the slot count every schedule is
padded to), ``frames`` (stepped an episode, from the schedule's frame 0),
``obstacles`` (the geometry's point count, checked), ``states`` (scenes;
their seeds drawn from ``--seed``, episode ``i`` runs scene ``i mod
states``), ``warmup_episodes``, ``check_episodes``, ``slice_episodes``.

The schedules come from ``benchmark/gc_scenario.py`` (the benchmark's copy
of the numpy sampler) at the configuration's arrival rate, and are padded
to ``capacity`` slots that never spawn (``spawn_frame`` = the schedule's
length), each a copy of slot 0 otherwise: the generator steps every slot
every frame, so every seed does the same work on the same shapes, and
only the scenes differ.

``check_episodes`` episodes of the window, a uniform sample drawn from the
seed, are generated again by the plain reference
(``reference/socialforce.py``) from the same schedule and compared frame
by frame: positions, and the acceleration ``(v_t − v_{t−1}) / time_unit``
taken the same way from both sides' velocities.  The control
(``reference_pairs(..., tf32=True)``) is the reference with its pair terms
in bfloat16: the law has no matrix product, so TF32 cannot be its lower
precision.  The window's sample, the check and the readings without a
source here are ``generate_episodes``' (the session below extends its
session).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gc_scenario, inputs
from benchmark.drivers import generate_episodes
from benchmark.drivers.generate_episodes import acceleration
from benchmark.reference import socialforce as ref_sf
from benchmark.yardstick import sf_law

KNOBS = ("desired_speed_intensity", "pedped_repulsive_intensity",
         "pedped_repulsive_radius", "pedobs_repulsive_intensity",
         "pedobs_repulsive_radius", "oversampling", "max_speed_multiplier",
         "sight_angle_ped", "time_unit", "arrive_distance")
FIELDS = ("spawn_frame", "position", "velocity", "waypoints", "dest_num",
          "desired_speed")


def knobs(config: dict) -> ref_sf.Knobs:
    c = config
    return ref_sf.Knobs(
        float(c["desired_speed_intensity"]),
        float(c["pedped_repulsive_intensity"]),
        float(c["pedped_repulsive_radius"]),
        float(c["pedobs_repulsive_intensity"]),
        float(c["pedobs_repulsive_radius"]), int(c["oversampling"]),
        float(c["max_speed_multiplier"]), float(c["sight_angle_ped"]),
        float(c["time_unit"]), float(c["arrive_distance"]))


def pad(sched: dict, capacity: int, never: int) -> dict:
    """``sched`` padded to ``capacity`` slots: each added slot spawns at
    ``never`` and is otherwise slot 0 (velocity 0)."""
    n = sched["position"].shape[0]
    if n > capacity:
        raise ValueError(f"sf_generate: a schedule of {n} slots exceeds the "
                         f"capacity of {capacity}")
    extra = capacity - n
    out = {}
    for k in FIELDS:
        x = sched[k]
        axis = 1 if k == "waypoints" else 0
        first = np.take(x, [0], axis=axis)
        out[k] = np.concatenate([x, np.repeat(first, extra, axis=axis)],
                                axis=axis)
    out["spawn_frame"][n:] = never
    out["velocity"][n:] = 0.0
    return out


def schedules(tr: dict, config: dict, seed: int):
    """The run's ``states`` padded schedules (numpy) and the obstacle
    points ``(M, 2)`` float32."""
    rng = inputs.host_rng(seed, 6)
    out, obstacles = [], None
    for _ in range(tr["states"]):
        sched, obstacles = gc_scenario.GC(
            tr["schedule_frames"], time_unit=float(config["time_unit"]),
            initial_peds=int(config["initial_peds"]),
            lam_per_s=float(config["lam_per_s"]),
            seed=rng.randrange(2 ** 32))
        out.append(pad(sched, tr["capacity"], tr["schedule_frames"]))
    obstacles = obstacles.astype(np.float32)
    if obstacles.shape[0] != tr["obstacles"]:
        raise ValueError(f"sf_generate: {obstacles.shape[0]} obstacle "
                         f"points, the traffic says {tr['obstacles']}")
    return out, obstacles


def pair_count() -> dict:
    """The program's count of pairs evaluated (none where it keeps no
    such counter)."""
    from piml_tpu_torch.gen import socialforce

    pairs = getattr(socialforce, "PAIRS", None)
    return {} if pairs is None else {"sf_ped_pairs": pairs.ped,
                                     "sf_obs_pairs": pairs.obs}


class Session(generate_episodes.Session):
    def __init__(self, ctx):
        from piml_tpu_torch.gen.socialforce import SFParams, SpawnSchedule

        self.ctx = ctx
        tr, conf, dev = ctx.traffic, ctx.config, ctx.device
        if tr["scenario"] != "GC":
            raise ValueError(f"sf_generate: scenario {tr['scenario']!r} not "
                             "supported")
        self.frames = tr["frames"]
        self.knobs = knobs(conf)
        self.params = SFParams(**{k: conf[k] for k in KNOBS})
        self.dt = float(conf["time_unit"])
        scheds, obstacles = schedules(tr, conf, ctx.seed)
        self.capacity = tr["capacity"]
        self.obstacles = torch.as_tensor(obstacles, device=dev)
        self.schedules = [SpawnSchedule(*(torch.as_tensor(s[k], device=dev)
                                          for k in FIELDS)) for s in scheds]
        self.rng = inputs.host_rng(ctx.seed, 7)
        self.sample, self.seen = [], 0
        self.keep = tr["check_episodes"]
        self.recording = False
        self.time_backward = False
        self.failed = 0
        self.slice_units = tr["slice_episodes"]
        self.warmup = tr["warmup_episodes"]
        for _ in range(self.warmup):
            self._episode(record=False)
        self.counter0 = pair_count()

    def _episode(self, record: bool):
        from piml_tpu_torch.gen import socialforce

        i = self.seen
        s = i % len(self.schedules)
        sched = self.schedules[s]
        ps, vs, _ = socialforce.simulate(self.params, sched, self.obstacles,
                                         self.frames, device=self.ctx.device)
        self.seen += 1
        if record:
            self._reservoir(i, s, ps, acceleration(sched.velocity, vs,
                                                   self.dt))

    def counters(self) -> dict:
        now = pair_count()
        return {k: now[k] - self.counter0[k] for k in now}

    def window_flops(self) -> float:
        """The law's work over the frames stepped since the warm-up (the
        window's, read before the traced slice)."""
        return (sf_law.frame_flops(self.capacity, self.obstacles.shape[0],
                                   self.knobs.oversampling)
                * self.frames * (self.seen - self.warmup))

    def reference_pairs(self, sample, tf32: bool = False):
        """``(program, reference)`` per sampled episode; ``tf32``: the
        control, the reference's pair terms in bfloat16."""
        ref_sf.fp32_only()
        dtype = torch.bfloat16 if tf32 else torch.float32
        for _, s, p, a in sample:
            sc = self.schedules[s]
            run = ref_sf.generate(
                self.knobs, sc.spawn_frame, sc.position, sc.velocity,
                sc.waypoints, sc.dest_num, sc.desired_speed, self.obstacles,
                self.frames, pair_dtype=dtype)
            yield ({"p": p, "a": a},
                   {"p": run.p, "a": acceleration(sc.velocity, run.v,
                                                  self.dt)})
