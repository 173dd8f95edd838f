"""Generator episodes, back to back: a force law stepped over a crowd.

One unit is one episode: one call of the program's generator over
``frames`` frames on a spawn schedule in which every agent spawns at
frame 0, ending in a synchronize.  The traffic's ``engine`` names the
generator (``"mlapm"``: ``piml_tpu_torch.gen.simulate_mlapm`` with the
configuration's law) and ``source`` the crowds (``"uniform"``: ``states``
crowds drawn from the seed by ``inputs.dense_crowds``, one waypoint an
agent; episode ``i`` starts from crowd ``i mod states``).

``check_episodes`` episodes of the window, a uniform sample drawn from
the seed, are generated again by the plain reference
(``reference/mlapm.py``) from the same schedule and compared frame by
frame: positions, and the acceleration ``(v_t − v_{t−1}) / dt`` (the
force ``F`` of the frame's step), taken the same way from both sides'
velocities.  The control (``reference_pairs(..., tf32=True)``) is the
reference with its pair terms in bfloat16: the law has no matrix
product, so TF32 cannot be its lower precision.
"""

from __future__ import annotations

import torch

from benchmark import inputs
from benchmark.reference import mlapm as ref_mlapm
from benchmark.yardstick import compare, pair_law

ENGINES = ("mlapm",)


def law(config: dict) -> ref_mlapm.Law:
    return ref_mlapm.Law(*(float(config[k])
                           for k in ("tau", "A", "B", "C", "D", "theta")))


def acceleration(v0: torch.Tensor, vs: torch.Tensor,
                 dt: float) -> torch.Tensor:
    """``(v_t − v_{t−1}) / dt`` of each frame, ``v_{−1}`` the spawn
    velocity: ``(T, N, 2)``."""
    return torch.diff(torch.cat([v0[None], vs]), dim=0) / dt


def pair_count() -> dict:
    """The program's count of pairs evaluated (none where it keeps no
    such counter)."""
    from piml_tpu_torch.models import mlapm

    pairs = getattr(mlapm, "PAIRS", None)
    return {} if pairs is None else {"mlapm_pairs": pairs.pairs}


class Session:
    kind = "sim"

    def __init__(self, ctx):
        from piml_tpu_torch.gen.socialforce import SpawnSchedule
        from piml_tpu_torch.models.mlapm import MLAPMParams

        self.ctx = ctx
        tr, conf, dev = ctx.traffic, ctx.config, ctx.device
        if tr["engine"] not in ENGINES or tr["source"] != "uniform":
            raise ValueError(f"generate_episodes: engine {tr['engine']!r}, "
                             f"source {tr['source']!r} not supported")
        self.frames = tr["frames"]
        self.law = law(conf)
        self.params = MLAPMParams(version=conf["version"],
                                  **self.law._asdict())
        self.dt = float(conf["dt"])
        self.radius = float(conf["radius"])
        self.arrive = float(conf["arrive_distance"])
        self.agents = tr["agents"]
        c = inputs.dense_crowds(tr, ctx.seed, dev)
        n = self.agents
        self.schedules = [SpawnSchedule(
            spawn_frame=torch.zeros(n, dtype=torch.int32, device=dev),
            position=c["pos"][s], velocity=c["vel"][s],
            waypoints=c["waypoints"][s],
            dest_num=torch.ones(n, dtype=torch.int32, device=dev),
            desired_speed=c["desired_speed"]) for s in range(tr["states"])]
        self.rng = inputs.host_rng(ctx.seed, 4)
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

    # -- the timed unit -----------------------------------------------------

    def _episode(self, record: bool):
        from piml_tpu_torch.gen import mlapm_sim

        i = self.seen
        s = i % len(self.schedules)
        sched = self.schedules[s]
        ps, vs, _ = mlapm_sim.simulate_mlapm(
            self.params, sched, self.frames, dt=self.dt, radius=self.radius,
            arrive_distance=self.arrive, device=self.ctx.device)
        self.seen += 1
        if record:
            self._reservoir(i, s, ps, acceleration(sched.velocity, vs,
                                                   self.dt))

    def _reservoir(self, i, s, p, a):
        item = (i, s, p, a)
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
        now = pair_count()
        return {k: now[k] - self.counter0[k] for k in now}

    def window_flops(self) -> float:
        """The law's work over the frames stepped since the warm-up (the
        window's, read before the traced slice)."""
        return (pair_law.frame_flops(self.agents) * self.frames
                * (self.seen - self.warmup))

    def slice_selection_seconds(self, peaks: dict):
        return None

    def backward_seconds(self):
        return None

    # -- correctness --------------------------------------------------------

    def check(self) -> dict:
        """Free the program's state, then generate each sampled episode
        with the reference and compare every frame."""
        sample = sorted(self.sample)
        self.sample = None
        if self.ctx.dev.cuda:
            torch.cuda.empty_cache()
        return compare.rollout_numbers(self.reference_pairs(sample))

    def reference_pairs(self, sample, tf32: bool = False):
        """``(program, reference)`` per sampled episode; ``tf32``: the
        control, the reference's pair terms in bfloat16."""
        ref_mlapm.fp32_only()
        dtype = torch.bfloat16 if tf32 else torch.float32
        for _, s, p, a in sample:
            sc = self.schedules[s]
            run = ref_mlapm.generate(
                self.law, sc.spawn_frame, sc.position, sc.velocity,
                sc.waypoints, sc.dest_num, sc.desired_speed, self.frames,
                self.dt, self.arrive, pair_dtype=dtype)
            yield ({"p": p, "a": a},
                   {"p": run.p, "a": acceleration(sc.velocity, run.v,
                                                  self.dt)})
