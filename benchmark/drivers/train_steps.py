"""BPTT finetune steps, back to back.

One unit is one optimizer step: ``engine.simulator.training_rollout_loss``
of a batch of windows, ``backward``, and the step of
``train.trainer.make_optimizer(cfg, model, finetune=True)`` (Adam), with
the loss read on the host once, as the trainer does.  Dropout is live at
the configuration's rate, its ``(windows, frames)`` seeds drawn for each
step from the run's seed.  The traffic names the windows:

- ``"source": "uniform"``: a pool of ``batches`` batches drawn from the
  seed (``inputs.dense_windows``), cycled;
- ``"source": "scene"``: ``batches`` batches of ``windows`` windows of
  ``frames`` frames of the recorded scene, their starts drawn from the
  seed in ``[start_min, last]``, cycled.

Set-up builds the model and the optimizer once and drives them through
the first ``checked_steps`` steps, on batches that all differ; the same
objects then run the window.  The reference follows those first steps
from the same weights, batches and seeds: each step's loss, the first
gradient as the optimizer took it (read from its first moment), and the
parameters' change over the steps.
"""

from __future__ import annotations

import torch

from benchmark import inputs
from benchmark.drivers.common import clamped, kernel_counts, neighbor, ref_spec
from benchmark.reference import crowd, scene as ref_scene
from benchmark.yardstick import compare, flops, selection


# the reference batch's entries with a leading window axis
WINDOWED = ("position", "velocity", "acceleration", "destination", "dest_idx",
            "hist_v", "mask_p", "mask_p_pred", "labels_p", "heading0")


class Session:
    kind = "train"

    def __init__(self, ctx):
        from piml_tpu_torch.config import PIMLConfig
        from piml_tpu_torch.models import ModelSpec, build_finetune_model
        from piml_tpu_torch.train.trainer import make_optimizer

        self.ctx = ctx
        tr, conf, dev = ctx.traffic, ctx.config, ctx.device
        self.settings = dict(conf["settings"])
        self.cfg = PIMLConfig(**self.settings)
        self.weights = inputs.load_weights(conf, "finetune", ctx.seed, dev)
        model = build_finetune_model(ModelSpec.from_config(self.cfg))
        model.load_state_dict(self.weights)
        self.model = model.to(dev).train()
        self.fn = clamped(self.model, conf.get("clamp"))
        self.opt = make_optimizer(self.cfg, self.model, finetune=True)
        self.seed_gen = torch.Generator().manual_seed(int(ctx.seed) % 2 ** 63)
        self.recording, self.recorded = False, []
        self.time_backward, self.events = False, []
        self.failed, self.done = 0, 0
        self.live_frames = 0.0
        self.slice_units = tr["slice_steps"]
        if tr["source"] == "uniform":
            self.raw = inputs.dense_windows(tr, ctx.seed, dev)
            self.batches = [self._dense_batch(b) for b in self.raw]
        else:
            self._scene_batches()
        self.live = [self._live_agent_frames(b) for b in self.batches]
        self._first_steps(tr["checked_steps"])
        self.counter0 = kernel_counts()

    # -- set-up -------------------------------------------------------------

    def _dense_batch(self, b):
        """The program's batch: frame-0 features from the program's own
        channel-batched feature pass, the tracks as drawn."""
        from piml_tpu_torch.data import ChanneledData
        from piml_tpu_torch.data.views import neighbor_config
        from piml_tpu_torch.physics import heading_direction, relative_features

        C, T, n = b["position"].shape[:3]
        vel0, acc0 = b["velocity"][:, 0], b["acceleration"][:, 0]
        with torch.no_grad():
            pf0, of0, df0 = relative_features(
                b["position"][:, 0], vel0, acc0, b["destination"][:, 0],
                b["obstacles"], neighbor_config(self.cfg),
                heading=heading_direction(vel0, time_axis=False), batched=True)
        ds = b["desired_speed"][None, :, None].expand(C, n, 1)
        sf0 = torch.cat([df0, vel0, acc0, ds], dim=-1)

        def tile(x):
            return x[:, None].expand((C, T) + x.shape[1:])

        ones = b["mask_p"]
        labels = torch.cat([b["labels_p"], b["velocity"], b["acceleration"],
                            torch.zeros((C, T, n, 1), device=ones.device)], -1)
        return ChanneledData(
            ped_features=tile(pf0), obs_features=tile(of0),
            self_features=tile(sf0), labels=labels, mask_p=ones, mask_v=ones,
            mask_a=ones, mask_p_pred=b["mask_p_pred"], mask_v_pred=ones,
            mask_a_pred=ones, position=b["position"], velocity=b["velocity"],
            acceleration=b["acceleration"], destination=b["destination"],
            dest_idx=b["dest_idx"], abnormal_mask=b["abnormal_mask"],
            dest_num=b["dest_num"], waypoints=b["waypoints"],
            obstacles=b["obstacles"], desired_speed=b["desired_speed"],
            meta_data={"time_unit": self.cfg.time_unit})

    def _scene_batches(self):
        from piml_tpu_torch.data import make_time_indexed, to_channeled
        from piml_tpu_torch.scene import Scene

        ctx, tr, dev = self.ctx, self.ctx.traffic, self.ctx.device
        arrays = inputs.decode_scene(tr["scene"], tr.get("scene_frames"),
                                     self.cfg.time_unit)
        self.arrays = arrays
        T = tr["frames"]
        data = make_time_indexed(self.cfg, Scene.from_arrays(arrays, dev))
        windows = to_channeled(data, T, "slice")
        last = data.num_frames - T - 1
        self.starts = [inputs.draw_starts(ctx.seed, 10 + b, tr["start_min"],
                                          last + 1, tr["windows"])
                       for b in range(tr["batches"])]
        self.batches = [windows.slice_channels(s) for s in self.starts]
        del windows, data

    @staticmethod
    def _live_agent_frames(b) -> float:
        """Agent-frames the rollout carries: present at a window's frame 0
        or teleported in since (no agent retires in training)."""
        present = ~torch.isnan(b.position[:, 0, :, 0])
        total = present.sum()
        new = (b.mask_p - b.mask_p_pred) == 1
        for t in range(1, b.position.shape[1]):
            present = present | new[:, t]
            total = total + present.sum()
        return float(total)

    def _seeds(self):
        C, T = self.batches[0].position.shape[:2]
        return torch.randint(0, 2 ** 62, (C, T), generator=self.seed_gen)

    def _first_steps(self, n: int):
        """The first steps, whose readings the reference follows."""
        params = dict(self.model.named_parameters())
        theta0 = {k: p.detach().clone() for k, p in params.items()}
        self.first = {"losses": [], "seeds": []}
        b1 = self.opt.param_groups[0]["betas"][0]
        for i in range(n):
            seeds = self._seeds()
            self.first["seeds"].append(seeds)
            self.first["losses"].append(self._step(self.batches[i % len(self.batches)],
                                                   seeds))
            if i == 0:
                self.first["grad_norms"] = {
                    k: self._first_moment_norm(p, b1) for k, p in params.items()}
        self.first["change_norms"] = {
            k: float(torch.linalg.vector_norm(p.detach() - theta0[k]))
            for k, p in params.items()}
        self.done = n

    def _first_moment_norm(self, p, b1: float) -> float:
        """The norm of the gradient Adam took at its first step, read back
        from its first moment; NaN where the optimizer kept none."""
        m = self.opt.state.get(p, {}).get("exp_avg")
        if m is None:
            return float("nan")
        return float(torch.linalg.vector_norm(m / (1 - b1)))

    # -- the timed unit -----------------------------------------------------

    def _step(self, batch, seeds) -> float:
        from piml_tpu_torch.engine import training_rollout_loss

        out = training_rollout_loss(self.fn, self.cfg, batch, seeds=seeds)
        self.opt.zero_grad(set_to_none=True)
        if self.time_backward and self.ctx.dev.cuda:
            ev0, ev1 = self.ctx.dev.event(), self.ctx.dev.event()
            ev0.record()
            out.loss.backward()
            ev1.record()
            self.events.append((ev0, ev1))
        else:
            out.loss.backward()
        self.opt.step()
        return out.loss.item()

    def unit(self) -> dict:
        i = self.done
        batch = self.batches[i % len(self.batches)]
        loss = self._step(batch, self._seeds())
        if loss != loss or abs(loss) == float("inf"):
            self.failed += 1
        if self.recording:
            self.recorded.append(i % len(self.batches))
        else:
            self.live_frames += self.live[i % len(self.batches)]
        self.done += 1
        return {"steps": 1}

    # -- readings -----------------------------------------------------------

    def counters(self) -> dict:
        now = kernel_counts()
        return {k: now[k] - self.counter0[k] for k in now}

    def window_flops(self) -> float:
        nb = neighbor(self.settings)
        return flops.train_step(self.ctx.config["widths"], nb["topk_ped"],
                                nb["topk_obs"], self.live_frames)

    def slice_selection_seconds(self, peaks: dict):
        """The least time of the slice's selections: each window's frame
        selected once (positions: the batch's drifting tracks, which the
        rollout follows within its clipped accelerations)."""
        nb = neighbor(self.settings)
        costs = []
        for j in self.recorded:
            b = self.batches[j]
            for c in range(b.position.shape[0]):
                for t in range(b.position.shape[1]):
                    costs += selection.frame_costs(b.position[c, t],
                                                   b.obstacles, nb)
        if not costs:
            return None
        return selection.least_seconds(costs, peaks)

    def backward_seconds(self):
        if not self.events:
            return None
        self.ctx.dev.sync()
        return [a.elapsed_time(b) * 1e-3 for a, b in self.events]

    # -- correctness --------------------------------------------------------

    def check(self) -> dict:
        """Free the program's state, then follow the first steps with the
        reference and compare."""
        self.model = self.fn = self.opt = self.batches = None
        if self.ctx.dev.cuda:
            torch.cuda.empty_cache()
        return compare.training_numbers(self.first, self.reference_steps())

    def reference_steps(self, tf32: bool = False, fault: str = "") -> dict:
        """The reference's readings of the first steps.  ``tf32``: its
        matrix products in TF32 (the control).  ``fault`` plants one in
        the reference put in the program's place: ``"half"`` leaves out
        half of each batch's windows and scales the loss of the rest up
        to their mean; ``"altered"`` doubles one leaf's gradient."""
        ctx, conf = self.ctx, self.ctx.config
        st = self.settings
        spec = ref_spec(conf, dropout=st["dropout"])
        sim = dict(time_unit=st["time_unit"], retire=False,
                   track_collisions=True,
                   track_labels=st["collision_pred_weight"] > 0,
                   collision_threshold=st["collision_threshold"],
                   neighbor=neighbor(st))
        loss_cfg = {k: st[k] for k in (
            "time_decay", "reg_weight", "collision_loss_weight",
            "hard_collision_penalty", "collision_pred_weight",
            "collision_loss_version")}
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self.weights.items()}
        theta0 = {k: v.detach().clone() for k, v in params.items()}
        adam = crowd.Adam(params, lr=st["learning_rate"] * st["finetune_lr_decay"],
                          wd=st["weight_decay"] * st.get("finetune_wd_aug", 1.0))
        out = {"losses": []}
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for i, seeds in enumerate(self.first["seeds"]):
                batch = self._reference_batch(i)
                if fault == "half":
                    keep = max(1, seeds.shape[0] // 2)
                    batch = {k: (v[:keep] if k in WINDOWED else v)
                             for k, v in batch.items()}
                    seeds = seeds[:keep]
                loss = crowd.bptt_loss(params, spec, loss_cfg, sim, batch,
                                       seeds, ctx.on_card)
                if fault == "half":
                    loss = loss * (self.first["seeds"][i].shape[0] / keep)
                names = list(params)
                grads = list(torch.autograd.grad(loss, [params[k] for k in names]))
                if fault == "altered":
                    grads[0] = grads[0] * 2.0
                taken = adam.step(dict(zip(names, grads)))
                out["losses"].append(loss.item())
                if i == 0:
                    out["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                                         for k, g in taken.items()}
                del loss, grads, batch
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        out["change_norms"] = {k: float(torch.linalg.vector_norm(
            params[k].detach() - theta0[k])) for k in params}
        return out

    def _reference_batch(self, i: int) -> dict:
        """The ``i``-th batch's raw tracks for the reference, which works
        out every derived quantity itself."""
        tr = self.ctx.traffic
        if tr["source"] == "uniform":
            b = dict(self.raw[i % len(self.raw)])
            b["hist_v"] = b["velocity"]
            return b
        if not hasattr(self, "tracks"):
            self.tracks = inputs.tracks_on(self.arrays, self.ctx.device)
            self.terms = ref_scene.scene_terms(self.tracks, self.cfg.skip_frames)
        tk, tm = self.tracks, self.terms
        starts = self.starts[i % len(self.starts)]
        T = tr["frames"]

        def win(x):
            return torch.stack([x[s:s + T] for s in starts])

        return dict(
            position=win(tk["position"]), velocity=win(tk["velocity"]),
            acceleration=win(tk["acceleration"]),
            destination=win(tk["destination"]), dest_idx=win(tk["dest_idx"]),
            hist_v=win(tk["velocity"]), mask_p=win(tk["mask_p"]),
            mask_p_pred=win(tm["mask_p_pred"]), labels_p=win(tk["position"]),
            heading0=torch.stack([tm["heading"][s] for s in starts]),
            waypoints=tk["waypoints"], dest_num=tk["dest_num"],
            obstacles=tk["obstacles"], desired_speed=tm["desired_speed"],
            abnormal_mask=tm["abnormal_mask"])
