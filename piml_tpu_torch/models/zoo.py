"""The model zoo: the physics-infused PINNSF family and the GNS-style Base
ablations.

Counterpart of ``piml_tpu/models/zoo.py``.  Every model maps
``(ped_features (..., k1, 6), obs_features (..., k2, 6), self_features
(..., 7)[, rng]) → ModelOutput(pred_acc (..., 2), ped_msgs, obs_msgs,
coll_pred)`` through the encoder → processor → decoder → predictor MLP
skeleton, with ``self_features`` = ``[dest_vec(2), hist_velocity(2h),
cur_acc(2), desired_speed(1)]``.  Sub-modules carry the flax names, so
every flax parameter tree converts by name (``models/convert.py``).

Registry names match the reference CLI (src/models/simulators.py:40-106):
``base, base1..base7, base_nd, base_test, pinnsf, pinnsf2, pinnsf_polar,
pinnsf_bottleneck, pinnsf_pb, pinnsf_pbc, pinnsf_bm, pinnsf_m,
pinnsf_res``.

``ModelSpec.compute_dtype`` (``"bfloat16"``) runs the modules the JAX
package gives a dtype in that dtype, with float32 parameters; the modules
it leaves without one (the collision head, the corrector, the Base
self / processor stacks) promote, as flax does (``models/blocks.py``).
The goal force and the outputs stay float32.

The JAX package runs the model once per window channel (``vmap``), where
the heading of a polar model is a rank-2 ``(N, 2)`` array with no
temporal fill; the port calls it on the ``(C, N, ...)`` channel batch,
so the heading is taken without the fill on any rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from piml_tpu_torch.models.blocks import (MLP, AttnPooling, ResDNN, Rng,
                                          activation_fn)
from piml_tpu_torch.physics import heading_direction
from piml_tpu_torch.physics import polar as polar_mod


class ModelOutput(NamedTuple):
    pred_acc: torch.Tensor
    ped_msgs: Optional[torch.Tensor] = None
    obs_msgs: Optional[torch.Tensor] = None
    coll_pred: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static hyper-parameters shared across the zoo."""

    name: str = "pinnsf_m"
    ped_feature_dim: int = 6
    obs_feature_dim: int = 6
    self_feature_dim: int = 7
    encoder_hidden_size: int = 128
    encoder_hidden_layers: int = 3
    processor_hidden_size: int = 128
    processor_hidden_layers: int = 16
    decoder_hidden_size: int = 64
    decoder_hidden_layers: int = 2
    res_hidden_layers: int = 3
    correction_hidden_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.5
    tau: float = 2.0
    time_unit: float = 0.08
    collision_threshold: float = 0.5
    resdnn_chain: bool = False        # True = fixed residual chain (non-compat)
    dest_norm_axis1: bool = False     # reproduce torch.norm(dim=1) on 3-D input
    compute_dtype: Optional[str] = None   # None = float32 everywhere

    @classmethod
    def from_config(cls, cfg: Any, name: Optional[str] = None) -> "ModelSpec":
        return cls(
            name=name or cfg.model,
            ped_feature_dim=cfg.ped_feature_dim,
            obs_feature_dim=cfg.obs_feature_dim,
            self_feature_dim=cfg.self_feature_dim,
            encoder_hidden_size=cfg.encoder_hidden_size,
            encoder_hidden_layers=cfg.encoder_hidden_layers,
            processor_hidden_size=cfg.processor_hidden_size,
            processor_hidden_layers=cfg.processor_hidden_layers,
            decoder_hidden_size=cfg.decoder_hidden_size,
            decoder_hidden_layers=cfg.decoder_hidden_layers,
            res_hidden_layers=cfg.res_hidden_layers,
            correction_hidden_layers=cfg.correction_hidden_layers,
            activation=cfg.activation,
            dropout=cfg.dropout,
            tau=cfg.tau,
            time_unit=cfg.time_unit,
            collision_threshold=cfg.collision_threshold,
            resdnn_chain=not cfg.compat_resdnn_last_block_only,
            dest_norm_axis1=cfg.compat_dest_norm_axis1,
            compute_dtype=cfg.compute_dtype or None,
        )

    @property
    def nn_dtype(self) -> Optional[torch.dtype]:
        if not self.compute_dtype:
            return None
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"compute_dtype {self.compute_dtype!r} is not "
                             "a torch dtype")
        return dt

    @property
    def enc_units(self):
        return tuple(self.encoder_hidden_size
                     for _ in range(self.encoder_hidden_layers))

    @property
    def proc_units(self):
        return tuple((self.processor_hidden_size,)
                     for _ in range(self.processor_hidden_layers))

    @property
    def dec_units(self):
        return tuple(self.decoder_hidden_size
                     for _ in range(self.decoder_hidden_layers))


def goal_acceleration(self_features: torch.Tensor, tau,
                      dest_norm_axis1: bool) -> torch.Tensor:
    """Analytic goal force from self features (reference: model.py:780-787)."""
    desired_speed = self_features[..., -1:]
    dest = self_features[..., :2]
    dim = 1 if (dest_norm_axis1 and self_features.ndim == 3) else -1
    norm = torch.linalg.vector_norm(dest, dim=dim, keepdim=True)
    norm = torch.where(norm == 0, norm + 0.1, norm)
    direction = dest / norm
    velocity = self_features[..., 2:4]
    return (desired_speed * direction - velocity) / tau


def _f32(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.float()


# ---------------------------------------------------------------------------
# PINNSF family
# ---------------------------------------------------------------------------

class PINNSF(nn.Module):
    """Configurable physics-infused model covering the PINNSF family.

    Variant axes (reference classes in src/models/model.py):

    - ``bottleneck``: per-edge 2-D force before pooling
      (PINNSF_bottleneck:1062; the messages are forces);
    - ``polar``: decode in heading-aligned polar coordinates, converted
      back per edge (``"edge"``, pinnsf_pb:1452) or per node (``"node"``,
      pinnsf_polar:795 / pbc:1307);
    - ``collision_head``: per-edge sigmoid collision predictor on the
      decoder embeddings (``"decoder"``, pinnsf_bm:1138) or the processor
      messages (``"processor"``, pinnsf_m:1224);
    - ``collision_rules``: hard rule-based collision handling (pbc:1307);
    - ``corrector``: residual attention-pooled corrector branch on the
      agent encoder's output (PINNSF_residual:973);
    - ``learnable_tau``: PINNSF2's ``τ = 2 + tau_delta`` with a trainable
      zero-initialised scalar (model.py:888), in place of ``spec.tau``.

    Dropout lives on the processors' outputs and is drawn from ``rng``
    (``models/blocks.py``); without it the forward is deterministic."""

    def __init__(self, spec: ModelSpec, bottleneck: bool = False,
                 polar: Optional[str] = None,
                 collision_head: Optional[str] = None,
                 collision_rules: bool = False, corrector: bool = False,
                 learnable_tau: bool = False):
        super().__init__()
        if polar not in (None, "edge", "node"):
            raise ValueError(f"polar {polar!r}")
        if collision_head not in (None, "decoder", "processor"):
            raise ValueError(f"collision_head {collision_head!r}")
        self.spec = s = spec
        self.bottleneck = bottleneck
        self.polar = polar
        self.collision_source = collision_head
        self.collision_rules = collision_rules
        self.corrector = corrector
        act = activation_fn(s.activation)
        dt = s.nn_dtype
        hid, proc = s.encoder_hidden_size, s.processor_hidden_size
        dec = s.decoder_hidden_size
        branches = ["ped"] + (["obs"] if s.obs_feature_dim > 0 else [])
        for b in branches:
            in_dim = s.ped_feature_dim if b == "ped" else s.obs_feature_dim
            self.add_module(f"{b}_encoder", MLP(in_dim, s.enc_units,
                                                dtype=dt))
            self.add_module(f"{b}_processor", ResDNN(
                hid, s.proc_units, act, s.dropout, s.resdnn_chain, dt))
            self.add_module(f"{b}_decoder", MLP(proc, s.dec_units, dtype=dt))
            self.add_module(f"{b}_predictor", MLP(dec, (2,), dtype=dt))
        if corrector:
            res_units = tuple((proc,) for _ in range(s.res_hidden_layers))
            self.corrector_resdnn = ResDNN(hid, res_units, act, s.dropout,
                                           s.resdnn_chain)
            self.corrector_attn = AttnPooling(proc, proc)
            self.corrector_head = MLP(proc, (proc // 2, 2))
        if collision_head is not None:
            # the decoder embeddings, or the messages (2-D forces when
            # bottlenecked)
            src = (dec if collision_head == "decoder"
                   else 2 if bottleneck else proc)
            self.collision_head = MLP(src, (s.dec_units[-1], 1))
        self.learnable_tau = learnable_tau
        if learnable_tau:
            self.tau_delta = nn.Parameter(torch.zeros(()))

    def _branch(self, b: str, features: torch.Tensor, rng: Rng,
                polar_base: Optional[torch.Tensor]):
        """One interaction branch: ``(encoder output, decoder embeddings
        (bottleneck) or None, per-edge messages, summed acceleration)``."""
        enc = getattr(self, f"{b}_encoder")(features)
        emb = getattr(self, f"{b}_processor")(enc, rng)
        decoder = getattr(self, f"{b}_decoder")
        predictor = getattr(self, f"{b}_predictor")
        if self.bottleneck:
            dec_emb = decoder(emb)
            msgs = predictor(dec_emb)                           # ..., k, 2
            if self.polar == "edge":
                msgs = polar_mod.polar_to_cart(
                    msgs, polar_base[..., None, :].expand(msgs.shape))
            acc = msgs.sum(dim=-2)
        else:
            dec_emb, msgs = None, emb
            acc = predictor(decoder(emb.sum(dim=-2)))
        if self.polar == "node":
            acc = polar_mod.polar_to_cart(acc, polar_base)
        return enc, dec_emb, msgs, acc

    def forward(self, ped_features: torch.Tensor, obs_features: torch.Tensor,
                self_features: torch.Tensor, rng: Rng = None) -> ModelOutput:
        s = self.spec
        if self_features.shape[-1] != 7:
            raise ValueError("PINN models take 7 self features "
                             "(no historical velocities; model.py:763)")
        polar_base = None
        if self.polar is not None or self.collision_rules:
            polar_base = heading_direction(self_features[..., -5:-3],
                                           time_axis=False)
        ped_enc, ped_dec, ped_msgs, pred_acc = self._branch(
            "ped", ped_features, rng, polar_base)
        obs_msgs = None
        if s.obs_feature_dim > 0:
            _, _, obs_msgs, obs_acc = self._branch("obs", obs_features, rng,
                                                   polar_base)
            pred_acc = pred_acc + obs_acc

        # the compute dtype stops at the branches: the goal force and
        # everything after it are float32
        tau = 2.0 + self.tau_delta if self.learnable_tau else s.tau
        predictions = pred_acc.float() + goal_acceleration(
            self_features, tau, s.dest_norm_axis1)

        if self.corrector:                    # model.py:1016-1054
            res = self.corrector_resdnn(ped_enc, rng)
            predictions = predictions + self.corrector_head(
                self.corrector_attn(res))
        if self.collision_rules:              # model.py:1383-1444
            predictions = apply_collision_rules(
                predictions, ped_features, self_features,
                s.collision_threshold, s.time_unit)

        coll_pred = None
        if self.collision_source is not None:
            src = ped_dec if self.collision_source == "decoder" else ped_msgs
            coll_pred = torch.sigmoid(self.collision_head(src))[..., 0]
        return ModelOutput(predictions, _f32(ped_msgs), _f32(obs_msgs),
                           _f32(coll_pred))


def apply_collision_rules(predictions: torch.Tensor,
                          ped_features: torch.Tensor,
                          self_features: torch.Tensor,
                          collision_threshold: float,
                          time_unit: float) -> torch.Tensor:
    """Hard rule-based collision handling (reference: model.py:1383-1444).

    Classifies the nearest neighbour inside the reaction radius as head-on
    or chasing, projects out the predicted acceleration's component
    toward it and adds a braking term ``-(v·n)n/Δt``.  Ties in the
    nearest-neighbour search take the first slot, as ``jnp.argmin``
    does."""
    reaction_radius = collision_threshold + 1.34 * 2 * time_unit
    pji = ped_features[..., :2]
    pji = torch.where(torch.isnan(pji), 0.0, pji)
    norm_pji = torch.linalg.vector_norm(pji, dim=-1) + 1e-6       # ..., k
    nji = pji / norm_pji[..., None]
    vi = self_features[..., 2:4]                                   # ..., 2
    vji = ped_features[..., 2:4]                                   # ..., k, 2
    vi_k = vi[..., None, :].expand(vji.shape)
    vj = vji + vi_k

    dtype = predictions.dtype
    collision_flag = ((reaction_radius >= norm_pji)
                      & (norm_pji > 1e-4)).to(dtype)
    inter = (vi_k * pji).sum(dim=-1) * (vj * (-pji)).sum(dim=-1)
    inter = torch.where(torch.isnan(inter), 0.0, inter)
    inter = (inter > 0).to(dtype)
    encounter = collision_flag * inter
    chasing = collision_flag * (1.0 - inter)

    def nearest(flag):
        masked = norm_pji * flag
        masked = torch.where(masked < 1e-4, masked + 100.0, masked)
        idx = torch.argmin(masked, dim=-1)[..., None, None]

        def take(arr):
            return torch.gather(arr, -2, idx.expand(
                idx.shape[:-1] + arr.shape[-1:]))[..., 0, :]
        return take(nji), take(vji)

    # head-on encounters: brake along the collision normal
    nji_c, _ = nearest(encounter)
    has_enc = encounter.sum(dim=-1, keepdim=True) > 0
    ai_c = -(vi * nji_c).sum(dim=-1, keepdim=True) * nji_c / time_unit
    ai_c = ai_c * has_enc
    pred_e = predictions * has_enc
    ai_nji = (pred_e * nji_c).sum(dim=-1, keepdim=True)
    ai_nji = ai_nji * (ai_nji > 0)
    predictions = predictions + (pred_e - ai_nji * nji_c + ai_c)

    # chasing: decelerate only if approaching
    nji_c, vji_c = nearest(chasing)
    has_cha = chasing.sum(dim=-1, keepdim=True) > 0
    ai_c = (vji_c * nji_c).sum(dim=-1, keepdim=True)
    approaching = ai_c < 0
    ai_c_ = ai_c * approaching * nji_c / time_unit * has_cha
    pred_c = predictions * has_cha
    ai_nji = (pred_c * nji_c).sum(dim=-1, keepdim=True)
    ai_nji = ai_nji * (ai_nji > 0) * approaching
    return predictions + (pred_c - ai_nji * nji_c + ai_c_)


class BaseTest(nn.Module):
    """Goal-force baseline (reference: model.py:1538-1609): the analytic
    goal force plus the NN branches the reference also runs and adds.  Its
    second output is the goal force, which the rollout's ``msg_l1`` reads
    as the messages, as in the JAX package."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = s = spec
        act = activation_fn(s.activation)
        dt = s.nn_dtype
        for b in ["ped"] + (["obs"] if s.obs_feature_dim > 0 else []):
            in_dim = s.ped_feature_dim if b == "ped" else s.obs_feature_dim
            self.add_module(f"{b}_encoder", MLP(in_dim, s.enc_units,
                                                dtype=dt))
            self.add_module(f"{b}_processor", ResDNN(
                s.encoder_hidden_size, s.proc_units, act, s.dropout,
                s.resdnn_chain, dt))
            self.add_module(f"{b}_decoder", MLP(s.processor_hidden_size,
                                                s.dec_units, dtype=dt))
            self.add_module(f"{b}_predictor", MLP(s.decoder_hidden_size,
                                                  (2,), dtype=dt))

    def _branch(self, b: str, features: torch.Tensor, rng: Rng):
        emb = getattr(self, f"{b}_processor")(
            getattr(self, f"{b}_encoder")(features), rng)
        return getattr(self, f"{b}_predictor")(
            getattr(self, f"{b}_decoder")(emb.sum(dim=-2)))

    def forward(self, ped_features: torch.Tensor, obs_features: torch.Tensor,
                self_features: torch.Tensor, rng: Rng = None) -> ModelOutput:
        s = self.spec
        pred_acc_dest = goal_acceleration(self_features, s.tau,
                                          s.dest_norm_axis1)
        pred_acc = self._branch("ped", ped_features, rng)
        if s.obs_feature_dim > 0:
            pred_acc = pred_acc + self._branch("obs", obs_features, rng)
        return ModelOutput(pred_acc + pred_acc_dest, pred_acc_dest)


# ---------------------------------------------------------------------------
# GNS-style Base ablations (reference: model.py:122-717)
# ---------------------------------------------------------------------------

class BaseSim(nn.Module):
    """The 9 Base ablations as one configurable module.

    Variant axes mirror model.py:122-717:

    - ``dest_mode``: how self_features[:2] (the destination vector) is
      treated: ``"raw"`` (base/base6), ``"split"`` (base1: separate dest
      and rest encoders), ``"unit"`` (base3/base4/base5: normalised, with
      no guard against a zero vector, as in the reference), ``"unit_norm"``
      (base7: unit + |d|);
    - ``fuse``: ``"node"`` (the self branch is processed apart and joined
      before the decoder) or ``"edge"`` (base2/base5: the self embedding is
      broadcast onto each edge and processed with it, at twice the
      processor width);
    - ``abs_dist``: base6 prepends |rel_pos| to each agent edge row;
    - ``corrector``: BaseNDSimModel's extra ResDNN before the predictor
      (model.py:649-717), the finetune variant of ``base``.

    base4 and base5 take the single self encoder on unit destinations by
    name, as the JAX package does."""

    def __init__(self, spec: ModelSpec, dest_mode: str = "raw",
                 fuse: str = "node", abs_dist: bool = False,
                 corrector: bool = False):
        super().__init__()
        if dest_mode not in ("raw", "split", "unit", "unit_norm"):
            raise NotImplementedError(dest_mode)
        self.spec = s = spec
        self.dest_mode, self.fuse = dest_mode, fuse
        self.abs_dist, self.corrector_on = abs_dist, corrector
        act = activation_fn(s.activation)
        dt = s.nn_dtype
        hid, proc = s.encoder_hidden_size, s.processor_hidden_size
        half = tuple(hid // 2 for _ in range(s.encoder_hidden_layers))
        self.ped_encoder = MLP(s.ped_feature_dim + int(abs_dist), s.enc_units,
                               dtype=dt)
        if s.obs_feature_dim > 0:
            self.obs_encoder = MLP(s.obs_feature_dim, s.enc_units, dtype=dt)
        rest = s.self_feature_dim - 2
        self.single_self = (dest_mode in ("raw", "unit_norm")
                            or dest_mode == "unit"
                            and (fuse == "edge"
                                 or spec.name in ("base4", "base5")))
        if self.single_self:
            self.self_encoder = MLP(
                s.self_feature_dim + int(dest_mode == "unit_norm"),
                s.enc_units)
        else:
            self.self_encoder1 = MLP(2, half)
            self.self_encoder2 = MLP(rest, half)
        width = 2 * proc        # the decoder's input either way
        if fuse == "edge":
            self.ped_processor = ResDNN(
                2 * hid,
                tuple((width,) for _ in range(s.processor_hidden_layers)),
                act, s.dropout, s.resdnn_chain)
        else:
            self.ped_processor = ResDNN(hid, s.proc_units, act, s.dropout,
                                        s.resdnn_chain)
            self.self_processor = ResDNN(hid, s.proc_units, act, s.dropout,
                                         s.resdnn_chain)
        self.ped_decoder = MLP(width, s.dec_units, dtype=dt)
        dec = s.decoder_hidden_size
        if corrector:
            self.corrector = ResDNN(
                dec, tuple((dec, dec) for _ in range(
                    s.correction_hidden_layers)),
                act, s.dropout, s.resdnn_chain)
        self.predictor = MLP(dec, (2,))

    def _self_embedding(self, self_features: torch.Tensor) -> torch.Tensor:
        s = self.spec
        dest, rest = self_features[..., :2], self_features[..., 2:]
        if self.dest_mode in ("unit", "unit_norm"):
            dim = 1 if (s.dest_norm_axis1 and self_features.ndim == 3) else -1
            norm = torch.linalg.vector_norm(dest, dim=dim, keepdim=True)
            dest = dest / norm
        if self.dest_mode == "raw":
            return self.self_encoder(self_features)
        if self.dest_mode == "unit_norm":
            return self.self_encoder(torch.cat([dest, norm, rest], dim=-1))
        if self.single_self:
            return self.self_encoder(torch.cat([dest, rest], dim=-1))
        return torch.cat([self.self_encoder1(dest), self.self_encoder2(rest)],
                         dim=-1)

    def forward(self, ped_features: torch.Tensor, obs_features: torch.Tensor,
                self_features: torch.Tensor, rng: Rng = None) -> ModelOutput:
        s = self.spec
        if self.abs_dist:
            dist = torch.linalg.vector_norm(ped_features[..., :2], dim=-1,
                                            keepdim=True)
            ped_features = torch.cat([dist, ped_features], dim=-1)
        ped_emb = self.ped_encoder(ped_features)
        if s.obs_feature_dim > 0:
            ped_emb = torch.cat([ped_emb, self.obs_encoder(obs_features)],
                                dim=-2)
        self_emb = self._self_embedding(self_features)
        if self.fuse == "edge":
            # torch.cat promotes as jnp.concatenate does
            self_b = self_emb[..., None, :].expand(
                ped_emb.shape[:-1] + self_emb.shape[-1:])
            joint = self.ped_processor(torch.cat([ped_emb, self_b], dim=-1),
                                       rng)
            pooled = joint.sum(dim=-2)
        else:
            ped_emb = self.ped_processor(ped_emb, rng)
            self_emb = self.self_processor(self_emb, rng)
            pooled = torch.cat([ped_emb.sum(dim=-2), self_emb], dim=-1)
        pooled = self.ped_decoder(pooled)
        if self.corrector_on:
            pooled = self.corrector(pooled, rng)
        return ModelOutput(self.predictor(pooled))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def build_model(spec: ModelSpec) -> nn.Module:
    """Model registry by reference name (src/models/simulators.py:40-63)."""
    name = spec.name
    if name == "base":
        return BaseSim(spec)
    if name == "base1":
        return BaseSim(spec, dest_mode="split")
    if name == "base2":
        return BaseSim(spec, dest_mode="split", fuse="edge")
    if name in ("base3", "base4"):
        return BaseSim(spec, dest_mode="unit")
    if name == "base5":
        return BaseSim(spec, dest_mode="unit", fuse="edge")
    if name == "base6":
        return BaseSim(spec, abs_dist=True)
    if name == "base7":
        return BaseSim(spec, dest_mode="unit_norm")
    if name == "base_nd":
        return BaseSim(spec, corrector=True)
    if name == "base_test":
        return BaseTest(spec)
    if name == "pinnsf":
        return PINNSF(spec)
    if name == "pinnsf2":
        return PINNSF(spec, learnable_tau=True)
    if name == "pinnsf_polar":
        return PINNSF(spec, polar="node")
    if name == "pinnsf_bottleneck":
        return PINNSF(spec, bottleneck=True)
    if name == "pinnsf_pb":
        return PINNSF(spec, bottleneck=True, polar="edge")
    if name == "pinnsf_pbc":
        return PINNSF(spec, bottleneck=True, polar="node",
                      collision_rules=True)
    if name == "pinnsf_bm":
        return PINNSF(spec, bottleneck=True, collision_head="decoder")
    if name == "pinnsf_m":
        return PINNSF(spec, collision_head="processor")
    if name == "pinnsf_res":
        return PINNSF(spec, corrector=True)
    raise NotImplementedError(name)


def build_finetune_model(spec: ModelSpec) -> nn.Module:
    """Finetune registry (src/models/simulators.py:78-102): ``base`` swaps
    to the corrector-equipped BaseND; ``pinnsf_res`` (pretrained as plain
    PINNSF) swaps to the residual-corrector PINNSF; every other name
    finetunes the model it pretrained."""
    if spec.name == "base":
        return BaseSim(spec, corrector=True)
    if spec.name == "pinnsf_res":
        return PINNSF(spec, corrector=True)
    return build_model(spec)


def pretrain_model_name(name: str) -> str:
    """Pretraining uses plain PINNSF when the CLI asks for pinnsf_res
    (src/models/simulators.py:44-45)."""
    return "pinnsf" if name == "pinnsf_res" else name
