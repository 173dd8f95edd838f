"""The model zoo: the ``pinnsf_bm`` physics-infused model.

Counterpart of ``piml_tpu/models/zoo.py``.  The call signature is the
zoo's: ``(ped_features (..., k1, 6), obs_features (..., k2, 6),
self_features (..., 7)) → ModelOutput``, with ``self_features`` =
``[dest_vec(2), hist_velocity(2h), cur_acc(2), desired_speed(1)]``.
Only the ``pinnsf_bm`` variant (per-edge bottleneck forces plus the
decoder collision head, reference model.py:1138) is ported so far; the
other variants raise in :func:`build_model` and
:func:`build_finetune_model`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from piml_tpu_torch.models.blocks import MLP, ResDNN, Rng, activation_fn


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
    activation: str = "relu"
    dropout: float = 0.5
    tau: float = 2.0
    resdnn_chain: bool = False        # True = fixed residual chain (non-compat)
    dest_norm_axis1: bool = False     # reproduce torch.norm(dim=1) on 3-D input

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
            activation=cfg.activation,
            dropout=cfg.dropout,
            tau=cfg.tau,
            resdnn_chain=not cfg.compat_resdnn_last_block_only,
            dest_norm_axis1=cfg.compat_dest_norm_axis1,
        )

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


class PINNSF(nn.Module):
    """``pinnsf_bm``: encoder → ResDNN processor → decoder → per-edge 2-D
    force for agents and obstacles, summed over edges, plus the analytic
    goal force; a sigmoid collision head reads the agent decoder
    embeddings (reference: model.py:1062 bottleneck, :1138 pinnsf_bm).
    Dropout lives on the processors' outputs and is drawn from ``rng``
    (see ``models/blocks.py``); without it the forward is deterministic."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = s = spec
        act = activation_fn(s.activation)
        hid = s.encoder_hidden_size
        self.ped_encoder = MLP(s.ped_feature_dim, s.enc_units)
        self.ped_processor = ResDNN(hid, s.proc_units, act, s.dropout,
                                    s.resdnn_chain)
        self.ped_decoder = MLP(s.processor_hidden_size, s.dec_units)
        self.ped_predictor = MLP(s.decoder_hidden_size, (2,))
        if s.obs_feature_dim > 0:
            self.obs_encoder = MLP(s.obs_feature_dim, s.enc_units)
            self.obs_processor = ResDNN(hid, s.proc_units, act, s.dropout,
                                        s.resdnn_chain)
            self.obs_decoder = MLP(s.processor_hidden_size, s.dec_units)
            self.obs_predictor = MLP(s.decoder_hidden_size, (2,))
        self.collision_head = MLP(s.decoder_hidden_size,
                                  (s.dec_units[-1], 1))

    def forward(self, ped_features: torch.Tensor, obs_features: torch.Tensor,
                self_features: torch.Tensor, rng: Rng = None) -> ModelOutput:
        s = self.spec
        if self_features.shape[-1] != 7:
            raise ValueError("PINN models take 7 self features "
                             "(no historical velocities; model.py:763)")
        ped_emb = self.ped_decoder(
            self.ped_processor(self.ped_encoder(ped_features), rng))
        ped_msgs = self.ped_predictor(ped_emb)                  # ..., k1, 2
        pred_acc = ped_msgs.sum(dim=-2)
        obs_msgs = None
        if s.obs_feature_dim > 0:
            obs_emb = self.obs_decoder(
                self.obs_processor(self.obs_encoder(obs_features), rng))
            obs_msgs = self.obs_predictor(obs_emb)
            pred_acc = pred_acc + obs_msgs.sum(dim=-2)
        pred_acc = pred_acc + goal_acceleration(self_features, s.tau,
                                                s.dest_norm_axis1)
        coll_pred = torch.sigmoid(self.collision_head(ped_emb))[..., 0]
        return ModelOutput(pred_acc, ped_msgs, obs_msgs, coll_pred)


def build_model(spec: ModelSpec) -> nn.Module:
    """Model registry by reference name (src/models/simulators.py:40-63);
    the port has ``pinnsf_bm`` so far."""
    if spec.name == "pinnsf_bm":
        return PINNSF(spec)
    raise NotImplementedError(
        f"model {spec.name!r} is not ported to PyTorch yet")


def build_finetune_model(spec: ModelSpec) -> nn.Module:
    """Finetune registry (src/models/simulators.py:78-102): ``pinnsf_bm``
    finetunes the model it pretrained.  ``base`` and ``pinnsf_res`` swap in
    corrector-equipped models, which are not ported yet."""
    if spec.name in ("base", "pinnsf_res"):
        raise NotImplementedError(
            f"finetune model {spec.name!r} is not ported to PyTorch yet")
    return build_model(spec)


def pretrain_model_name(name: str) -> str:
    """Pretraining uses plain PINNSF when the CLI asks for pinnsf_res
    (src/models/simulators.py:44-45)."""
    return "pinnsf" if name == "pinnsf_res" else name
