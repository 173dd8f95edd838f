"""YAML-driven dataset orchestration and training batches.

Counterpart of ``piml_tpu/data/datasets.py`` (reference:
src/data/dataset.py).  A data config YAML maps split names (train / valid /
test / vis) to lists of v2.2 ``.npy`` paths; the orchestrators build every
view on one device:

- :class:`PointwiseDataset` (dataset.py:106): the pretrain path, train and
  valid as pointwise rows, test time-indexed;
- :class:`FinetuneDataset` (dataset.py:312, with dataset.py:399's
  time-indexed validation): train as ``'slice'`` windows, valid and test
  time-indexed;
- :class:`RatioSplitDataset` (dataset.py:208-255): one scene split by
  frame-index ratio;
- :class:`SceneListSplitDataset` (dataset.py:155-206): a list of scenes
  split by scene index;
- :class:`OnlyTrainingDataset` (dataset.py:256-310): pointwise train,
  channeled validation windows when finetuning;
- :class:`VisDataset` (dataset.py:423): every split time-indexed.

Feature dims are published back onto the config (dataset.py:144-146).
The JAX package's ``stacked_channel_batches`` exists only to feed its
finetune epoch, one ``lax.scan`` over stacked batches; the port's trainer
loops over :func:`channel_batches` instead.  ``polar=True`` builds the
polar views (``*Polar`` classes, dataset.py:454, :503).
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data.views import (ChanneledData, PointwiseData,
                                       TimeIndexedData, make_time_indexed,
                                       merge_pointwise, pad_agents,
                                       slice_frames, to_channeled,
                                       to_pointwise)
from piml_tpu_torch.scene import Scene, mirror, random_walk_noise, rotate

Device = Union[str, torch.device]


def load_scenes(data_config_path: str, device: Device = "cuda:0"
                ) -> Dict[str, List[Scene]]:
    """Read the split → paths YAML and decode every scene onto ``device``
    (reference: dataset.py:45-53).  Relative paths are tried as given and
    beside the YAML file."""
    # PyYAML is imported here only: a host without it can still run
    # everything that reads no YAML
    import yaml

    with open(data_config_path) as f:
        split_paths = yaml.safe_load(f)
    scenes: Dict[str, List[Scene]] = defaultdict(list)
    base = os.path.dirname(os.path.abspath(data_config_path))
    for split, paths in split_paths.items():
        for path in paths:
            if not os.path.isabs(path):
                for cand in (path, os.path.join(base, path)):
                    if os.path.exists(cand):
                        path = cand
                        break
            scenes[split].append(Scene.load(path, device=device))
    return dict(scenes)


def augment_scenes(scenes: List[Scene],
                   thetas: Optional[Sequence[float]] = None,
                   mirrors: Optional[Sequence[float]] = None) -> List[Scene]:
    """Rotation / mirror augmentation (reference: dataset.py:55-72)."""
    out = list(scenes)
    for s in scenes:
        out.extend(rotate(s, th) for th in thetas or [])
        out.extend(mirror(s, th) for th in mirrors or [])
    return out


def _parse_floats(s: str) -> List[float]:
    return [float(x) for x in s.split(",") if x.strip()] if s else []


def apply_config_augmentation(raw: Dict[str, List[Scene]],
                              cfg: PIMLConfig) -> Dict[str, List[Scene]]:
    """The config's rotate / mirror augmentation of the named splits
    (reference: BaseDataset.data_augmentation, dataset.py:68-73)."""
    thetas = _parse_floats(cfg.augment_thetas)
    mirrors = _parse_floats(cfg.augment_mirrors)
    if not thetas and not mirrors:
        return raw
    out = dict(raw)
    for split in (s.strip() for s in cfg.augment_splits.split(",")):
        if split in out:
            out[split] = augment_scenes(out[split], thetas, mirrors)
    return out


def perturb_velocity(scene: Scene, std: float, seed: int) -> Scene:
    """Random-walk velocity perturbation (reference: dataset.py:222-228,
    src/functions/noises.py:9-19).  The noise is drawn on the CPU from
    ``seed``, so a seed gives the same scene on every device; features and
    labels are rebuilt from the perturbed velocities."""
    gen = torch.Generator().manual_seed(seed)
    noise = random_walk_noise(gen, scene.velocity, scene.mask_v, std)
    return dataclasses.replace(scene, velocity=scene.velocity + noise)


def _maybe_noisy(scene: Scene, cfg: PIMLConfig, idx: int) -> Scene:
    if not cfg.add_noise_flag:
        return scene
    return perturb_velocity(scene, cfg.add_noise_std, cfg.seed + idx)


def split_train_val_test(n: int, train_ratio: float, val_ratio: float,
                         test_ratio: float, seed: int, shuffle: bool = False):
    """Frame-index ratio split (reference: dataset.py:75-95), including
    the reference's ``shuffle`` branch that permutes only the first
    ``int(n * val_ratio)`` indices; the test block is the contiguous
    tail."""
    if abs(train_ratio + val_ratio + test_ratio - 1.0) > 1e-9:
        raise ValueError("illegal train valid test split!")
    idx_all = np.arange(n)
    if shuffle:
        head = int(n * val_ratio)
        idx_all[:head] = np.random.RandomState(seed).permutation(head)
    n_train = int(n * train_ratio)
    n_val = int(n * (train_ratio + val_ratio))
    return idx_all[:n_train], idx_all[n_train:n_val], idx_all[n_val:]


def _check_time_unit(scenes: Dict[str, List[Scene]]) -> float:
    units = {s.time_unit for split in scenes.values() for s in split}
    if len(units) != 1:
        raise ValueError(f"inconsistent time units: {units}")
    return units.pop()


def _publish_dims(cfg: PIMLConfig, data: TimeIndexedData) -> PIMLConfig:
    p, o, s = data.feature_dims
    return cfg.replace(ped_feature_dim=p, obs_feature_dim=o,
                       self_feature_dim=s)


class _Orchestrator:
    """Raw scenes of a data config, decoded onto ``device``."""

    def __init__(self, polar: bool = False, device: Device = "cuda:0"):
        self.polar = polar
        self.device = device
        self.raw: Dict[str, List[Scene]] = {}

    def load_data(self, data_config_path: str) -> None:
        self.raw = load_scenes(data_config_path, self.device)

    def _raw(self, cfg: PIMLConfig, augment: bool = True):
        if not self.raw:
            raise RuntimeError("must load raw data before build_dataset")
        raw = apply_config_augmentation(self.raw, cfg) if augment \
            else self.raw
        return raw, cfg.replace(time_unit=_check_time_unit(raw))


class PointwiseDataset(_Orchestrator):
    """The pretrain path: pointwise train / valid, time-indexed test."""

    def __init__(self, polar: bool = False, device: Device = "cuda:0"):
        super().__init__(polar, device)
        self.train_data: Optional[PointwiseData] = None
        self.valid_data: Optional[PointwiseData] = None
        self.test_data: List[TimeIndexedData] = []

    def build_dataset(self, cfg: PIMLConfig) -> PIMLConfig:
        raw, cfg = self._raw(cfg)
        dataset: Dict[str, list] = defaultdict(list)
        ti = None
        for split, scenes in raw.items():
            for i, scene in enumerate(scenes):
                if split in ("train", "valid"):
                    # the velocity noise reaches train and valid features
                    # and labels; test stays clean (dataset.py:222-243)
                    ti = make_time_indexed(cfg, _maybe_noisy(scene, cfg, i),
                                           polar=self.polar)
                    dataset[split].append(to_pointwise(ti))
                else:
                    ti = make_time_indexed(cfg, scene, polar=self.polar)
                    dataset[split].append(ti)
        self.train_data = merge_pointwise(dataset["train"])
        self.valid_data = merge_pointwise(dataset["valid"])
        self.test_data = dataset.get("test", [])
        return _publish_dims(cfg, ti)


class FinetuneDataset(_Orchestrator):
    """The finetune path: ``'slice'`` train windows, time-indexed valid and
    test scenes evaluated by rollout."""

    def __init__(self, polar: bool = False, device: Device = "cuda:0"):
        super().__init__(polar, device)
        self.train_data: List[ChanneledData] = []
        self.valid_data: List[TimeIndexedData] = []
        self.test_data: List[TimeIndexedData] = []

    def build_dataset(self, cfg: PIMLConfig) -> PIMLConfig:
        raw, cfg = self._raw(cfg)
        ti = None
        train_ti = []
        for split, scenes in raw.items():
            for scene in scenes:
                ti = make_time_indexed(cfg, scene, polar=self.polar)
                if split == "train":
                    train_ti.append(ti)
                elif split == "valid":
                    self.valid_data.append(ti)
                else:
                    self.test_data.append(ti)
        if cfg.unify_train_slots and len(train_ti) > 1:
            # one agent count across the training scenes: inert padded
            # slots (NaN positions, zero masks) change no loss or metric
            n_max = max(t.num_pedestrians for t in train_ti)
            train_ti = [pad_agents(t, n_max) for t in train_ti]
        self.train_data = [to_channeled(t, cfg.valid_steps, "slice")
                           for t in train_ti]
        return _publish_dims(cfg, ti)


class RatioSplitDataset:
    """One scene split by frame-index ratio (reference:
    ``PointwisePedDataset.old_build_dataset``, dataset.py:208-255, with
    ``split_train_val_test``, dataset.py:75-95): train and valid are
    pointwise rows of their frames, drawn from the velocity-perturbed view
    when ``add_noise_flag`` (dataset.py:222-228); test is the clean
    contiguous tail, time-indexed."""

    def __init__(self, polar: bool = False, device: Device = "cuda:0"):
        self.polar = polar
        self.device = device
        self.scene: Optional[Scene] = None
        self.train_data: Optional[PointwiseData] = None
        self.valid_data: Optional[PointwiseData] = None
        self.test_data: List[TimeIndexedData] = []

    def load_data(self, path_or_config: str) -> None:
        """A ``.npy`` scene, or a data config that names exactly one."""
        if path_or_config.endswith(".npy"):
            self.scene = Scene.load(path_or_config, device=self.device)
            return
        raw = load_scenes(path_or_config, self.device)
        scenes = [s for split in raw.values() for s in split]
        if len(scenes) != 1:
            raise ValueError("RatioSplitDataset splits a single scene by "
                             f"ratio; got {len(scenes)} scenes")
        self.scene = scenes[0]

    def build_dataset(self, cfg: PIMLConfig) -> PIMLConfig:
        if self.scene is None:
            raise RuntimeError("must load raw data before build_dataset")
        cfg = cfg.replace(time_unit=self.scene.time_unit)
        clean = make_time_indexed(cfg, self.scene, polar=self.polar)
        noisy = clean
        if cfg.add_noise_flag:
            noisy = make_time_indexed(
                cfg, perturb_velocity(self.scene, cfg.add_noise_std,
                                      cfg.seed), polar=self.polar)
        train_idx, valid_idx, test_idx = split_train_val_test(
            clean.num_frames, cfg.train_ratio, cfg.val_ratio, cfg.test_ratio,
            cfg.seed, shuffle=cfg.shuffle)
        self.train_data = to_pointwise(noisy, frames=train_idx)
        self.valid_data = to_pointwise(noisy, frames=valid_idx)
        self.test_data = (
            [slice_frames(clean, int(test_idx[0]), int(test_idx[-1]) + 1)]
            if len(test_idx) else [])
        return _publish_dims(cfg, clean)


class SceneListSplitDataset:
    """A list of scenes split by scene index (reference:
    ``PointwisePedDataset.build_dataset_with_list``, dataset.py:155-206),
    with ``split_train_val_test``'s index semantics and no shuffle
    (dataset.py:170-172): train and valid scenes merged pointwise, test
    the first test scene, time-indexed (the reference keeps only
    ``test_data[0]``, dataset.py:194-195)."""

    def __init__(self, polar: bool = False, device: Device = "cuda:0"):
        self.polar = polar
        self.device = device
        self.scenes: List[Scene] = []
        self.train_data: Optional[PointwiseData] = None
        self.valid_data: Optional[PointwiseData] = None
        self.test_data: List[TimeIndexedData] = []

    def load_data(self, path_or_config: Union[str, Sequence[str]]) -> None:
        """A list of ``.npy`` scenes, or a data config (every split's
        scenes, in its order)."""
        if isinstance(path_or_config, (list, tuple)):
            self.scenes = [Scene.load(p, device=self.device)
                           for p in path_or_config]
        else:
            raw = load_scenes(path_or_config, self.device)
            self.scenes = [s for split in raw.values() for s in split]

    def build_dataset(self, cfg: PIMLConfig) -> PIMLConfig:
        if not self.scenes:
            raise RuntimeError("must load raw data before build_dataset")
        cfg = cfg.replace(time_unit=_check_time_unit({"all": self.scenes}))
        views = [make_time_indexed(cfg, s, polar=self.polar)
                 for s in self.scenes]
        train_idx, valid_idx, test_idx = split_train_val_test(
            len(views), cfg.train_ratio, cfg.val_ratio, cfg.test_ratio,
            cfg.seed, shuffle=False)
        self.train_data = merge_pointwise(
            [to_pointwise(views[i]) for i in train_idx])
        self.valid_data = merge_pointwise(
            [to_pointwise(views[i]) for i in valid_idx])
        self.test_data = [views[test_idx[0]]] if len(test_idx) else []
        return _publish_dims(cfg, views[0])


class OnlyTrainingDataset(_Orchestrator):
    """Train-only orchestration (reference:
    ``PointwisePedDatasetOnlyTraining``, dataset.py:256-310): train as
    pointwise rows (velocity-perturbed with ``add_noise_flag``); valid as
    ``'split'`` windows when ``finetune_flag``, else pointwise; test
    time-indexed.

    The reference's ``pointwise_set.union({'valid'})`` is a no-op (its
    result is discarded, dataset.py:275-277), yet it still merges valid as
    pointwise at dataset.py:289; this class implements the evident intent,
    as the JAX package does."""

    def __init__(self, polar: bool = False, device: Device = "cuda:0"):
        super().__init__(polar, device)
        self.train_data: Optional[PointwiseData] = None
        self.valid_data: Union[PointwiseData, List[ChanneledData],
                               None] = None
        self.test_data: List[TimeIndexedData] = []

    def build_dataset(self, cfg: PIMLConfig) -> PIMLConfig:
        raw, cfg = self._raw(cfg)
        ti = None
        train, valid, test = [], [], []
        for split, scenes in raw.items():
            for i, scene in enumerate(scenes):
                if split == "train":
                    ti = make_time_indexed(cfg, _maybe_noisy(scene, cfg, i),
                                           polar=self.polar)
                    train.append(to_pointwise(ti))
                elif split == "valid":
                    ti = make_time_indexed(cfg, scene, polar=self.polar)
                    valid.append(to_channeled(ti, cfg.valid_steps, "split")
                                 if cfg.finetune_flag else to_pointwise(ti))
                else:
                    ti = make_time_indexed(cfg, scene, polar=self.polar)
                    test.append(ti)
        self.train_data = merge_pointwise(train)
        self.valid_data = valid if cfg.finetune_flag else \
            merge_pointwise(valid)
        self.test_data = test
        return _publish_dims(cfg, ti)


class VisDataset(_Orchestrator):
    """Visualisation / collision-metric scenes, every split
    time-indexed."""

    def __init__(self, device: Device = "cuda:0"):
        super().__init__(False, device)
        self.dataset: Dict[str, List[TimeIndexedData]] = {}

    def build_dataset(self, cfg: PIMLConfig) -> PIMLConfig:
        raw, cfg = self._raw(cfg, augment=False)
        self.dataset = {split: [make_time_indexed(cfg, s) for s in scenes]
                        for split, scenes in raw.items()}
        return _publish_dims(cfg, next(iter(self.dataset.values()))[0])


def channel_batches(data: List[ChanneledData], batch_size: int,
                    rng: np.random.RandomState,
                    shuffle: bool = False) -> List[ChanneledData]:
    """``batch_size``-window batches of every scene, the last partial one
    dropped (reference: src/utils/data_loader.py:41-53); with ``shuffle``
    the windows are drawn in the order of one ``rng.permutation`` per
    scene, as the JAX package draws them."""
    out = []
    for d in data:
        n = d.num_channels
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(n // batch_size):
            out.append(d.slice_channels(
                order[i * batch_size:(i + 1) * batch_size]))
    return out
