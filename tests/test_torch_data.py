"""The port's data layer against the JAX package (CPU): ``Scene.pad_agents``
/ ``pad_time``, the ratio / scene-list / train-only orchestrators and the
raw-data processors and exporters of ``data/processing.py``.

Inputs: scenes cropped from the committed GC scene
(``repro_work/gc_sf_repro.npy``, the 40 first agents) and written with the
port's ``Scene.save``; both packages load the same files.  The processors
run on the synthetic annotation fixtures of ``tests/test_processing.py``.

Tolerances:
- padding, split indices, row counts, the processors' outputs and the
  exported text: exact;
- pointwise rows and time-indexed views: self features, labels and masks
  to atol 1e-5 (as ``tests/test_torch_pretrain.py``); neighbour and
  obstacle features by ``_torch_compare.assert_features_match``, which
  names the rows where near-tied obstacle points of the scene's walls
  are ordered differently by the two packages' matmul-expansion
  distances;
- velocity noise (``add_noise_flag``) is drawn from a ``torch.Generator``,
  so it cannot match JAX's bit for bit: with noise on, the training rows
  must change and the test data must not.
"""

import os

import numpy as np
import pytest
import torch

from _torch_compare import assert_features_match
from piml_tpu.config import PIMLConfig as JaxConfig
from piml_tpu.data import OnlyTrainingDataset as JaxOnlyTraining
from piml_tpu.data import RatioSplitDataset as JaxRatioSplit
from piml_tpu.data import SceneListSplitDataset as JaxSceneListSplit
from piml_tpu.data import processing as jax_processing
from piml_tpu.scene import Scene as JaxScene
from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data import (OnlyTrainingDataset, RatioSplitDataset,
                                 SceneListSplitDataset, processing)
from piml_tpu_torch.scene import Scene, codec, crop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "repro_work", "gc_sf_repro.npy")
AGENTS = list(range(40))
CFG = dict(model="pinnsf_bm", dataset_name="gc2344", skip_frames=5,
           valid_steps=5, seed=7)
ROW_KEYS = ("self_features", "labels")
VIEW_KEYS = ("position", "self_features", "labels", "mask_p_pred")
NEIGHBOUR_KEYS = ("ped_features", "obs_features")
PAD_FIELDS = ("position", "velocity", "acceleration", "destination",
              "waypoints", "dest_idx", "dest_num", "obstacles", "mask_p",
              "mask_v", "mask_a")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Five cropped scenes on disk (frame ranges of the GC scene)."""
    base = tmp_path_factory.mktemp("data")
    src = Scene.load(SOURCE, device="cpu")
    paths = []
    for i, (a, b) in enumerate([(0, 60), (60, 110), (110, 150), (150, 200),
                                (200, 240)]):
        paths.append(str(base / f"s{i}.npy"))
        crop(src, a, b, AGENTS).save(paths[-1])
    return dict(base=base, paths=paths)


def _config(tmp_path, mapping, name="data.yaml"):
    path = tmp_path / name
    path.write_text("".join(
        f"{split}:\n" + "".join(f"  - {p}\n" for p in paths)
        for split, paths in mapping.items()))
    return str(path)


def _neighbours_match(got, ref, what):
    for key in NEIGHBOUR_KEYS:
        assert_features_match(np.asarray(getattr(ref, key)),
                              getattr(got, key).numpy(), 4.0,
                              name=f"{what} {key}")


def _rows_match(got, ref, what):
    assert len(got) == len(ref) > 0, what
    for key in ROW_KEYS:
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)), atol=1e-5,
                                   err_msg=f"{what} {key}")
    _neighbours_match(got, ref, what)


def _views_match(got, ref, what):
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert g.num_frames == r.num_frames, what
        for key in VIEW_KEYS:
            np.testing.assert_allclose(getattr(g, key).numpy(),
                                       np.asarray(getattr(r, key)),
                                       atol=1e-5, err_msg=f"{what} {key}")
        _neighbours_match(g, r, what)


def _dims(cfg):
    return (cfg.ped_feature_dim, cfg.obs_feature_dim, cfg.self_feature_dim,
            cfg.time_unit)


# ---------------------------------------------------------------------------
# Scene padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["agents", "time"])
def test_scene_padding_matches_jax_bitwise(scenes, axis):
    """Both packages pad the same decoded arrays: every field bit for bit
    (NaN where JAX writes NaN)."""
    d = codec.decode(scenes["paths"][0])
    got, ref = Scene.from_arrays(d, device="cpu"), JaxScene.from_arrays(d)
    if axis == "agents":
        got, ref = got.pad_agents(53), ref.pad_agents(53)
        assert got.num_pedestrians == 53
    else:
        got, ref = got.pad_time(77), ref.pad_time(77)
        assert got.num_steps == 77
    for key in PAD_FIELDS:
        g, r = getattr(got, key).numpy(), np.asarray(getattr(ref, key))
        assert g.dtype == r.dtype and g.shape == r.shape, key
        np.testing.assert_array_equal(g, r, err_msg=key)


def test_scene_padding_refuses_to_shrink(scenes):
    scene = Scene.load(scenes["paths"][0], device="cpu")
    assert scene.pad_agents(scene.num_pedestrians) is scene
    assert scene.pad_time(scene.num_steps) is scene
    with pytest.raises(ValueError, match="capacity"):
        scene.pad_agents(scene.num_pedestrians - 1)
    with pytest.raises(ValueError, match="capacity"):
        scene.pad_time(scene.num_steps - 1)


# ---------------------------------------------------------------------------
# the split orchestrators (noise off: the JAX package's numbers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source,shuffle", [("npy", False), ("yaml", True)])
def test_ratio_split_dataset_matches_jax(scenes, tmp_path, source, shuffle):
    path = scenes["paths"][0]
    if source == "yaml":
        path = _config(tmp_path, {"train": [path]})
    kw = dict(CFG, shuffle=shuffle)
    jds = JaxRatioSplit()
    jds.load_data(path)
    jcfg = jds.build_dataset(JaxConfig(**kw))
    ds = RatioSplitDataset(device="cpu")
    ds.load_data(path)
    cfg = ds.build_dataset(PIMLConfig(**kw))
    assert _dims(cfg) == _dims(jcfg)
    _rows_match(ds.train_data, jds.train_data, "train")
    _rows_match(ds.valid_data, jds.valid_data, "valid")
    _views_match(ds.test_data, jds.test_data, "test")
    # the test block is the contiguous tail of the scene's frames
    total = ds.scene.num_steps
    assert ds.test_data[0].num_frames == total - int(total * 0.8)


def test_ratio_split_dataset_takes_one_scene(scenes, tmp_path):
    ds = RatioSplitDataset(device="cpu")
    with pytest.raises(ValueError, match="single scene"):
        ds.load_data(_config(tmp_path, {"train": scenes["paths"][:2]}))


@pytest.mark.parametrize("source", ["list", "yaml"])
def test_scene_list_split_dataset_matches_jax(scenes, tmp_path, source):
    """Five scenes at 0.6 / 0.2 / 0.2: three train, one valid, one test
    scene, split by scene index without a shuffle."""
    arg = scenes["paths"]
    if source == "yaml":
        arg = _config(tmp_path, {"train": scenes["paths"][:3],
                                 "valid": scenes["paths"][3:]})
    jds = JaxSceneListSplit()
    jds.load_data(arg)
    jcfg = jds.build_dataset(JaxConfig(**CFG))
    ds = SceneListSplitDataset(device="cpu")
    ds.load_data(arg)
    cfg = ds.build_dataset(PIMLConfig(**CFG))
    assert _dims(cfg) == _dims(jcfg)
    _rows_match(ds.train_data, jds.train_data, "train")
    _rows_match(ds.valid_data, jds.valid_data, "valid")
    _views_match(ds.test_data, jds.test_data, "test")
    assert ds.test_data[0].num_frames == 40   # the fifth scene


@pytest.mark.parametrize("finetune_flag", [False, True])
def test_only_training_dataset_matches_jax(scenes, tmp_path, finetune_flag):
    p = scenes["paths"]
    config = _config(tmp_path, {"train": p[:2], "valid": [p[2]],
                                "test": [p[3]]})
    kw = dict(CFG, finetune_flag=finetune_flag)
    jds = JaxOnlyTraining()
    jds.load_data(config)
    jcfg = jds.build_dataset(JaxConfig(**kw))
    ds = OnlyTrainingDataset(device="cpu")
    ds.load_data(config)
    cfg = ds.build_dataset(PIMLConfig(**kw))
    assert _dims(cfg) == _dims(jcfg)
    _rows_match(ds.train_data, jds.train_data, "train")
    _views_match(ds.test_data, jds.test_data, "test")
    if not finetune_flag:
        _rows_match(ds.valid_data, jds.valid_data, "valid")
        return
    assert isinstance(ds.valid_data, list) and len(ds.valid_data) == 1
    got, ref = ds.valid_data[0], jds.valid_data[0]
    assert got.num_channels == ref.num_channels > 0
    for key in ("position", "labels", "self_features", "mask_p_pred"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)), atol=1e-5,
                                   err_msg=f"valid {key}")
    _neighbours_match(got, ref, "valid")


@pytest.mark.parametrize("which", ["ratio", "only_training"])
def test_add_noise_flag_changes_training_rows_not_test(scenes, tmp_path,
                                                       which):
    """``add_noise_flag`` reaches the training rows and leaves the test
    data clean (reference: dataset.py:222-243), as
    ``tests/test_datasets_wiring.py`` checks for the JAX package."""
    p = scenes["paths"]
    if which == "ratio":
        make, arg = RatioSplitDataset, p[0]
    else:
        make = OnlyTrainingDataset
        arg = _config(tmp_path, {"train": p[:2], "valid": [p[2]],
                                 "test": [p[3]]})
    built = []
    for noise in (False, True):
        ds = make(device="cpu")
        ds.load_data(arg)
        ds.build_dataset(PIMLConfig(**CFG, add_noise_flag=noise,
                                    add_noise_std=0.1))
        built.append(ds)
    clean, noisy = built
    assert len(clean.train_data) == len(noisy.train_data)
    assert not torch.allclose(clean.train_data.self_features,
                              noisy.train_data.self_features)
    for a, b in zip(clean.test_data, noisy.test_data):
        assert torch.equal(a.self_features, b.self_features)
        assert torch.equal(torch.nan_to_num(a.position),
                           torch.nan_to_num(b.position))


# ---------------------------------------------------------------------------
# data/processing.py (a numpy copy): bit for bit
# ---------------------------------------------------------------------------

def _gc_annotations(tmp_path):
    """``tests/test_processing.py``'s synthetic GC annotations."""
    ann = tmp_path / "ann"
    ann.mkdir()
    for i, x0 in [(1, 700), (2, 1000)]:
        rows = []
        for j in range(40):
            rows += [str(x0 + 6 * j), str(500 + 3 * j), str(19000 + 20 * j)]
        (ann / f"{i:06d}.txt").write_text("\n".join(rows))
    return str(ann)


def _ucy_vsp(tmp_path):
    vsp = tmp_path / "students003.vsp"
    lines = ["2 - number of splines"]
    for start in (0, 100):
        lines.append("5 - spline points")
        for j in range(5):
            lines.append(f"{100 + 20 * j} {200 + 10 * j} {start + j * 25} 0")
    vsp.write_text("\n".join(lines))
    return str(vsp)


def _same_scene_file(a, b):
    ma, ta, da, oa = np.load(a, allow_pickle=True)
    mb, tb, db, ob = np.load(b, allow_pickle=True)
    assert ma == mb
    assert ta == tb and da == db
    np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))


def test_processing_helpers_match_jax_bitwise():
    pts = np.array([[100.0, 200.0], [500.0, 800.0], [1000.0, 50.0]])
    for mat in ("GC_HOMOGRAPHY", "UCY_HOMOGRAPHY"):
        np.testing.assert_array_equal(getattr(processing, mat),
                                      getattr(jax_processing, mat))
        np.testing.assert_array_equal(
            processing.apply_homography(pts, getattr(processing, mat)),
            jax_processing.apply_homography(pts, getattr(processing, mat)))
    traj = np.array([[0.0, 0, 0], [1, 1, 10], [2, 0, 20], [3, -1, 30]])
    for t in (traj, traj[:2]):
        frames = np.arange(0, int(t[-1, 2]) + 1)
        np.testing.assert_array_equal(
            processing.interpolate_trajectory(t, frames),
            jax_processing.interpolate_trajectory(t, frames))
    tracks = [[(0.0, 0.0, 0), (0.1, 0.0, 1), (0.2, 0.0, 5), (0.3, 0.0, 6)],
              [(1.0, 1.0, 3), (1.0, 1.1, 4)]]
    assert processing.split_at_gaps(tracks) == \
        jax_processing.split_at_gaps(tracks)
    np.testing.assert_array_equal(processing.gc_obstacle(),
                                  jax_processing.gc_obstacle())


def test_process_gc_matches_jax_bitwise(tmp_path):
    ann = _gc_annotations(tmp_path)
    kw = dict(ped_range=(1, 3), time_range_s=(760, 790),
              space_range=((0, 0), (40, 40)))
    got = processing.process_gc(ann, str(tmp_path / "t.npy"), **kw)
    ref = jax_processing.process_gc(ann, str(tmp_path / "j.npy"), **kw)
    _same_scene_file(got, ref)
    scene = Scene.load(got, device="cpu")
    assert scene.num_pedestrians >= 1
    assert scene.obstacles.shape[0] == 100


def test_process_ucy_matches_jax_bitwise(tmp_path):
    vsp = _ucy_vsp(tmp_path)
    assert all(np.array_equal(a, b) for a, b in zip(
        processing.parse_vsp(vsp), jax_processing.parse_vsp(vsp)))
    got = processing.process_ucy(vsp, str(tmp_path / "t.npy"),
                                 time_range_s=(0, 10))
    ref = jax_processing.process_ucy(vsp, str(tmp_path / "j.npy"),
                                     time_range_s=(0, 10))
    _same_scene_file(got, ref)
    scene = Scene.load(got, device="cpu")
    assert scene.num_pedestrians == 2
    np.testing.assert_array_equal(scene.obstacles.numpy(),
                                  codec.DUMMY_OBSTACLES)


@pytest.mark.parametrize("fmt", ["sgan", "stgcnn", "social_lstm"])
def test_export_matches_jax_bitwise(scenes, tmp_path, fmt):
    path = scenes["paths"][0]
    got = processing.export_scene(Scene.load(path, device="cpu"),
                                  str(tmp_path / "t" / f"{fmt}.txt"), fmt)
    ref = jax_processing.export_scene(JaxScene.load(path),
                                      str(tmp_path / "j" / f"{fmt}.txt"), fmt)
    with open(got) as a, open(ref) as b:
        text = a.read()
        assert text == b.read()
    assert text.count("\n") == int(Scene.load(path, device="cpu")
                                   .mask_p.sum())
    split = {"train": [path], "test": [scenes["paths"][1]]}
    written = processing.export_splits(split, str(tmp_path / "splits"), fmt,
                                       device="cpu")
    assert [os.path.relpath(w, tmp_path / "splits") for w in written] == \
        ["train/s0.txt", "test/s1.txt"]
