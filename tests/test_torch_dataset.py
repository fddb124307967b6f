"""The port's dataset layer against scikit-learn, scipy and the JAX
package: the KD-tree's radius query returns exactly
`sklearn.neighbors.KDTree.query_radius`'s arrays (same indices, same order),
`compute_local_stats` matches scipy's moments within 1e-9 relative, and
`LasDataset` gives the same splits, bit-equal processed samples, the same
per-area statistics and the same `InstanceSpec` scale and center as the JAX
`LasDataset` (with a pre_transform that ends in a mean-mode
`GridSampling3D` too); each package reads the processed cache the other
wrote."""
import copy
import json
import os

import numpy as np
import pytest
from sklearn.neighbors import KDTree

from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.data import dataset as jds
from dpcr_agb_tpu.data.stats import compute_local_stats as jstats
from dpcr_agb_tpu.models.base import build_instance_spec as jspec
from dpcr_agb_tpu.transforms import instantiate_transforms as jtransforms
from dpcr_agb_tpu_torch import native
from dpcr_agb_tpu_torch.config import load_config as tload
from dpcr_agb_tpu_torch.data import dataset as tds
from dpcr_agb_tpu_torch.data.stats import compute_local_stats as tstats
from dpcr_agb_tpu_torch.models.base import build_instance_spec as tspec
from dpcr_agb_tpu_torch.transforms import instantiate_transforms as ttransforms

CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")

# (n points, rounding of the coordinates to force ties, radii)
KD_CASES = [(1, None, (0.0, 1.0)), (5, None, (0.5, 40.0)),
            (39, 1, (3.0, 7.5)), (40, None, (5.0,)), (41, 0, (4.0, 15.0)),
            (500, 1, (0.0, 2.5, 15.0)), (6000, 2, (7.5, 15.0)),
            (30000, 0, (15.0, 100.0)), (2000, None, (1e-9,))]


@pytest.mark.parametrize("n,decimals,radii", KD_CASES)
def test_radius_query_is_sklearns(n, decimals, radii):
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 30, (n, 2)).astype(np.float32)
    if decimals is not None:
        xy = np.round(xy, decimals)
    ref = KDTree(xy)
    tree = native.KDTree2D(xy)
    np.testing.assert_array_equal(tree.idx, ref.get_arrays()[1])
    centers = list(rng.uniform(-5, 35, (4, 2))) + [xy[0].astype(np.float64),
                                                   np.array([500.0, 500.0])]
    for c in centers:
        for r in radii:
            want = ref.query_radius(np.asarray(c)[None], r)[0]
            got = tree.query_radius(c, r)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                native.radius_query_2d(xy, c, r), want)


@pytest.mark.parametrize("kind", ["normal", "constant", "one_point",
                                  "skewed", "two_points"])
def test_local_stats_match_scipy(kind):
    rng = np.random.default_rng(7)
    n = {"one_point": 1, "two_points": 2}.get(kind, 400)
    pos = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    if kind == "constant":
        pos[:, 2] = 3.25
    if kind == "skewed":
        pos[:, 2] = rng.gamma(1.5, 4.0, n)
    want, got = jstats(pos), tstats(pos)
    assert list(got) == list(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


def _overrides(root, tt="sparse_xy", extra=()):
    return ["task=instance", "models=instance/minkowski_baseline",
            "model_name=SENet14", "data=instance/synthetic/reg",
            f"data.transform_type={tt}", "data.synthetic_plots=14",
            f"data.dataroot={root}", "run_dir=unused", *extra]


def _datasets(tmp_path, extra=(), jroot="j", troot="t"):
    jd = jds.instantiate_dataset(jload(CONF, "config", _overrides(
        str(tmp_path / jroot), extra=extra))["data"])
    td = tds.instantiate_dataset(tload(CONF, "config", _overrides(
        str(tmp_path / troot), extra=extra))["data"])
    return jd, td


def assert_same_samples(jd, td):
    for split in ("train", "val", "test"):
        a, b = jd.datasets[split], td.datasets[split]
        assert (a is None) == (b is None), split
        if a is None:
            continue
        assert len(a) == len(b), split
        for i in range(len(a)):
            x, y = a.get(i), b.get(i)
            assert list(x) == list(y), (split, i)
            for k in x:
                xa, ya = np.asarray(x[k]), np.asarray(y[k])
                assert xa.dtype == ya.dtype and xa.shape == ya.shape, k
                np.testing.assert_array_equal(xa, ya, err_msg=f"{split} {k}")


def assert_same_stats(jd, td):
    for name in ("mean_targets_", "std_targets_", "min_targets_",
                 "max_targets_"):
        want, got = getattr(jd, name), getattr(td, name)
        assert list(got) == list(want)
        for area in want:
            assert list(got[area]) == list(want[area])
            for split in want[area]:
                np.testing.assert_array_equal(got[area][split],
                                              want[area][split])


@pytest.mark.parametrize("extra", [(), ("data.train_subset=0.5",),
                                   ("data.save_local_stats=True",
                                    "data.in_memory=False")])
def test_las_dataset_equals_jax(tmp_path, extra):
    jd, td = _datasets(tmp_path, extra)
    for area in jd.area_names:
        jl, tl = jd.get_labels(area), td.get_labels(area)
        assert tl.columns == list(jl.columns)
        np.testing.assert_array_equal(tl.index, jl.index.to_numpy())
        assert tl["split"].tolist() == jl["split"].tolist()
    assert_same_samples(jd, td)
    assert_same_stats(jd, td)
    assert td.feature_dimension == jd.feature_dimension == 3
    opt = {"reg_loss_fn": "smoothl1"}
    want, got = jspec(jd, opt), tspec(td, opt)
    for field in ("scale", "center", "weights"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.loss_names == want.loss_names
    assert got.double_batch == want.double_batch


@pytest.mark.parametrize("norm", [
    {"normalization": "min-max"},
    {"normalization": "standard", "center_override": 10.0,
     "scale_mult": 2.0},
    {"normalization": "none", "scale_override": 3.0}])
def test_instance_spec_options_equal_jax(tmp_path, norm):
    targets = {"BMag_ha": {"task": "regression", "weight": 0.25, **norm},
               "V_ha": {"task": "regression", "weight": 0.75}}
    extra = ["data.targets=" + repr(targets).replace("'", "")]
    jd, td = _datasets(tmp_path, extra)
    want, got = jspec(jd, {}), tspec(td, {})
    for field in ("scale", "center", "weights"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


# the NFI pre_transform (conf/data/instance/NFI/default.yaml) then a 0.5 m
# mean-mode grid, which merges the crowns' points
MEAN_GRID_PRE = [
    {"transform": "DBSCANZOutlierRemoval",
     "params": {"eps": 1.5, "min_samples": 10,
                "skip_list": "${data.skip_list}"}},
    {"transform": "StartZFromZero"},
    {"transform": "ZFilter", "params": {"z_min": -1.0e-5, "z_max": 50,
                                        "skip_keys": "${data.skip_list}"}},
    {"transform": "GridSampling3D", "params": {"size": 0.5}}]


def test_mean_grid_pre_transform_equals_jax(tmp_path):
    extra = ("data.pre_transform=" + json.dumps(MEAN_GRID_PRE),
             "data.synthetic_plots=8")
    jd, td = _datasets(tmp_path, extra)
    assert_same_samples(jd, td)
    sample = td.datasets["train"].get(0)
    assert sample["grid_size"].tolist() == [0.5]
    # one point a 0.5 m cell: each cell's mean stays in its cell
    cells = np.unique(np.round(sample["pos"] / 0.5), axis=0)
    assert len(cells) == len(sample["pos"])


def test_each_package_reads_the_others_cache(tmp_path):
    # in_memory False: every get() reads the .npz files
    extra = ("data.in_memory=False",)
    jd, td = _datasets(tmp_path, extra)
    # the port over the JAX package's cache, the JAX package over the port's
    td2 = tds.instantiate_dataset(tload(CONF, "config", _overrides(
        str(tmp_path / "j"), extra=extra))["data"])
    jd2 = jds.instantiate_dataset(jload(CONF, "config", _overrides(
        str(tmp_path / "t"), extra=extra))["data"])
    processed = tmp_path / "j" / "synthetic" / "processed_nfi_reg"
    assert (processed / "train" / "SYNTH" / "done.flag").exists()
    assert sorted(os.listdir(processed / "train" / "SYNTH"))[:2] == [
        "0.npz", "1.npz"]
    assert_same_samples(jd, td2)
    assert_same_samples(jd2, td)
    assert_same_samples(jd2, td2)


def test_classification_filter_equals_jax():
    rng = np.random.default_rng(3)
    n = 300
    sample = {"pos": rng.normal(size=(n, 3)).astype(np.float32),
              "x": np.stack([rng.choice([1, 2, 5], n),
                             rng.normal(size=n)], 1).astype(np.float32),
              "y_reg": np.array([1.0, 2.0], np.float32),
              "intensity": rng.integers(0, 255, n)}
    for params in ({"feature_index": 0, "class_indices": [2],
                    "keep": False, "remove_feat": True},
                   {"feature_index": 0, "class_indices": [1, 5],
                    "keep": True, "remove_feat": False}):
        cfg = [{"transform": "ClassificationFilter", "params": params}]
        want = jtransforms(copy.deepcopy(cfg))(None, dict(sample))
        got = ttransforms(copy.deepcopy(cfg))(None, dict(sample))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    one = {"pos": sample["pos"], "x": sample["x"][:, :1]}
    cfg = [{"transform": "ClassificationFilter",
            "params": {"feature_index": 0, "class_indices": [2]}}]
    assert ttransforms(cfg)(None, dict(one))["x"] is None
