"""The 37 transforms that slice 16 ported, against the JAX package's on the
CPU: both registries hold the same 65 names; each transform gives the same
sample, bit for bit, from the same sample and seed, and draws as much from
the generator (3 seeds each); the three that the JAX package hands to
scikit-learn agree with scikit-learn where its rules bite (OPTICS' index-0
border point, KDTree's inclusive float64 count at exactly r and at
float32(r), the KDE score within 1e-10 of scikit-learn's and the kept range
on either side of log(p)); FCompose calls its first filter twice; the
batch-level ClampBatchSize through both loaders, padded batches included;
CenterXYbyZ's objects through both RadiusObjectAdders; a composed preset
(sparse_xy with new transforms, five input channels) through both
packages' dataset and loader; and a narrow SENet14 forward at Cin 5 in
both packages."""
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import OPTICS
from sklearn.neighbors import KDTree, KernelDensity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import dpcr_agb_tpu.transforms as J  # noqa: E402
import dpcr_agb_tpu_torch.transforms as T  # noqa: E402
from dpcr_agb_tpu.config import load_config as jload  # noqa: E402
from dpcr_agb_tpu.data import dataset as jds  # noqa: E402
from dpcr_agb_tpu.data.batch import Batch as JBatch  # noqa: E402
from dpcr_agb_tpu.data.batch import CollateSpec as JSpec  # noqa: E402
from dpcr_agb_tpu.data.loader import Loader as JLoader  # noqa: E402
from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet  # noqa: E402
from dpcr_agb_tpu.transforms import objects as jobj  # noqa: E402
from dpcr_agb_tpu_torch.config import load_config as tload  # noqa: E402
from dpcr_agb_tpu_torch.data import dataset as tds  # noqa: E402
from dpcr_agb_tpu_torch.data.batch import Batch  # noqa: E402
from dpcr_agb_tpu_torch.data.batch import CollateSpec as TSpec  # noqa: E402
from dpcr_agb_tpu_torch.data.loader import Loader as TLoader  # noqa: E402
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet  # noqa: E402
from dpcr_agb_tpu_torch.transforms import geometry  # noqa: E402
from dpcr_agb_tpu_torch.transforms import objects as tobj  # noqa: E402
from dpcr_agb_tpu_torch.weights import from_flax  # noqa: E402

CONF = os.path.join(ROOT, "conf")
SEEDS = (0, 1, 2)
KDE_TOL = 1e-10   # |score - scikit-learn's|: both sum every term in f64,
#                   in another order (measured ~1e-13 at 1500 points)

# the names the port had before slice 16
PORTED_BEFORE = {
    "AddFeatsByKeys", "AddOnes", "AddRandomPoints", "AddXYDistanceToCenter",
    "ClassificationFilter", "CopyJitterRandomPoints",
    "DBSCANZOutlierRemoval", "FixedPointsOwn", "GridSampling3D", "MaxPoints",
    "MinPoints", "ModelInference", "MoveCenterPosPerSample",
    "PointNetForward", "Polygon2dExtend", "Random3AxisRotation",
    "RandomCoordsFlip", "RandomDropout", "RandomGroundRemoval",
    "RandomNoise", "RandomPolygon2dExtend", "RandomShiftPos",
    "RadiusObjectAdder", "ScalePos", "ShiftVoxels", "StartZFromZero",
    "XYZFeature", "ZFilter"}


def _sample(seed, kind="unit", n=None):
    """A plot-like sample: `unit` in the normalised frame (xy in [0, 1],
    z from 0), `metres` as the pre_transform sees it (z outliers above and
    below, a 15 m plot); x, rgb, norm and the per-sample values."""
    rng = np.random.default_rng(1000 + seed)
    n = n or int(rng.integers(500, 2000))
    if kind == "metres":
        xy = rng.uniform(-15, 15, (n, 2))
        z = rng.gamma(2.0, 4.0, n)
        z[:3] = [-6.0, 41.0, 47.5]
    else:
        xy = rng.uniform(0, 1, (n, 2))
        z = rng.gamma(2.0, 0.1, n)
    norm = rng.normal(size=(n, 3))
    return {"pos": np.concatenate([xy, z[:, None]], 1).astype(np.float32),
            "x": rng.normal(size=(n, 2)).astype(np.float32),
            "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "norm": (norm / np.linalg.norm(norm, axis=1, keepdims=True)
                     ).astype(np.float32),
            "y_reg": np.array([1.5, 2.0], np.float32),
            "y_reg_mask": np.ones(2, bool), "label_idx": np.int64(seed),
            "area_idx": np.int64(0)}


def _assert_same(want, got, what):
    assert list(got) == list(want), what
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")


SKIP = ["y_reg", "y_reg_mask"]
CROPS = [{"transform": "EllipsoidCrop", "params": {"a": 0.5, "b": 0.4}},
         {"transform": "CubeCrop", "params": {"c": 0.3,
                                              "grid_size_center": 0.05}},
         {"transform": "PeriodicSampling", "params": {"period": 0.07}}]
# (name, params, sample kind); every ported name at least once
CASES = [
    ("LotteryTransform", {"transform_options": CROPS}, "unit"),
    ("ComposeTransform", {"transform_options": [
        {"transform": "RandomSymmetry", "params": {"axis": [True, False,
                                                            True]}},
        {"transform": "RandomTranslation"}]}, "unit"),
    ("RandomParamTransform", {"transform_name": "RandomScaling",
                              "transform_params": {
                                  "scales": {"value": [0.8, 1.2]}}}, "unit"),
    ("RandomParamTransform", {"transform_name": "MaxPoints",
                              "transform_params": {
                                  "num": {"min": 100, "max": 450.9,
                                          "type": "int"}}}, "unit"),
    ("RandomParamTransform", {"transform_name": "IrregularSampling",
                              "transform_params": {
                                  "d_half": {"min": 0.1, "max": 0.6},
                                  "grid_size_center": {"value": 0.05}}},
     "unit"),
    ("CenterPosPerSample", {}, "unit"),
    ("CenterPosPerSample", {"center": "quantile", "center_z": True}, "unit"),
    ("CenterPosPerSample", {"center": "maxmin", "center_x": False}, "unit"),
    ("CenterPosPerSample", {"center_x": False, "center_y": False}, "unit"),
    ("FixedCenterPosPerSample", {"center_z": 0.0}, "unit"),
    ("CenterXYbyZ", {"center_x": 0.5, "z_thresh_min": 0.05,
                     "z_thresh_max": 0.3}, "unit"),
    ("RandomScaling", {"scales": [0.9, 1.2]}, "unit"),
    ("RandomSymmetry", {"axis": [True, True, True]}, "unit"),
    ("RandomTranslation", {"delta_max": [0.1, 0.2, 0.0],
                           "delta_min": [-0.1, 0.0, 0.0]}, "unit"),
    ("AddGround", {"max_points": 3000, "n_points": 64, "xy_max": 2.0},
     "unit"),
    ("AddGround", {"max_points": 10, "n_points": 64}, "unit"),
    ("CylinderExtend", {"radius": 0.6, "skip_list": SKIP}, "unit"),
    ("RectangleExtend", {"e_x": 0.7, "e_y": 0.4, "e_z": 0.3}, "unit"),
    ("EllipsoidCrop", {"a": 0.3, "b": 0.5, "c": 0.2, "rot_x": 20}, "unit"),
    ("CubeCrop", {"c": 0.25, "rot_y": 0, "grid_size_center": 0.02}, "unit"),
    ("IrregularSampling", {"d_half": 0.3, "p": 1, "grid_size_center": 0.05,
                           "skip_keys": SKIP}, "unit"),
    ("IrregularSampling", {"d_half": 0.2, "grid_size_center": 0.1}, "unit"),
    ("PeriodicSampling", {"period": 0.05, "prop": 0.3, "box_multiplier": 2},
     "unit"),
    ("StatZOutlierRemoval", {"threshold": 2.5, "skip_list": SKIP}, "metres"),
    ("OPTICSZOutlierRemoval", {"eps": 1.0, "min_samples": 10}, "metres"),
    ("OPTICSZOutlierRemoval", {"eps": 0.4, "min_samples": 6,
                               "skip_list": SKIP}, "metres"),
    ("KernelDensityZOutlierRemoval", {"bandwidth": 1.0, "p": 0.002},
     "metres"),
    ("KernelDensityZOutlierRemoval", {"bandwidth": 0.5, "p": 0.02},
     "metres"),
    ("DensityFilter", {"radius_nn": 1.5, "min_num": 2}, "metres"),
    ("DensityFilter", {"radius_nn": 0.04, "min_num": 0}, "unit"),
    ("AddZDistanceToTop", {}, "unit"),
    ("AddFeatByKey", {"add_to_x": True, "feat_name": "rgb",
                      "input_nc_feat": 3}, "unit"),
    ("AddFeatByKey", {"add_to_x": True, "feat_name": "missing",
                      "strict": False}, "unit"),
    ("NormalizeFeature", {"feat_name": "x", "mean": 0.5, "std": 2.0},
     "unit"),
    ("NormalFeature", {}, "unit"),
    ("PCACompute", {}, "unit"),
    ("PlanarityFilter", {"thresh": 0.5}, "unit"),
    ("PlanarityFilter", {"thresh": 0.5, "is_leq": False}, "unit"),
    ("RandomFilter", {"thresh": 0.5}, "unit"),
    ("NormalizeRGB", {}, "unit"),
    ("ChromaticTranslation", {"trans_range_ratio": 0.2}, "unit"),
    ("ChromaticAutoContrast", {}, "unit"),
    ("ChromaticAutoContrast", {"randomize_blend_factor": False,
                               "blend_factor": 0.3}, "unit"),
    ("ChromaticJitter", {"std": 0.05}, "unit"),
    ("DropFeature", {"drop_proba": 0.6, "feature_name": "x"}, "unit"),
    ("Jitter", {"sigma": 0.1, "p": 0.7}, "unit"),
    ("SaveOriginalPosId", {}, "unit"),
    ("ElasticDistortion", {"granularity": [0.05, 0.2],
                           "magnitude": [0.01, 0.02], "p": 0.7}, "unit"),
    ("ElasticDistortion", {"granularity": [1.0, 3.0], "p": 1.0}, "metres"),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


def test_registries_are_equal():
    assert set(T.TRANSFORM_REGISTRY) == set(J.TRANSFORM_REGISTRY)
    assert len(T.TRANSFORM_REGISTRY) == 65
    new = set(T.TRANSFORM_REGISTRY) - PORTED_BEFORE
    assert len(new) == 37
    covered = {c[0] for c in CASES} | {"FCompose", "ClampBatchSize"}
    assert new <= covered, sorted(new - covered)


@pytest.mark.parametrize("name,params,kind", CASES, ids=IDS)
def test_transform_equals_jax(name, params, kind):
    for seed in SEEDS:
        sample = _sample(seed, kind)
        if name == "NormalizeRGB":
            sample["rgb"] = sample["rgb"] * 255.0
        jt = J.instantiate_transform({"transform": name, "params": params})
        tt = T.instantiate_transform({"transform": name, "params": params})
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jt(jr, dict(sample))
        got = tt(tr, dict(sample))
        what = f"{name} {params} seed {seed}"
        if isinstance(want, (bool, np.bool_)):
            assert isinstance(got, (bool, np.bool_)) and got == want, what
        else:
            _assert_same(want, got, what)
        assert jr.random() == tr.random(), f"{what}: draws differ"


def test_random_param_int_truncates():
    tt = T.instantiate_transform({
        "transform": "RandomParamTransform",
        "params": {"transform_name": "MaxPoints", "transform_params": {
            "num": {"min": 100, "max": 450.9, "type": "int"}}}})
    rng = np.random.default_rng(4)
    drawn = tt._draw(np.random.default_rng(4))
    v = rng.random() * (450.9 - 100) + 100
    assert isinstance(drawn.num, int) and drawn.num == int(v)


def test_normal_feature_raises_without_norm():
    sample = _sample(0)
    del sample["norm"]
    for pkg in (J, T):
        t = pkg.instantiate_transform({"transform": "NormalFeature"})
        with pytest.raises(NotImplementedError, match="norm"):
            t(np.random.default_rng(0), sample)


def test_fcompose_calls_its_first_filter_twice():
    """A RandomFilter first draws twice (the first filter starts the
    result and is called again in the loop), as in the JAX package."""
    for seed in SEEDS + (3, 4, 5):
        sample = _sample(seed)
        jf = J.FCompose([J.RandomFilter(0.6), J.PlanarityFilter(0.9)])
        tf = T.TRANSFORM_REGISTRY["FCompose"](
            [T.TRANSFORM_REGISTRY["RandomFilter"](0.6),
             T.TRANSFORM_REGISTRY["PlanarityFilter"](0.9)])
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        assert tf(tr, sample) == jf(jr, sample)
        ref = np.random.default_rng(seed)
        draws = ref.random(), ref.random()
        assert tr.random() == jr.random() == ref.random()
        plan = T.TRANSFORM_REGISTRY["PlanarityFilter"](0.9)(None, sample)
        assert tf(np.random.default_rng(seed), sample) == bool(
            draws[0] < 0.6 and draws[1] < 0.6 and plan)


def test_optics_keeps_sklearns_range_with_an_index0_border_point():
    """Index 0 at 5.9 is processed first, at infinite reachability, before
    any core point within eps: OPTICS calls it noise where DBSCAN calls it
    border, so the kept range ends at 4.986, not 5.9."""
    rng = np.random.default_rng(0)
    z = np.concatenate([[5.9], 200 * [0.0]]).astype(np.float32)
    z[1:] = (rng.random(200) * 5).astype(np.float32)
    labels = OPTICS(eps=1.0, min_samples=10, cluster_method="dbscan") \
        .fit_predict(z[:, None])
    noise = geometry.optics_dbscan_noise(z, 1.0, 10)
    np.testing.assert_array_equal(noise, labels == -1)
    assert noise[0] and z[~noise].max() == pytest.approx(4.986, abs=1e-3)
    dbscan = geometry.dbscan1d_labels(z, 1.0, 10) != -1
    assert dbscan[0]      # DBSCAN's border
    sample = {"pos": np.stack([np.zeros(201), np.zeros(201), z], 1)
              .astype(np.float32)}
    for pkg in (J, T):
        out = pkg.instantiate_transform({
            "transform": "OPTICSZOutlierRemoval"})(None, dict(sample))
        assert out["pos"][:, 2].max() == z[~noise].max()


@pytest.mark.parametrize("seed", range(6))
def test_optics_noise_is_sklearns(seed):
    """Clouds with several clusters, borders between them and far noise, in
    another order each: the noise mask equals scikit-learn's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 1200))
    z = np.concatenate([rng.normal(0, 1, n // 2), rng.normal(7, 0.4, n // 4),
                        rng.uniform(-8, 25, n - n // 2 - n // 4)])
    z = rng.permutation(z).astype(np.float32)
    eps, k = (1.0, 10) if seed % 2 else (0.3, 5)
    want = OPTICS(eps=eps, min_samples=k, cluster_method="dbscan") \
        .fit_predict(z[:, None]) == -1
    np.testing.assert_array_equal(geometry.optics_dbscan_noise(z, eps, k),
                                  want)


def test_density_filter_counts_exact_radius_as_kdtree():
    """Inclusive, in float64 of the float32 positions: (0, 0.3f, 0.4f) is
    not within 0.5 of the origin, (0, 0, float32(0.04)) is within 0.04."""
    pos = np.array([[0, 0, 0], [0, 0.3, 0.4], [0, 0, 0.04], [0.5, 0.5, 0.5],
                    [0, 0, 0.08]], np.float32)
    for r in (0.5, 0.04, float(np.float32(0.04)), 0.3, 1e-9):
        want = KDTree(pos).query_radius(pos, r, count_only=True)
        np.testing.assert_array_equal(geometry.radius_counts(pos, r), want,
                                      err_msg=str(r))
    pair = np.array([[0, 0, 0], [0, 0.3, 0.4]], np.float32)
    assert list(geometry.radius_counts(pair, 0.5)) == [1, 1]
    pair = np.array([[0, 0, 0], [0, 0, 0.04]], np.float32)
    assert list(geometry.radius_counts(pair, 0.04)) == [2, 2]
    rng = np.random.default_rng(9)
    cloud = np.round(rng.uniform(0, 1, (3000, 3)), 2).astype(np.float32)
    for r in (0.01, 0.05, 0.1):
        np.testing.assert_array_equal(
            geometry.radius_counts(cloud, r),
            KDTree(cloud).query_radius(cloud, r, count_only=True))
    sample = {"pos": cloud}
    for params in ({"radius_nn": 0.03, "min_num": 3},
                   {"radius_nn": 0.05, "min_num": 10}):
        _assert_same(J.instantiate_transform({"transform": "DensityFilter",
                                              "params": params})(None, sample),
                     T.instantiate_transform({"transform": "DensityFilter",
                                              "params": params})(None, sample),
                     str(params))


@pytest.mark.parametrize("seed", SEEDS)
def test_kde_score_within_tolerance_of_sklearns(seed):
    z = _sample(seed, "metres")["pos"][:, 2].astype(np.float64)
    for h in (0.5, 1.0, 3.0):
        want = KernelDensity(kernel="gaussian", bandwidth=h).fit(
            z[:, None]).score_samples(z[:, None])
        got = geometry.gaussian_kde_log_density(z, z, h)
        assert np.abs(got - want).max() < KDE_TOL, h


@pytest.mark.parametrize("side", [-1, 1])
def test_kde_filter_at_log_p_plus_minus_tolerance(side):
    """The lowest point's score sits 10 tolerances above (kept) or below
    (dropped) log(p): both packages keep the same range, and the range
    starts at it or above it. Every other score is farther from log(p)
    than the tolerance, so the masks must be equal."""
    sample = _sample(1, "metres")
    z = sample["pos"][:, 2].astype(np.float64)
    low = int(np.argmin(z))
    score = KernelDensity(kernel="gaussian", bandwidth=1.0).fit(
        z[:, None]).score_samples(z[:, None])
    p = math.exp(score[low] - side * 10 * KDE_TOL)
    assert (np.abs(np.delete(score, low) - math.log(p)) > KDE_TOL).all()
    params = {"bandwidth": 1.0, "p": p}
    want = J.instantiate_transform({"transform":
                                    "KernelDensityZOutlierRemoval",
                                    "params": params})(None, dict(sample))
    got = T.instantiate_transform({"transform":
                                   "KernelDensityZOutlierRemoval",
                                   "params": params})(None, dict(sample))
    _assert_same(want, got, f"side {side}")
    assert (got["pos"][:, 2].min() == z[low]) == (side == 1)


def test_clamp_batch_size_drops_and_keeps_the_smallest():
    sizes = [300, 500, 200, 400]
    samples = [{"pos": np.zeros((n, 3), np.float32)} for n in sizes]
    for budget in (0, 700, 1000, 150, 2000):
        j = J.TRANSFORM_REGISTRY["ClampBatchSize"](budget)(samples)
        t = T.TRANSFORM_REGISTRY["ClampBatchSize"](budget)(samples)
        assert [len(s["pos"]) for s in t] == [len(s["pos"]) for s in j]
    assert [len(s["pos"]) for s in T.TRANSFORM_REGISTRY["ClampBatchSize"](
        150)(samples)] == [200]
    assert T.TRANSFORM_REGISTRY["ClampBatchSize"].batch_level


def test_center_xy_by_z_objects_through_the_object_adders(tmp_path):
    """Tree objects centred by each package's CenterXYbyZ (which records
    pos_deviation and pos_center_points) and saved; each package's
    RadiusObjectAdder reads its own: the same samples."""
    rng = np.random.default_rng(21)
    for pkg, name in ((J, "j"), (T, "t")):
        d = tmp_path / name / "treeDB" / "processed_treeDB_ALS" / "train" \
            / "treeDB"
        d.mkdir(parents=True)
        t = pkg.instantiate_transform({"transform": "CenterXYbyZ",
                                       "params": {"z_thresh_min": 2.0,
                                                  "z_thresh_max": 12.0}})
        objs = np.random.default_rng(5)
        for i in range(5):
            k = 60 + 7 * i
            obj = {"pos": (objs.normal(size=(k, 3)) * [1.5, 1.0, 4.0]
                           + [3.0, -2.0, 8.0]).astype(np.float32),
                   "x": objs.normal(size=(k, 2)).astype(np.float32),
                   "local_stats": objs.uniform(2, 30, 3).astype(np.float32)}
            obj = t(None, obj)
            assert obj["pos_deviation"].shape == (1, 2)
            np.savez(d / f"{i}.npz", **obj)
    kw = dict(areas={"treeDB": {"type": "object"}}, dataset_name="treeDB",
              processed_folder="processed_treeDB_ALS", min_radius=15.1,
              max_radius=20.0, n_max_objects={"scene": 4, "object": 3},
              rot_z=180, zero_center_z=True, in_memory=True, p=1.0)
    jadd = jobj.RadiusObjectAdder(root_folder=str(tmp_path / "j"), **kw)
    tadd = tobj.RadiusObjectAdder(root_folder=str(tmp_path / "t"), **kw)
    for seed in SEEDS:
        sample = {"pos": rng.uniform(-15, 15, (300, 3)).astype(np.float32),
                  "x": rng.normal(size=(300, 2)).astype(np.float32),
                  "area_name": np.str_("NFI"), "is_double": False}
        want = jadd(np.random.default_rng(seed), dict(sample))
        got = tadd(np.random.default_rng(seed), dict(sample))
        _assert_same(want, got, f"seed {seed}")
        assert got["pos"].shape[0] > 300


# -- a composed preset through both packages' dataset and loader ---------

def _overrides(root, clamp):
    return ["task=instance", "models=instance/minkowski_baseline",
            "model_name=SENet14", "data=instance/synthetic/reg",
            "data.synthetic_plots=10", f"data.dataroot={root}",
            "run_dir=unused", "data.xy_radius=3",
            *chip_smoke.augmented_overrides(clamp)]


CLAMP = 500     # a batch of 3 samples (~100-550 points each) overflows


@pytest.fixture(scope="module")
def augmented(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug")
    jd = jds.instantiate_dataset(jload(CONF, "config", _overrides(
        str(root / "j"), CLAMP))["data"])
    td = tds.instantiate_dataset(tload(CONF, "config", _overrides(
        str(root / "t"), CLAMP))["data"])
    return jd, td


def test_augmented_preset_samples_equal_jax(augmented):
    jd, td = augmented
    assert td.feature_dimension == jd.feature_dimension == 5
    for split in ("train", "val", "test"):
        a, b = jd.datasets[split], td.datasets[split]
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            _assert_same(a.get(i), b.get(i), f"{split} {i}")


def _spec(cls):
    return cls(conv_type="sparse", use_coords=True,
               buckets=(1024, 2048), min_bucket=512)


@pytest.mark.parametrize("split", ["train", "test"])
def test_augmented_preset_batches_equal_jax(augmented, split):
    """The chains, ClampBatchSize and the padded collate: the same batches
    bit for bit; some batch lost a sample to the budget (padding rows,
    masked), and the x rows are 5 wide."""
    jd, td = augmented
    is_train = split == "train"
    kw = dict(batch_size=3, shuffle=is_train, drop_last=is_train, seed=3,
              num_workers=2)
    jl = JLoader(jd.datasets[split], jd.transform_for(split),
                 spec=_spec(JSpec),
                 pre_batch_collate=jd.pre_batch_collate_transform, **kw)
    tl = TLoader(td.datasets[split], td.transform_for(split),
                 spec=_spec(TSpec),
                 pre_batch_collate=td.pre_batch_collate_transform, **kw)
    kept = []
    for epoch in (0, 1):
        for jb, tb in zip(jl.epoch(epoch), tl.epoch(epoch)):
            for f in dataclasses.fields(jb):
                want, got = getattr(jb, f.name), getattr(tb, f.name)
                if want is None:
                    assert got is None, f.name
                    continue
                got = got.numpy() if isinstance(got, torch.Tensor) else got
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            assert tb.x.shape[-1] == 5
            rows = np.asarray(tb.valid)   # padding rows are not valid
            kept.append(int(rows.sum()))
    if is_train:
        assert min(kept) < 3, kept   # the budget dropped a sample


# -- SENet14 at five input channels --------------------------------------

NARROW = dict(block="se_basic", layers=(1, 1, 1, 1), planes=(16, 16, 32, 32),
              init_dim=16, activation="gelu", first_stride=1,
              global_pool="sum", drop_path=0.01, dense_dims=(12, 12, 12))


def test_narrow_senet14_forward_at_cin5_matches_jax():
    """The stem at Cin 5 (the plain version here), the rest of the net
    unchanged: f32 within test_torch_model.py's rtol 1e-4, atol 1e-4."""
    rng = np.random.default_rng(16)
    b, v, zb, cin = 2, 96, 8, 5
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i, n_occ in enumerate((80, 61)):
        flat = rng.choice(12 * 12 * zb, size=n_occ, replace=False)
        coords[i, :n_occ] = np.stack(
            [flat // (12 * zb), (flat // zb) % 12, flat % zb], 1)
        coords[i, n_occ:] = -(2 ** 20)
        mask[i, :n_occ] = True
    x = rng.normal(size=(b, v, cin)).astype(np.float32)
    x[~mask] = 0
    fields = dict(pos=np.zeros((b, v, 3), np.float32), x=x, mask=mask,
                  y_reg=np.zeros((b, 2), np.float32),
                  y_reg_mask=np.ones((b, 2), bool),
                  area_idx=np.zeros(b, np.int32),
                  label_idx=np.arange(b, dtype=np.int64),
                  is_double=np.zeros(b, bool), coords=coords,
                  aux={"zcells": np.zeros(zb, np.int8)})
    jbatch = JBatch(**{k: (jax.tree.map(jnp.asarray, f) if f is not None
                           else None) for k, f in fields.items()})
    jnet = JNet(num_reg_targets=2, **NARROW)
    v0 = jax.tree.map(np.asarray, jax.jit(lambda bb: jnet.init(
        jax.random.PRNGKey(0), bb, train=False))(jbatch))
    params = jax.tree.map(
        lambda a: (a + rng.normal(size=a.shape) * 0.05).astype(np.float32),
        v0["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v0["batch_stats"])
    want = np.asarray(jax.jit(lambda vv, bb: jnet.apply(vv, bb, train=False))(
        {"params": params, "batch_stats": stats}, jbatch))
    net = SparseResNet(num_reg_targets=2, in_channels=cin, **NARROW)
    net.load_state_dict(from_flax(params, stats), strict=True)
    net.eval()
    assert net.stem_conv.kernel.shape[1] == cin
    with torch.no_grad():
        got = net(Batch(**fields).to("cpu")).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
