"""The treeadd chain of the port against the JAX package on the CPU:
`RadiusObjectAdder` and `topview_sample` give the same arrays, bit for bit,
on the same seed (every option that changes the draws: p=0, the
only_doubled_batch gate, the density adjustment with and without the
top-view resampling, the pos_deviation redraw, indicator_key, objects
without features, the in_memory cache under threads) and raise the same
"no objects" error; `generate_tree_db` writes the same files; the treeDB
processed from `data=instance/treeDB/ALS` (.las and .laz trees) is the
same `.npz` samples; and a narrow MPointNet evaluated with
`data.transform_type=sparse_xy_treeadd_eval` through both `eval` CLIs
gives the same prediction CSVs (predictions within 1e-4 relative, every
other cell equal)."""
import csv
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import eval as jeval  # noqa: E402
from dpcr_agb_tpu.ops import layout as jlayout  # noqa: E402
from dpcr_agb_tpu.config import load_config as jload  # noqa: E402
from dpcr_agb_tpu.data import dataset as jds  # noqa: E402
from dpcr_agb_tpu.data import synthetic as jsyn  # noqa: E402
from dpcr_agb_tpu.transforms import objects as jobj  # noqa: E402
from dpcr_agb_tpu_torch import eval as teval  # noqa: E402
from dpcr_agb_tpu_torch import train as ttrain  # noqa: E402
from dpcr_agb_tpu_torch.config import load_config as tload  # noqa: E402
from dpcr_agb_tpu_torch.data import dataset as tds  # noqa: E402
from dpcr_agb_tpu_torch.data import labels as tlabels  # noqa: E402
from dpcr_agb_tpu_torch.data import synthetic as tsyn  # noqa: E402
from dpcr_agb_tpu_torch.data.las_io import read_las, write_laz  # noqa: E402
from dpcr_agb_tpu_torch.transforms import TRANSFORM_REGISTRY  # noqa: E402
from dpcr_agb_tpu_torch.transforms import objects as tobj  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _jax_layout_restored():
    """The JAX trainer behind the root CLIs (eval.py, predict.py) sets the
    JAX package's batch layout (`dpcr_agb_tpu.ops.layout`) for its
    8-device mesh and keeps it: the files after this one in the same test
    worker get it back as it was, as tests/test_torch_trainer.py does (a
    leaked per-sample layout fails tests/test_sparse_stem.py's chunked
    pool backward)."""
    saved = (jlayout.BATCH_LOCAL, jlayout.DATA_PARALLEL_DEGREE)
    yield
    jlayout.set_batch_local(*saved)


CONF = os.path.join(ROOT, "conf")
AREA = "treeDB"
SUB = ("treeDB", "processed_treeDB_ALS", "train", AREA)


def _objects(root, n=6, x=True, deviation=None):
    """n processed-looking objects under root/treeDB/.../train/treeDB."""
    rng = np.random.default_rng(11)
    d = os.path.join(root, *SUB)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        k = 40 + 9 * i
        obj = {"pos": (rng.normal(size=(k, 3)) * [1.0, 1.0, 4.0]
                       + [0.0, 0.0, 9.0]).astype(np.float32),
               "local_stats": rng.uniform(2, 30, 3).astype(np.float32)}
        if x:
            obj["x"] = rng.normal(size=(k, 2)).astype(np.float32)
        if deviation is not None:
            obj["pos_deviation"] = np.array(
                [[deviation[i % len(deviation)], 1.0]], np.float32)
        np.savez(os.path.join(d, f"{i}.npz"), **obj)
    return root


def _sample(rng, n=300, area="NFI", doubled=False):
    return {"pos": rng.uniform(-15, 15, (n, 3)).astype(np.float32),
            "x": rng.normal(size=(n, 2)).astype(np.float32),
            "local_stats": rng.uniform(5, 20, 3).astype(np.float32),
            "y_reg": np.array([1.0, 2.0], np.float32),
            "area_name": np.str_(area), "is_double": doubled}


BASE = dict(areas={AREA: {"type": "object"}}, dataset_name="treeDB",
            processed_folder="processed_treeDB_ALS", min_radius=15.1,
            max_radius=20.0, n_max_objects={"scene": 4, "object": 3},
            rot_z=180, zero_center_z=True, in_memory=True, p=1.0)
# (case, objects kwargs, adder kwargs, sample kwargs)
CASES = [
    ("treeadd_eval", {}, {}, {}),
    ("object_area", {}, {}, {"area": AREA}),
    ("p0", {}, {"p": 0.0}, {}),
    ("p_half", {}, {"p": 0.5, "n_max_objects": 2}, {}),
    ("not_doubled", {}, {"only_doubled_batch": True}, {}),
    ("doubled", {}, {"only_doubled_batch": True}, {"doubled": True}),
    ("density", {}, {"adjust_point_density": True, "density_index": 1,
                     "density_adjustment": [0.2, 0.9]}, {}),
    ("density_topview", {}, {"adjust_point_density": True,
                             "density_topview_sample": True,
                             "density_adjustment": 0.3}, {}),
    ("pos_deviation", {"deviation": [1.0, 12.0, 3.0]},
     {"max_radius": 19.0, "rot_x": 10.0, "rot_y": 5.0}, {}),
    ("indicator", {}, {"indicator_key": "object_indicator",
                       "in_memory": False}, {}),
    ("indicator_gate_closed", {}, {"indicator_key": "object_indicator",
                                   "p": 0.0}, {}),
    ("no_x", {"x": False}, {"zero_center_z": False}, {}),
]


@pytest.mark.parametrize("case,okw,akw,skw", CASES, ids=[c[0] for c in CASES])
def test_adder_equals_jax(tmp_path, case, okw, akw, skw):
    root = _objects(str(tmp_path), **okw)
    kw = {**BASE, "root_folder": root, **akw}
    jadd, tadd = jobj.RadiusObjectAdder(**kw), tobj.RadiusObjectAdder(**kw)
    for seed in range(4):   # the in_memory cache is hit from the second on
        sample = _sample(np.random.default_rng(100 + seed), **skw)
        want = jadd(np.random.default_rng(seed), dict(sample))
        got = tadd(np.random.default_rng(seed), dict(sample))
        assert list(got) == list(want)
        for k in want:
            a, b = np.asarray(want[k]), np.asarray(got[k])
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=f"{case} {seed} {k}")
        added = got["pos"].shape[0] - sample["pos"].shape[0]
        assert got["x"].shape[0] == got["pos"].shape[0]
        if akw.get("p") == 0.0 or case == "not_doubled":
            assert added == 0
        elif case != "p_half":
            assert added > 0
    if case == "no_x":
        assert not got["x"][sample["pos"].shape[0]:].any()
    if case == "indicator":
        assert got["object_indicator"][300:].all()
        assert not got["object_indicator"][:300].any()


def test_adder_cache_hands_out_copies_under_threads(tmp_path):
    """Eight threads on one in_memory adder (as the loader's): each call
    equals a fresh adder's on its seed, and the cached arrays stay as they
    were read from disk."""
    root = _objects(str(tmp_path))
    kw = {**BASE, "root_folder": root}
    shared = tobj.RadiusObjectAdder(**kw)
    sample = _sample(np.random.default_rng(5))

    def run(seed):
        return shared(np.random.default_rng(seed), dict(sample))

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(run, range(32)))
    for seed, out in enumerate(got):
        want = jobj.RadiusObjectAdder(**kw)(np.random.default_rng(seed),
                                            dict(sample))
        np.testing.assert_array_equal(out["pos"], want["pos"])
    assert shared.memory
    for path, cached in shared.memory.items():
        with np.load(path) as z:
            for k in z.files:
                np.testing.assert_array_equal(cached[k], z[k])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_missing_objects_raise_naming_the_directory(tmp_path, pkg):
    mod = jobj if pkg == "jax" else tobj
    adder = mod.RadiusObjectAdder(**{**BASE, "root_folder": str(tmp_path),
                                     "dataset_name": "nope"})
    want = os.path.join(str(tmp_path), "nope", "processed_treeDB_ALS",
                        "train")
    with pytest.raises(AssertionError, match="no objects for "
                       "RadiusObjectAdder under " + want):
        adder(np.random.default_rng(0), _sample(np.random.default_rng(0)))


def test_adder_is_registered_and_finds_late_objects(tmp_path):
    assert TRANSFORM_REGISTRY["RadiusObjectAdder"] is tobj.RadiusObjectAdder
    adder = tobj.RadiusObjectAdder(**{**BASE, "root_folder": str(tmp_path)})
    assert adder.object_files == []
    _objects(str(tmp_path))     # processed after the adder was built
    out = adder(np.random.default_rng(0), _sample(np.random.default_rng(0)))
    assert out["pos"].shape[0] > 300 and len(adder.object_files) == 6


@pytest.mark.parametrize("num", [1, 7, 250])
def test_topview_sample_equals_jax(num):
    rng = np.random.default_rng(num)
    s = {"pos": rng.uniform(0, 20, (400, 3)).astype(np.float32),
         "x": rng.normal(size=(400, 2)).astype(np.float32),
         "one": np.ones(1, np.float32), "y_reg": np.array([3.0], np.float32)}
    want = jobj.topview_sample(np.random.default_rng(9), s, num)
    got = tobj.topview_sample(np.random.default_rng(9), s, num)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["pos"].shape == (num, 3) and got["one"].shape == (1,)


def test_generate_tree_db_equals_jax(tmp_path):
    jfile = jsyn.generate_tree_db(str(tmp_path / "j"), n_trees=6, seed=4)
    tfile = tsyn.generate_tree_db(str(tmp_path / "t"), n_trees=6, seed=4)
    assert os.path.basename(jfile) == os.path.basename(tfile) \
        == "treeDB_epsg_25832.gpkg"
    jl, tl = (tlabels.read_label_file(f) for f in (jfile, tfile))
    assert tl.columns == jl.columns
    for c in jl.columns:
        np.testing.assert_array_equal(np.asarray(tl[c]), np.asarray(jl[c]))
    for i in range(6):
        name = f"raw/ALS/tree_{i:04d}.las"
        with open(tmp_path / "j" / name, "rb") as a, \
                open(tmp_path / "t" / name, "rb") as b:
            assert a.read() == b.read()
    for seed in (0, 3):
        jp, jh = jsyn.generate_tree(np.random.default_rng(seed))
        tp, th = tsyn.generate_tree(np.random.default_rng(seed))
        np.testing.assert_array_equal(tp, jp)
        assert th == jh


def _treedb(root, n=24, laz_every=3):
    """A synthetic treeDB with every laz_every-th tree as a .laz file."""
    tsyn.generate_tree_db(os.path.join(root, "treeDB"), n_trees=n, seed=2)
    als = os.path.join(root, "treeDB", "raw", "ALS")
    for i in range(0, n, laz_every):
        las = os.path.join(als, f"tree_{i:04d}.las")
        pos, extras = read_las(las, ("classification",))
        write_laz(las[:-4] + ".laz", pos,
                  classification=extras["classification"])
        os.remove(las)


def _tree_overrides(root):
    return ["task=instance", "models=instance/simplestnet",
            "model_name=SimplestNet", "data=instance/treeDB/ALS",
            "data.transform_type=trees", "+data.trees.num_points=2048",
            f"data.dataroot={root}", "run_dir=unused"]


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_processed_treedb_equals_jax(tmp_path):
    for pkg in ("j", "t"):
        _treedb(str(tmp_path / pkg))
    jd = jds.instantiate_dataset(jload(CONF, "config", _tree_overrides(
        str(tmp_path / "j")))["data"])
    td = tds.instantiate_dataset(tload(CONF, "config", _tree_overrides(
        str(tmp_path / "t")))["data"])
    assert sorted(td.datasets) == sorted(jd.datasets)
    n = 0
    for split in ("train", "val", "test"):
        sub = os.path.join("treeDB", "processed_treeDB_ALS", split, AREA)
        jdir, tdir = tmp_path / "j" / sub, tmp_path / "t" / sub
        jf = sorted(os.listdir(jdir)) if jdir.exists() else []
        tf = sorted(os.listdir(tdir)) if tdir.exists() else []
        assert tf == jf, split
        for f in (f for f in jf if f.endswith(".npz")):
            want, got = _npz_arrays(jdir / f), _npz_arrays(tdir / f)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert {"pos", "x", "local_stats", "y_reg"} <= set(got)
            assert got["pos"][:, 2].min() == 0.0   # StartZFromZero
            n += 1
    assert n >= 16
    labels = td.get_labels(AREA)
    assert any(str(p).endswith(".laz") for p in labels["pt_file"])


def test_processed_treedb_through_the_train_route(tmp_path):
    """docs/treedb.md's step 1 through the port's train CLI: the treeDB is
    processed where RadiusObjectAdder looks for it, and the JAX package's
    dataset over the same raw files reads the same samples."""
    root = str(tmp_path / "t")
    _treedb(root)
    ttrain.main(_tree_overrides(root)[:-1] + [
        "training=default", "training.epochs=1", "training.batch_size=4",
        "training.num_workers=1", f"run_dir={tmp_path / 'run'}",
        "device=cpu"])
    objs = sorted((tmp_path / "t").glob("/".join(SUB) + "/*.npz"))
    assert objs
    _treedb(str(tmp_path / "j"))
    jds.instantiate_dataset(jload(CONF, "config", _tree_overrides(
        str(tmp_path / "j")))["data"])
    for f in objs:
        want = _npz_arrays(tmp_path / "j" / os.path.join(*SUB) / f.name)
        got = _npz_arrays(f)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_treeadd_eval_through_both_clis(tmp_path):
    """A narrow MPointNet trained one epoch by the port (its `.ckpt` is
    the JAX layout), then both eval CLIs with the treeadd preset over one
    processed treeDB: equal CSVs (predictions within 1e-4 relative)."""
    data = str(tmp_path / "data")
    _treedb(data, laz_every=100)
    jds.instantiate_dataset(jload(CONF, "config", _tree_overrides(
        data))["data"])
    run = str(tmp_path / "run")
    ttrain.main(["task=instance", "models=instance/minkowski_baseline",
                 "model_name=MPointNet", "data=instance/synthetic/reg",
                 "data.transform_type=sparse_xy", "data.synthetic_plots=12",
                 f"data.dataroot={data}", "training=nfi/minkowski",
                 "training.epochs=1", "training.batch_size=4",
                 "training.num_workers=1", "lr_scheduler=cosineawr",
                 "update_lr_scheduler_on=on_num_batch", "visualization=eval",
                 f"run_dir={run}", "device=cpu"])
    args = [f"checkpoint_dir={run}", "model_name=MPointNet",
            "weight_name=latest", "batch_size=4", "pretty_print=False",
            "data.transform_type=sparse_xy_treeadd_eval"]
    added = []
    real = tobj.RadiusObjectAdder.__call__

    def counting(self, rng, sample):
        out = real(self, rng, sample)
        added.append(out["pos"].shape[0] - sample["pos"].shape[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tobj.RadiusObjectAdder, "__call__", counting)
        teval.main(args + [f"run_dir={tmp_path / 'et'}", "device=cpu"])
    jeval.main(args + [f"run_dir={tmp_path / 'ej'}"])
    assert added and min(added) > 0
    for stage in ("val", "test"):
        jh, jr = _read_csv(tmp_path / "ej" / f"SYNTH_{stage}_preds.csv")
        th, tr = _read_csv(tmp_path / "et" / f"SYNTH_{stage}_preds.csv")
        assert th == jh and len(tr) == len(jr) > 0
        pred = [i for i, h in enumerate(jh) if h.startswith("pred_")]
        for a, b in zip(jr, tr):
            assert [v for i, v in enumerate(b) if i not in pred] \
                == [v for i, v in enumerate(a) if i not in pred]
            np.testing.assert_allclose([float(b[i]) for i in pred],
                                       [float(a[i]) for i in pred],
                                       rtol=1e-4)
