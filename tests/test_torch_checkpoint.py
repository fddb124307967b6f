"""The port's reading and writing of the JAX package's `.ckpt` checkpoints,
held against the JAX package on the CPU.

- The port's msgpack decoder (`training/msgpack.unpackb`) returns what
  `flax.serialization.msgpack_restore` returns on one payload of every
  msgpack type and flax ext code, bfloat16, numpy scalars, complex numbers
  and chunked leaves (flax's MAX_CHUNK_SIZE set small for the test); flax
  restores what the port's encoder writes to an equal tree.
- `Checkpoint.get_model_state` resolves each weight name to the state JAX
  resolves it to, in the pool layout (two names sharing one pool entry)
  and in the first, legacy layout.
- `.ckpt` serving: a JAX `Checkpoint` of a JAX model's init variables
  (perturbed, with random BN running stats) and a run_config from
  `load_config(conf, ...)`; the root `predict.py` and
  `python -m dpcr_agb_tpu_torch.predict ... device=cpu` write CSVs that
  agree on the same `.laz` plots for SENet14, a narrow KPConv, MPointNet
  and SimplestNet, all four through the root CLI: within 1e-4, and for
  MPointNet and KPConv within the relative tolerance of their forward
  parity tests (`RTOL`). Their raw outputs are sums over the plot's ~2000
  points (MPointNet's sum pool) and over neighbour lists (KPConv, whose
  root CLI builds the host pyramid where the port builds its device
  pyramid); at this checkpoint's random BN stats they sit at ~10-80, and
  the two frameworks' f32 sums part at ~1e-6 (MPointNet) and ~1e-5
  (KPConv) of them. (The JAX serving bundle builds KPConv 1 input wide,
  from a feature_dimension it leaves at 0, but flax applies the
  checkpoint's 3-wide first layer as it is, so the root CLI serves it.)
- A `.ckpt` written by the port is read by JAX's `Checkpoint.from_bytes`
  and served by the root `predict.py` to the port's CSV.
- `PointNetForward`: the port's per-point features within 1e-5 of JAX's.

Sizes: 3 plots at 3 points/m^2 (~2100 points each). SENet14 runs at its
full width over a level-0 volume of (40, 40, 16): the NFI chains put the
plot in the unit box's hexagon, which leaves (16, 16, 16)'s corner empty
and every prediction equal. The targets' scale (4, 8) keeps one f32
rounding of SENet14's and SimplestNet's raw outputs (~1e-6 of them) under
the CSV's 1e-4."""
import csv
import logging
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import predict as jax_predict
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.config import load_config
from dpcr_agb_tpu.data.batch import collate as jcollate
from dpcr_agb_tpu.data.las_io import write_laz14 as jwrite_laz14
from dpcr_agb_tpu.serving import load_serving_bundle as jload_bundle
from dpcr_agb_tpu.training import state as jstate
from dpcr_agb_tpu.training.state import Checkpoint as JCheckpoint
from dpcr_agb_tpu.transforms import PointNetForward as JPointNetForward
from dpcr_agb_tpu_torch import predict
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.serving import load_serving_bundle
from dpcr_agb_tpu_torch.training import msgpack as pmsgpack
from dpcr_agb_tpu_torch.training import state as pstate
from dpcr_agb_tpu_torch.training.state import Checkpoint
from dpcr_agb_tpu_torch.transforms import ModelInference, PointNetForward
from dpcr_agb_tpu_torch.weights import to_flax


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


CONF = os.path.join(os.path.dirname(__file__), "..", "conf")
PROPS = {"target_stats": {"scale": [4.0, 8.0], "center": [100.0, 200.0],
                          "weights": [0.5, 0.5]},
         "reg_targets": ["BMag_ha", "V_ha"]}
# model_name -> (models group, transform_type)
SETUP = {"SENet14": ("instance/minkowski_baseline", "sparse_xy"),
         "KPConv": ("instance/kpconv", "xy"),
         "MPointNet": ("instance/minkowski_baseline", "sparse_xy"),
         "SimplestNet": ("instance/simplestnet", "fixed_xy")}
# the CSVs agree within 1e-4; MPointNet and KPConv also within the relative
# tolerance of their whole-model forward parity tests
# (tests/test_torch_pointnet.py, tests/test_torch_kpconv_model.py), taken
# of the de-standardized prediction less the targets' center
RTOL = {"SENet14": 0.0, "KPConv": 2e-4, "MPointNet": 1e-5,
        "SimplestNet": 0.0}
KPCONV_NARROW = {"architecture": ["simple", "resnetb", "resnetb_strided",
                                  "resnetb", "global_sum"],
                 "first_features_dim": 16, "num_kernel_points": 5,
                 "first_subsampling_dl": 0.1}


# --- msgpack -----------------------------------------------------------

def _same(got, want, path="$"):
    """got (the port's tree) equals want (flax's): the same containers and
    keys, scalars of the same type, arrays of the same dtype and values
    (flax's numpy scalars against the port's 0-d arrays, flax's bfloat16
    arrays against the port's torch.bfloat16 tensors, bit for bit)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) \
            and np.asarray(want).dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, np.ndarray), (path, type(got))
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, msgpack.ExtType):
        assert isinstance(got, pmsgpack.Ext) and tuple(got) == tuple(want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _every_type(rng) -> dict:
    """A tree of every msgpack type that flax writes, and of flax's ext
    codes; each ExtType of an unknown code takes a fixext or ext length."""
    return {
        "ints": [5, 200, 60000, 4_000_000_000, 2 ** 63 + 5, -5, -100,
                 -30000, -2 ** 31, -2 ** 40],
        "atoms": [None, True, False, 1.5, -2.25e300],
        "strs": ["", "a" * 31, "b" * 40, "c" * 300, "d" * 70000, "é€"],
        "bins": [b"", b"x" * 40, b"y" * 300, b"z" * 70000],
        "arrays": [list(range(15)), list(range(20)), list(range(70000))],
        "maps": [{"k": 1}, {str(i): i for i in range(20)},
                 {str(i): -i for i in range(70000)}],
        "exts": [msgpack.ExtType(5, bytes(range(n)))
                 for n in (1, 2, 4, 8, 16, 100)]
        + [msgpack.ExtType(6, b"e" * n) for n in (300, 70000)],
        "ndarrays": {
            "f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f64": rng.normal(size=(5,)),
            "i8": rng.integers(-100, 100, (2, 3)).astype(np.int8),
            "u16": rng.integers(0, 60000, (7,)).astype(np.uint16),
            "i64": rng.integers(-2 ** 40, 2 ** 40, (2, 2)),
            "bool": rng.random(6) < 0.5,
            "c64": (rng.normal(size=3) + 1j * rng.normal(size=3)).astype(
                np.complex64),
            "zero_d": np.array(3.5, np.float32),
            "empty": np.zeros((0, 3), np.int32),
            "bf16": jnp.asarray(rng.normal(size=(4, 5)), jnp.bfloat16),
            "wide": rng.normal(size=(40, 40)).astype(np.float32),
        },
        "scalars": [np.float32(2.5), np.int64(-7), np.bool_(True)],
        "complex": complex(1.0, -2.0),
        # over the test's MAX_CHUNK_SIZE of 4096 bytes: 3 and 2 chunks
        "chunked": rng.normal(size=(30, 100)).astype(np.float32),
        "chunked_bf16": jnp.asarray(rng.normal(size=(3000,)), jnp.bfloat16),
    }


def test_decoder_equals_flax_on_every_type(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 4096)
    tree = _every_type(np.random.default_rng(0))
    body = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in body
    # a top-level map of the tree and a float32, which flax never writes
    data = (b"\x82" + msgpack.packb("tree") + body + msgpack.packb("f32")
            + msgpack.packb(0.1, use_single_float=True))
    want = fser.msgpack_restore(data)
    got = pmsgpack.unpackb(data)
    _same(got, want)
    assert got["tree"]["chunked"].shape == (30, 100)
    assert got["f32"] == np.float32(0.1)


def test_encoder_output_is_restored_by_flax(monkeypatch):
    """Arrays, tensors (bf16 too), numpy scalars, complex numbers, tuples,
    every length form; a chunked numpy leaf and a chunked bf16 tensor."""
    monkeypatch.setattr(pmsgpack, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(1)
    tree = _every_type(rng)
    tree["ndarrays"]["bf16"] = torch.randn(4, 5).to(torch.bfloat16)
    tree["chunked_bf16"] = torch.randn(3000).to(torch.bfloat16)
    tree["tensor_f32"] = torch.randn(2, 3)
    tree["tuple"] = (1, "two", 3.0)
    del tree["exts"]                 # flax writes no ext of its own codes
    data = pmsgpack.packb(tree)
    assert b"__msgpack_chunked_array__" in data
    back = fser.msgpack_restore(data)
    # what flax reads is what the port reads, and both are the tree
    _same(pmsgpack.unpackb(data), back)
    np.testing.assert_array_equal(back["tensor_f32"],
                                  tree["tensor_f32"].numpy())
    np.testing.assert_array_equal(
        np.asarray(back["chunked_bf16"]).view(np.int16),
        tree["chunked_bf16"].view(torch.int16).numpy())
    np.testing.assert_array_equal(back["chunked"], tree["chunked"])
    assert back["tuple"] == [1, "two", 3.0]
    assert back["complex"] == complex(1.0, -2.0)
    assert back["scalars"][1] == np.int64(-7)
    with pytest.raises(TypeError, match="not a str"):
        pmsgpack.packb({1: 2})


# --- checkpoint layout and weight names --------------------------------

def _marked(i):
    return {"params": {"w": np.full(2, float(i), np.float32)},
            "batch_stats": {}}


def _models(with_latest=True):
    """Five names over four states; best_val_total_BMag_ha_rmse and
    best_val_loss_total are one object (one pool entry)."""
    shared = _marked(1)
    models = {"best_val_total_BMag_ha_rmse": shared,
              "best_val_loss_total": shared,
              "best_test_total_BMag_ha_rmse": _marked(2),
              "best_train_total_V_ha_mae": _marked(3)}
    if with_latest:
        models["latest"] = _marked(0)
    return models


def _jax_checkpoints(with_latest=True):
    """(pool layout, legacy layout) bytes written by the JAX package."""
    ck = JCheckpoint({"model_name": "X"}, dict(PROPS))
    ck.models = _models(with_latest)
    legacy = fser.msgpack_serialize({
        "models": _models(with_latest), "run_config": {"model_name": "X"},
        "dataset_properties": dict(PROPS)})
    return ck.to_bytes(), legacy


def _resolve(ckpt, name):
    try:
        return float(np.asarray(ckpt.get_model_state(name)["params"]["w"])[0])
    except KeyError:
        return "KeyError"


@pytest.mark.parametrize("name", [
    "latest", "best_val_total_BMag_ha_rmse", "val_total_BMag_ha_rmse",
    "total_BMag_ha_rmse", "total_V_ha_mae", "loss_total",
    "total_AGB_rmse"])
def test_weight_names_resolve_as_in_jax(name):
    """The exact name, best_<name>, the stage-prefixed suffix (best_val_
    first), else latest; KeyError without latest. Both layouts."""
    for with_latest in (True, False):
        for data in _jax_checkpoints(with_latest):
            want = _resolve(JCheckpoint.from_bytes(data), name)
            got = _resolve(Checkpoint.from_bytes(data), name)
            assert got == want, (name, with_latest)
    pool, _ = _jax_checkpoints()
    ck = Checkpoint.from_bytes(pool)
    assert ck.models["best_val_total_BMag_ha_rmse"] \
        is ck.models["best_val_loss_total"]
    assert ck.run_config == {"model_name": "X"}
    assert ck.dataset_properties["reg_targets"] == PROPS["reg_targets"]


def test_port_checkpoint_layout_is_read_by_jax():
    """The port's to_bytes: one pool entry for the shared state, refs for
    every name, stats, optimizer and schedulers as JAX lays them out."""
    ck = Checkpoint({"model_name": "X"}, dict(PROPS))
    ck.models = _models()
    ck.stats["train"].append({"epoch": 1, "loss": np.float32(0.5)})
    ck.optimizer = ("AdaBelief", {"step": 3, "flat": [np.ones(2)]})
    back = JCheckpoint.from_bytes(ck.to_bytes())
    raw = fser.msgpack_restore(ck.to_bytes())
    assert len(raw["model_pool"]) == 4 and len(raw["model_refs"]) == 5
    assert back.models["best_val_total_BMag_ha_rmse"] \
        is back.models["best_val_loss_total"]
    for name in ck.models:
        np.testing.assert_array_equal(
            back.get_model_state(name)["params"]["w"],
            ck.models[name]["params"]["w"])
    assert back.optimizer[0] == "AdaBelief" \
        and back.optimizer[1]["step"] == 3
    assert back.stats["train"][0]["epoch"] == 1 and back.start_epoch == 2
    assert Checkpoint.from_bytes(ck.to_bytes()).stats == back.stats
    # the port reads its own file back the same way
    again = Checkpoint.from_bytes(ck.to_bytes())
    assert again.models["best_val_total_BMag_ha_rmse"] \
        is again.models["best_val_loss_total"]


def test_env_snapshot_check_matches_jax(monkeypatch, caplog):
    monkeypatch.setenv("DPCR_L0", "dense")
    monkeypatch.delenv("DPCR_POOL_BWD", raising=False)
    saved = {"dpcr_env": {"DPCR_L0": "sparse", "DPCR_POOL_BWD": "xla"}}
    assert pstate.dpcr_env_snapshot() == jstate.dpcr_env_snapshot()
    with caplog.at_level(logging.WARNING):
        got = pstate.check_env_snapshot(saved)
    assert got == jstate.check_env_snapshot(saved) \
        == ["DPCR_L0", "DPCR_POOL_BWD"]
    assert "DPCR_L0" in caplog.text
    assert pstate.check_env_snapshot({}) == []


# --- serving a JAX checkpoint ------------------------------------------

def _run_config(model_name: str, transform_type=None) -> dict:
    models, tt = SETUP[model_name]
    rc = load_config(CONF, "config", [
        "task=instance", "data=instance/NFI/reg", f"model_name={model_name}",
        f"models={models}",
        f"data.transform_type={transform_type or tt}"]).to_dict()
    option = rc["models"][model_name]
    if model_name == "SENet14":
        option.setdefault("extra_options", {})["dense_dims"] = [40, 40, 16]
    if model_name == "KPConv":
        option["config"].update(KPCONV_NARROW)
    return rc


def _write_plots(root, n=3, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, _, _ = generate_plot(rng, density=3.0)
        jwrite_laz14(os.path.join(root, f"plot_{i:02d}.laz"),
                     pts + np.array([5e5, 6e6, 120.0]))
    return sorted(os.path.join(root, f) for f in os.listdir(root))


def _jax_batch(bundle, files):
    """The files as the root predict.py batches them (one batch)."""
    rng = np.random.default_rng(0)
    samples = []
    for f in files:
        s = jax_predict._sample_from_file(f, bundle.feature_cols, None,
                                          bundle.pre_transform)
        samples.append(bundle.eval_transform(rng, s))
    for s in samples:
        s["y_reg"] = np.full(2, np.nan, np.float32)
        s["y_reg_mask"] = np.zeros(2, bool)
    batch = jcollate(samples, bundle.collate_spec, pad_to_batch=16)
    return bundle.post_collate(batch) if bundle.post_collate else batch


def _write_jax_checkpoint(ckpt_dir, model_name, files, seed=0) -> dict:
    """A JAX `.ckpt` of the model's init variables, perturbed, with random
    BN running stats; returns them."""
    rc = _run_config(model_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{model_name}.ckpt")
    ck = JCheckpoint(rc, dict(PROPS))
    ck.models["latest"] = {"params": {}, "batch_stats": {}}
    with open(path, "wb") as f:     # the JAX bundle's pipeline and net
        f.write(ck.to_bytes())
    bundle = jload_bundle(ckpt_dir, model_name, feature_dimension=3)
    v = jax.tree.map(np.asarray, bundle.net.init(
        jax.random.PRNGKey(seed), _jax_batch(bundle, files), train=False))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + rng.normal(size=a.shape) * 0.05).astype(np.float32),
        v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    ck.models["latest"] = {"params": params, "batch_stats": stats}
    with open(path, "wb") as f:
        f.write(ck.to_bytes())
    return ck.models["latest"]


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.array([[float(v) for v in r[1:]] for r in rows[1:]])


@pytest.mark.parametrize("model_name", list(SETUP))
def test_jax_checkpoint_served_by_both_clis(tmp_path, model_name):
    files = _write_plots(str(tmp_path / "plots"))
    ckpt = str(tmp_path / "ckpt")
    _write_jax_checkpoint(ckpt, model_name, files)
    args = [f"checkpoint_dir={ckpt}", f"model_name={model_name}",
            f"input={tmp_path}/plots/*.laz"]
    got = predict.main(args + [f"output={tmp_path}/port.csv", "device=cpu"])
    want = jax_predict.main(args + [f"output={tmp_path}/jax.csv"])
    (gh, gf, gp), (wh, wf, wp) = _read_csv(got), _read_csv(want)
    assert gh == wh == ["file", "pred_BMag_ha", "pred_V_ha"]
    assert gf == wf == [os.path.basename(f) for f in files]
    assert np.isfinite(gp).all()
    # the plots differ, and so do their predictions
    assert np.ptp(wp[:, 0]) > 1e-3
    center = np.asarray(PROPS["target_stats"]["center"])
    np.testing.assert_allclose(gp - center, wp - center,
                               rtol=RTOL[model_name], atol=1e-4)


def test_port_written_checkpoint_served_by_root_cli(tmp_path):
    """SENet14 from a JAX `.ckpt` into the port, out again as a `.ckpt`
    by `weights.to_flax` and the port's `Checkpoint.to_bytes`; the root
    predict.py reads it (JAX's `Checkpoint.from_bytes`) to the port's
    CSV, and the port serves its own file to the same."""
    files = _write_plots(str(tmp_path / "plots"))
    _write_jax_checkpoint(str(tmp_path / "jax"), "SENet14", files)
    bundle = load_serving_bundle(str(tmp_path / "jax"), "SENet14",
                                 device="cpu")
    params, stats = to_flax(bundle.net.state_dict())
    ck = Checkpoint(_run_config("SENet14"), dict(PROPS))
    ck.models["latest"] = {"params": params, "batch_stats": stats}
    ck.models["best_val_total_BMag_ha_rmse"] = ck.models["latest"]
    os.makedirs(tmp_path / "port")
    (tmp_path / "port" / "SENet14.ckpt").write_bytes(ck.to_bytes())
    args = ["model_name=SENet14", "weight_name=total_BMag_ha_rmse",
            f"input={tmp_path}/plots/*.laz"]
    want = predict.main(args + [f"checkpoint_dir={tmp_path}/jax",
                                f"output={tmp_path}/a.csv", "device=cpu"])
    got_jax = jax_predict.main(args + [f"checkpoint_dir={tmp_path}/port",
                                       f"output={tmp_path}/b.csv"])
    got_port = predict.main(args + [f"checkpoint_dir={tmp_path}/port",
                                    f"output={tmp_path}/c.csv", "device=cpu"])
    ref = _read_csv(want)
    for got in (got_jax, got_port):
        g = _read_csv(got)
        assert g[:2] == ref[:2]
        np.testing.assert_allclose(g[2], ref[2], rtol=0, atol=1e-4)
    raw = fser.msgpack_restore((tmp_path / "port" / "SENet14.ckpt")
                               .read_bytes())
    assert len(raw["model_pool"]) == 1 and len(raw["model_refs"]) == 2


def test_transform_type_and_missing_files(tmp_path):
    """transform_type picks the stored preset `<tt>_eval`: the treeadd
    preset builds, with RadiusObjectAdder first in its chain, and without a
    processed treeDB the adder raises its "no objects" error, naming the
    directory, at its first call (never skipped); no checkpoint file names
    both paths."""
    from dpcr_agb_tpu_torch.models.factory import build_model
    rc = _run_config("SimplestNet")
    net, _ = build_model(rc["models"]["SimplestNet"], 2, 3)
    params, stats = to_flax(net.state_dict())
    ck = Checkpoint(rc, dict(PROPS))
    ck.models["latest"] = {"params": params, "batch_stats": stats}
    (tmp_path / "SimplestNet.ckpt").write_bytes(ck.to_bytes())
    b = load_serving_bundle(str(tmp_path), "SimplestNet", device="cpu")
    assert b.collate_spec.num_points == 12000
    assert [type(t).__name__ for t in b.eval_transform.transforms][-1] \
        == "AddFeatsByKeys"
    tb = load_serving_bundle(str(tmp_path), "SimplestNet", device="cpu",
                             transform_type="fixed_xy_treeadd")
    adder = tb.eval_transform.transforms[0]
    assert type(adder).__name__ == "RadiusObjectAdder"
    assert [type(t).__name__ for t in tb.eval_transform.transforms[1:]] \
        == [type(t).__name__ for t in b.eval_transform.transforms]
    sample = {"pos": np.zeros((20, 3), np.float32),
              "area_name": np.str_("NFI")}
    with pytest.raises(AssertionError,
                       match="no objects for RadiusObjectAdder under .*"
                             "processed_treeDB_ALS"):
        adder(np.random.default_rng(0), sample)
    with pytest.raises(ValueError, match="not in the stored config"):
        load_serving_bundle(str(tmp_path), "SimplestNet", device="cpu",
                            transform_type="no_such_preset")
    with pytest.raises(FileNotFoundError, match=r"KPConv\.pt.*KPConv\.ckpt"):
        load_serving_bundle(str(tmp_path), "KPConv", device="cpu")


def test_pointnet_forward_features_match_jax(tmp_path):
    files = _write_plots(str(tmp_path / "plots"), n=2)
    _write_jax_checkpoint(str(tmp_path), "MPointNet", files)
    rng = np.random.default_rng(3)
    sample = {"pos": rng.random((300, 3)).astype(np.float32),
              "x": rng.normal(size=(300, 3)).astype(np.float32)}
    want = JPointNetForward(checkpoint_dir=str(tmp_path),
                            model_name="MPointNet", feat_name="pn")(
        rng, dict(sample))["pn"]
    got = PointNetForward(checkpoint_dir=str(tmp_path),
                          model_name="MPointNet", feat_name="pn",
                          device="cpu")(rng, dict(sample))
    assert got["pn"].shape == want.shape == (300, 1024)
    assert got["pn"].dtype == np.float32
    np.testing.assert_allclose(got["pn"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["x"], sample["x"])
    with pytest.raises(NotImplementedError):
        ModelInference(checkpoint_dir=str(tmp_path), model_name="MPointNet",
                       device="cpu")(rng, sample)
