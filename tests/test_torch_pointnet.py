"""MPointNet and SimplestNet in the port against the JAX package on the
CPU: the eval forward, the train-mode forward with its BN batch moments
and running stats, and `return_point_features` (MPointNet at
embedding_channel 32; rtol 1e-5, atol 1e-5 * max|JAX|); one train step of
each from the same state against the JAX package's step (loss, every
gradient, the updated parameters and BN stats, within the tolerances of
`tests/test_torch_train.py`); padding rows that change nothing; the
port's `fixed_xy` chains against the JAX preset read from `conf/` (the
same arrays from one numpy seed, exactly 12000 points); `train.main` then
`predict.main` with `device=cpu` for both models; bf16 refused and no
CUDA fallback. Inputs are made with numpy from a seed; weights cross by
`weights.from_flax`."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.config import load_config
from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
from dpcr_agb_tpu.models.pointnet import MPointNet as JMPointNet
from dpcr_agb_tpu.models.simplestnet import SimplestNet as JSimplestNet
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import _forward, make_train_step
from dpcr_agb_tpu.transforms import instantiate_transforms as jtransforms
from dpcr_agb_tpu.transforms.core import _flatten
from dpcr_agb_tpu_torch import predict, train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.models.factory import build_model, collate_spec
from dpcr_agb_tpu_torch.models.pointnet import MPointNet
from dpcr_agb_tpu_torch.models.simplestnet import SimplestNet
from dpcr_agb_tpu_torch.serving import nfi_fixed_xy_data_cfg
from dpcr_agb_tpu_torch.transforms import instantiate_transforms
from dpcr_agb_tpu_torch.weights import from_flax

CONF = os.path.join(os.path.dirname(__file__), "..", "conf")
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}
EMBED = 32
MODELS = ("MPointNet", "SimplestNet")


def _fields(rng, b=4, n=96, n_valid=None):
    """A padded batch of b samples of n rows: pos in the unit cube, three
    features, a ragged mask (padding rows hold values too: the models must
    not read them), targets with a NaN."""
    n_valid = n_valid or [int(rng.integers(40, n)) for _ in range(b)]
    mask = np.zeros((b, n), bool)
    for i, k in enumerate(n_valid):
        mask[i, :k] = True
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    y[1, 0] = np.nan
    return dict(pos=rng.uniform(0, 1, (b, n, 3)).astype(np.float32),
                x=rng.normal(size=(b, n, 3)).astype(np.float32),
                mask=mask, y_reg=y, y_reg_mask=~np.isnan(y),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool))


def _jbatch(fields):
    return JBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


def _nets(name):
    """(JAX module, port module) of one model at the test's width."""
    if name == "MPointNet":
        return (JMPointNet(num_reg_targets=2, embedding_channel=EMBED),
                MPointNet(2, 3, embedding_channel=EMBED))
    return JSimplestNet(num_reg_targets=2), SimplestNet(2, 3)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _variables(name, rng):
    """JAX init, then parameters and BN stats moved off their init values
    (BN affine and running stats far from 1 and 0)."""
    jnet, _ = _nets(name)
    v = _np(jnet.init(jax.random.PRNGKey(0), _jbatch(_fields(rng)),
                      train=False))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    return params, stats


def _port(name, params, stats):
    _, net = _nets(name)
    net.load_state_dict(from_flax(params, stats), strict=True)
    return net


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


# ---- forward ----------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_eval_forward_matches_jax(name):
    rng = np.random.default_rng(1)
    params, stats = _variables(name, rng)
    fields = _fields(rng)
    jnet, _ = _nets(name)
    want = jnet.apply({"params": params, "batch_stats": stats},
                      _jbatch(fields), train=False)
    net = _port(name, params, stats).eval()
    with torch.no_grad():
        got = net(Batch(**fields).to("cpu"))
    assert got.shape == (4, 2) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", MODELS)
def test_train_forward_and_bn_stats_match_jax(name):
    """Training mode: BN moments over the valid rows (MPointNet's pooled
    blocks over the batch), the running stats moved by momentum 0.1 with
    the unbiased variance."""
    rng = np.random.default_rng(2)
    params, stats = _variables(name, rng)
    fields = _fields(rng)
    jnet, _ = _nets(name)
    want, mutated = jnet.apply({"params": params, "batch_stats": stats},
                               _jbatch(fields), train=True,
                               mutable=["batch_stats"])
    net = _port(name, params, stats).train()
    with torch.no_grad():
        got = net(Batch(**fields).to("cpu"),
                  generator=torch.Generator().manual_seed(0))
    _close(got.numpy(), want)
    sd = net.state_dict()
    want_stats = from_flax({}, _np(mutated["batch_stats"]))
    assert want_stats and set(want_stats) <= set(sd)
    for key, w in want_stats.items():
        _close(sd[key].numpy(), w.numpy(), key)


def test_point_features_match_jax():
    """MPointNet's return_point_features: the per-row embedding after the
    three shared blocks, in eval and in training mode."""
    rng = np.random.default_rng(3)
    params, stats = _variables("MPointNet", rng)
    fields = _fields(rng)
    jnet, _ = _nets("MPointNet")
    variables = {"params": params, "batch_stats": stats}
    net = _port("MPointNet", params, stats)
    for train_mode in (False, True):
        want = jnet.apply(variables, _jbatch(fields), train=train_mode,
                          return_point_features=True,
                          mutable=["batch_stats"] if train_mode else False)
        if train_mode:
            want = want[0]
        net.train(train_mode)
        with torch.no_grad():
            got = net(Batch(**fields).to("cpu"), return_point_features=True)
        assert got.shape == (4, 96, EMBED)
        _close(got.numpy(), want, f"train={train_mode}")


@pytest.mark.parametrize("name", MODELS)
def test_padding_rows_change_nothing(name):
    """The same samples padded with 40 more rows of other values (mask
    False): the same outputs in eval and in training mode and the same
    running stats."""
    rng = np.random.default_rng(4)
    fields = _fields(rng, n=96)
    padded = dict(fields)
    extra = _fields(rng, n=40, n_valid=[0] * 4)
    for k in ("pos", "x", "mask"):
        padded[k] = np.concatenate([fields[k], extra[k]], 1)
    torch.manual_seed(0)
    _, net = _nets(name)
    twin = _nets(name)[1]
    twin.load_state_dict(net.state_dict())
    for mode in (False, True):
        net.train(mode)
        twin.train(mode)
        with torch.no_grad():
            a = net(Batch(**fields).to("cpu"))
            b = twin(Batch(**padded).to("cpu"))
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for key, t in net.state_dict().items():
        torch.testing.assert_close(t, twin.state_dict()[key], rtol=1e-5,
                                   atol=1e-7, msg=key)


# ---- one train step ----------------------------------------------------------

def _jtx():
    return optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(name):
    """One step of the paper's recipe (clip 100, AdaBelief, CAWR) from one
    state on both sides: loss rel 1e-5, each gradient rel-L2 1e-4, the
    updated parameters and BN stats rtol 1e-4, atol 1e-5."""
    rng = np.random.default_rng(5)
    params, stats = _variables(name, rng)
    fields = _fields(rng)
    jnet, _ = _nets(name)
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(v, np.float32)
                                       for k, v in STATS.items()})

    def loss_fn(p):
        reg_out, _, _ = _forward(jnet, spec, p, stats, _jbatch(fields),
                                 train=True)
        return jloss(spec, reg_out, jnp.asarray(fields["y_reg"]),
                     jnp.asarray(fields["y_reg_mask"]), True)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = _jtx()
    p1, s1, _, out = make_train_step(jnet, spec, tx)(
        params, stats, tx.init(params), _jbatch(fields), np.int32(0))
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-6)

    runner = train.build_runner(_port(name, params, stats), STATS, seed=0)
    got = runner.train(Batch(**fields))
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    want_g = from_flax(jax.tree.map(lambda g: np.clip(g, -100, 100),
                                    _np(grads)), None)
    named = dict(runner.net.named_parameters())
    assert set(want_g) == set(named)
    for key, g in want_g.items():
        assert _rel(named[key].grad.numpy(), g.numpy()) < 1e-4, key
    sd = runner.net.state_dict()
    want = from_flax(_np(p1), _np(s1))
    assert set(want) == set(sd)
    for key, w in want.items():
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


# ---- the fixed_xy chains -------------------------------------------------------

def _plot_sample(seed):
    """A synthetic plot as the pre_transform leaves it (metres, XY centred,
    z from 0), with its targets."""
    rng = np.random.default_rng(seed)
    pts, bm, v = generate_plot(rng, density=8.0)
    pos = pts - np.array([pts[:, 0].mean(), pts[:, 1].mean(),
                          pts[:, 2].min()], np.float32)
    return {"pos": pos.astype(np.float32),
            "y_reg": np.array([bm, v], np.float32),
            "y_reg_mask": np.ones(2, bool)}


@pytest.mark.parametrize("split", ["train_transform", "test_transform"])
def test_fixed_xy_chain_mirrors_the_yaml_and_equals_jax(split):
    cfg = load_config(CONF, "config", [
        "task=instance", "data=instance/NFI/reg", "model_name=SimplestNet",
        "models=instance/simplestnet",
        "data.transform_type=fixed_xy"]).data.to_dict()
    mine_cfg = nfi_fixed_xy_data_cfg()
    assert mine_cfg["fixed_xy"]["num_points"] == \
        cfg["fixed_xy"]["num_points"] == 12000
    chain = mine_cfg[split]
    assert chain == list(_flatten(cfg["fixed_xy"][split]))
    mine, ref = instantiate_transforms(chain), jtransforms(chain)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for seed in range(2):
        s = _plot_sample(seed)
        out = mine(rng, dict(s))
        want = ref(jrng, dict(s))
        assert out.keys() == want.keys()
        for k in out:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
            assert np.asarray(out[k]).dtype == np.asarray(want[k]).dtype, k
        assert out["pos"].shape == (12000, 3) and out["x"].shape == (12000, 3)
    assert rng.random() == jrng.random()
    spec = collate_spec("PARTIAL_DENSE", mine_cfg)
    assert spec.conv_type == "dense" and spec.num_points == 12000


# ---- the entry points -----------------------------------------------------------

def _write_plots(root, n=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, bm, v = generate_plot(rng, radius=6.0, density=3.0)
        np.savez(os.path.join(root, f"p{i}.npz"),
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=v)


@pytest.mark.parametrize("name", MODELS)
def test_train_then_predict_on_the_cpu(tmp_path, name):
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots)
    out = train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                      f"model_name={name}", "steps=2", "batch_size=2",
                      "device=cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    path = predict.main([f"checkpoint_dir={ckpt}", f"model_name={name}",
                         f"input={plots}/*.npz",
                         f"output={tmp_path}/p.csv", "device=cpu"])
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    preds = np.array([[float(x) for x in r[1:]] for r in rows])
    assert preds.shape == (3, 2) and np.isfinite(preds).all()
    bundle = predict.load_serving_bundle(ckpt, name, device="cpu")
    assert type(bundle.net) is {"MPointNet": MPointNet,
                                "SimplestNet": SimplestNet}[name]
    assert bundle.post_collate is None
    if name == "SimplestNet":
        assert bundle.collate_spec.num_points == 12000
    else:
        assert bundle.collate_spec.conv_type == "sparse"
        assert bundle.net.add_pos


@pytest.mark.parametrize("name", MODELS)
def test_bf16_is_refused(tmp_path, name):
    with pytest.raises(ValueError, match="f32 only"):
        train.model_option(name, bf16=True)
    option = train.model_option(name, bf16=False)
    option["extra_options"] = {"bf16": True}
    with pytest.raises(ValueError, match="f32 only"):
        build_model(option, 2, 3)
    with pytest.raises(ValueError, match="dense_dims"):
        train.model_option(name, bf16=False, dense_dims=(8, 8, 8))
    plots = str(tmp_path / "plots")
    _write_plots(plots, 1)
    with pytest.raises(ValueError, match="f32 only"):
        train.main([f"input={plots}/*.npz", f"checkpoint_dir={tmp_path}/ck",
                    f"model_name={name}", "steps=1", "bf16=true",
                    "device=cpu"])


@pytest.mark.parametrize("name", MODELS)
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(tmp_path,
                                                             monkeypatch,
                                                             name):
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots, 1)
    train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                f"model_name={name}", "steps=1", "batch_size=1",
                "device=cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}2",
                    f"model_name={name}", "steps=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([f"checkpoint_dir={ckpt}", f"model_name={name}",
                      f"input={plots}/*.npz", f"output={tmp_path}/p.csv"])


def test_factory_defaults_follow_the_jax_factory():
    """An entry that names nothing gets the JAX factory's MPointNet: relu,
    mean pool, no positions; the train entry is README's recipe."""
    bare = {"class": "minkowski.MinkowskiBaselineModel",
            "model_name": "MinkowskiPointNet"}
    net, conv_type = build_model(bare, 2, 3)
    assert conv_type == "SPARSE" and not net.add_pos
    assert net.b1_lin.kernel.shape == (3, 64)
    assert net.b3_lin.kernel.shape == (128, 1024)
    net, _ = build_model(train.model_option("MPointNet", False), 2, 3)
    assert net.add_pos and net.b1_lin.kernel.shape == (6, 64)
    net, conv_type = build_model(train.model_option("SimplestNet", False),
                                 2, 3)
    assert conv_type == "PARTIAL_DENSE"
    assert net.conv0.kernel.shape == (6, 64) and net.conv0.bias is not None
