"""Parity of the port's bottleneck nets with the JAX package on the CPU: a
narrow SENet50 (se_bottleneck) and ResNet50_ (bottleneck) over dense_dims
(12,10,12) with a z bucket of 9, layers (2,1,1,1) so that blocks with and
without a projection shortcut both occur, the same weights through
weights.from_flax (conv3 / norm3 included) and the same numpy batch: the
eval forward in f32 (1e-4) and bf16 (5e-2 of the largest value), one
`make_train_step` step from a fresh state and one after carrying the optax
state across, the full-width builders, and the entry points
(`train.main` -> `predict.main` on the CPU) for SENet50 and for SENet14
under the dense level 0."""
import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import make_train_step
from dpcr_agb_tpu_torch import predict, train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet, build_resnet
from dpcr_agb_tpu_torch.training.state import load_named_optimizer_state
from dpcr_agb_tpu_torch.weights import (from_flax, opt_state_from_optax,
                                        to_flax)

DIMS, ZB = (12, 10, 12), 9
NARROW = dict(layers=(2, 1, 1, 1), planes=(8, 8, 16, 16), init_dim=16,
              activation="gelu", first_stride=1, global_pool="sum",
              drop_path=0.0, dense_dims=DIMS)
BLOCKS = {"SENet50": "se_bottleneck", "ResNet50_": "bottleneck"}
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}


def _fields(rng, b=3, v=96):
    d, h, _ = DIMS
    coords = np.full((b, v, 3), -(2 ** 20), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        n = int(rng.integers(50, 90))
        flat = rng.choice(d * h * ZB, size=n, replace=False)
        coords[i, :n] = np.stack([flat // (h * ZB), flat // ZB % h,
                                  flat % ZB], 1)
        mask[i, :n] = True
    x = np.where(mask[..., None], rng.uniform(0, 1, (b, v, 3)), 0)
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    y[2, 1] = np.nan
    return dict(pos=np.zeros((b, v, 3), np.float32), x=x.astype(np.float32),
                mask=mask, y_reg=y, y_reg_mask=~np.isnan(y),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool), coords=coords,
                aux={"zcells": np.zeros(ZB, np.int8)})


def _jbatch(fields):
    return JBatch(**{k: jax.tree.map(jnp.asarray, f)
                     for k, f in fields.items()})


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _tx():
    return optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX: perturbed init, eval outputs in f32 and bf16, two train steps
    (the states after each, the optax state after the first)."""
    rng = np.random.default_rng(0)
    batches = [_fields(rng), _fields(rng)]
    kw = dict(num_reg_targets=2, block=BLOCKS[arch], **NARROW)
    jnet = JNet(**kw)
    v = _np(jax.jit(lambda b: jnet.init(jax.random.PRNGKey(0), b,
                                        train=False))(_jbatch(batches[0])))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, _jbatch(batches[0])))
    jnet16 = JNet(dtype=jnp.bfloat16, **kw)
    want16 = np.asarray(jax.jit(
        lambda v, b: jnet16.apply(v, b, train=False))(
            variables, _jbatch(batches[0])))
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(v, np.float32)
                                       for k, v in STATS.items()})
    tx = _tx()
    step = make_train_step(jnet, spec, tx)
    p, s, o = params, stats, tx.init(params)
    states, losses = [(params, stats, _np(o))], []
    for i in range(2):
        p, s, o, out = step(p, s, o, _jbatch(batches[i]), np.int32(i))
        losses.append(float(out["loss"]))
        p, s, o = _np(p), _np(s), _np(o)
        states.append((p, s, o))
    return dict(batches=batches, want=want, want16=want16, states=states,
                losses=losses)


def _net(arch, params, stats, dtype=torch.float32):
    net = SparseResNet(num_reg_targets=2, in_channels=3, dtype=dtype,
                       block=BLOCKS[arch], **NARROW)
    net.load_state_dict(from_flax(params, stats), strict=True)
    return net


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_bottleneck_forward_matches_jax_f32(arch):
    run = _jax_run(arch)
    net = _net(arch, *run["states"][0][:2]).eval()
    with torch.no_grad():
        got = net(Batch(**run["batches"][0]).to("cpu")).numpy()
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, run["want"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_bottleneck_forward_bf16_close_to_jax(arch):
    """bf16 activations round at other places in the two frameworks:
    within 5% of the output magnitude."""
    run = _jax_run(arch)
    net = _net(arch, *run["states"][0][:2], dtype=torch.bfloat16).eval()
    with torch.no_grad():
        got = net(Batch(**run["batches"][0]).to("cpu")).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, run["want16"], rtol=0,
                               atol=5e-2 * np.abs(run["want16"]).max())


def _check_step(arch, i):
    """Port step i from JAX state i: loss 1e-5, updated parameters and BN
    running stats rtol 1e-4 (atol 1e-5)."""
    run = _jax_run(arch)
    params, stats, opt_state = run["states"][i]
    runner = train.build_runner(_net(arch, params, stats), STATS, seed=0)
    if i:
        load_named_optimizer_state(runner, opt_state_from_optax(opt_state))
        runner.step = i
    out = runner.train(Batch(**run["batches"][i]))
    np.testing.assert_allclose(float(out["loss"]), run["losses"][i],
                               rtol=1e-5)
    p, s, _ = run["states"][i + 1]
    sd = runner.net.state_dict()
    want = from_flax(p, s)
    assert set(want) == set(sd)
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    return runner


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_bottleneck_train_step_matches_jax(arch):
    runner = _check_step(arch, 0)
    assert runner.step == 1 and runner.num_samples == 3


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_bottleneck_step_after_carrying_the_optax_state(arch):
    """The optax moments of conv3 / norm3 (and of every other parameter)
    cross with `opt_state_from_optax`, then the second step agrees."""
    run = _jax_run(arch)
    named = opt_state_from_optax(run["states"][1][2])
    assert named["count"] == 1
    assert "stage0_block0.conv3.kernel" in named["exp_avg"]
    assert "stage0_block0.norm3.scale" in named["exp_avg_var"]
    _check_step(arch, 1)


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_weight_bridge_covers_the_bottleneck_names(arch):
    params, stats, _ = _jax_run(arch)["states"][0]
    sd = from_flax(params, stats)
    net = SparseResNet(num_reg_targets=2, in_channels=3, block=BLOCKS[arch],
                       **NARROW)
    assert set(net.state_dict()) == set(sd)
    assert sd["stage0_block0.conv3.kernel"].shape == (1, 8, 32)
    assert sd["stage0_block0.norm3.mean"].shape == (32,)
    assert sd["stage0_block0.conv1.kernel"].shape == (1, 16, 8)
    # the second block of stage 0 keeps its 32 channels: no projection
    assert "stage0_block0.downsample_conv.kernel" in sd
    assert "stage0_block1.downsample_conv.kernel" not in sd
    assert ("stage0_block0.se.fc1.kernel" in sd) == (arch == "SENet50")
    p2, s2 = to_flax(sd)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    for (pa, a), (pb, b) in zip(flat(params) + flat(stats),
                                flat(p2) + flat(s2)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,blocks,se", [
    ("SENet50", 16, True), ("ResNet50_", 16, False),
    ("SENet101", 33, True), ("ResNet101_", 33, False)])
def test_full_width_bottleneck_archs_build_with_flax_names(name, blocks, se):
    net = build_resnet(name, {"activation": "gelu", "first_stride": 1,
                              "global_pool": "sum", "drop_path": 0.01}, 2, 3,
                       generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    assert len(net.block_names) == blocks and net.sparse_level0
    assert sd["stem_conv.kernel"].shape == (343, 3, 64)
    assert sd["stage0_block0.conv1.kernel"].shape == (1, 64, 64)
    assert sd["stage0_block0.conv3.kernel"].shape == (1, 64, 256)
    assert sd["stage0_block0.downsample_conv.kernel"].shape == (1, 64, 256)
    assert sd["stage3_block2.conv2.kernel"].shape == (27, 512, 512)
    assert sd["stage3_block0.downsample_conv.kernel"].shape == (1, 1024,
                                                                2048)
    assert sd["final.linear_1.kernel"].shape == (2048, 1)
    assert ("stage3_block2.se.fc1.kernel" in sd) == se
    if se:
        assert sd["stage3_block2.se.fc1.kernel"].shape == (2048, 128)


def _write_plots(root, n=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, bm, v = generate_plot(rng, radius=6.0, density=3.0)
        np.savez(os.path.join(root, f"p{i}.npz"),
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=v)


def _train_then_predict(tmp_path, model_name, dims):
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots)
    out = train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                      f"model_name={model_name}", "steps=2", "batch_size=2",
                      "device=cpu", f"dense_dims={dims}"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    path = predict.main([f"checkpoint_dir={ckpt}",
                         f"model_name={model_name}", f"input={plots}/*.npz",
                         f"output={tmp_path}/p.csv", "device=cpu"])
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    preds = np.array([[float(x) for x in r[1:]] for r in rows])
    assert preds.shape == (3, 2) and np.isfinite(preds).all()
    return ckpt


def test_senet50_entry_points_train_and_serve_on_the_cpu(tmp_path):
    """Full width (planes 64-512 x 4, layers (3,4,6,3)) on tiny plots."""
    ckpt = _train_then_predict(tmp_path, "SENet50", "24,24,32")
    saved = torch.load(os.path.join(ckpt, "SENet50.pt"), map_location="cpu",
                       weights_only=True)
    assert saved["option"]["model_name"] == "SENet50"
    assert saved["weights"]["latest"][
        "stage3_block2.conv3.kernel"].shape == (1, 512, 2048)


def test_senet14_entry_points_under_the_dense_level0(tmp_path, monkeypatch):
    """DPCR_L0=dense with the folded, firewalled stem and the kernels'
    pool, read when `train.main` and `predict.main` build the model."""
    for var, value in (("DPCR_L0", "dense"),
                       ("DPCR_STEM_MODE", "zfold2d_firewall"),
                       ("DPCR_POOL_BWD", "pallas")):
        monkeypatch.setenv(var, value)
    ckpt = _train_then_predict(tmp_path, "SENet14", "24,24,32")
    bundle = predict.load_serving_bundle(ckpt, "SENet14", device="cpu")
    assert not bundle.net.sparse_level0
    assert bundle.net.stem_mode == "zfold2d_firewall"


def test_conf_model_names_are_the_entry_points_models():
    assert train.MODELS["ResNet50"][0]["model_name"] == "ResNet50_"
    assert train.MODELS["SENet101"][0]["model_name"] == "SENet101"
    assert train.model_option("SENet50", bf16=True)["extra_options"] == {
        "bf16": True}
    for name in ("PointNet", "PointNext"):
        assert train.model_option(name, bf16=False)["class"] == \
            "pointnext.PointNext"
    assert train.model_option("PointNet", False)["arch"] == "pointnet"
    assert train.model_option("PointNext", False)["arch"] == "pointnext_s"
    with pytest.raises(NotImplementedError, match="trains"):
        train.model_option("PointTransformer", bf16=False)
