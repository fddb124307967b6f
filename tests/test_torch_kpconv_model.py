"""Parity of the port's KPCNN with the JAX `KPCNN(fused_kernel=True)` on the
CPU (the Pallas kernel in interpret mode): a narrow net (the 5-block
architecture simple, resnetb, resnetb_strided, resnetb, global_sum;
first_features_dim 16, 5 kernel points, first_subsampling_dl 0.1) over
clouds of 64 points, the device pyramid built on both sides, weights
carried across by `weights.from_flax`. Then `build_kpconv`, the collate
policy, the xy chains and the serving entry point for `model_name=KPConv`
on tiny plots with `device=cpu`."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.config import load_config
from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.kpconv import KPCNN as JNet
from dpcr_agb_tpu.transforms import instantiate_transforms as jtransforms
from dpcr_agb_tpu.transforms.core import _flatten
from dpcr_agb_tpu_torch import predict, train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.models.factory import (build_model, collate_spec,
                                               make_post_collate)
from dpcr_agb_tpu_torch.models.kpconv import KPCNN, KPConvOp, build_kpconv
from dpcr_agb_tpu_torch.serving import (load_serving_bundle, nfi_xy_data_cfg,
                                        save_checkpoint)
from dpcr_agb_tpu_torch.transforms import instantiate_transforms
from dpcr_agb_tpu_torch.weights import from_flax, to_flax

CONF = os.path.join(os.path.dirname(__file__), "..", "conf")
ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "global_sum"]
NARROW = dict(architecture=ARCH, num_reg_targets=2, in_features_dim=3,
              first_features_dim=16, num_kernel_points=5,
              first_subsampling_dl=0.1, use_batch_norm=True)


def _fields(rng, b=2, n=64):
    """Clouds in the unit cube, the tail of the second masked out; no exact
    distance ties, so both top-k give the same neighbour lists."""
    pos = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 50:] = False
    pos[~mask] = 0.0                       # what the collate pads with
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x[~mask] = 0.0
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    return dict(pos=pos, x=x, mask=mask, y_reg=y,
                y_reg_mask=np.ones((b, 2), bool),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool))


def _jbatch(fields):
    return JBatch(**{k: jnp.asarray(f) for k, f in fields.items()})


def _variables(jnet, jbatch, rng):
    """Init, then non-trivial BN affine and running stats."""
    v = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), jbatch,
                                           train=False))
    params = jax.tree.map(
        lambda a: (a + rng.normal(size=a.shape) * 0.05).astype(np.float32),
        v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    fields = _fields(rng)
    jbatch = _jbatch(fields)
    jnet = JNet(fused_kernel=True, **NARROW)
    variables = _variables(jnet, jbatch, rng)
    return dict(fields=fields, variables=variables, jbatch=jbatch)


def _port(case, train_mode=False, **overrides):
    net = KPCNN(**{**NARROW, **overrides})
    net.load_state_dict(from_flax(case["variables"]["params"],
                                  case["variables"]["batch_stats"]),
                        strict=True)
    net.train(train_mode)
    with torch.no_grad():
        out = net(Batch(**case["fields"]).to("cpu"))
    return net, out.numpy()


def test_eval_forward_matches_jax_fused_f32(case):
    """2e-4, the JAX package's tolerance between its fused and its einsum
    whole-model forwards."""
    jnet = JNet(fused_kernel=True, **NARROW)
    want = np.asarray(jnet.apply(case["variables"], case["jbatch"],
                                 train=False))
    _, got = _port(case)
    assert got.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_train_forward_and_running_stats_match_jax(case):
    """BN batch moments over the valid points and the momentum-0.02 update
    of the running stats: output 2e-4, stats 1e-4."""
    jnet = JNet(fused_kernel=True, **NARROW)
    want, mutated = jnet.apply(case["variables"], case["jbatch"], train=True,
                               mutable=["batch_stats"])
    net, got = _port(case, train_mode=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    sd = net.state_dict()
    stats = from_flax({}, jax.tree.map(np.asarray, mutated["batch_stats"]))
    assert stats
    for name, w in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_bf16_forward_close_to_jax_bf16(case):
    """bf16 inside the fused KPConv only, f32 around it. The Pallas body
    sums the per-edge products over K in bf16, the port in f32, and four
    KPConvs follow one another: within 5e-2 of the output's magnitude."""
    jnet = JNet(fused_kernel=True, dtype=jnp.bfloat16, **NARROW)
    want = np.asarray(jnet.apply(case["variables"], case["jbatch"],
                                 train=False))
    net, got = _port(case, dtype=torch.bfloat16)
    assert net.block0_kpconv.dtype == torch.bfloat16
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("overrides", [
    dict(architecture=ARCH[:-1] + ["global_average"]),
    dict(kp_influence="gaussian", aggregation_mode="closest"),
    dict(architecture=["simple", "resnetb_strided", "unary", "global_sum"],
         neighborhood_limits=[9, 6], point_fracs=[1.0, 0.5]),
], ids=["global-average", "gaussian-closest", "unary-limits-fracs"])
def test_variants_match_jax(case, overrides):
    cfg = {**NARROW, **overrides}
    jnet = JNet(fused_kernel=True, **cfg)
    variables = _variables(jnet, case["jbatch"], np.random.default_rng(1))
    want = np.asarray(jnet.apply(variables, case["jbatch"], train=False))
    net = KPCNN(**cfg)
    net.load_state_dict(from_flax(variables["params"],
                                  variables["batch_stats"]), strict=True)
    net.eval()
    with torch.no_grad():
        got = net(Batch(**case["fields"]).to("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_no_batch_norm_uses_a_bias(case):
    cfg = {**NARROW, "use_batch_norm": False}
    jnet = JNet(fused_kernel=True, **cfg)
    v = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(1),
                                           case["jbatch"], train=False))
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), v["params"])
    want = np.asarray(jnet.apply({"params": params}, case["jbatch"],
                                 train=False))
    net = KPCNN(**cfg)
    net.load_state_dict(from_flax(params, {}), strict=True)
    assert "block0_norm.bias" in net.state_dict()
    net.eval()
    with torch.no_grad():
        got = net(Batch(**case["fields"]).to("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_a_pyramid_in_aux_is_used_as_given(case):
    """`device_pyramid` returns the form `batch.aux` carries; a batch that
    brings it gives the same output, and a changed list changes it."""
    net, want = _port(case)
    batch = Batch(**case["fields"]).to("cpu")
    aux = net.device_pyramid(batch.pos, batch.mask)
    assert sorted(aux) == ["kp_conv0", "kp_conv1", "kp_mask0", "kp_mask1",
                           "kp_pool0", "kp_pts0", "kp_pts1"]
    assert aux["kp_conv0"].shape == (2, 64, 40)
    assert aux["kp_pool0"].shape == (2, net.level_caps(64)[1], 40)
    batch.aux = aux
    with torch.no_grad():
        np.testing.assert_array_equal(net(batch).numpy(), want)
        aux["kp_conv0"] = torch.full_like(aux["kp_conv0"], 64)
        assert np.abs(net(batch).numpy() - want).max() > 1e-3


def test_weight_bridge_round_trips_and_full_width_names_match_flax():
    """The paper's 14-block net at full width: the port's state_dict has
    the flax names and shapes (the JAX side traced with `jax.eval_shape`,
    nothing computed); the kernel points are not in it."""
    option = train.model_option("KPConv", bf16=False)
    net = build_kpconv(option, 2, 3, torch.Generator().manual_seed(0))
    cfg = option["config"]
    jnet = JNet(architecture=cfg["architecture"], num_reg_targets=2,
                in_features_dim=3)
    fields = _fields(np.random.default_rng(0), n=32)
    shapes = jax.eval_shape(lambda b: jnet.init(
        jax.random.PRNGKey(0), b, train=False), _jbatch(fields))
    want = from_flax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"]),
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                     shapes["batch_stats"]))
    sd = net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == {k: tuple(v.shape) for k, v in want.items()}
    assert sd["block0_kpconv.weights"].shape == (15, 3, 32)
    assert sd["block13_kpconv.weights"].shape == (15, 256, 256)
    assert sum(k.endswith("_kpconv.weights") for k in sd) == 14
    bound = 1 / np.sqrt(256 * 256)
    w = sd["block13_kpconv.weights"]
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound
    params, stats = to_flax(sd)
    back = from_flax(params, stats)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy())


def test_per_level_extent_and_kernel_points():
    net = build_kpconv(train.model_option("KPConv", bf16=True), 2, 3)
    assert net.dtype == torch.bfloat16
    assert [len(lv) for lv in net.levels] == [3, 3, 3, 3, 2]
    assert net.level_caps(8192) == [8192, 5736, 2872, 1480, 824]
    for bi, level in ((0, 0), (2, 0), (3, 1), (13, 4)):
        op = getattr(net, f"block{bi}_kpconv")
        assert op.dtype == torch.bfloat16
        np.testing.assert_allclose(op.extent, 0.0125 * 2 ** level, rtol=1e-6)
        assert op.kernel_points.shape == (15, 3)
        assert float(op.kernel_points.norm(dim=1).max()) \
            <= 0.0125 * 2.5 * 2 ** level * 1.1


@pytest.mark.parametrize("make", [
    lambda: KPConvOp(3, 4, np.zeros((5, 3), np.float32), 0.1,
                     deformable=True),
    lambda: KPCNN(**{**NARROW, "architecture": [
        "simple", "resnetb_deformable", "global_sum"]}),
    lambda: build_kpconv({"config": {"architecture": ARCH,
                                     "modulated": True}}, 2, 3),
], ids=["op", "architecture", "modulated"])
def test_deformable_kpconv_waits_for_a_later_slice(make):
    """Deformable and modulated KPConv are ported (their parity with the
    JAX package is in tests/test_torch_deformable.py): each builds and
    gives a finite forward of the right shape in train mode, recording
    the regularizer only where an op is deformable."""
    rng = np.random.default_rng(0)
    m = make()
    m.train()
    if isinstance(m, KPConvOp):
        nbr = torch.from_numpy(rng.integers(0, 9, (2, 6, 4)).astype(
            np.int32))
        x = torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(
            np.float32))
        rel = torch.from_numpy(rng.uniform(-0.1, 0.1, (2, 6, 4, 3)).astype(
            np.float32))
        out = m(nbr, x, rel)
        assert out.shape == (2, 6, 4) and m.loss is not None
        losses = {"op": m.loss}
    else:
        out = m(Batch(**_fields(rng)).to("cpu"))
        assert out.shape == (2, 2)
        losses = m.internal_losses()
        assert bool(losses) == any("deformable" in b
                                   for b in m.architecture)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(v) for v in losses.values())


def test_factory_builds_kpconv_with_the_dense_collate():
    option = train.model_option("KPConv", bf16=False)
    net, conv_type = build_model(option, 2, 3)
    assert isinstance(net, KPCNN) and conv_type == "PARTIAL_DENSE"
    # the entry points' batches carry the pyramid built on the host: five
    # levels, 40 neighbours a level where the option names no limits
    aux = make_post_collate(net)(
        Batch(**_fields(np.random.default_rng(0)))).aux
    assert sorted(aux) == sorted(
        [f"kp_{k}{l}" for k in ("pts", "mask", "conv") for l in range(5)]
        + [f"kp_pool{l}" for l in range(4)])
    assert aux["kp_conv0"].shape == (2, 64, 40)
    spec = collate_spec(conv_type, nfi_xy_data_cfg())
    assert (spec.conv_type, spec.num_points, spec.min_bucket,
            spec.use_coords) == ("dense", None, 1024, False)
    fixed = collate_spec("DENSE", {"transform_type": "fixed_xy",
                                   "fixed_xy": {"num_points": 4096}})
    assert fixed.num_points == 4096
    with pytest.raises(ValueError, match="dense_dims"):
        train.model_option("KPConv", bf16=False, dense_dims=(8, 8, 8))


def _sample(seed=0, density=8.0):
    rng = np.random.default_rng(seed)
    pts, bm, v = generate_plot(rng, density=density)
    pos = (pts / np.array([30.0, 30.0, 40.0], np.float32) + np.array(
        [0.5, 0.5, 0.0], np.float32)).astype(np.float32)
    return {"pos": pos, "y_reg": np.array([bm, v], np.float32),
            "y_reg_mask": np.ones(2, bool)}


@pytest.mark.parametrize("which", ["train_transform", "test_transform"])
def test_xy_chains_mirror_the_yaml_and_equal_jax(which):
    """The port's plain-dict xy chains are the YAML's, and give the JAX
    package's samples from one numpy seed (equal arrays and dtypes); a plot
    dense enough that MaxPoints 6144 binds is among them."""
    cfg = load_config(CONF, "config", [
        "task=instance", "data=instance/NFI/reg", "model_name=KPConv",
        "models=instance/kpconv", "data.transform_type=xy"]).data.to_dict()
    chain = nfi_xy_data_cfg()[which]
    assert chain == list(_flatten(cfg["xy"][which]))
    mine, ref = instantiate_transforms(chain), jtransforms(chain)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    counts = []
    for i, density in enumerate((8.0, 8.0, 30.0)):
        s = _sample(i, density)
        a, b = mine(rng, dict(s)), ref(jrng, dict(s))
        assert a.keys() == b.keys() and "coords" not in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert a["x"].shape[1] == 3
        counts.append(len(a["pos"]))
    assert max(counts) == 6144 > min(counts) >= 500
    assert rng.random() == jrng.random()


def _write_plots(root, n=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, bm, v = generate_plot(rng, radius=6.0, density=3.0)
        np.savez(os.path.join(root, f"p{i}.npz"),
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=v)


def test_predict_serves_a_kpconv_checkpoint_on_the_cpu(tmp_path):
    """A full-width checkpoint with seeded weights through `predict.main`:
    finite rows, the batch padded to a power-of-two bucket without coords,
    with its host pyramid in aux, and the same raw output as the module
    called directly."""
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots)
    option = train.model_option("KPConv", bf16=False)
    net, _ = build_model(option, 2, 3, torch.Generator().manual_seed(0))
    save_checkpoint(ckpt, "KPConv", net, option, 3, nfi_xy_data_cfg(),
                    {"scale": [60.0, 120.0], "center": [150.0, 300.0],
                     "weights": [0.5, 0.5]}, ["BMag_ha", "V_ha"])
    path = predict.main([f"checkpoint_dir={ckpt}", "model_name=KPConv",
                         f"input={plots}/*.npz", f"output={tmp_path}/p.csv",
                         "batch_size=2", "device=cpu"])
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["file", "pred_BMag_ha", "pred_V_ha"]
    preds = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    assert preds.shape == (3, 2) and np.isfinite(preds).all()

    bundle = load_serving_bundle(ckpt, "KPConv", device="cpu")
    assert bundle.conv_type == "PARTIAL_DENSE" \
        and bundle.post_collate is not None
    files = sorted(os.path.join(plots, f) for f in os.listdir(plots))
    samples, _ = predict.load_samples(bundle, files)
    (batch, n), _ = predict.make_batches(bundle, samples, 2)
    assert n == 2 and batch.coords is None
    n_max = max(len(s["pos"]) for s in samples[:2])
    bucket = 1024 if n_max <= 1024 else 2048
    assert 500 <= n_max <= 2048
    assert batch.pos.shape == batch.x.shape == (2, bucket, 3)
    assert batch.aux["kp_conv0"].shape == (2, bucket, 40)
    assert predict.describe_batch(batch) == f"N bucket {bucket}"
    got = predict.predictions(bundle, predict.forward_raw(bundle, batch))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, preds[:2], rtol=1e-5)
