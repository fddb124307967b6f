"""Parity of the port's SENet14 eval forward with the JAX
SparseResNet._dense_forward (sparse level 0, fused pool; the other modes
in test_torch_dense_l0_model.py) on the CPU: a
narrow net (planes 16,16,32,32, init_dim 16) over dense_dims (12,12,12)
with a z bucket of 8, the same weights carried across by weights.from_flax,
random positive BN running stats."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet, build_resnet
from dpcr_agb_tpu_torch.weights import from_flax, to_flax

NARROW = dict(block="se_basic", layers=(1, 1, 1, 1), planes=(16, 16, 32, 32),
              init_dim=16, activation="gelu", first_stride=1,
              global_pool="sum", drop_path=0.01, dense_dims=(12, 12, 12))
ZB = 8


def _batch(rng, b=2, v=96, n_occ=(80, 57)):
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        flat = rng.choice(12 * 12 * ZB, size=n_occ[i], replace=False)
        coords[i, :n_occ[i]] = np.stack(
            [flat // (12 * ZB), (flat // ZB) % 12, flat % ZB], 1)
        coords[i, n_occ[i]:] = -(2 ** 20)
        mask[i, :n_occ[i]] = True
    x = rng.uniform(0, 1, (b, v, 3)).astype(np.float32)
    x[~mask] = 0
    fields = dict(pos=np.zeros((b, v, 3), np.float32), x=x, mask=mask,
                  y_reg=np.zeros((b, 2), np.float32),
                  y_reg_mask=np.ones((b, 2), bool),
                  area_idx=np.zeros(b, np.int32),
                  label_idx=np.arange(b, dtype=np.int64),
                  is_double=np.zeros(b, bool), coords=coords,
                  aux={"zcells": np.zeros(ZB, np.int8)})
    return fields


def _variables(jnet, jbatch, rng):
    init = jax.jit(lambda b: jnet.init(jax.random.PRNGKey(0), b,
                                       train=False))
    v = jax.tree.map(np.asarray, init(jbatch))
    # non-trivial params (biases and BN affine too) and BN running stats
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
    fields = _batch(rng)
    jbatch = JBatch(**{k: (jax.tree.map(jnp.asarray, f) if f is not None
                           else None) for k, f in fields.items()})
    jnet = JNet(num_reg_targets=2, **NARROW)
    variables = _variables(jnet, jbatch, rng)
    want = np.asarray(jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, jbatch))
    jnet16 = JNet(num_reg_targets=2, dtype=jnp.bfloat16, **NARROW)
    want16 = np.asarray(jax.jit(
        lambda v, b: jnet16.apply(v, b, train=False))(variables, jbatch))
    return dict(fields=fields, variables=variables, want=want,
                want16=want16)


def _port(case, dtype=torch.float32):
    net = SparseResNet(num_reg_targets=2, in_channels=3, dtype=dtype,
                       **NARROW)
    sd = from_flax(case["variables"]["params"],
                   case["variables"]["batch_stats"])
    net.load_state_dict(sd, strict=True)
    net.eval()
    with torch.no_grad():
        return net(Batch(**case["fields"]).to("cpu"))


def test_slice_forward_matches_jax_f32(case):
    got = _port(case).numpy()
    assert got.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, case["want"], rtol=1e-4, atol=1e-4)


def test_slice_forward_bf16_close_to_jax(case):
    """bf16 activations round at other places in the two frameworks:
    within 5% of the output magnitude."""
    got = _port(case, torch.bfloat16).numpy()
    assert np.isfinite(got).all()
    scale = np.abs(case["want16"]).max()
    np.testing.assert_allclose(got, case["want16"], rtol=0,
                               atol=5e-2 * scale)


def test_weight_bridge_round_trips_exactly(case):
    params, stats = case["variables"]["params"], \
        case["variables"]["batch_stats"]
    p2, s2 = to_flax(from_flax(params, stats))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    for (pa, a), (pb, b) in zip(flat(params) + flat(stats),
                                flat(p2) + flat(s2)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert len(flat(params)) == len(flat(p2))
    net = SparseResNet(num_reg_targets=2, in_channels=3, **NARROW)
    assert set(net.state_dict()) == set(from_flax(params, stats))


def test_z_bucket_shrinks_level0_dims(case):
    net = SparseResNet(num_reg_targets=2, in_channels=3, **NARROW)
    b = Batch(**case["fields"])
    assert net.level0_dims(b) == (12, 12, ZB)
    assert net.level0_dims(dataclasses.replace(b, aux=None)) == (12, 12, 12)


def test_full_width_senet14_builds_with_flax_names():
    net = build_resnet("SENet14", {"activation": "gelu", "first_stride": 1,
                                   "global_pool": "sum", "drop_path": 0.01},
                       num_reg_targets=2, in_channels=3,
                       generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    assert sd["stem_conv.kernel"].shape == (343, 3, 64)
    assert sd["stage3_block0.conv2.kernel"].shape == (27, 512, 512)
    assert sd["stage1_block0.downsample_conv.kernel"].shape == (1, 64, 128)
    assert sd["stage0_block0.se.fc1.kernel"].shape == (64, 4)
    assert sd["final.linear_1.kernel"].shape == (512, 1)
    assert "stage0_block0.downsample_conv.kernel" not in sd


@pytest.mark.parametrize("option,env", [
    ({"norm_type": "gn"}, {}),
    ({}, {"DPCR_L0": "dense3d"}),
    ({}, {"DPCR_SPARSE_POOL": "row"}),
    ({}, {"DPCR_STEM_MODE": "zfold"}),
    ({}, {"DPCR_POOL_BWD": "knockout"}),
    ({"first_stride": 2}, {"DPCR_POOL_FWD": "knockout"}),
])
def test_unported_modes_raise(option, env, monkeypatch):
    """A norm type neither package has (the instance and layer norms build
    since slice 17: tests/test_torch_norms.py; map mode since slice 15:
    tests/test_torch_map_mode.py) raises naming the four types, as the
    JAX `make_norm` does; an unknown value of a mode variable raises when
    the model is built."""
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    with pytest.raises((NotImplementedError, ValueError),
                       match="bn, bn_no_affine, in, ln" if not env
                       else "one of"):
        build_resnet("SENet14", {"first_stride": 1, **option}, 2, 3)
    if not env:
        from dpcr_agb_tpu.models.minkowski import make_norm as jmake_norm
        with pytest.raises(NotImplementedError,
                           match="bn, bn_no_affine, in, ln"):
            jmake_norm(option["norm_type"], 8, 0.1)


@pytest.mark.parametrize("name,option,env,sparse", [
    ("SENet14", {"first_stride": 2}, {}, False),
    ("SENet14", {}, {}, False),          # build_resnet's default stride is 2
    ("SENet14", {"first_stride": 1}, {"DPCR_L0": "dense"}, False),
    ("SENet14", {"first_stride": 1}, {"DPCR_SPARSE_POOL": "rows"}, True),
    ("SENet50", {"first_stride": 1}, {}, True),
    ("ResNet50_", {"first_stride": 1}, {"DPCR_L0": "dense",
                                        "DPCR_POOL_BWD": "pallas"}, False),
])
def test_once_unported_modes_build_and_run(name, option, env, sparse, case,
                                           monkeypatch):
    """The dense level 0 (by DPCR_L0 or first_stride 2), the other sparse
    pools and the bottleneck nets: full-width models that run the tiny
    batch."""
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    net = build_resnet(name, {"extra_options": {"dense_dims": (12, 12, 12)},
                              **option}, 2, 3,
                       generator=torch.Generator().manual_seed(0))
    assert net.sparse_level0 == sparse
    net.eval()
    with torch.no_grad():
        out = net(Batch(**case["fields"]).to("cpu"))
    assert out.shape == (2, 2) and bool(torch.isfinite(out).all())


def test_bottleneck_archs_raise():
    """Since slice 15 the bottleneck archs raise in neither mode: in map
    mode, as every arch, they build with the dense grid's parameters; a
    norm neither package has still raises."""
    mapped = build_resnet("SENet50", {"first_stride": 1,
                                      "extra_options": {"dense_dims": None}},
                          2, 3)
    net = build_resnet("SENet50", {"first_stride": 1}, 2, 3)
    assert mapped.dense_dims is None and net.dense_dims == (88, 88, 104)
    assert net.stage0_block0.conv3.kernel.shape == (1, 64, 256)
    assert {k: v.shape for k, v in mapped.state_dict().items()} \
        == {k: v.shape for k, v in net.state_dict().items()}
    with pytest.raises(NotImplementedError, match="norm_type='gn'"):
        build_resnet("SENet50", {"first_stride": 1, "norm_type": "gn"}, 2, 3)
