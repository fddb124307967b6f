"""Parity of the port's narrow SENet14 with the JAX package on the CPU under
every level-0 execution mode: the dense level 0 in each stem mode x each
pool-backward mode, first_stride 2, and each sparse-pool mode and fused
forward flavour of the sparse level 0. The same weights (through
weights.from_flax) and the same batch, made with numpy from a seed; the
eval forward (f32, 1e-4) and one `make_train_step` step (loss 1e-5, updated
parameters and BN running stats 1e-4). The JAX side's modes are module
globals set around the trace, the port's are constructor arguments; a last
case sets the port's through the environment instead. One checkpoint gives
the same output through the sparse and the dense level 0."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet
from dpcr_agb_tpu.ops import dense_grid as jgrid
from dpcr_agb_tpu.ops import dense_stem as jstem
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import make_train_step
from dpcr_agb_tpu_torch import train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models.minkowski import (MODE_VARS, SparseResNet,
                                                 build_resnet)
from dpcr_agb_tpu_torch.ops.dense_grid import POOL_BWD_MODES, STEM_MODES
from dpcr_agb_tpu_torch.weights import from_flax

DIMS, ZB = (12, 10, 12), 9          # level-0 dims (12, 10, 9)
NARROW = dict(block="se_basic", layers=(1, 1, 1, 1), planes=(16, 16, 32, 32),
              init_dim=16, activation="gelu", global_pool="sum",
              drop_path=0.0, dense_dims=DIMS)
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}
# the JAX package's module globals behind each mode
JAX_GLOBALS = {"l0_mode": [(jgrid, "L0_MODE")],
               "stem_mode": [(jgrid, "STEM_MODE")],
               "pool_bwd": [(jgrid, "POOL_BWD_MODE")],
               "sparse_pool": [(jgrid, "SPARSE_POOL_MODE")],
               "pool_fwd": [(jgrid, "POOL_FWD_MODE"),
                            (jstem, "POOL_FWD_MODE")]}

DENSE = [dict(l0_mode="dense", stem_mode=s, pool_bwd=p)
         for s in STEM_MODES for p in POOL_BWD_MODES]
STRIDE2 = [dict(first_stride=2),
           dict(first_stride=2, stem_mode="zfold2d_firewall",
                pool_bwd="pallas"),
           dict(first_stride=2, stem_mode="zfold_firewall",
                pool_bwd="manual", pool_fwd="window3d")]
SPARSE = [dict(sparse_pool=m) for m in ("fused", "scattermax", "dense",
                                        "rows")] \
    + [dict(sparse_pool="dense", pool_bwd="pallas"),
       dict(sparse_pool="fused", pool_fwd="separable"),
       dict(sparse_pool="fused", pool_fwd="scattermax")]
CASES = DENSE + STRIDE2 + SPARSE


def _id(case):
    return "-".join(f"{k}={v}" for k, v in case.items())


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
    y[1, 0] = np.nan
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


@contextlib.contextmanager
def _jax_modes(case):
    """The JAX package's mode globals set to `case` (defaults elsewhere)."""
    saved = []
    for name, (_, default, _) in MODE_VARS.items():
        value = case.get(name, default)
        for mod, attr in JAX_GLOBALS[name]:
            if name == "pool_fwd" and value == "unset":
                continue           # each module keeps its own default
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
    try:
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)


@functools.lru_cache(maxsize=None)
def _shared():
    """The batch and one set of weights (biases, BN affine and running
    stats moved off their initial values) for every case: the two level-0
    forms share parameter names and shapes."""
    rng = np.random.default_rng(0)
    fields = _fields(rng)
    jnet = JNet(num_reg_targets=2, first_stride=1, **NARROW)
    v = _np(jax.jit(lambda b: jnet.init(jax.random.PRNGKey(0), b,
                                        train=False))(_jbatch(fields)))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    return fields, params, stats


@functools.lru_cache(maxsize=None)
def _jax_case(key):
    """JAX under the case's modes: (eval output, loss of one train step,
    the parameters and BN stats after it)."""
    case = dict(key)
    fields, params, stats = _shared()
    jnet = JNet(num_reg_targets=2,
                first_stride=case.get("first_stride", 1), **NARROW)
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(v, np.float32)
                                       for k, v in STATS.items()})
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))
    with _jax_modes(case):
        out = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
            {"params": params, "batch_stats": stats}, _jbatch(fields))
        p, s, _, res = make_train_step(jnet, spec, tx)(
            params, stats, tx.init(params), _jbatch(fields), np.int32(0))
    return np.asarray(out), float(res["loss"]), _np(p), _np(s)


def _port(case, **extra):
    fields, params, stats = _shared()
    net = SparseResNet(num_reg_targets=2, in_channels=3,
                       **{"first_stride": 1, **NARROW, **case, **extra})
    net.load_state_dict(from_flax(params, stats), strict=True)
    return net, Batch(**fields).to("cpu")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_eval_forward_matches_jax_in_every_mode(case):
    want = _jax_case(tuple(case.items()))[0]
    net, batch = _port(case)
    net.eval()
    with torch.no_grad():
        got = net(batch).numpy()
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_train_step_matches_jax_in_every_mode(case):
    """One clip + AdaBelief step from the shared state: loss 1e-5, every
    updated parameter and BN running stat rtol 1e-4 (atol 1e-5)."""
    _, loss, p, s = _jax_case(tuple(case.items()))
    net, batch = _port(case)
    runner = train.build_runner(net, STATS, seed=0)
    out = runner.train(batch)
    np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-5)
    sd = net.state_dict()
    want = from_flax(p, s)
    assert set(want) == set(sd)
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_modes_come_from_the_environment_when_the_model_is_built(
        monkeypatch):
    """With no constructor argument each mode is its environment variable,
    read at construction (not at import): the net built under
    DPCR_L0=dense etc. equals the one built with the arguments, and later
    changes of the environment leave a built net alone."""
    case = dict(l0_mode="dense", stem_mode="zfold2d_firewall",
                pool_bwd="pallas", sparse_pool="rows", pool_fwd="separable")
    for name, value in case.items():
        monkeypatch.setenv(MODE_VARS[name][0], value)
    net, batch = _port({})
    for name, value in case.items():
        assert getattr(net, name) == value
        monkeypatch.delenv(MODE_VARS[name][0])
    assert not net.sparse_level0
    fresh, _ = _port({})
    assert fresh.sparse_level0 and fresh.pool_fwd == "unset"
    net.eval()
    with torch.no_grad():
        got = net(batch).numpy()
    want = _jax_case(tuple(dict(l0_mode="dense",
                                stem_mode="zfold2d_firewall",
                                pool_bwd="pallas").items()))[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
def test_one_checkpoint_serves_through_both_level0_forms(dtype, tol):
    """The sparse and the dense level 0 (every stem mode, the kernels'
    pool) share their parameters: the same state_dict gives the same
    output, f32 within 1e-3 of the largest value, bf16 within 5e-2."""
    sparse, batch = _port({}, dtype=dtype)
    sparse.eval()
    with torch.no_grad():
        want = sparse(batch).numpy()
        for stem in STEM_MODES:
            dense, _ = _port(dict(l0_mode="dense", stem_mode=stem,
                                  pool_bwd="pallas"), dtype=dtype)
            assert set(dense.state_dict()) == set(sparse.state_dict())
            dense.eval()
            np.testing.assert_allclose(dense(batch).numpy(), want, rtol=0,
                                       atol=tol * np.abs(want).max())


def test_bf16_dense_level0_close_to_jax():
    """bf16 activations round at other places in the two frameworks: the
    folded, firewalled dense level 0 within 5% of the output magnitude."""
    case = dict(l0_mode="dense", stem_mode="zfold2d_firewall",
                pool_bwd="pallas")
    fields, params, stats = _shared()
    jnet = JNet(num_reg_targets=2, first_stride=1, dtype=jnp.bfloat16,
                **NARROW)
    with _jax_modes(case):
        want = np.asarray(jax.jit(
            lambda v, b: jnet.apply(v, b, train=False))(
                {"params": params, "batch_stats": stats}, _jbatch(fields)))
    net, batch = _port(case, dtype=torch.bfloat16)
    net.eval()
    with torch.no_grad():
        got = net(batch).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def test_default_option_dict_builds_the_dense_level0_and_runs():
    """`build_resnet`'s own default is first_stride 2: an option dict that
    does not name it lands on the dense level 0."""
    fields, _, _ = _shared()
    net = build_resnet("SENet14", {"extra_options": {"dense_dims": DIMS}}, 2,
                       3, generator=torch.Generator().manual_seed(0))
    assert net.first_stride == 2 and not net.sparse_level0
    net.eval()
    with torch.no_grad():
        out = net(Batch(**fields).to("cpu"))
    assert out.shape == (3, 2) and bool(torch.isfinite(out).all())
