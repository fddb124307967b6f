"""Parity of the port's training ops with the JAX package on the CPU: the
row-form pool backward against the VJP of `pooled_rows_fused` and against
the interpret-mode `pallas_max_pool` VJP read at the occupied cells (ties
included), the stem's weight and bias gradients against `jax.grad` of
`stem_conv_sparse_batch`, and the explicit-generator DropPath and Dropout.
Same numpy inputs on both sides."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.ops.pallas_pool import pallas_max_pool
from dpcr_agb_tpu.ops.sparse_stem import (_scatter_to_dense_impl,
                                          pooled_rows_fused,
                                          stem_conv_sparse_batch)
from dpcr_agb_tpu_torch.nn.blocks import DropPath, Dropout
from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool, scatter_to_dense
from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                         masked_max_pool_bwd_rows,
                                         masked_max_pool_bwd_rows_plain,
                                         pooled_rows)
from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_rows,
                                                stem_conv_sites_dw_plain)

T = torch.from_numpy
DIMS = [(12, 10, 9), (7, 13, 8)]


def _rows(rng, dims, b=2, v=48, n_occ=(40, 31), c=16):
    """Unique occupied coords per sample; padding rows carry PAD_COORD."""
    d, h, w = dims
    coords = np.full((b, v, 3), -(2 ** 20), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        flat = rng.choice(d * h * w, size=n_occ[i], replace=False)
        coords[i, :n_occ[i]] = np.stack(
            [flat // (h * w), (flat // w) % h, flat % w], 1)
        mask[i, :n_occ[i]] = True
    # distinct values: no ties between rows anywhere
    vals = rng.permutation(b * v * c).reshape(b, v, c).astype(np.float32)
    h_rows = np.where(mask[..., None], (vals - b * v * c / 2) / 64.0, 0.0)
    return coords, mask, h_rows.astype(np.float32)


def _ct(rng, shape):
    return (rng.integers(-64, 64, shape) / 16.0).astype(np.float32)


def _jax_pool_vjp(coords, mask, h_rows, ct, dims, dtype=jnp.float32):
    f = lambda hr: pooled_rows_fused(  # noqa: E731
        jnp.asarray(coords), jnp.asarray(mask), hr, dims)[0]
    y, vjp = jax.vjp(f, jnp.asarray(h_rows, dtype))
    return np.asarray(vjp(jnp.asarray(ct, dtype))[0].astype(jnp.float32))


def _port_pool_bwd(coords, mask, h_rows, ct, dims, dtype=torch.float32):
    c, m = T(coords), T(mask)
    h = T(h_rows).to(dtype)
    y, occ_l = pooled_rows(c, m, h, dims)
    return masked_max_pool_bwd_rows_plain(c, m, h, y, occ_l,
                                          T(ct).to(dtype), dims)


def _l1_shape(dims, b=2, c=16):
    return (b, *(-(-n // 2) for n in dims), c)


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_pool_bwd_rows_match_jax_vjp_exactly(dims):
    rng = np.random.default_rng(3)
    coords, mask, h_rows = _rows(rng, dims)
    ct = _ct(rng, _l1_shape(dims))
    want = _jax_pool_vjp(coords, mask, h_rows, ct, dims)
    got = _port_pool_bwd(coords, mask, h_rows, ct, dims)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_pool_bwd_rows_bf16_tie_free_match_jax(dims):
    """Distinct row values on a grid that bf16 holds exactly, cotangents on
    a coarse grid: both sides sum the same bf16 values in f32 and round
    once, so they agree exactly."""
    rng = np.random.default_rng(4)
    coords, mask, h_rows = _rows(rng, dims, c=8)
    h_rows = np.where(mask[..., None], np.sign(h_rows) * (
        np.abs(h_rows) * 64 % 200 + 1), 0).astype(np.float32)
    ct = _ct(rng, _l1_shape(dims, c=8))
    want = _jax_pool_vjp(coords, mask, h_rows, ct, dims, jnp.bfloat16)
    got = _port_pool_bwd(coords, mask, h_rows, ct, dims, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_pool_bwd_rows_equal_pallas_dx_at_the_occupied_cells(dims):
    """The row form is the Pallas kernel's volume dx read at the rows."""
    rng = np.random.default_rng(5)
    coords, mask, h_rows = _rows(rng, dims)
    ct = _ct(rng, _l1_shape(dims))
    hv, occ_v = _scatter_to_dense_impl(jnp.asarray(coords), jnp.asarray(mask),
                                       jnp.asarray(h_rows), dims)
    occ_l = jnp.asarray(occupancy_pool(T(np.array(occ_v))).numpy())
    _, vjp = jax.vjp(lambda x: pallas_max_pool(x, occ_v, occ_l, True), hv)
    dxv = np.asarray(vjp(jnp.asarray(ct))[0])
    bi = np.arange(2)[:, None]
    c = np.clip(coords, 0, None)
    want = np.where(mask[..., None], dxv[bi, c[..., 0], c[..., 1], c[..., 2]],
                    0.0)
    got = _port_pool_bwd(coords, mask, h_rows, ct, dims)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_pool_bwd_tie_gives_every_maximizer_the_full_cotangent():
    """Two rows of one window hold the same maximum: JAX, Pallas and the
    port route the full cotangent to both (torch's max_pool3d would pick
    one, torch.maximum would split it)."""
    dims = (6, 6, 6)
    coords = np.array([[[2, 2, 2], [3, 2, 2], [4, 2, 2], [0, 0, 0]]],
                      np.int32)
    mask = np.ones((1, 4), bool)
    h_rows = np.array([[[4.0], [4.0], [1.0], [2.0]]], np.float32).repeat(
        4, -1)
    ct = np.zeros((1, 3, 3, 3, 4), np.float32)
    ct[0, 1, 1, 1] = 3.0   # window {1,2,3}^3: holds both tied rows
    ct[0, 2, 1, 1] = 5.0   # window x {3,4,5}: its max is [3,2,2]
    want = _jax_pool_vjp(coords, mask, h_rows, ct, dims)
    got = _port_pool_bwd(coords, mask, h_rows, ct, dims).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [3.0] * 4)
    np.testing.assert_array_equal(got[0, 1], [8.0] * 4)
    np.testing.assert_array_equal(got[0, 2], [0.0] * 4)
    hv, occ_v = _scatter_to_dense_impl(jnp.asarray(coords), jnp.asarray(mask),
                                       jnp.asarray(h_rows), dims)
    occ_l = jnp.asarray(occupancy_pool(T(np.array(occ_v))).numpy())
    _, vjp = jax.vjp(lambda x: pallas_max_pool(x, occ_v, occ_l, True), hv)
    dxv = np.asarray(vjp(jnp.asarray(ct))[0])
    np.testing.assert_array_equal(dxv[0, 2, 2, 2], got[0, 0])
    np.testing.assert_array_equal(dxv[0, 3, 2, 2], got[0, 1])


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_pooled_rows_function_backward_on_cpu(dims):
    """Autograd through `pooled_rows` gives the JAX VJP, keeps no
    full-resolution volume for the backward, and dispatches to the plain
    version (no kernel launch) on CPU tensors."""
    from dpcr_agb_tpu_torch import kernels
    rng = np.random.default_rng(6)
    coords, mask, h_rows = _rows(rng, dims)
    ct = _ct(rng, _l1_shape(dims))
    h = T(h_rows).requires_grad_(True)
    saved = []
    before = dict(kernels.LAUNCHES)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        y, occ_l = pooled_rows(T(coords), T(mask), h, dims)
    assert not occ_l.requires_grad
    (y * T(ct)).sum().backward()
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(
        h.grad.numpy(), _jax_pool_vjp(coords, mask, h_rows, ct, dims))
    full = (2, *dims, 16)
    assert full not in saved and len(saved) == 5, saved
    # the forward is unchanged: scatter + masked_max_pool
    hv, occ_v = scatter_to_dense(T(coords), T(mask), T(h_rows), dims)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  masked_max_pool(hv, occ_v).numpy())


def test_pool_bwd_dispatch_takes_the_plain_version_on_cpu():
    from dpcr_agb_tpu_torch import kernels
    dims = DIMS[0]
    rng = np.random.default_rng(7)
    coords, mask, h_rows = _rows(rng, dims)
    c, m, h = T(coords), T(mask), T(h_rows)
    y, occ_l = pooled_rows(c, m, h, dims)
    ct = T(_ct(rng, _l1_shape(dims)))
    before = dict(kernels.LAUNCHES)
    got = masked_max_pool_bwd_rows(c, m, h, y, occ_l, ct, dims)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(),
        masked_max_pool_bwd_rows_plain(c, m, h, y, occ_l, ct, dims).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool_k3s2_bwd(c, m, h, y, occ_l, ct, dims)


def _stem_case(rng, dims, cout=64):
    d, h, w = dims
    coords, mask, _ = _rows(rng, dims, v=40, n_occ=(29, 23), c=1)
    coords = np.where(mask[..., None], coords, coords[:, :1])
    # a row past the volume reads at the clipped site, as in the forward
    coords[1, 0] = (d + 1, h - 1, w + 2)
    feats = np.where(mask[..., None],
                     rng.normal(size=(2, 40, 3)), 0).astype(np.float32)
    wts = (rng.normal(size=(343, 3, cout)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    ct = rng.normal(size=(2, 40, cout)).astype(np.float32)
    return coords, mask, feats, wts, bias, ct


def _jax_stem_grads(coords, mask, feats, wts, bias, ct, dims):
    def loss(w, b):
        y = stem_conv_sparse_batch(jnp.asarray(coords), jnp.asarray(mask),
                                   jnp.asarray(feats), dims, w, 7)
        y = (y + b) * jnp.asarray(mask)[..., None]      # SparseConv sites
        return jnp.sum(y * jnp.asarray(ct))
    gw, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(wts),
                                            jnp.asarray(bias))
    return np.asarray(gw), np.asarray(gb)


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_stem_weight_and_bias_grads_match_jax(dims):
    """f32, rtol 1e-4 (summation order only)."""
    rng = np.random.default_rng(8)
    coords, mask, feats, wts, bias, ct = _stem_case(rng, dims)
    gw_want, gb_want = _jax_stem_grads(coords, mask, feats, wts, bias, ct,
                                       dims)
    w = T(wts).requires_grad_(True)
    b = T(bias).requires_grad_(True)
    y = stem_conv_rows(T(coords), T(mask), T(feats), dims, w, b)
    (y * T(ct)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), gw_want, rtol=1e-4,
                               atol=1e-4 * np.abs(gw_want).max())
    np.testing.assert_allclose(b.grad.numpy(), gb_want, rtol=1e-4,
                               atol=1e-5)
    # the plain dW on its own: patches^T @ masked ct
    vol, _ = scatter_to_dense(T(coords), T(mask), T(feats), dims)
    dw = stem_conv_sites_dw_plain(vol, T(coords), T(mask), T(ct))
    assert dw.dtype == torch.float32 and dw.shape == (343, 3, 64)
    np.testing.assert_allclose(dw.numpy(), gw_want, rtol=1e-4,
                               atol=1e-4 * np.abs(gw_want).max())


def test_stem_grads_bf16_close_to_jax():
    """bf16 volume and cotangent, f32 accumulation, dW returned in the
    weights' dtype: within 2 bf16 ulps (2^-7) of the largest value."""
    dims = DIMS[0]
    rng = np.random.default_rng(9)
    coords, mask, feats, wts, bias, ct = _stem_case(rng, dims)
    feats16 = feats.astype(ml_dtypes.bfloat16).astype(np.float32)
    ct16 = ct.astype(ml_dtypes.bfloat16).astype(np.float32)
    gw_want, _ = _jax_stem_grads(coords, mask, feats16, wts, bias, ct16,
                                 dims)
    w = T(wts).requires_grad_(True)
    y = stem_conv_rows(T(coords), T(mask), T(feats), dims, w, None,
                       compute_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    (y.float() * T(ct16)).sum().backward()
    assert w.grad.dtype == torch.float32
    np.testing.assert_allclose(w.grad.numpy(), gw_want, rtol=0,
                               atol=2 ** -7 * np.abs(gw_want).max())


def test_stem_dw_launcher_refuses_cpu_tensors():
    from dpcr_agb_tpu_torch import kernels
    vol = torch.zeros(1, 4, 4, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stem_sites_dw(vol, torch.zeros(1, 2, 3, dtype=torch.int32),
                              torch.ones(1, 2, dtype=torch.bool),
                              torch.zeros(1, 2, 64))


@pytest.mark.parametrize("module", [DropPath, Dropout])
def test_dropout_masks_come_from_the_callers_generator(module):
    layer = module(0.25).train()
    x = torch.ones(4000, 3, 2)
    a = layer(x, torch.Generator().manual_seed(5))
    b = layer(x, torch.Generator().manual_seed(5))
    c = layer(x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # survivors rescaled by 1/keep (x / keep in f32), the rate holds
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    dropped = (a == 0).float().mean().item()
    assert abs(dropped - 0.25) < 0.03
    if module is DropPath:   # one coin per sample
        assert bool(((a == a[:, :1, :1]).all()))
    with pytest.raises(ValueError, match="generator"):
        layer(x)
    assert torch.equal(layer.eval()(x), x)
