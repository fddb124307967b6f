"""Parity of the port's ops (dpcr_agb_tpu_torch.ops) with the JAX package on
the CPU: the sparse-site stem conv against stem_conv_sparse_batch and the
Pallas stem (interpret mode) read at the sites, the masked k3/s2 max pool
against pallas_max_pool (interpret mode) and dense_max_pool_xla, and the
dense-grid helpers. Same numpy inputs on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.ops import dense_grid as jdg
from dpcr_agb_tpu.ops import masked as jmasked
from dpcr_agb_tpu.ops.pallas_pool import pallas_max_pool
from dpcr_agb_tpu.ops.pallas_stem import fused_stem_conv_volume
from dpcr_agb_tpu.ops.sparse_stem import (_scatter_to_dense_impl,
                                          pooled_rows_fused,
                                          stem_conv_sparse_batch)
from dpcr_agb_tpu_torch.ops import dense_grid as tdg
from dpcr_agb_tpu_torch.ops import masked as tmasked
from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                         masked_max_pool_plain, pooled_rows)
from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_rows,
                                                stem_conv_sites,
                                                stem_conv_sites_plain)

T = torch.from_numpy


def _random_batch(rng, b, dims, n_occ, v_cap, cin):
    """Unique occupied coords per sample, padding rows repeat coords[0]."""
    d, h, w = dims
    cs, ms, fs = [], [], []
    for _ in range(b):
        flat = rng.choice(d * h * w, size=n_occ, replace=False)
        coords = np.stack([flat // (h * w), (flat // w) % h, flat % w], 1)
        out = np.zeros((v_cap, 3), np.int32)
        out[:n_occ] = coords
        mask = np.arange(v_cap) < n_occ
        out[~mask] = coords[0]
        f = rng.normal(size=(v_cap, cin)).astype(np.float32)
        f[~mask] = 0.0
        cs.append(out), ms.append(mask), fs.append(f)
    return np.stack(cs), np.stack(ms), np.stack(fs)


STEM_DIMS = [(12, 10, 9), (7, 13, 8)]


@pytest.fixture(scope="module", params=STEM_DIMS, ids=str)
def stem_case(request):
    """One stem input per dims, with the JAX row stem and the Pallas volume
    stem (interpret mode, read at the sites) computed once."""
    dims = request.param
    d, h, w = dims
    k, cin, cout = 7, 3, 16
    rng = np.random.default_rng(11)
    coords, mask, feats = _random_batch(rng, 2, dims, 29, 40, cin)
    wts = (rng.normal(size=(k ** 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    rows = np.asarray(stem_conv_sparse_batch(
        jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(feats), dims,
        jnp.asarray(wts), k, compute_dtype=jnp.float32))
    vol, _ = fused_stem_conv_volume(
        jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(feats), dims,
        jnp.asarray(wts), k, compute_dtype=jnp.float32, ty=5, td=0,
        interpret=True)
    vol = np.asarray(vol)
    b_idx = np.arange(coords.shape[0])[:, None]
    at_sites = vol[b_idx, coords[..., 0], coords[..., 1], coords[..., 2]]
    at_sites = np.where(mask[..., None], at_sites, 0.0)
    return dict(dims=dims, coords=coords, mask=mask, feats=feats, wts=wts,
                bias=bias, rows=rows, at_sites=at_sites)


def test_stem_plain_matches_jax_row_stem(stem_case):
    c = stem_case
    got = stem_conv_rows(T(c["coords"]), T(c["mask"]), T(c["feats"]),
                         c["dims"], T(c["wts"]))
    np.testing.assert_allclose(got.numpy(), c["rows"], rtol=1e-4, atol=1e-4)


def test_stem_plain_matches_pallas_stem_at_sites(stem_case):
    c = stem_case
    got = stem_conv_rows(T(c["coords"]), T(c["mask"]), T(c["feats"]),
                         c["dims"], T(c["wts"]))
    np.testing.assert_allclose(got.numpy(), c["at_sites"], rtol=1e-4,
                               atol=1e-4)


def test_stem_bias_then_mask(stem_case):
    """(y + bias) * mask, as SparseConv's sites mode does (minkowski.py)."""
    c = stem_case
    got = stem_conv_rows(T(c["coords"]), T(c["mask"]), T(c["feats"]),
                         c["dims"], T(c["wts"]), T(c["bias"]))
    want = (c["rows"] + c["bias"]) * c["mask"][..., None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_stem_bf16_inputs_close_to_f32(stem_case):
    """bf16 inputs and weights, f32 accumulation, bf16 output: within the
    bf16 rounding of inputs and output (2e-2 of the largest magnitude)."""
    c = stem_case
    got = stem_conv_rows(T(c["coords"]), T(c["mask"]), T(c["feats"]),
                         c["dims"], T(c["wts"]), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    scale = np.abs(c["rows"]).max()
    np.testing.assert_allclose(got.float().numpy(), c["rows"], rtol=0,
                               atol=2e-2 * scale)


def test_stem_out_of_volume_rows_read_clipped_site():
    """A valid row past the volume is computed at its clipped site (and
    dropped from the scatter), like the JAX row stem."""
    dims = (6, 5, 7)
    rng = np.random.default_rng(2)
    coords, mask, feats = _random_batch(rng, 1, dims, 9, 12, 3)
    coords[0, 3] = [7, -2, 9]
    wts = (rng.normal(size=(343, 3, 8)) * 0.1).astype(np.float32)
    want = np.asarray(stem_conv_sparse_batch(
        jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(feats), dims,
        jnp.asarray(wts), 7, compute_dtype=jnp.float32))
    got = stem_conv_rows(T(coords), T(mask), T(feats), dims, T(wts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_stem_wrapper_takes_plain_version_on_cpu(stem_case):
    from dpcr_agb_tpu_torch import kernels
    c = stem_case
    vol, _ = tdg.scatter_to_dense(T(c["coords"]), T(c["mask"]),
                                  T(c["feats"]), c["dims"])
    before = dict(kernels.LAUNCHES)
    args = (vol, T(c["coords"]), T(c["mask"]), T(c["wts"]), T(c["bias"]))
    got = stem_conv_sites(*args)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(),
                                  stem_conv_sites_plain(*args).numpy())


# ---- pool --------------------------------------------------------------

def _pool_case(shape, occ_p, seed):
    """Distinct values (the tests of pallas_pool use the same rule)."""
    b, d, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.permutation(b * d * h * w * c).astype(np.float64)
    x = ((x / x.size) * 8 - 4).reshape(shape).astype(np.float32)
    occ = (rng.random((b, d, h, w, 1)) < occ_p).astype(np.float32)
    return x * occ, occ


POOL_CASES = [((2, 8, 8, 8, 8), 0.15), ((1, 7, 9, 6, 16), 0.4),
              ((2, 6, 6, 8, 8), 0.9)]


@pytest.mark.parametrize("shape,occ_p", POOL_CASES)
def test_pool_plain_equals_pallas_and_xla(shape, occ_p):
    x, occ = _pool_case(shape, occ_p, seed=0)
    xj, oj = jnp.asarray(x), jnp.asarray(occ)
    occ_l = jdg.occupancy_pool(oj)
    want_pl = np.asarray(pallas_max_pool(xj, oj, occ_l, True))
    want_xla = np.asarray(jdg.dense_max_pool_xla(xj, oj, occ_l))
    got = masked_max_pool_plain(T(x), T(occ)).numpy()
    np.testing.assert_array_equal(got, want_pl)
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(masked_max_pool(T(x), T(occ)).numpy(), got)


def test_pool_bf16_and_empty_sample():
    x, occ = _pool_case((2, 8, 6, 8, 8), 0.2, seed=3)
    occ[1] = 0.0
    x = x * occ
    xj = jnp.asarray(x, jnp.bfloat16)
    oj = jnp.asarray(occ, jnp.bfloat16)
    want = np.asarray(pallas_max_pool(xj, oj, jdg.occupancy_pool(oj), True),
                      np.float32)
    got = masked_max_pool_plain(T(x).bfloat16(), T(occ).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.isnan(got.float().numpy()).any()


@pytest.mark.parametrize("dims", [(9, 8, 7), (10, 6, 11)])
def test_pooled_rows_equals_fused_forward(dims):
    rng = np.random.default_rng(4)
    coords, mask, _ = _random_batch(rng, 2, dims, 40, 48, 3)
    c = 16
    rows = rng.permutation(2 * 48 * c).reshape(2, 48, c).astype(np.float32)
    rows = rows / rows.size - 0.5
    rows[~mask] = 0.0
    want_y, want_occ = pooled_rows_fused(jnp.asarray(coords),
                                         jnp.asarray(mask),
                                         jnp.asarray(rows), dims)
    got_y, got_occ = pooled_rows(T(coords), T(mask), T(rows), dims)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))


# ---- dense-grid helpers and masked ops -----------------------------------

def test_scatter_to_dense_and_occupancy_pool():
    dims = (7, 6, 5)
    rng = np.random.default_rng(5)
    coords, mask, feats = _random_batch(rng, 2, dims, 20, 24, 4)
    coords[1, 2] = [7, 0, 0]          # out of volume: dropped
    want_v, want_o = _scatter_to_dense_impl(
        jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(feats), dims)
    got_v, got_o = tdg.scatter_to_dense(T(coords), T(mask), T(feats), dims)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(
        tdg.occupancy_pool(got_o).numpy(),
        np.asarray(jdg.occupancy_pool(want_o)))
    assert tdg.level_dims(dims, 2) == jdg.level_dims(dims, 2)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_dense_conv_matches_jax(k, stride):
    rng = np.random.default_rng(6)
    b, d, h, w, cin, cout = 2, 7, 6, 5, 4, 8
    x = rng.normal(size=(b, d, h, w, cin)).astype(np.float32)
    occ_in = (rng.random((b, d, h, w, 1)) < 0.5).astype(np.float32)
    x = x * occ_in
    occ_out = occ_in if stride == 1 else np.array(
        jdg.occupancy_pool(jnp.asarray(occ_in)))
    wts = (rng.normal(size=(k ** 3, cin, cout)) * 0.2).astype(np.float32)
    want = np.asarray(jdg.dense_conv(jnp.asarray(x), jnp.asarray(occ_out),
                                     jnp.asarray(wts), k, stride))
    got = tdg.dense_conv(T(x), T(occ_out), T(wts), k, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dense_conv_bf16_weight_gradient_matches_jax_and_repeats():
    """A k3 stride-2 conv of a [2,2,1] volume at batch 4 in bf16 (SENet14's
    last stage at the narrow test widths), where the CPU's own bf16 conv3d
    gives a weight gradient read from uninitialized memory: the port's is
    the same on every call and within 2 bf16 ulps (2^-7) of the largest
    value of the JAX function's."""
    import jax
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 2, 2, 1, 32)).astype(np.float32)
    occ_out = np.ones((4, 1, 1, 1, 1), np.float32)
    wts = (rng.normal(size=(27, 32, 32)) * 0.2).astype(np.float32)
    ct = rng.normal(size=(4, 1, 1, 1, 32)).astype(np.float32)
    gw_want = np.asarray(jax.grad(lambda w: jnp.sum(jdg.dense_conv(
        jnp.asarray(x), jnp.asarray(occ_out), w, 3, 2,
        jnp.bfloat16).astype(jnp.float32) * ct))(jnp.asarray(wts)))
    grads = []
    for _ in range(3):
        # fill freed memory with NaN: a read of it shows in the gradient
        torch.full((1 << 22,), float("nan"))
        w = T(wts).requires_grad_(True)
        y = tdg.dense_conv(T(x), T(occ_out), w, 3, 2, torch.bfloat16)
        assert y.dtype == torch.bfloat16
        (y.float() * T(ct)).sum().backward()
        grads.append(w.grad)
    assert all(torch.equal(g, grads[0]) for g in grads[1:])
    np.testing.assert_allclose(grads[0].numpy(), gw_want, rtol=0,
                               atol=2 ** -7 * np.abs(gw_want).max())

@pytest.mark.parametrize("name", ["sum", "mean", "max"])
def test_masked_pools_match_jax(name):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 10, 5)).astype(np.float32)
    mask = rng.random((3, 10)) < 0.5
    mask[2] = False                   # an all-padding sample
    want = np.asarray(jmasked.GLOBAL_POOL[name](jnp.asarray(x),
                                                jnp.asarray(mask)))
    got = tmasked.GLOBAL_POOL[name](T(x), T(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_masked_moments_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 4, 3)).astype(np.float32)
    mask = rng.random((2, 6, 4)) < 0.6
    want = jmasked.masked_moments(jnp.asarray(x), jnp.asarray(mask),
                                  (0, 1, 2))
    got = tmasked.masked_moments(T(x), T(mask), (0, 1, 2))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
