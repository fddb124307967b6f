"""Parity of the port's dense level-0 ops with the JAX package on the CPU,
on tiny volumes like (12,10,9) made with numpy from a seed: the layout
firewall (JAX's Pallas copy in interpret mode), the folded stem convs, the
backward-only fold, `dense_max_pool` in its four backward modes with
distinct values and with one constructed tie each, the volume-form VJP of
the equality-routed pool against the interpret-mode Pallas VJP, the manual
pool, and the row pools of the sparse level 0 (scatter-max, the 27-row
gather, the three forward flavours of the fused pool)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.ops import dense_grid as jgrid
from dpcr_agb_tpu.ops import dense_stem as jstem
from dpcr_agb_tpu.ops import pallas_pool as jpool
from dpcr_agb_tpu.ops import sparse_stem as jsparse
from dpcr_agb_tpu.ops.voxel import build_grid as jbuild_grid
from dpcr_agb_tpu.ops.voxel import downsample as jdownsample
from dpcr_agb_tpu_torch.ops import dense_grid, dense_stem, pool, sparse_stem
from dpcr_agb_tpu_torch.ops.voxel import build_grid, downsample

DIMS = [(12, 10, 9), (11, 9, 7)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DT[dtype])


def _np(t):
    return t.detach().float().numpy()


def _j(a, dtype="float32"):
    return jnp.asarray(a, JAX_DT[dtype])


# ---- layout_firewall ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,perm", [
    ((2, 5, 4, 6, 3), None), ((2, 5, 4, 6, 3), (0, 4, 1, 2, 3)),
    ((3, 7), (1, 0)), ((2, 3, 4, 130), None), ((4, 6, 5), (2, 0, 1))])
def test_layout_firewall_value_and_gradient_equal_jax(shape, perm, dtype):
    """The copy of a contiguous and of a permuted (non-contiguous) input
    and of its cotangent, against JAX's Pallas copy in interpret mode:
    exact, and the result is contiguous in the logical order."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    ct = rng.normal(size=shape).astype(np.float32)
    tx, tct = _t(x, dtype), _t(ct, dtype)
    if perm is not None:
        tx, tct = tx.permute(perm), tct.permute(perm)
        x, ct = x.transpose(perm), ct.transpose(perm)
        assert not tx.is_contiguous()
    tx = tx.detach().requires_grad_(True)
    got = dense_stem.layout_firewall(tx)
    assert got.is_contiguous() and got.data_ptr() != tx.data_ptr()
    got.backward(tct)
    want, vjp = jax.vjp(jstem.layout_firewall, _j(x, dtype))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        _np(tx.grad), np.asarray(vjp(_j(ct, dtype))[0], np.float32))
    assert torch.equal(dense_stem.firewall_copy_plain(tx.detach()),
                       got.detach())


# ---- the folded stem ------------------------------------------------------

def _stem_case(rng, dims, k, cin=3, cout=8, b=2, stride=1):
    x = rng.normal(size=(b, *dims, cin)).astype(np.float32)
    x *= rng.random((b, *dims, 1)) < 0.3
    w = (rng.normal(size=(k ** 3, cin, cout)) * 0.1).astype(np.float32)
    out = tuple((n + 2 * (k // 2) - k) // stride + 1 for n in dims)
    occ = (rng.random((b, *out, 1)) < 0.5).astype(np.float32)
    ct = rng.normal(size=(b, *out, cout)).astype(np.float32)
    return x, w, occ, ct


def _folded_both(x, w, occ, ct, k, stride, two_d, dtype):
    """(value, dW) of stem_conv_folded in the port and in JAX."""
    tw = _t(w).requires_grad_(True)
    got = dense_stem.stem_conv_folded(_t(x), _t(occ), tw, k, stride,
                                      TORCH_DT[dtype], two_d)
    got.backward(_t(ct, dtype))
    want, vjp = jax.vjp(
        lambda w_: jstem.stem_conv_folded(_j(x), _j(occ), w_, k, stride,
                                          JAX_DT[dtype], two_d), _j(w))
    return got, tw.grad, np.asarray(want, np.float32), \
        np.asarray(vjp(_j(ct, dtype))[0], np.float32)


@pytest.mark.parametrize("two_d", [False, True], ids=["zfold", "zfold2d"])
@pytest.mark.parametrize("k,stride", [(7, 1), (7, 2), (3, 1), (3, 2)])
def test_stem_conv_folded_matches_jax_and_dense_conv_f32(two_d, k, stride):
    """f32, 1e-4: sums in another order only."""
    rng = np.random.default_rng(1)
    x, w, occ, ct = _stem_case(rng, (12, 10, 9), k, stride=stride)
    got, dw, want, want_dw = _folded_both(x, w, occ, ct, k, stride, two_d,
                                          "float32")
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dw), want_dw, rtol=1e-4, atol=1e-4)
    tw = _t(w).requires_grad_(True)
    plain = dense_grid.dense_conv(_t(x), _t(occ), tw, k, stride)
    plain.backward(_t(ct))
    np.testing.assert_allclose(_np(got), _np(plain), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dw), _np(tw.grad), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("two_d", [False, True], ids=["zfold", "zfold2d"])
def test_stem_conv_folded_bf16_close_to_jax(two_d):
    """bf16 inputs and weights, f32 accumulation on both sides, results
    rounded to bf16: within 5e-2 of the largest value."""
    rng = np.random.default_rng(2)
    x, w, occ, ct = _stem_case(rng, (11, 9, 7), 7)
    got, dw, want, want_dw = _folded_both(x, w, occ, ct, 7, 1, two_d,
                                          "bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
    np.testing.assert_allclose(_np(dw), want_dw, rtol=0,
                               atol=5e-2 * np.abs(want_dw).max())


@pytest.mark.parametrize("mode", dense_grid.STEM_MODES)
def test_dense_conv_stem_modes_agree_with_bias(mode):
    """dense_conv under each stem mode, bias included: one function. A conv
    that is not tiny-Cin (Cin*k > 32) ignores the mode."""
    rng = np.random.default_rng(3)
    x, w, occ, _ = _stem_case(rng, (12, 10, 9), 7)
    bias = _t(rng.normal(size=8) * 0.1)
    want = dense_grid.dense_conv(_t(x), _t(occ), _t(w), 7, 1,
                                 torch.float32, bias)
    got = dense_grid.dense_conv(_t(x), _t(occ), _t(w), 7, 1, torch.float32,
                                bias, stem_mode=mode)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    x, w, occ, _ = _stem_case(rng, (6, 5, 4), 3, cin=16)
    a = dense_grid.dense_conv(_t(x), _t(occ), _t(w), 3, 1)
    b = dense_grid.dense_conv(_t(x), _t(occ), _t(w), 3, 1, stem_mode=mode)
    assert torch.equal(a, b)


@pytest.mark.parametrize("k,stride", [(7, 1), (3, 2)])
def test_tiny_cin_conv_matches_jax(k, stride):
    """Plain conv forward, folded backward: value, dx and dW, f32 1e-4."""
    rng = np.random.default_rng(4)
    x, w, _, ct = _stem_case(rng, (12, 10, 9), k, stride=stride)
    w5 = w.reshape(k, k, k, 3, 8)
    tx, tw = _t(x).requires_grad_(True), _t(w5).requires_grad_(True)
    got = dense_grid._tiny_cin_conv(tx, tw, k, stride)
    got.backward(_t(ct))
    want, vjp = jax.vjp(lambda a, b: jgrid._tiny_cin_conv(a, b, k, stride),
                        _j(x), _j(w5))
    dx, dw = vjp(_j(ct))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(dw), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        _np(got), _np(dense_grid._dense_conv_dfold_core(_t(x), _t(w5), k,
                                                        stride)),
        rtol=1e-4, atol=1e-4)


# ---- the volume-form pools ------------------------------------------------

def _pool_case(rng, dims, c=8, b=2, p=0.35, dtype="float32"):
    x = rng.normal(size=(b, *dims, c)).astype(np.float32)
    occ = (rng.random((b, *dims, 1)) < p).astype(np.float32)
    x = np.asarray(_t(x * occ, dtype).float())          # representable
    d1 = tuple(-(-n // 2) for n in dims)
    ct = rng.normal(size=(b, *d1, c)).astype(np.float32)
    return x, occ, np.asarray(_t(ct, dtype).float())


def _tie_case(dims, c=4):
    """Two windows with tied maxima among occupied cells: cells (2,2,2) and
    (3,3,3) tie in the window of output (1,1,1) and (3,3,3) also lies in
    the window of (2,2,2), cell (1,2,2) is lower; a second tie along one
    axis at (6,4,4) and (7,4,4), the latter alone on top of the window of
    (4,2,2)."""
    x = np.zeros((1, *dims, c), np.float32)
    occ = np.zeros((1, *dims, 1), np.float32)
    for cell, v in (((2, 2, 2), 1.5), ((3, 3, 3), 1.5), ((1, 2, 2), 0.25),
                    ((6, 4, 4), -0.5), ((7, 4, 4), -0.5), ((5, 4, 4), -2.0),
                    ((8, 4, 4), -3.0)):
        occ[(0, *cell)] = 1
        x[(0, *cell)] = v + 0.125 * np.arange(c)
    d1 = tuple(-(-n // 2) for n in dims)
    ct = (1 + np.arange(np.prod(d1) * c, dtype=np.float32)
          ).reshape(1, *d1, c) / 16
    return x, occ, ct


def _jax_dense_pool(monkeypatch, mode, x, occ, ct, dtype="float32",
                    pool_fwd=None):
    monkeypatch.setattr(jgrid, "POOL_BWD_MODE", mode)
    if pool_fwd is not None:
        monkeypatch.setattr(jstem, "POOL_FWD_MODE", pool_fwd)
    occ_out = jgrid.occupancy_pool(_j(occ, dtype))
    y, vjp = jax.vjp(lambda a: jgrid.dense_max_pool(a, _j(occ, dtype),
                                                    occ_out), _j(x, dtype))
    return (np.asarray(y, np.float32),
            np.asarray(vjp(_j(ct, dtype))[0], np.float32))


def _port_dense_pool(mode, x, occ, ct, dtype="float32", separable=True):
    tx = _t(x, dtype).requires_grad_(True)
    tocc = _t(occ, dtype)
    y = dense_grid.dense_max_pool(tx, tocc, dense_grid.occupancy_pool(tocc),
                                  mode, separable)
    y.backward(_t(ct, dtype))
    return _np(y), _np(tx.grad)


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("mode", dense_grid.POOL_BWD_MODES)
def test_dense_max_pool_modes_match_jax(mode, dims, monkeypatch):
    """Distinct values, even and odd extents: value and dx of each backward
    mode equal JAX's exactly (a max and a routed sum of at most 8 terms)."""
    x, occ, ct = _pool_case(np.random.default_rng(5), dims)
    want_y, want_dx = _jax_dense_pool(monkeypatch, mode, x, occ, ct)
    y, dx = _port_dense_pool(mode, x, occ, ct)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_allclose(dx, want_dx, rtol=1e-6, atol=1e-6)
    assert (dx[np.broadcast_to(occ == 0, dx.shape)] == 0).all()


@pytest.mark.parametrize("mode", dense_grid.POOL_BWD_MODES)
def test_dense_max_pool_constructed_tie_matches_jax(mode, monkeypatch):
    """What a tie gets in each mode is the reference's: "xla" and
    "separable" give one maximizer (the first in row-major order, per pass
    when separable) the cotangent, "manual" and "pallas" give every
    maximizer all of it."""
    x, occ, ct = _tie_case((12, 10, 9))
    want_y, want_dx = _jax_dense_pool(monkeypatch, mode, x, occ, ct)
    y, dx = _port_dense_pool(mode, x, occ, ct)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(dx, want_dx)
    both = dx[0, 2, 2, 2, 0] != 0 and dx[0, 3, 3, 3, 0] != 0 \
        and dx[0, 6, 4, 4, 0] != 0 and dx[0, 7, 4, 4, 0] != 0
    assert both
    full = dx[0, 2, 2, 2, 0] == ct[0, 1, 1, 1, 0]
    assert full
    if mode in ("manual", "pallas"):   # (3,3,3) takes both windows in full
        assert dx[0, 3, 3, 3, 0] == ct[0, 1, 1, 1, 0] + ct[0, 2, 2, 2, 0]
        assert dx[0, 7, 4, 4, 0] == ct[0, 3, 2, 2, 0] + ct[0, 4, 2, 2, 0]
    else:                              # one maximizer a window
        assert dx[0, 3, 3, 3, 0] == ct[0, 2, 2, 2, 0]
        assert dx[0, 7, 4, 4, 0] == ct[0, 4, 2, 2, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", DIMS + [(5, 4, 3)])
def test_volume_pool_vjp_equals_the_interpret_mode_pallas_vjp(dims, dtype):
    """`pallas_max_pool` of the port (plain versions on the CPU) against
    the Pallas kernels in interpret mode: value and dx exact, in f32 and in
    bf16, where the rounded values tie."""
    x, occ, ct = _pool_case(np.random.default_rng(6), dims, dtype=dtype)
    if dtype == "bfloat16":
        assert len(np.unique(x[np.broadcast_to(occ > 0, x.shape)])) \
            < (occ > 0).sum() * x.shape[-1]
    tx = _t(x, dtype).requires_grad_(True)
    tocc = _t(occ, dtype)
    tout = dense_grid.occupancy_pool(tocc)
    y = pool.pallas_max_pool(tx, tocc, tout)
    y.backward(_t(ct, dtype))
    jocc = _j(occ, dtype)
    jout = jgrid.occupancy_pool(jocc)
    want, vjp = jax.vjp(lambda a: jpool.pallas_max_pool(a, jocc, jout, True),
                        _j(x, dtype))
    np.testing.assert_array_equal(_np(y), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        _np(tx.grad), np.asarray(vjp(_j(ct, dtype))[0], np.float32))
    # the manual pool's 27-tap form routes the same cotangents; it splits
    # the f32 sum of the up to 8 terms elsewhere (one rounding)
    ctm = torch.where(tout > 0, _t(ct, dtype), torch.zeros(()).to(y.dtype))
    np.testing.assert_allclose(
        _np(pool.masked_max_pool_bwd_vol_plain(tx.detach(), tocc,
                                               y.detach(), ctm)),
        _np(pool.manual_max_pool_bwd_plain(tx.detach(), tocc, tout,
                                           y.detach(), _t(ct, dtype))),
        rtol=1e-6 if dtype == "float32" else 1e-2, atol=1e-6)


@pytest.mark.parametrize("fwd", ["separable", "window3d"])
@pytest.mark.parametrize("dims", DIMS)
def test_manual_max_pool_matches_jax(dims, fwd, monkeypatch):
    x, occ, ct = _pool_case(np.random.default_rng(7), dims)
    want_y, want_dx = _jax_dense_pool(monkeypatch, "manual", x, occ, ct,
                                      pool_fwd=fwd)
    y, dx = _port_dense_pool("manual", x, occ, ct,
                             separable=fwd == "separable")
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(dx, want_dx)


def test_windowed_max_separable_equals_the_3d_window():
    x, occ, _ = _pool_case(np.random.default_rng(8), (11, 9, 7))
    filled = torch.where(_t(occ) > 0, _t(x), torch.tensor(-1e30))
    a = dense_grid.windowed_max(filled, separable=True)
    b = dense_grid.windowed_max(filled, separable=False)
    assert a.shape == (2, 6, 5, 4, 8) and torch.equal(a, b)
    want = jgrid.windowed_max(jnp.asarray(filled.numpy()), separable=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


def test_unknown_pool_mode_raises():
    x, occ, _ = _pool_case(np.random.default_rng(9), (4, 4, 4))
    with pytest.raises(ValueError, match="pool_bwd"):
        dense_grid.dense_max_pool(_t(x), _t(occ),
                                  dense_grid.occupancy_pool(_t(occ)), "fast")
    with pytest.raises(ValueError, match="stem_mode"):
        dense_grid.dense_conv(_t(x[..., :3]), _t(occ),
                              torch.zeros(27, 3, 4), 3, stem_mode="fold")


# ---- the row pools of the sparse level 0 ------------------------------------

def _rows_case(rng, dims, b=2, v=64, c=8):
    d, h, w = dims
    coords = np.full((b, v, 3), -(2 ** 20), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        n = int(rng.integers(30, 55))
        flat = rng.choice(d * h * w, size=n, replace=False)
        coords[i, :n] = np.stack([flat // (h * w), flat // w % h, flat % w],
                                 1)
        mask[i, :n] = True
    coords[0, 3] = (d, 0, 0)            # a valid row outside the volume
    h_rows = np.where(mask[..., None], rng.normal(size=(b, v, c)), 0)
    d1 = tuple(-(-n // 2) for n in dims)
    ct = rng.normal(size=(b, *d1, c)).astype(np.float32)
    return coords, mask, h_rows.astype(np.float32), ct


@pytest.mark.parametrize("dims", DIMS)
def test_scatter_max_pool_batch_matches_jax(dims):
    coords, mask, h, ct = _rows_case(np.random.default_rng(10), dims)
    th = _t(h).requires_grad_(True)
    y, occ = sparse_stem.scatter_max_pool_batch(
        torch.from_numpy(coords), torch.from_numpy(mask), th, dims)
    y.backward(_t(ct))
    (wy, wocc), vjp = jax.vjp(
        lambda r: jsparse.scatter_max_pool_batch(
            jnp.asarray(coords), jnp.asarray(mask), r, dims), _j(h))
    np.testing.assert_array_equal(_np(y), np.asarray(wy))
    np.testing.assert_array_equal(_np(occ), np.asarray(wocc))
    dh = vjp((_j(ct), jnp.zeros_like(wocc)))[0]
    np.testing.assert_allclose(_np(th.grad), np.asarray(dh), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dims", DIMS)
def test_max_pool_sparse_rows_match_jax(dims):
    """The level-1 sites from the sort, each site's 27 level-0 rows (as
    sets: the order within a window is free), the masked max and its
    gradient."""
    coords, mask, h, _ = _rows_case(np.random.default_rng(11), dims)
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    v = coords.shape[1]
    grid1, _ = downsample(build_grid(tc, tm), None, 2, v)
    jg1 = jax.vmap(lambda c, m: jdownsample(jbuild_grid(c, m), None, 2,
                                            v)[0])(jnp.asarray(coords),
                                                   jnp.asarray(mask))
    np.testing.assert_array_equal(grid1.mask.numpy(), np.asarray(jg1.mask))
    m1 = np.asarray(jg1.mask)
    np.testing.assert_array_equal(grid1.coords.numpy()[m1],
                                  np.asarray(jg1.coords)[m1])
    nbr = sparse_stem.pool_neighbor_map_batch(tc, tm, grid1.coords,
                                              grid1.mask, dims)
    jnbr = jsparse.pool_neighbor_map_batch(
        jnp.asarray(coords), jnp.asarray(mask), jg1.coords, jg1.mask, dims)
    np.testing.assert_array_equal(np.sort(nbr.numpy(), -1),
                                  np.sort(np.asarray(jnbr), -1))
    th = _t(h).requires_grad_(True)
    rows1 = sparse_stem.max_pool_sparse(th, nbr, grid1.mask)
    ct = np.random.default_rng(12).normal(size=rows1.shape).astype(np.float32)
    rows1.backward(_t(ct))
    want, vjp = jax.vjp(lambda r: jsparse.max_pool_sparse(r, jnbr, jg1.mask),
                        _j(h))
    np.testing.assert_array_equal(_np(rows1), np.asarray(want))
    np.testing.assert_allclose(_np(th.grad), np.asarray(vjp(_j(ct))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["scattermax", "rows", "fused"])
def test_row_pools_with_ties_match_jax(mode):
    """Values on a grid of halves, so that most windows hold tied maxima:
    the scatter-max and the 27-row max split a window's cotangent evenly
    among its maximizers, the fused pool gives each all of it, as JAX's
    do."""
    dims = (12, 10, 9)
    coords, mask, h, ct = _rows_case(np.random.default_rng(14), dims)
    h = np.round(h * 2) / 2
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    jc, jm = jnp.asarray(coords), jnp.asarray(mask)
    v = coords.shape[1]
    th = _t(h).requires_grad_(True)
    if mode == "rows":
        grid1, _ = downsample(build_grid(tc, tm), None, 2, v)
        nbr = sparse_stem.pool_neighbor_map_batch(tc, tm, grid1.coords,
                                                  grid1.mask, dims)
        y = sparse_stem.max_pool_sparse(th, nbr, grid1.mask)
        jg1 = jax.vmap(lambda c, m: jdownsample(jbuild_grid(c, m), None, 2,
                                                v)[0])(jc, jm)
        jnbr = jsparse.pool_neighbor_map_batch(jc, jm, jg1.coords, jg1.mask,
                                               dims)
        jfn = lambda r: jsparse.max_pool_sparse(r, jnbr, jg1.mask)  # noqa
        ct = np.abs(np.random.default_rng(15).normal(size=y.shape)).astype(
            np.float32)
        occ = grid1.mask.numpy()[..., None]
    elif mode == "scattermax":
        y, occ = sparse_stem.scatter_max_pool_batch(tc, tm, th, dims)
        jfn = lambda r: jsparse.scatter_max_pool_batch(  # noqa: E731
            jc, jm, r, dims)[0]
    else:
        y, occ = pool.pooled_rows(tc, tm, th, dims)
        jfn = lambda r: jsparse.pooled_rows_fused(  # noqa: E731
            jc, jm, r, dims)[0]
    ct, occ = np.abs(ct), _np(occ) if torch.is_tensor(occ) else occ
    y.backward(_t(ct))
    want, vjp = jax.vjp(jfn, _j(h))
    np.testing.assert_array_equal(_np(y), np.asarray(want))
    dh = np.asarray(vjp(_j(ct))[0])
    np.testing.assert_allclose(_np(th.grad), dh, rtol=1e-6, atol=1e-6)
    # ties are there: the splitting pools hand out exactly the cotangent
    # that reached occupied outputs, the fused pool more than that
    reached = float((ct * occ).sum())
    assert (abs(float(dh.sum()) - reached) < 1e-3) == (mode != "fused")


@pytest.mark.parametrize("flavour", pool.POOL_FWD_FLAVOURS)
def test_pooled_rows_forward_flavours_match_jax(flavour, monkeypatch):
    """The three DPCR_POOL_FWD flavours of the fused sparse pool: the
    values of the default flavour exactly, and JAX's value and row
    gradient under the same flavour."""
    dims = (11, 9, 7)
    coords, mask, h, ct = _rows_case(np.random.default_rng(13), dims)
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    th = _t(h).requires_grad_(True)
    y, occ = pool.pooled_rows(tc, tm, th, dims, flavour)
    y.backward(_t(ct))
    y0, occ0 = pool.pooled_rows(tc, tm, _t(h), dims)
    assert torch.equal(y, y0) and torch.equal(occ, occ0)
    monkeypatch.setattr(jgrid, "POOL_FWD_MODE", flavour)
    (wy, wocc), vjp = jax.vjp(
        lambda r: jsparse.pooled_rows_fused(
            jnp.asarray(coords), jnp.asarray(mask), r, dims), _j(h))
    np.testing.assert_array_equal(_np(y), np.asarray(wy))
    np.testing.assert_array_equal(_np(occ), np.asarray(wocc))
    dh = vjp((_j(ct), jnp.zeros_like(wocc)))[0]
    np.testing.assert_allclose(_np(th.grad), np.asarray(dh), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="flavour"):
        pool.pooled_rows(tc, tm, _t(h), dims, "window3d")
