"""Parity of the port's KPConv ops with the JAX package on the CPU: the
kernel-point dispositions, the plain fused KPConv (forward, dx, dW) against
the Pallas kernel in interpret mode and against the einsum formulation
`kpconv_apply_batched`, the sort-based voxel grid, `grid_subsample` and
`radius_neighbors`. Inputs are made with numpy from a seed and handed to
both sides. The CUDA kernels themselves run only on a card
(tests/test_torch_imports.py, chip_smoke.py); here every wrapper takes its
plain version because its tensors lie on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.models import kpconv as jkp
from dpcr_agb_tpu.ops import kernel_points as jkpts
from dpcr_agb_tpu.ops import neighbors as jnb
from dpcr_agb_tpu.ops import voxel as jvox
from dpcr_agb_tpu.ops.pallas_kpconv import kpconv_fused as jfused
from dpcr_agb_tpu_torch.models.kpconv import max_pool_zero_shadow_batched
from dpcr_agb_tpu_torch.ops import kernel_points, kpconv, neighbors, voxel

MODES = [(i, a) for i in ("linear", "gaussian", "constant")
         for a in ("sum", "closest")]
EXTENT = 0.4


# ---- kernel points ----------------------------------------------------------

@pytest.mark.parametrize("level", range(5))
def test_kernel_points_equal_jax_at_every_level(level):
    """The paper's 15 'center' points at the radius and seed of each level:
    the same tracked disposition, rotation and jitter, so equal arrays."""
    r = 0.0125 * 2.5 * 2 ** level
    mine = kernel_points.load_kernel_points(r, 15, "center", seed=42 + level,
                                            method="auto")
    ref = jkpts.load_kernel_points(r, 15, "center", seed=42 + level,
                                   method="auto")
    assert mine.dtype == ref.dtype and mine.shape == (15, 3)
    np.testing.assert_array_equal(mine, ref)


def test_kernel_points_lloyd_and_a_generated_disposition():
    """Lloyd's tracked file (K 5), and a disposition with no tracked file
    (K 4, generated in memory from the fixed seeds of both packages):
    1e-6, the descent runs in f64 on both sides."""
    np.testing.assert_array_equal(
        kernel_points.load_kernel_points(0.1, 5, "center", seed=7,
                                         method="lloyd"),
        jkpts.load_kernel_points(0.1, 5, "center", seed=7, method="lloyd"))
    mine = kernel_points.potential_descent(4, fixed="center")
    np.testing.assert_allclose(mine, jkpts.potential_descent(
        4, fixed="center"), rtol=0, atol=1e-6)


# ---- the fused KPConv, plain version ----------------------------------------

def _setup(rng, b=2, nq=24, ns=20, k=7, n_kp=5, c=6, cout=8):
    """The case of the JAX package's Pallas test: neighbour lists with
    shadows (index ns), one query row of shadows only."""
    q = rng.uniform(0, 1, (b, nq, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (b, ns, 3)).astype(np.float32)
    nbr = rng.integers(0, ns + 1, (b, nq, k)).astype(np.int32)
    nbr[:, :, -1] = ns
    nbr[:, nq // 2] = ns
    x = rng.standard_normal((b, ns, c)).astype(np.float32)
    kp = (rng.uniform(-1, 1, (n_kp, 3)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((n_kp, c, cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal((b, nq, cout)).astype(np.float32)
    return q, s, nbr, x, kp, w, g


def _rel_nx(q, s, nbr, x):
    b, ns, c = x.shape
    s_pad = np.concatenate([s, np.full((b, 1, 3), jkp.SHADOW_POS,
                                       np.float32)], 1)
    x_pad = np.concatenate([x, np.zeros((b, 1, c), np.float32)], 1)
    idx = nbr[:, :, :, None].astype(np.int64)
    rel = np.take_along_axis(s_pad[:, :, None, :], idx, axis=1) \
        - q[:, :, None, :]
    nx = np.take_along_axis(x_pad[:, :, None, :], idx, axis=1)
    return rel, nx


def _einsum_reference(q, s, nbr, x, kp, w, g, influence, aggregation):
    """Value, dx and dW of `kpconv_apply_batched` over the shared
    influences (autodiff)."""
    all_w = jkp.kp_influence_weights_batched(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(nbr), jnp.asarray(kp),
        EXTENT, influence, aggregation)

    def f(x_, w_):
        return jkp.kpconv_apply_batched(jnp.asarray(nbr), x_, w_, all_w)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _pallas_reference(rel, nx, nbr, kp, w, g, influence, aggregation,
                      dtype=jnp.float32):
    """Value, dx (dnx scattered back by nbr) and dW of the Pallas kernel in
    interpret mode."""
    def f(nx_, w_):
        return jfused(jnp.asarray(rel), nx_, w_, kp, EXTENT, influence,
                      aggregation, compute_dtype=dtype)

    out, vjp = jax.vjp(f, jnp.asarray(nx).astype(dtype), jnp.asarray(w))
    dnx, dw = vjp(jnp.asarray(g))
    b, nq, k, c = nx.shape
    ns = int(nbr.max())
    dx = np.zeros((b, ns + 1, c), np.float32)
    dnx = np.asarray(dnx.astype(jnp.float32))
    for i in range(b):
        np.add.at(dx[i], nbr[i].reshape(-1), dnx[i].reshape(-1, c))
    return np.asarray(out), dx[:, :ns], np.asarray(dw)


def _port(q, s, nbr, x, kp, w, g, influence, aggregation,
          dtype=torch.float32):
    """Value, dx and dW of the port's `kpconv_fused` (autograd.Function over
    the plain versions on the CPU)."""
    t = torch.from_numpy
    rel = kpconv.shared_rel(t(q), t(s), t(nbr))
    xt = t(x).requires_grad_()
    wt = t(w).requires_grad_()
    out = kpconv.kpconv_fused(xt, t(nbr), rel, wt, t(kp), EXTENT, influence,
                              aggregation, dtype)
    out.backward(t(g))
    assert out.dtype == xt.grad.dtype == wt.grad.dtype == torch.float32
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(), rel


@pytest.mark.parametrize("influence,aggregation", MODES)
def test_plain_kpconv_matches_pallas_and_einsum(influence, aggregation):
    """f32, every influence and aggregation: value, dx and dW within 2e-4
    (the JAX package's own tolerance between its two formulations: the sums
    over K, Kp and C are taken in other orders)."""
    case = _setup(np.random.default_rng(42))
    q, s, nbr, x, kp, w, g = case
    out, dx, dw, rel_t = _port(*case, influence, aggregation)
    rel, nx = _rel_nx(q, s, nbr, x)
    np.testing.assert_array_equal(rel_t.numpy(), rel)
    for want in (_einsum_reference(*case, influence, aggregation),
                 _pallas_reference(rel, nx, nbr, kp, w, g, influence,
                                   aggregation)):
        for got, ref, what in zip((out, dx, dw), want, ("out", "dx", "dW")):
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                                       err_msg=what)
    # a query row whose neighbours are all shadows gives exact zeros
    assert not out[:, 12].any()


def test_closest_keeps_the_first_of_tied_kernel_points():
    """All rel vectors equidistant to kp0 and kp1: only kp0 counts."""
    rng = np.random.default_rng(42)
    b, nq, ns, k, c, cout = 1, 8, 8, 4, 6, 8
    q = np.zeros((b, nq, 3), np.float32)
    s = np.zeros((b, ns, 3), np.float32)
    s[:, :, 1] = 0.1
    nbr = rng.integers(0, ns, (b, nq, k)).astype(np.int32)
    x = rng.standard_normal((b, ns, c)).astype(np.float32)
    kp = np.array([[0.05, 0, 0], [-0.05, 0, 0], [0, 0, 0.3], [0, 0, -0.3]],
                  np.float32)
    w = (rng.standard_normal((4, c, cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal((b, nq, cout)).astype(np.float32)
    case = (q, s, nbr, x, kp, w, g)
    out, dx, dw, _ = _port(*case, "linear", "closest")
    want = _einsum_reference(*case, "linear", "closest")
    for got, ref in zip((out, dx, dw), want):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    assert not dw[1].any() and dw[0].any()


def test_odd_sizes_and_the_first_layer_widths():
    """M = 13 rows, K 3, Kp 4, C 5 -> 3, and the first layer's 3 -> 32."""
    for sizes in (dict(b=1, nq=13, ns=9, k=3, n_kp=4, c=5, cout=3),
                  dict(b=2, nq=10, ns=11, k=6, n_kp=15, c=3, cout=32)):
        case = _setup(np.random.default_rng(42), **sizes)
        out, dx, dw, _ = _port(*case, "linear", "sum")
        assert out.shape == (sizes["b"], sizes["nq"], sizes["cout"])
        for got, ref in zip((out, dx, dw),
                            _einsum_reference(*case, "linear", "sum")):
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("influence,aggregation",
                         [("linear", "sum"), ("gaussian", "closest")])
def test_bf16_compute_dtype(influence, aggregation):
    """bf16 features and per-edge products with f32 sums. Against the f32
    einsum: 5e-2, the JAX package's tolerance for its bf16 kernel. Against
    the Pallas kernel in bf16, which sums over K in bf16 where the port
    sums in f32: the same 5e-2 for the value and dW, and 2e-2 for dx, whose
    influences stay f32 on both sides."""
    case = _setup(np.random.default_rng(42))
    q, s, nbr, x, kp, w, g = case
    out, dx, dw, _ = _port(*case, influence, aggregation, torch.bfloat16)
    ref = _einsum_reference(*case, influence, aggregation)
    for got, want in zip((out, dx, dw), ref):
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    rel, nx = _rel_nx(q, s, nbr, x)
    pal = _pallas_reference(rel, nx, nbr, kp, w, g, influence, aggregation,
                            jnp.bfloat16)
    for got, want, tol in zip((out, dx, dw), pal, (5e-2, 2e-2, 5e-2)):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_written_out_backward_equals_autograd_of_the_plain_forward(dtype):
    """`kpconv_fused_bwd_plain` (what the backward kernel is held against)
    against autograd over `kpconv_fused_plain`. f32: 1e-5. bf16: autograd
    differentiates through the roundings as identities, the written-out
    backward rounds g and W as the kernel does: 2e-2 of max|reference|."""
    q, s, nbr, x, kp, w, g = (torch.from_numpy(a) for a in
                              _setup(np.random.default_rng(3)))
    rel = kpconv.shared_rel(q, s, nbr)
    xc = x.to(dtype)
    xr, wr = xc.float().requires_grad_(), w.clone().requires_grad_()
    kpconv.kpconv_fused_plain(xr.to(dtype), nbr, rel, wr, kp, EXTENT) \
        .backward(g)
    dx, dw = kpconv.kpconv_fused_bwd_plain(xc, nbr, rel, w, kp, g, EXTENT)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in ((dx, xr.grad), (dw, wr.grad)):
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=tol * want.abs().max().item())


def test_kpconv_fused_rejects_bad_arguments():
    q, s, nbr, x, kp, w, _ = (torch.from_numpy(a) for a in
                              _setup(np.random.default_rng(0)))
    rel = kpconv.shared_rel(q, s, nbr)
    with pytest.raises(ValueError, match="KP_influence"):
        kpconv.kpconv_fused(x, nbr, rel, w, kp, EXTENT, "cubic")
    with pytest.raises(ValueError, match="aggregation_mode"):
        kpconv.kpconv_fused(x, nbr, rel, w, kp, EXTENT, "linear", "mean")
    with pytest.raises(ValueError, match="compute dtype"):
        kpconv.kpconv_fused(x, nbr, rel, w, kp, EXTENT,
                            compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="shapes"):
        kpconv.kpconv_fused(x, nbr, rel[:, :, :-1], w, kp, EXTENT)
    with pytest.raises(ValueError, match="shapes"):
        kpconv.kpconv_fused(x, nbr, rel, w[:, :-1], kp, EXTENT)


def test_strided_shortcut_max_pool_matches_jax():
    _, _, nbr, x, _, _, _ = _setup(np.random.default_rng(5))
    got = max_pool_zero_shadow_batched(torch.from_numpy(x),
                                       torch.from_numpy(nbr))
    want = jkp.max_pool_zero_shadow_batched(jnp.asarray(x), jnp.asarray(nbr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- voxel grid, grid_subsample, radius_neighbors --------------------------

def _cloud(rng, b=3, n=96):
    """Points in the unit cube, no exact distance ties; the tail of every
    sample but the first is masked out and parked far away."""
    pos = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    for i in range(1, b):
        mask[i, n - 7 * i:] = False
    pos[~mask] = 1e8
    return pos, mask


def test_pack_keys_and_build_grid_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(-600, 600, (2, 50, 3)).astype(np.int32)
    coords[0, 10] = coords[0, 3]                  # a duplicate: stable order
    mask = rng.uniform(size=(2, 50)) > 0.2
    keys = voxel.pack_keys(torch.from_numpy(coords), torch.from_numpy(mask))
    want = jax.vmap(jvox.pack_keys)(jnp.asarray(coords), jnp.asarray(mask))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want))
    assert keys.dtype == torch.int32
    grid = voxel.build_grid(torch.from_numpy(coords), torch.from_numpy(mask))
    jgrid = jax.vmap(jvox.build_grid)(jnp.asarray(coords), jnp.asarray(mask))
    np.testing.assert_array_equal(grid.keys_sorted.numpy(),
                                  np.asarray(jgrid.keys_sorted))
    np.testing.assert_array_equal(grid.order.numpy(), np.asarray(jgrid.order))


@pytest.mark.parametrize("n_out", [80, 8], ids=["room", "overflow"])
def test_grid_subsample_matches_jax(n_out):
    """Barycentres in cell-key order, with room for every cell and with
    more cells than rows (the largest keys are dropped): equal masks,
    positions within 1e-6 (a mean of a few f32 values)."""
    pos, mask = _cloud(np.random.default_rng(1))
    pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
    got_p, got_m = neighbors.grid_subsample(torch.from_numpy(pos),
                                            torch.from_numpy(mask), 0.3, n_out)
    want_p, want_m = jax.vmap(lambda p, m: jnb.grid_subsample(
        p, m, 0.3, n_out))(jnp.asarray(pos), jnp.asarray(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-6)
    assert got_m.any() and (n_out == 8 or not got_m.all())
    assert (got_p[~got_m] == 1e8).all()


def test_downsample_unique_matches_jax_and_other_modes_wait():
    rng = np.random.default_rng(2)
    coords = rng.integers(0, 12, (2, 60, 3)).astype(np.int32)
    mask = rng.uniform(size=(2, 60)) > 0.1
    grid = voxel.build_grid(torch.from_numpy(coords), torch.from_numpy(mask))
    out, feats = voxel.downsample(grid, None, 2, 48)
    jout, _ = jax.vmap(lambda c, m: jvox.downsample(
        jvox.build_grid(c, m), None, 2, 48))(jnp.asarray(coords),
                                             jnp.asarray(mask))
    assert feats is None
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(jout.mask))
    np.testing.assert_array_equal(out.coords.numpy()[out.mask.numpy()],
                                  np.asarray(jout.coords)[np.asarray(
                                      jout.mask)])
    # max and sum are ported (tests/test_torch_map_mode.py); a mode that
    # neither package has raises
    with pytest.raises(ValueError, match="unique, mean, sum or max"):
        voxel.downsample(grid, None, 2, 48, mode="min")


@pytest.mark.parametrize("k,tile", [(7, 1024), (7, 32), (120, 1024)],
                         ids=["k7", "query-tiles-of-32", "k-above-ns"])
def test_radius_neighbors_match_jax(k, tile):
    """Each row's neighbour list, compared as a list: the same set in the
    same order (ascending distance, then the shadow). The clouds are random
    f32 points without exact distance ties, where `torch.topk` and
    `jax.lax.top_k` could order equal distances differently. Queries are a
    subsample of the supports, some of both masked out; the radius crops
    some rows and not others."""
    pos, mask = _cloud(np.random.default_rng(4))
    q_pos, q_mask = pos[:, ::2].copy(), mask[:, ::2].copy()
    q_mask[0, :3] = False
    got = neighbors.radius_neighbors(
        torch.from_numpy(q_pos), torch.from_numpy(q_mask),
        torch.from_numpy(pos), torch.from_numpy(mask), 0.3, k, tile=tile)
    want = np.asarray(jax.vmap(lambda q, qm, s, sm: jnb.radius_neighbors(
        q, qm, s, sm, 0.3, k, tile=tile))(
            jnp.asarray(q_pos), jnp.asarray(q_mask), jnp.asarray(pos),
            jnp.asarray(mask)))
    ns = pos.shape[1]
    assert got.dtype == torch.int32 and got.shape == (3, 48, k)
    np.testing.assert_array_equal(got.numpy(), want)
    n_found = (want < ns).sum(-1)
    assert (want[0, :3] == ns).all() and n_found.max() > n_found[
        q_mask].min() > 0
    # masked-out supports are never listed
    listed = np.where(want < ns, want, 0)
    assert np.take_along_axis(mask[:, None, :].repeat(48, 1), listed,
                              2)[want < ns].all()


def test_radius_neighbors_refuses_tf32_on_cuda(monkeypatch):
    """The check reads the flag only for CUDA tensors: on the CPU the flag
    does not matter and the call goes through."""
    pos, mask = _cloud(np.random.default_rng(4), b=1, n=16)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    t = torch.from_numpy
    out = neighbors.radius_neighbors(t(pos), t(mask), t(pos), t(mask), 0.5, 4)
    assert out.shape == (1, 16, 4)
