"""The KPConv backward at the sparsity its kernel relies on, on the CPU.

`kpconv_fused_bwd_plain` (what the `kpconv_fused_bwd` kernel is held
against on the card) against the Pallas kernel's VJP in interpret mode and
against autodiff of the einsum formulation, on neighbour lists where most
rows are all shadow (whole 64-row tiles that the kernel skips) and real
neighbours are interleaved with shadows in the rest, at KPCNN's K 40 and
Kp 15, with a row count that is not a multiple of the kernel's row tile.
And `kernels.kpconv_bwd_plan`, the host side of the kernel's launch, at
the 14 layer shapes of KPCNN at bs16: shared memory within a block's,
grids within CUDA's limits, scratch sized to the rows and splits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu_torch import kernels
from dpcr_agb_tpu_torch.ops import kpconv
from test_torch_kpconv_ops import (EXTENT, _einsum_reference,
                                   _pallas_reference, _rel_nx)


def _sparse_case(seed, b, nq, ns, k, n_kp, c, cout, shadow_rows,
                 shadow_slots):
    """Clouds in the unit cube; `shadow_rows` of the query rows list only
    the shadow (index ns), and in the others `shadow_slots` of the K slots,
    drawn at random (so shadows sit between real neighbours), are shadow.
    Kernel points within the extent, as in the JAX package's tests."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (b, nq, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (b, ns, 3)).astype(np.float32)
    nbr = rng.integers(0, ns, (b, nq, k)).astype(np.int32)
    nbr[rng.random((b, nq, k)) < shadow_slots] = ns
    nbr[rng.random((b, nq)) < shadow_rows] = ns
    x = rng.standard_normal((b, ns, c)).astype(np.float32)
    kp = (rng.uniform(-1, 1, (n_kp, 3)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((n_kp, c, cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal((b, nq, cout)).astype(np.float32)
    return q, s, nbr, x, kp, w, g


# (B, Nq, Ns, K, Kp, C, Cout): 2 x 150 = 300 rows (4 tiles of 64 and a
# ragged fifth) at K 40, Kp 15, with level 0's width and the first layer's
SPARSE = [(2, 150, 90, 40, 15, 8, 8), (2, 150, 90, 40, 15, 3, 16)]


@pytest.mark.parametrize("sizes", SPARSE, ids=["c8", "c3-first-layer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_at_the_kernels_sparsity(sizes, dtype):
    """90% of the rows all shadow, 70% shadow slots in the rest. f32: dx
    and dW within 2e-4 of both references (the JAX package's own tolerance
    between its two formulations). bf16: the tolerances of
    `test_bf16_compute_dtype` (5e-2 against the f32 einsum; against the
    bf16 Pallas kernel, which sums over K in bf16, 2e-2 for dx, whose
    influences are f32 on both sides, and 5e-2 for dW). Rows of shadows
    contribute nothing, and dx of a point no row lists is exactly 0."""
    case = _sparse_case(7, *sizes, shadow_rows=0.9, shadow_slots=0.7)
    q, s, nbr, x, kp, w, g = case
    active = (nbr < sizes[2]).any(-1)
    assert 0 < active.mean() <= 0.15
    t = torch.from_numpy
    rel = kpconv.shared_rel(t(q), t(s), t(nbr))
    dx, dw = kpconv.kpconv_fused_bwd_plain(t(x).to(dtype), t(nbr), rel, t(w),
                                           t(kp), t(g), EXTENT)
    dx, dw = dx.numpy(), dw.numpy()
    rel_np, nx = _rel_nx(q, s, nbr, x)
    _, dx_e, dw_e = _einsum_reference(*case, "linear", "sum")
    _, dx_p, dw_p = _pallas_reference(
        rel_np, nx, nbr, kp, w, g, "linear", "sum",
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    if dtype == torch.float32:
        tols = ((dx_e, dw_e, 2e-4, 2e-4), (dx_p, dw_p, 2e-4, 2e-4))
    else:
        tols = ((dx_e, dw_e, 5e-2, 5e-2), (dx_p, dw_p, 2e-2, 5e-2))
    for want_dx, want_dw, tol_dx, tol_dw in tols:
        np.testing.assert_allclose(dx, want_dx, rtol=tol_dx, atol=tol_dx)
        np.testing.assert_allclose(dw, want_dw, rtol=tol_dw, atol=tol_dw)
    # the same backward from the active rows alone: shadow rows add nothing
    keep = np.where(active[..., None], nbr, sizes[2])
    dx_a, dw_a = kpconv.kpconv_fused_bwd_plain(
        t(x).to(dtype), t(keep), rel, t(w), t(kp), t(g), EXTENT)
    np.testing.assert_array_equal(dx_a.numpy(), dx)
    np.testing.assert_allclose(dw_a.numpy(), dw, rtol=1e-6, atol=1e-6)
    listed = np.zeros(x.shape[:2], bool)
    for i in range(x.shape[0]):
        listed[i, nbr[i][nbr[i] < sizes[2]]] = True
    assert not dx[~listed].any() and dx[listed].any()


# The rigid KPConvs of KPCNN (conf/models/instance/kpconv.yaml) at bs16 on
# an N bucket of 8192: (Nq, Ns, C, Cout) with level caps
# 8192/5736/2872/1480/824, K 40, Kp 15
KPCNN_LAYERS = [
    (8192, 8192, 3, 32), (8192, 8192, 16, 16), (5736, 8192, 16, 16),
    (5736, 5736, 32, 32), (5736, 5736, 32, 32), (2872, 5736, 32, 32),
    (2872, 2872, 64, 64), (2872, 2872, 64, 64), (1480, 2872, 64, 64),
    (1480, 1480, 128, 128), (1480, 1480, 128, 128), (824, 1480, 128, 128),
    (824, 824, 256, 256), (824, 824, 256, 256)]


@pytest.mark.parametrize("layer", KPCNN_LAYERS,
                         ids=[f"{i}-{l[2]}to{l[3]}-nq{l[0]}"
                              for i, l in enumerate(KPCNN_LAYERS)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_backward_plan_fits_the_card(layer, bf16):
    nq, ns, c, cout = layer
    plan = kernels.kpconv_bwd_plan(16, nq, ns, 40, c, cout, 15, bf16)
    rows = 16 * nq
    assert plan["tiles"] == -(-rows // 64) and plan["tile_rows"] == 64
    for name, smem in plan["smem_bytes"].items():
        assert 0 < smem <= kernels.SMEM_PER_BLOCK, name
    for name, (gx, gy) in plan["grids"].items():
        assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535, name
    assert 1 <= plan["splits"] <= min(plan["tiles"], 65535)
    bm, bn = plan["dw_tile"]
    assert bn >= min(cout, 64) and plan["dw_cfg"] in (0, 1, 2)
    # enough blocks for the card: the dW product fills 132 SMs unless the
    # row tiles run out
    out_tiles = -(-15 * c // bm) * -(-cout // bn)
    assert out_tiles * plan["splits"] >= min(132, out_tiles * plan["tiles"])
    esz = 2 if bf16 else 4
    scratch = plan["scratch_bytes"]
    assert scratch["part"] == plan["tiles"] * 64 * 15 * c * esz
    assert scratch["dpart"] == plan["tiles"] * 64 * 15 * c * 4
    assert scratch["partial"] == plan["splits"] * 15 * c * cout * 4
    assert sum(scratch.values()) < 1e9


def test_backward_plan_at_the_edges():
    """One row; no row at all; a width that fills neither tile."""
    one = kernels.kpconv_bwd_plan(1, 1, 5, 40, 16, 16, 15, False)
    assert one["tiles"] == 1 and one["splits"] == 1
    none = kernels.kpconv_bwd_plan(2, 0, 5, 40, 16, 16, 15, True)
    assert none["tiles"] == 0 and none["splits"] == 1
    odd = kernels.kpconv_bwd_plan(3, 70, 50, 9, 70, 24, 17, True)
    assert odd["dw_tile"] == (128, 32) and odd["grids"]["edge"] == (16, 3)
    assert odd["grids"]["dpart"] == (4, -(-17 * 70 // 64))


@pytest.mark.parametrize("sizes", SPARSE, ids=["c8", "c3-first-layer"])
def test_row_owner_dx_over_the_reverse_index(sizes):
    """dx as the card's kernel forms it, written out on the CPU: each row of
    x sums, over the edges that name it in the order of the reverse edge
    index (`kpconv.reverse_edges`), sum_p w_p * dpart[q, p, :], with the
    influences recomputed from rel and dpart = g @ W^T; within 2e-4 of the
    interpret-mode Pallas VJP, and exactly 0 where no edge names a row."""
    case = _sparse_case(7, *sizes, shadow_rows=0.9, shadow_slots=0.7)
    q, s, nbr, x, kp, w, g = case
    b, nq, ns, k, n_kp, c, _ = sizes
    t = torch.from_numpy
    rel = kpconv.shared_rel(t(q), t(s), t(nbr))
    wts = kpconv.influence_weights(rel, t(kp), EXTENT).numpy().reshape(
        -1, n_kp)
    dpart = np.einsum("bqd,pcd->bqpc", g, w).reshape(b * nq, n_kp, c)
    perm, off = (a.numpy() for a in kpconv.reverse_edges(t(nbr), ns))
    dx = np.zeros((b, ns, c), np.float32)
    for i in range(b):
        for j in range(ns):
            seg = i * (ns + 1) + j
            for e in perm[off[seg]:off[seg + 1]]:
                dx[i, j] += wts[e] @ dpart[e // k]
    rel_np, nx = _rel_nx(q, s, nbr, x)
    _, dx_p, _ = _pallas_reference(rel_np, nx, nbr, kp, w, g, "linear",
                                   "sum", jnp.float32)
    np.testing.assert_allclose(dx, dx_p, rtol=2e-4, atol=2e-4)
    named = np.zeros((b, ns), bool)
    for i in range(b):
        named[i, nbr[i][nbr[i] < ns]] = True
    assert not dx[~named].any() and dx[named].any()
