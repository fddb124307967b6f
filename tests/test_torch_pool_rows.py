"""The row form of the level-0 pool forward on the CPU: the plain version
of the `max_pool_k3s2_rows` kernel (`masked_max_pool_rows_plain`) against
the forward of the JAX `pooled_rows_fused` (default DPCR_POOL_FWD, legacy
scatter: duplicate cells sum) and against the scatter + occupancy_pool +
masked_max_pool composite, exactly, in f32 and bf16, on odd and even dims,
with a sample without a valid row, masked rows, rows outside the volume and
duplicate coordinates in pairs; `pooled_rows`' gradients against the JAX
VJP on the same batches; the dispatch (the plain version on CPU tensors,
the row form under `pooled_rows`' "dense" flavour); and `stem_sites_plan`.
The kernels themselves run on the card only (`tests/test_torch_card.py`,
`chip_smoke.py`).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pool_rows.py -q"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.ops.sparse_stem import pooled_rows_fused
from dpcr_agb_tpu_torch import kernels
from dpcr_agb_tpu_torch.ops import pool
from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool, scatter_to_dense

T = torch.from_numpy
DIMS = [(9, 7, 11), (8, 10, 6)]
DTYPES = {"float32": (torch.float32, jnp.float32, np.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16)}


def _batch(rng, dims, v=48, c=16):
    """Three samples: 30 unique cells with 4 masked rows among them, 3
    rows outside the volume and 4 duplicate pairs; none valid; 12 unique
    cells. Values are multiples of 1/16 in [-4, 4) (a pair's sum and every
    value are exact in bf16); masked and padding rows hold junk."""
    d, h, w = dims
    coords = np.full((3, v, 3), -7, np.int32)
    mask = np.zeros((3, v), bool)
    for i, n in ((0, 30), (2, 12)):
        flat = rng.choice(d * h * w, size=n, replace=False)
        coords[i, :n] = np.stack([flat // (h * w), flat // w % h, flat % w],
                                 1)
        mask[i, :n] = True
    mask[0, [3, 9, 14, 21]] = False
    coords[0, 30:33] = [[d, 0, 0], [0, h + 2, 1], [1, 1, -1]]
    coords[0, 33:37] = coords[0, [0, 5, 11, 17]]
    mask[0, 30:37] = True
    coords[1, :20] = coords[0, :20]               # all masked
    vals = rng.integers(-64, 64, (3, v, c)) / 16.0
    return coords, mask, vals.astype(np.float32)


def _jax_forward(coords, mask, vals, dims, jdt):
    y, occ = pooled_rows_fused(jnp.asarray(coords), jnp.asarray(mask),
                               jnp.asarray(vals, jdt), dims)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(occ.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_rows_plain_equals_jax_forward_and_the_composite(dims, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(21)
    coords, mask, vals = _batch(rng, dims)
    c, m, h = T(coords), T(mask), T(vals).to(tdt)
    y, occ = pool.masked_max_pool_rows_plain(c, m, h, dims)
    assert y.dtype == occ.dtype == tdt
    assert tuple(y.shape) == (3, *(-(-n // 2) for n in dims), 16)
    want_y, want_occ = _jax_forward(coords, mask, vals, dims, jdt)
    np.testing.assert_array_equal(y.float().numpy(), want_y)
    np.testing.assert_array_equal(occ.float().numpy(), want_occ)
    # the composite the dense flavour ran before the row form
    hv, occ_v = scatter_to_dense(c, m, h, dims)
    np.testing.assert_array_equal(
        y.float().numpy(), pool.masked_max_pool(hv, occ_v).float().numpy())
    np.testing.assert_array_equal(occ.float().numpy(),
                                  occupancy_pool(occ_v).float().numpy())
    # the cases are there: a pair's count, an empty sample, real maxima
    assert occ.max().item() == 2.0 and not occ[1].any() and not y[1].any()
    assert y[0].abs().sum() > 0 and y[2].abs().sum() > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_pooled_rows_gradients_match_the_jax_vjp(dims, dtype):
    """`pooled_rows` on CPU tensors (the row form's plain version forward,
    the row-form equality routing backward) against jax.vjp of
    pooled_rows_fused: the same forward, the same gradient bits (both sum
    the routed cotangents in f32 in slot order and round once)."""
    tdt, jdt, npdt = DTYPES[dtype]
    rng = np.random.default_rng(22)
    coords, mask, vals = _batch(rng, dims)
    l1 = (3, *(-(-n // 2) for n in dims), 16)
    ct = (rng.integers(-64, 64, l1) / 16.0).astype(np.float32)
    h = T(vals).to(tdt).requires_grad_(True)
    y, occ = pool.pooled_rows(T(coords), T(mask), h, dims)
    assert not occ.requires_grad
    (y.float() * T(ct)).sum().backward()
    f = lambda hr: pooled_rows_fused(  # noqa: E731
        jnp.asarray(coords), jnp.asarray(mask), hr, dims)[0]
    want_y, vjp = jax.vjp(f, jnp.asarray(vals, jdt))
    want = np.asarray(vjp(jnp.asarray(ct.astype(npdt)))[0].astype(
        jnp.float32))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(want_y.astype(jnp.float32)))
    assert h.grad.dtype == tdt
    np.testing.assert_array_equal(h.grad.float().numpy(), want)
    assert np.abs(want).sum() > 0


def test_rows_dispatch_takes_the_plain_version_on_cpu_and_refuses_launches():
    rng = np.random.default_rng(23)
    coords, mask, vals = _batch(rng, DIMS[0])
    c, m, h = T(coords), T(mask), T(vals)
    before = dict(kernels.LAUNCHES)
    y, occ = pool.masked_max_pool_rows(c, m, h, DIMS[0])
    assert kernels.LAUNCHES == before
    want_y, want_occ = pool.masked_max_pool_rows_plain(c, m, h, DIMS[0])
    assert torch.equal(y, want_y) and torch.equal(occ, want_occ)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool_k3s2_rows(c, m, h, DIMS[0])
    assert "max_pool_k3s2_rows" in kernels.LAUNCHES


def test_dense_flavour_pools_through_the_row_form(monkeypatch):
    """`pooled_rows`' default flavour takes `masked_max_pool_rows` (the
    kernel on the card) and no other forward; the backward saves only
    (coords, mask, h_rows, y, occ_l)."""
    rng = np.random.default_rng(24)
    coords, mask, vals = _batch(rng, DIMS[1])
    calls = []
    real = pool.masked_max_pool_rows

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    def refuse(*args):
        raise AssertionError("the volume-form pool ran")

    monkeypatch.setattr(pool, "masked_max_pool_rows", spy)
    monkeypatch.setattr(pool, "masked_max_pool", refuse)
    saved = []
    h = T(vals).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        y, occ = pool.pooled_rows(T(coords), T(mask), h, DIMS[1])
    assert calls == [DIMS[1]] and len(saved) == 5
    assert (3, *DIMS[1], 16) not in saved


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cin", [1, 2, 3, 4])
def test_stem_sites_plan_fits_a_block(cin, bf16):
    """W's share, the staged neighbours and the tap lists fit a block's
    shared memory, with 20 warps up to Cin 3 (8 at Cin 4, whose staged
    neighbours take 32 bytes); f32 splits the 64 output channels over two
    parts of blocks; never more blocks than the sites fill (4 a warp)."""
    plan = kernels.stem_sites_plan(16, 88, 88, 80, 16384, cin, bf16)
    assert plan["smem_bytes"] <= kernels.SMEM_PER_BLOCK
    assert plan["warps"] == (20 if cin <= 3 else 8)
    assert plan["parts"] == (1 if bf16 else 2)
    assert plan["grid"] == (kernels.H100_SMS // plan["parts"], plan["parts"])
    assert plan["scratch_bytes"]["bits"] == 4 * 16 * 88 * 88 * 3
    small = kernels.stem_sites_plan(1, 5, 5, 33, 200, cin, bf16)
    assert small["blocks"] == (3 if cin <= 3 else 7)
    assert small["scratch_bytes"]["bits"] == 200


@pytest.mark.parametrize("cin", [0, 19, 64])
def test_stem_sites_plan_refuses_what_does_not_fit(cin):
    with pytest.raises(ValueError, match="1 <= Cin <= 18"):
        kernels.stem_sites_plan(2, 9, 9, 9, 40, cin, False)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cin", list(range(1, 19)))
def test_stem_sites_plan_takes_every_width_to_18(cin, bf16):
    """Up to Cin 4 one launch holds W whole; past it one launch a group
    of 4 input channels (the last the rest), each with Cin 4's shared
    memory and 8 warps, adding to an f32 partial of the B*V output rows.
    Every width fits a block with at least one warp."""
    plan = kernels.stem_sites_plan(16, 88, 88, 80, 16384, cin, bf16)
    assert plan["smem_bytes"] <= kernels.SMEM_PER_BLOCK
    assert plan["warps"] >= 1
    assert sum(plan["groups"]) == cin
    assert all(1 <= g <= 4 for g in plan["groups"])
    if cin <= 4:
        assert plan["groups"] == [cin]
        assert plan["scratch_bytes"]["partial"] == 0
    else:
        assert plan["groups"][:-1] == [4] * (len(plan["groups"]) - 1)
        assert plan["warps"] == kernels.STEM_MAX_WIDE_WARPS == 8
        assert plan["smem_bytes"] == kernels.stem_sites_plan(
            16, 88, 88, 80, 16384, 4, bf16)["smem_bytes"]
        assert plan["scratch_bytes"]["partial"] == 4 * 16 * 16384 * 64
