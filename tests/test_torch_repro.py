"""What makes the port's train steps repeatable on the card, on the CPU.

The reverse edge index (`ops.kpconv.reverse_edges`, over which the card's
backward kernels sum dx of every KPConv and of the strided shortcut's
gather in a fixed order) against the JAX package's host-side
`_edge_transpose`; the new backward of `gather_rows` (plain path) and of
the shortcut's max pool, ties included, against `jax.vjp` of the JAX
functions; the host side of the redesigned kernels' launches
(`kernels.kpconv_fwd_plan`, `kpconv_bwd_plan`, `stem_dw_plan`) at KPCNN's
14 layer shapes, at the bench's K 51 and 70 and at the edges; and the
float32 precision that every entry point pins (`device.pin_numerics`) and
records in its checkpoint."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.models import kpconv as jkp
from dpcr_agb_tpu.ops.host_pyramid import _edge_transpose
from dpcr_agb_tpu_torch import device, kernels, predict, train
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.models.kpconv import max_pool_zero_shadow_batched
from dpcr_agb_tpu_torch.ops import kpconv


def _lists(seed, b=3, nq=37, ns=11, k=9):
    """Neighbour lists over few source rows (so sources repeat, within a
    row too), with shadows (index ns) between real neighbours and one row
    of shadows only."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, ns + 1, (b, nq, k)).astype(np.int32)
    nbr[:, 5] = ns
    return rng, nbr


@pytest.mark.parametrize("seed", range(3))
def test_reverse_edges_equal_the_host_edge_transpose(seed):
    """Sample b's slices of (perm, off), less b*Nq*K, are
    `_edge_transpose(nbr[b], Ns)`: the stable sort of the flat list and the
    first sorted position of every row (the shadow's segment last)."""
    _, nbr = _lists(seed)
    b, nq, k = nbr.shape
    ns, e = 11, nq * k
    perm, off = kpconv.reverse_edges(torch.from_numpy(nbr), ns)
    assert perm.dtype == off.dtype == torch.int32
    assert perm.shape == (b * e,) and off.shape == (b * (ns + 1) + 1,)
    perm, off = perm.numpy(), off.numpy()
    for i in range(b):
        p_ref, o_ref = _edge_transpose(nbr[i], ns)
        np.testing.assert_array_equal(perm[i * e:(i + 1) * e] - i * e, p_ref)
        np.testing.assert_array_equal(
            off[i * (ns + 1):i * (ns + 1) + ns + 2] - i * e, o_ref)


def test_reverse_edges_treat_any_index_outside_the_rows_as_shadow():
    _, nbr = _lists(4, b=2)
    odd = nbr.copy()
    odd[odd == 11] = -1
    odd[0, 3, 2] = 40
    clean = np.where((odd >= 0) & (odd < 11), odd, 11).astype(np.int32)
    for got, want in zip(kpconv.reverse_edges(torch.from_numpy(odd), 11),
                         kpconv.reverse_edges(torch.from_numpy(clean), 11)):
        assert torch.equal(got, want)


def _jax_gather_vjp(x, nbr, g):
    b, ns, c = x.shape
    x_pad = jnp.concatenate([jnp.asarray(x), jnp.zeros((b, 1, c))], 1)
    _, vjp = jax.vjp(lambda t: jkp._batched_rows(t, jnp.asarray(nbr)), x_pad)
    return np.asarray(vjp(jnp.asarray(g))[0])[:, :ns]


@pytest.mark.parametrize("given", [True, False], ids=["rev", "built"])
def test_gather_backward_matches_jax(given):
    """The row gather's backward over the reverse index (given, or built by
    the backward) against jax.vjp of the JAX package's `_batched_rows`;
    rows that no list names get exactly 0."""
    rng, nbr = _lists(5)
    x = rng.standard_normal((3, 11, 6)).astype(np.float32)
    g = rng.standard_normal((*nbr.shape, 6)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    nt = torch.from_numpy(nbr)
    rev = kpconv.reverse_edges(nt, 11) if given else None
    out = kpconv.gather_rows(xt, nt, rev)
    np.testing.assert_array_equal(
        out.detach().numpy(), kpconv.gather_rows(torch.from_numpy(x),
                                                 nt).numpy())
    out.backward(torch.from_numpy(g))
    want = _jax_gather_vjp(x, nbr, g)
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    listed = np.zeros((3, 11), bool)
    for i in range(3):
        listed[i, nbr[i][nbr[i] < 11]] = True
    assert not xt.grad.numpy()[~listed].any()


def test_plain_gather_backward_equals_autograd_of_index_select():
    rng, nbr = _lists(6)
    g = torch.from_numpy(rng.standard_normal((*nbr.shape, 4)).astype(
        np.float32))
    x = torch.zeros((3, 11, 4), requires_grad=True)
    kpconv._gather_plain(x, torch.from_numpy(nbr)).backward(g)
    got = kpconv.gather_rows_bwd_plain(g, torch.from_numpy(nbr), 11)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_shortcut_max_pool_backward_with_ties_matches_jax():
    """The strided shortcut's max pool: ties between two source rows that
    hold the same values, and between negative rows and the shadow's zero
    row, split the cotangent evenly on both sides (jnp.max's VJP)."""
    rng, nbr = _lists(7)
    x = rng.standard_normal((3, 11, 5)).astype(np.float32)
    x[:, 4] = x[:, 3]                       # rows 3 and 4 tie everywhere
    x[:, 7] = -np.abs(x[:, 7])              # row 7 ties the shadow's 0 ...
    x[:, 7, 0] = 0.0
    nbr[:, 0] = 11                          # ... and so do these
    nbr[:, 0, :2] = [3, 4]
    nbr[:, 1] = 11
    nbr[:, 1, :2] = [7, 7]
    gy = rng.standard_normal((3, nbr.shape[1], 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    nt = torch.from_numpy(nbr)
    y = max_pool_zero_shadow_batched(xt, nt, kpconv.reverse_edges(nt, 11))
    y.backward(torch.from_numpy(gy))
    y_j, vjp = jax.vjp(lambda t: jkp.max_pool_zero_shadow_batched(
        t, jnp.asarray(nbr)), jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    assert want[0, 3].any() and want[0, 7, 0] != 0


# The rigid KPConvs of KPCNN at bs16 on an N bucket of 8192, (Nq, Ns, C,
# Cout), as in test_torch_kpconv_bwd.py
KPCNN_LAYERS = [
    (8192, 8192, 3, 32), (8192, 8192, 16, 16), (5736, 8192, 16, 16),
    (5736, 5736, 32, 32), (5736, 5736, 32, 32), (2872, 5736, 32, 32),
    (2872, 2872, 64, 64), (2872, 2872, 64, 64), (1480, 2872, 64, 64),
    (1480, 1480, 128, 128), (1480, 1480, 128, 128), (824, 1480, 128, 128),
    (824, 824, 256, 256), (824, 824, 256, 256)]


def _check_fwd_plan(plan, b, nq, c, cout, k, bf16):
    tiles = -(-b * nq // 64)
    assert plan["tiles"] == tiles and plan["tile_rows"] == 64
    bm, bn = plan["product_tile"]
    assert (bm, bn) == ((256, 16) if cout <= 16 else (128, 32) if cout <= 32
                        else (64, 64)) and plan["tile"] in (0, 1, 2)
    splits = plan["splits"]
    assert splits == (min(8, 15 * c // 480) if 15 * c >= 2048 else 1)
    assert plan["grids"] == {
        "flags": (tiles, 1), "part": (tiles * 4, -(-c // 32)),
        "product": (-(-b * nq // bm), -(-cout // bn), splits),
        "reduce": (-(-b * nq * cout // 32) if splits > 1 else 0, 1)}
    for name, (gx, gy, *gz) in plan["grids"].items():
        assert gx < 2 ** 31 and gy <= 65535 and gz in ([], [splits]), name
    for name, smem in plan["smem_bytes"].items():
        assert 0 < smem <= kernels.SMEM_PER_BLOCK, name
    assert plan["smem_bytes"]["part"] \
        == kernels.kpconv_bwd_plan(b, nq, 50, k, c, cout, 15,
                                   bf16)["smem_bytes"]["edge"]
    assert plan["scratch_bytes"] == {
        "flags": 4 * tiles, "part": tiles * 64 * 15 * c * (2 if bf16 else 4),
        "partial": splits * b * nq * cout * 4 if splits > 1 else 0}


@pytest.mark.parametrize("k", [40, 51, 70])
@pytest.mark.parametrize("layer", KPCNN_LAYERS,
                         ids=[f"{i}-{l[2]}to{l[3]}" for i, l in
                              enumerate(KPCNN_LAYERS)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_launch_plans_fit_the_card(layer, k, bf16):
    """`kpconv_fused` and `kpconv_fused_bwd` at every KPCNN layer of a bs16
    batch, at K 40 and at the bench's 51 and 70: shared memory within a
    block's 232,448 bytes, grids within CUDA's limits, the forward's part
    kernel the backward's."""
    nq, ns, c, cout = layer
    plan = kernels.kpconv_fwd_plan(16, nq, ns, k, c, cout, 15, bf16)
    _check_fwd_plan(plan, 16, nq, c, cout, k, bf16)
    bwd = kernels.kpconv_bwd_plan(16, nq, ns, k, c, cout, 15, bf16)
    for name, smem in bwd["smem_bytes"].items():
        assert 0 < smem <= kernels.SMEM_PER_BLOCK, name
    for name, (gx, gy) in bwd["grids"].items():
        assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535, name
    assert bwd["grids"]["dx"] == (-(-16 * ns // 8), 1)
    assert bwd["scratch_bytes"]["reverse_index"] \
        == 4 * (16 * nq * k + 16 * (ns + 1) + 1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_launch_plans_at_the_edges(bf16):
    """C 3 and C 256, Cout 1, one row, no row, K 150; K in the thousands
    is refused."""
    for c, cout in ((3, 1), (3, 32), (256, 1), (256, 256), (5, 33)):
        for b, nq in ((1, 1), (2, 0), (3, 70)):
            plan = kernels.kpconv_fwd_plan(b, nq, 50, 40, c, cout, 15, bf16)
            _check_fwd_plan(plan, b, nq, c, cout, 40, bf16)
            bwd = kernels.kpconv_bwd_plan(b, nq, 50, 40, c, cout, 15, bf16)
            assert max(bwd["smem_bytes"].values()) <= kernels.SMEM_PER_BLOCK
    wide = kernels.kpconv_fwd_plan(16, 824, 824, 150, 256, 256, 15, bf16)
    assert wide["smem_bytes"]["part"] <= kernels.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        kernels.kpconv_fwd_plan(16, 824, 824, 3000, 256, 256, 15, bf16)


@pytest.mark.parametrize("cin", [1, 3, 18])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stem_dw_plan(cin, bf16):
    """dW [343*Cin, 64] in tiles of 64 rows, ~4 blocks an SM in all (not
    from the batch's occupancy: the same for any mask), never more splits
    than windows of 256 sites; the partials' scratch and shared memory."""
    plan = kernels.stem_dw_plan(16, 16384, cin, bf16)
    m = -(-343 * cin // 64)
    assert plan["m_tiles"] == m and plan["grid"] == (m, plan["splits"])
    assert plan["splits"] == min(16384 * 16 // 256, 4 * 132 // m)
    assert plan["splits"] * plan["sites_per_split"] >= 16 * 16384
    assert 0 < plan["smem_bytes"] <= 48 * 1024       # static shared memory
    assert plan["scratch_bytes"]["partial"] \
        == plan["splits"] * 343 * cin * 64 * 4
    small = kernels.stem_dw_plan(1, 300, cin, bf16)
    assert small["splits"] == 2
    assert kernels.stem_dw_plan(2, 0, cin, bf16)["splits"] == 1


def test_pin_numerics_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = device.pin_numerics()
    assert got == device.numerics() == {
        "cudnn_allow_tf32": False, "matmul_allow_tf32": False,
        "cudnn_deterministic": bool(torch.backends.cudnn.deterministic)}
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_entry_points_pin_numerics_and_record_them(tmp_path, monkeypatch):
    """`train.main` and `predict.main` started with TF32 on (PyTorch's
    default for cuDNN) leave it off and the checkpoint records the pin; a
    KPConv step goes through the shortcut's gather backward 4 times (the 4
    strided blocks), on the CPU with no reverse index (only the card's
    kernels read it)."""
    rng = np.random.default_rng(3)
    plots = tmp_path / "plots"
    plots.mkdir()
    for i in range(2):
        pts, bm, v = generate_plot(rng, radius=6.0, density=2.0)
        np.savez(plots / f"p{i}.npz",
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=v)
    seen = []
    backward = kpconv.gather_rows_backward

    def counted(g, nbr, ns, rev=None):
        seen.append(rev is not None)
        return backward(g, nbr, ns, rev)

    monkeypatch.setattr(kpconv, "gather_rows_backward", counted)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", True)
    ckpt = str(tmp_path / "ck")
    out = train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                      "model_name=KPConv", "steps=1", "batch_size=2",
                      "device=cpu"])
    assert seen == [False] * 4
    pinned = device.numerics()
    assert not pinned["cudnn_allow_tf32"] and not pinned["matmul_allow_tf32"]
    saved = torch.load(out["checkpoint"], map_location="cpu",
                       weights_only=True)
    assert saved["numerics"] == pinned
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    path = predict.main([f"checkpoint_dir={ckpt}", "model_name=KPConv",
                         f"input={plots}/*.npz",
                         f"output={tmp_path / 'p.csv'}", "device=cpu"])
    assert not torch.backends.cudnn.allow_tf32 and os.path.exists(path)
    with open(path) as f:
        assert len(list(csv.reader(f))) == 3
