"""The redesigned kernels on the card (marked `cuda`; they skip without
one): `kpconv_fused` against its plain version where its tiles are all
shadow, ragged or wide, in every influence and aggregation mode, at C 3,
16 and 256 and K 40 and 70; `stem_sites_dw` at Cin 3 and 18 and with an
empty mask; and the sums that make a train step repeatable, each run twice
for the same bits: `stem_sites_dw`, `kpconv_fused_bwd`'s dx and dW, and
`gather_rows_bwd` (against its plain version too); and a KPConv train
step that builds each neighbour list's reverse index once and hands it to
every gather backward; the two pool forms (`max_pool_k3s2_rows` and the
volume form), the volume-form pool backward and `stem_sites` (Cin 1 to 18)
against their plain versions at their edges (for the row form also whole and childless
windows; for the backward its warp tiles' edges), the same bits twice;
the row-form pool backward (`max_pool_k3s2_bwd`) against its plain
version with ties, padded rows and rows on the volume's upper edge, the
same bits twice, and its C entry refusing shapes past 32-bit offsets
and taking the largest ones below; MPointNet's and SimplestNet's forwards
on the card, which launch none of the port's kernels and agree with the
CPU's; `fps` against its plain version, indices exactly and the same bits
twice, at PointNeXt's samplings, at B 1 and 32 and at its edges
(duplicates in different CTAs of a cluster, an integer grid's exact ties,
starts other than 0), under each cluster size; the five custom ops of
`kernels/ops.py` on CUDA tensors (one launch a call, the plain version's
values, `torch.library.opcheck`) and a narrow SENet14 exported and loaded
on the card.
This file imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_imports.py \\
        tests/test_torch_card.py -q"""
import numpy as np
import pytest
import torch

from test_torch_imports import _kpconv_case

# (B, Nq, Ns, K, Kp, C, Cout, share of all-shadow rows): 64- and 128-row
# tiles of shadows only between real ones, rows not a multiple of a tile,
# the first layer (3 -> 32), level 0, the widest level, K 70 at level 3's
# width and at the first layer's (the forward's largest shared memory),
# Cout that fills no tile
FWD_CASES = [
    (3, 300, 120, 40, 15, 16, 16, 0.9), (2, 260, 130, 40, 15, 3, 32, 0.9),
    (2, 90, 70, 40, 15, 256, 256, 0.9), (2, 150, 90, 70, 15, 128, 128, 0.5),
    (2, 150, 90, 70, 15, 3, 32, 0.5), (1, 77, 40, 13, 15, 24, 40, 0.0),
    (1, 1, 5, 40, 15, 16, 1, 0.0)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels "
                    "at the main path's shapes")


@pytest.mark.cuda
def test_redesigned_kpconv_forward_matches_its_plain_version():
    """Tolerances of test_kpconv_kernels_match_plain_versions_on_the_card:
    f32 rtol 1e-4 with atol 1e-4 of max|plain|, bf16 atol 1e-2 of
    max|plain|; a query row of shadows only,
    and every row of an all-shadow tile, gives exact zeros."""
    _card()
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import kpconv
    rng = np.random.default_rng(11)
    for case in FWD_CASES:
        q, s, nbr, x, kp, w, _ = _kpconv_case(rng, *case[:7], device="cuda",
                                              shadow_rows=case[7])
        rel = kpconv.shared_rel(q, s, nbr)
        shadow_rows = ~(nbr < case[2]).any(-1)
        modes = [(i, a) for i in kpconv.INFLUENCES
                 for a in kpconv.AGGREGATIONS] if case[5] <= 16 \
            else [("linear", "sum"), ("gaussian", "closest")]
        for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-4),
                                  (torch.bfloat16, 0.0, 1e-2)):
            plan = kernels.kpconv_fwd_plan(case[0], case[1], case[2],
                                           case[3], case[5], case[6], 15,
                                           dtype == torch.bfloat16)
            for influence, aggregation in modes:
                args = (x.to(dtype), nbr, rel, w, kp, 0.4, influence,
                        aggregation)
                want = kpconv.kpconv_fused_plain(*args)
                got = kpconv.kpconv_forward(*args)
                what = f"{case} {dtype} {influence} {aggregation} {plan}"
                torch.testing.assert_close(
                    got, want, rtol=rtol, msg=lambda m: f"{what}: {m}",
                    atol=atol * max(want.abs().max().item(), 1e-30))
                assert not got[shadow_rows].any(), what
                assert torch.equal(kpconv.kpconv_forward(*args), got), what


@pytest.mark.cuda
def test_stem_dw_matches_its_plain_version_and_repeats():
    """Cin 3 and 18, f32 and bf16, a mask with holes and an empty one:
    within rtol 1e-4, atol 1e-5 of max|plain| (the tolerance of
    test_backward_kernels_match_plain_versions_on_the_card), the same bits
    in two runs, and dW 0 for the empty mask."""
    _card()
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites_dw,
                                                    stem_conv_sites_dw_plain)
    rng = np.random.default_rng(12)
    dims = (11, 9, 8)
    n = 300
    flat = np.stack([rng.choice(11 * 9 * 8, n, replace=False)
                     for _ in range(2)])
    coords = torch.from_numpy(np.stack(
        [flat // 72, flat // 8 % 9, flat % 8], -1).astype(np.int32)).cuda()
    for cin in (3, 18):
        for dtype in (torch.float32, torch.bfloat16):
            for keep in (0.6, 0.0):
                mask = torch.from_numpy(rng.random((2, n)) < keep).cuda()
                feats = torch.randn((2, n, cin), device="cuda").to(dtype)
                vol, _ = scatter_to_dense(coords, mask, feats, dims)
                ct = torch.randn((2, n, 64), device="cuda").to(dtype)
                want = stem_conv_sites_dw_plain(vol, coords, mask, ct)
                got = stem_conv_sites_dw(vol, coords, mask, ct)
                what = f"Cin {cin} {dtype} keep {keep}"
                torch.testing.assert_close(
                    got, want, rtol=1e-4, msg=lambda m: f"{what}: {m}",
                    atol=1e-5 * max(want.abs().max().item(), 1e-30))
                assert torch.equal(stem_conv_sites_dw(vol, coords, mask, ct),
                                   got), what
                if keep == 0.0:
                    assert not got.any(), what


@pytest.mark.cuda
def test_backward_sums_repeat_bit_for_bit():
    """kpconv_fused_bwd's dx and dW, and gather_rows_bwd (also against its
    plain version, index_add_: rtol 1e-5, atol 1e-6 of max|plain|), the
    same bits in two runs, over the reverse index given and built."""
    _card()
    from dpcr_agb_tpu_torch.ops import kpconv
    rng = np.random.default_rng(13)
    for case in ((3, 300, 120, 40, 15, 16, 16), (2, 90, 70, 40, 15, 256, 64),
                 (2, 150, 90, 70, 15, 128, 128)):
        q, s, nbr, x, kp, w, g = _kpconv_case(rng, *case, device="cuda",
                                              shadow_rows=0.5)
        rel = kpconv.shared_rel(q, s, nbr)
        rev = kpconv.reverse_edges(nbr, case[2])
        for dtype in (torch.float32, torch.bfloat16):
            args = (x.to(dtype), nbr, rel, w, kp, g, 0.4)
            dx, dw = kpconv.kpconv_backward(*args, rev=rev)
            dx2, dw2 = kpconv.kpconv_backward(*args)
            assert torch.equal(dx, dx2) and torch.equal(dw, dw2), case
        ct = torch.randn((*nbr.shape, case[5]), device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            got = kpconv.gather_rows_backward(ct.to(dtype), nbr, case[2], rev)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(
                kpconv.gather_rows_backward(ct.to(dtype), nbr, case[2]), got)
            want = kpconv.gather_rows_bwd_plain(ct.to(dtype), nbr, case[2])
            torch.testing.assert_close(
                got.float(), want.float(),
                rtol=1e-5 if dtype == torch.float32 else 1e-2,
                atol=(1e-6 if dtype == torch.float32 else 1e-2)
                * want.float().abs().max().item())


@pytest.mark.cuda
def test_card_train_step_hands_each_list_its_reverse_index(tmp_path,
                                                           monkeypatch):
    """A KPConv step on the card builds each neighbour list's reverse index
    once in the forward and hands it to all 4 gather backwards of the
    strided shortcuts, so no backward builds its own."""
    _card()
    from dpcr_agb_tpu_torch import train
    from dpcr_agb_tpu_torch.data.synthetic import generate_plot
    from dpcr_agb_tpu_torch.models import kpconv as model
    from dpcr_agb_tpu_torch.ops import kpconv
    rng = np.random.default_rng(3)
    plots = tmp_path / "plots"
    plots.mkdir()
    for i in range(2):
        pts, bm, v = generate_plot(rng, radius=6.0, density=2.0)
        np.savez(plots / f"p{i}.npz",
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=v)
    built, seen = [], []
    build, backward = model.reverse_edges, kpconv.gather_rows_backward

    def counted_build(nbr, ns):
        built.append(nbr.shape)
        return build(nbr, ns)

    def counted(g, nbr, ns, rev=None):
        seen.append(rev is not None)
        return backward(g, nbr, ns, rev)

    monkeypatch.setattr(model, "reverse_edges", counted_build)
    monkeypatch.setattr(kpconv, "gather_rows_backward", counted)
    train.main([f"input={plots}/*.npz", f"checkpoint_dir={tmp_path / 'ck'}",
                "model_name=KPConv", "steps=1", "batch_size=2"])
    assert seen == [True] * 4
    # one index per (level, conv or pool) list: 5 conv lists, 4 pool lists
    assert len(built) == 9, built


def _bits_equal(a, b):
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _sites(rng, dims, b, v, n_valid):
    """Unique coordinates for the first n_valid[i] rows of sample i (the
    rest masked, at coordinates that repeat valid ones)."""
    d, h, w = dims
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        flat = rng.choice(d * h * w, size=v, replace=False)
        coords[i] = np.stack([flat // (h * w), flat // w % h, flat % w], 1)
        mask[i, :n_valid[i]] = True
    return coords, mask


@pytest.mark.cuda
def test_pool_forms_match_their_plain_versions_and_repeat():
    """max_pool_k3s2_rows against masked_max_pool_rows_plain (y and occ_l)
    and the volume form against masked_max_pool_plain, exactly, at C 64 and
    128, f32 and bf16, odd and even dims: an all-empty sample, masked rows,
    rows outside the volume, duplicate pairs and a triple (values on a
    1/16 grid: every sum is exact in any order), and 80% occupied volumes;
    the same bits in two calls."""
    _card()
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import pool
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    rng = np.random.default_rng(14)
    for dims in ((13, 10, 9), (8, 12, 34)):
        coords, mask = _sites(rng, dims, 3, 203, (170, 0, 61))
        coords[0, 170:173] = [[dims[0], 0, 0], [0, -1, 2], [1, 2, dims[2]]]
        coords[0, 173:178] = coords[0, [0, 1, 2, 3, 3]]  # pairs, a triple
        mask[0, 170:178] = True
        c_t, m_t = torch.from_numpy(coords).cuda(), torch.from_numpy(
            mask).cuda()
        for c in (64, 128):
            vals = torch.from_numpy(rng.integers(-64, 64, (3, 203, c))
                                    / 16.0).float().cuda()
            for dtype in (torch.float32, torch.bfloat16):
                h = vals.to(dtype)
                what = f"{dims} C {c} {dtype}"
                before = kernels.LAUNCHES["max_pool_k3s2_rows"]
                y, occ = pool.masked_max_pool_rows(c_t, m_t, h, dims)
                assert kernels.LAUNCHES["max_pool_k3s2_rows"] == before + 1
                want_y, want_occ = pool.masked_max_pool_rows_plain(
                    c_t, m_t, h, dims)
                torch.testing.assert_close(y, want_y, rtol=0, atol=0,
                                           msg=what)
                torch.testing.assert_close(occ, want_occ, rtol=0, atol=0,
                                           msg=what)
                assert occ.max().item() == 3.0 and not y[1].any(), what
                y2, occ2 = pool.masked_max_pool_rows(c_t, m_t, h, dims)
                assert _bits_equal(y, y2) and _bits_equal(occ, occ2), what
                hv, occ_v = scatter_to_dense(c_t, m_t, h, dims)
                dense = (torch.rand(occ_v.shape, device="cuda") < 0.8).to(
                    dtype)
                for x, o in ((hv, occ_v), (torch.randn(
                        hv.shape, device="cuda").to(dtype) * dense, dense)):
                    got = pool.masked_max_pool(x, o)
                    torch.testing.assert_close(
                        got, pool.masked_max_pool_plain(x, o), rtol=0, atol=0,
                        msg=what)
                    assert _bits_equal(got, pool.masked_max_pool(x, o)), what


@pytest.mark.cuda
def test_row_pool_full_and_childless_windows():
    """max_pool_k3s2_rows at the window cases of its list design, exactly
    against masked_max_pool_rows_plain (y and occ_l) and the same bits in
    two calls, C 64 and 128, f32 and bf16 (values on a 1/16 grid), odd and
    even dims. Sample 0 holds only constructed rows: an output cell whose
    whole 27-cell window is occupied, with a duplicate pair among its
    children; one with occupied window cells but no occupied child (y and
    occ_l 0 there); the volume's far corner. Sample 1 random rows, masked
    ones and ones outside the volume."""
    _card()
    from dpcr_agb_tpu_torch.ops import pool
    rng = np.random.default_rng(16)
    full = [(3 + a, 3 + c, 3 + f) for a in range(3) for c in range(3)
            for f in range(3)]              # the window of output (2, 2, 2)
    # output (5, 1, 1): children {10,11} x {2,3} x {2,3}; these window
    # cells each have a coordinate 2u - 1, so none is a child of it
    childless = [(9, 1, 1), (9, 2, 3), (10, 1, 2), (11, 3, 1)]
    for dims in ((13, 10, 9), (12, 14, 40)):
        d, h, w = dims
        coords, mask = _sites(rng, dims, 2, 160, (0, 90))
        built = full + childless + [(d - 1, h - 1, w - 1), (4, 4, 4)]
        coords[0, :len(built)] = built
        mask[0, :len(built)] = True
        coords[1, 90:93] = [[d, 0, 0], [0, -1, 2], [1, 2, w]]
        mask[1, 90:93] = True
        c_t, m_t = torch.from_numpy(coords).cuda(), torch.from_numpy(
            mask).cuda()
        for c in (64, 128):
            vals = torch.from_numpy(rng.integers(-64, 64, (2, 160, c))
                                    / 16.0).float().cuda()
            for dtype in (torch.float32, torch.bfloat16):
                h_rows = vals.to(dtype)
                what = f"{dims} C {c} {dtype}"
                y, occ = pool.masked_max_pool_rows(c_t, m_t, h_rows, dims)
                want_y, want_occ = pool.masked_max_pool_rows_plain(
                    c_t, m_t, h_rows, dims)
                torch.testing.assert_close(y, want_y, rtol=0, atol=0,
                                           msg=what)
                torch.testing.assert_close(occ, want_occ, rtol=0, atol=0,
                                           msg=what)
                assert occ[0, 2, 2, 2, 0] == 2.0, what   # the duplicate pair
                assert occ[0, 5, 1, 1, 0] == 0 and not y[0, 5, 1, 1].any(), \
                    what
                assert occ[0, -1, -1, -1, 0] == 1.0, what
                y2, occ2 = pool.masked_max_pool_rows(c_t, m_t, h_rows, dims)
                assert _bits_equal(y, y2) and _bits_equal(occ, occ2), what


@pytest.mark.cuda
def test_volume_backward_at_tile_edges_and_repeats():
    """max_pool_k3s2_bwd_vol exactly against masked_max_pool_bwd_vol_plain
    and the same bits in two calls, C 64 and 128, f32 and bf16, at the
    edges of its 32-cell warp tiles: cell counts that are not a multiple
    of 32, tiles that straddle a z row (W 5, 9, 33) and a sample, a volume
    smaller than one tile, odd and even dims, 1% and 80% occupancy; values
    on a 1/16 grid, so windows hold ties (every maximizer gets the full
    cotangent) in both dtypes."""
    _card()
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import pool
    from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool
    rng = np.random.default_rng(17)
    for shape in ((3, 5, 6, 7), (2, 9, 4, 33), (2, 24, 20, 9), (1, 1, 2, 5),
                  (2, 16, 12, 10)):
        for share in (0.01, 0.8):
            occ_np = (rng.random((*shape, 1)) < share).astype(np.float32)
            occ_np.reshape(-1)[-1] = 1.0        # the last cell of the volume
            for c in (64, 128):
                x_np = rng.integers(-8, 8, (*shape, c)) / 16.0 * occ_np
                for dtype in (torch.float32, torch.bfloat16):
                    what = f"{shape} {share} C {c} {dtype}"
                    occ = torch.from_numpy(occ_np).cuda().to(dtype)
                    x = torch.from_numpy(x_np).float().cuda().to(dtype)
                    y = pool.masked_max_pool_plain(x, occ)
                    ct = torch.from_numpy(rng.normal(size=tuple(y.shape))
                                          .astype(np.float32)).cuda() \
                        .to(dtype) * occupancy_pool(occ)
                    before = kernels.LAUNCHES["max_pool_k3s2_bwd_vol"]
                    got = pool.masked_max_pool_bwd_vol(x, occ, y, ct)
                    assert kernels.LAUNCHES["max_pool_k3s2_bwd_vol"] \
                        == before + 1, what
                    want = pool.masked_max_pool_bwd_vol_plain(x, occ, y, ct)
                    torch.testing.assert_close(got, want, rtol=0, atol=0,
                                               msg=what)
                    assert _bits_equal(
                        pool.masked_max_pool_bwd_vol(x, occ, y, ct), got), \
                        what


@pytest.mark.cuda
def test_stem_sites_matches_its_plain_version_and_repeats():
    """Cin 1, 3 and 4 (one launch) and 5, 7 and 18 (a launch a group of 4
    input channels), with and without a bias: f32 within rtol 1e-4, atol
    1e-4 and bf16 within atol 2e-2 of max|plain| (chip_smoke.py's
    tolerances); sites on all six faces of the volume and past it (read at
    the clipped site), an all-masked sample, B*V = 3 * 301 sites (not a
    multiple of a block's); masked rows 0; the same bits in two calls."""
    _card()
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites,
                                                    stem_conv_sites_plain)
    rng = np.random.default_rng(15)
    dims = (9, 11, 37)
    coords, mask = _sites(rng, dims, 3, 301, (260, 0, 97))
    coords[0, :8] = [[0, 5, 20], [8, 5, 20], [4, 0, 20], [4, 10, 20],
                     [4, 5, 0], [4, 5, 36], [0, 0, 0], [8, 10, 36]]
    coords[2, :2] = [[9, -2, 40], [-1, 11, 3]]
    c_t, m_t = torch.from_numpy(coords).cuda(), torch.from_numpy(mask).cuda()
    for cin in (1, 3, 4, 5, 7, 18):
        feats = torch.from_numpy(rng.normal(size=(3, 301, cin)).astype(
            np.float32)).cuda()
        wts = torch.from_numpy((rng.normal(size=(343, cin, 64)) * 0.1)
                               .astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=64).astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            vol, _ = scatter_to_dense(c_t, m_t, feats.to(dtype), dims)
            for b in (bias.to(dtype), None):
                args = (vol, c_t, m_t, wts.to(dtype), b)
                got = stem_conv_sites(*args)
                want = stem_conv_sites_plain(*args)
                what = f"Cin {cin} {dtype} bias {b is not None}"
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, rtol=1e-4,
                                               atol=1e-4, msg=what)
                else:
                    torch.testing.assert_close(
                        got.float(), want.float(), rtol=0, msg=what,
                        atol=2e-2 * want.float().abs().max().item())
                assert not got[~m_t].any(), what
                assert _bits_equal(stem_conv_sites(*args), got), what


@pytest.mark.cuda
def test_row_backward_matches_its_plain_version_and_repeats():
    """max_pool_k3s2_bwd exactly against masked_max_pool_bwd_rows_plain and
    the same bits in two calls, f32 and bf16, C 32 and 64 (and the
    smallest C the contract takes, one 16-byte group, and C 256, whose
    rows loop over their items), odd and even dims: y pooled from the rows
    with values on a 1/16 grid, so windows hold ties (every maximizer gets
    the full cotangent); padded rows (a whole sample of them), rows at odd
    coordinates on the volume's upper edge (no upper parent there when the
    extent is even), rows outside the volume, a duplicate pair; ct not
    zero at unoccupied outputs (the kernel masks it by occ_l)."""
    _card()
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import pool
    rng = np.random.default_rng(19)
    for dims in ((13, 10, 9), (12, 14, 40)):
        d, h, w = dims
        coords, mask = _sites(rng, dims, 3, 170, (150, 0, 97))
        odd_edge = [(d - 1, h - 1, w - 1), (d - 1, 3, 5), (1, h - 1, 3),
                    (5, 7, w - 1), ((d - 1) | 1 if d % 2 == 0 else d - 2,
                                    (h - 1) | 1 if h % 2 == 0 else h - 2, 1)]
        coords[0, :len(odd_edge)] = odd_edge
        coords[0, 150:153] = [[d, 0, 0], [0, -1, 2], [1, 2, w]]
        coords[0, 153] = coords[0, 7]                 # a duplicate pair
        mask[0, 150:154] = True
        c_t, m_t = torch.from_numpy(coords).cuda(), torch.from_numpy(
            mask).cuda()
        for c in (32, 64, 4, 8, 256):
            vals = torch.from_numpy(rng.integers(-16, 16, (3, 170, c))
                                    / 16.0).float().cuda()
            for dtype in (torch.float32, torch.bfloat16):
                if c * torch.finfo(dtype).bits // 8 % 16:
                    continue           # not a whole number of 16-byte groups
                h_rows = vals.to(dtype)
                what = f"{dims} C {c} {dtype}"
                y, occ_l = pool.masked_max_pool_rows_plain(c_t, m_t, h_rows,
                                                           dims)
                ct = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
                    np.float32)).cuda().to(dtype)
                before = kernels.LAUNCHES["max_pool_k3s2_bwd"]
                got = pool.masked_max_pool_bwd_rows(c_t, m_t, h_rows, y,
                                                    occ_l, ct, dims)
                assert kernels.LAUNCHES["max_pool_k3s2_bwd"] == before + 1
                want = pool.masked_max_pool_bwd_rows_plain(
                    c_t, m_t, h_rows, y, occ_l, ct, dims)
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           msg=what)
                assert got[0, :5].any() and not got[1].any(), what
                assert not got[~m_t].any() and not got[0, 150:153].any(), what
                assert _bits_equal(pool.masked_max_pool_bwd_rows(
                    c_t, m_t, h_rows, y, occ_l, ct, dims), got), what


@pytest.mark.cuda
def test_row_backward_entry_refuses_shapes_past_32_bit_offsets():
    """The C entry takes 32-bit element offsets: it refuses (before it
    reads anything) B*V*C or B*ceil(D/2)*ceil(H/2)*ceil(W/2)*C of 2^31 or
    more, and takes the largest shapes a row of 64 values below, in rows
    and in parents (bf16, 4 GB a tensor): there the last row, and a row
    whose one parent is the last cell, are routed right, at offsets just
    under 2^31, and every other row writes zeros."""
    _card()
    from dpcr_agb_tpu_torch.kernels import build
    fn = build.entry("max_pool_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    null = [0] * 7
    assert fn(0, *null, 1, 2 ** 25, 2, 2, 2, 64, stream) == -2   # rows
    assert fn(0, *null, 1, 1, 2048, 2048, 2048, 64, stream) == -2  # parents
    assert fn(1, *null, 2, 2 ** 24, 2, 2, 2, 64, stream) == -2
    assert fn(1, *null, 1, 1, 64, 2048, 2048, 64, stream) == -2  # 2^25 cells
    assert fn(0, *null, 0, 0, 2048, 2048, 1024, 8, stream) == 0  # no rows
    gen = torch.Generator(device="cuda").manual_seed(21)
    bf = torch.bfloat16

    def run(v, dims, last_cell):
        """One launch over v rows (all padded but the last two, which lie
        at the cell whose only parent is `last_cell`: the last one's h
        equals y there, the one before not), y and ct of `dims`' level 1
        (read at last_cell only, the one occupied output): dx."""
        d1, h1, w1 = ((n + 1) // 2 for n in dims)
        coords = torch.zeros((1, v, 3), dtype=torch.int32, device="cuda")
        coords[0, -2:] = torch.tensor([2 * n for n in last_cell],
                                      dtype=torch.int32)
        mask = torch.zeros((1, v), dtype=torch.uint8, device="cuda")
        mask[0, -2:] = 1
        y = torch.empty((1, d1, h1, w1, 64), dtype=bf, device="cuda")
        ct = torch.empty_like(y)
        occ = torch.zeros((1, d1, h1, w1, 1), dtype=bf, device="cuda")
        occ[(0, *last_cell)] = 1
        y[(0, *last_cell)] = torch.randn(64, generator=gen, device="cuda")
        ct[(0, *last_cell)] = torch.randn(64, generator=gen, device="cuda")
        h = torch.zeros((1, v, 64), dtype=bf, device="cuda")
        h[0, -1] = y[(0, *last_cell)]
        h[0, -2] = y[(0, *last_cell)] + 1
        dx = torch.full_like(h, 7.0)
        assert fn(1, *(t.data_ptr() for t in (coords, mask, h, y, occ, ct,
                                              dx)),
                  1, v, *dims, 64, stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(dx[0, -1], ct[(0, *last_cell)])
        assert not dx[0, :-1].any()

    run(2 ** 25 - 1, (2, 2, 2), (0, 0, 0))          # rows: V*C = 2^31 - 64
    torch.cuda.empty_cache()
    # parents: 31 * 601 * 1801 cells = 2^25 - 1, times C = 2^31 - 64
    run(2, (62, 1202, 3602), (30, 600, 1800))
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["MPointNet", "SimplestNet"])
def test_pointwise_model_on_the_card_launches_no_kernel_and_matches_the_cpu(
        name):
    """MPointNet (the train entry's option: gelu, sum pool, positions
    added, embedding 1024) on a padded batch, and SimplestNet on a full
    batch of the fixed_xy preset's 12000 points, at full width: the CUDA
    forward, in eval and in training mode, launches none of the port's
    kernels and agrees with the same forward on the CPU, and so do the BN
    running stats it moves (f32, TF32 off: rtol 1e-4, atol 1e-4 * max|CPU|
    of each tensor)."""
    _card()
    import copy
    from dpcr_agb_tpu_torch import kernels, train
    from dpcr_agb_tpu_torch.data.batch import Batch
    from dpcr_agb_tpu_torch.device import pin_numerics
    from dpcr_agb_tpu_torch.models.factory import build_model
    pin_numerics()
    rng = np.random.default_rng(20)
    b, n = 4, (3000 if name == "MPointNet" else 12000)
    mask = np.zeros((b, n), bool)
    counts = (3000, 2100, 17, 1200) if name == "MPointNet" else (n,) * b
    for i, k in enumerate(counts):
        mask[i, :k] = True
    batch = Batch(pos=rng.uniform(0, 1, (b, n, 3)).astype(np.float32),
                  x=rng.normal(size=(b, n, 3)).astype(np.float32), mask=mask,
                  y_reg=np.zeros((b, 2), np.float32),
                  y_reg_mask=np.ones((b, 2), bool),
                  area_idx=np.zeros(b, np.int32),
                  label_idx=np.arange(b, dtype=np.int64),
                  is_double=np.zeros(b, bool))
    net, _ = build_model(train.model_option(name, False), 2, 3,
                         generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(net).cuda()
    for mode in (False, True):
        net.train(mode)
        card.train(mode)
        kernels.reset_launches()
        with torch.no_grad():
            got = card(batch.to("cuda")).cpu()
            want = net(batch.to("cpu"))
        assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())
    for key, t in card.state_dict().items():
        want = net.state_dict()[key]
        torch.testing.assert_close(t.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item(),
                                   msg=key)


def _fps_cloud(rng, b, n, kind):
    """pos [b,n,3] f32 and mask [b,n]: uniform in the unit cube; "edges":
    sample 1 padded (rows 2000 on masked and far), sample 2 with 700 valid
    rows, sample 3 all masked, sample 4 with exact duplicates; "cross":
    each sample's last quarter a copy of its first, so that a duplicate
    lies in another CTA of the cluster; "grid": integer coordinates in a
    12 x 12 x 12 grid, where many distances tie exactly."""
    pos = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    if kind == "edges":
        mask[1, 2000:] = False
        pos[1, 2000:] = 1e6
        mask[2, 700:] = False
        mask[3] = False
        pos[4, 1000:2000] = pos[4, :1000]
    elif kind == "cross":
        q = n // 4
        pos[:, n - q:] = pos[:, :q]
    elif kind == "grid":
        pos = rng.integers(0, 12, (b, n, 3)).astype(np.float32)
    return pos, mask


@pytest.mark.cuda
def test_fps_matches_its_plain_version_and_repeats():
    """`fps` against `fps_plain` on the card, indices exactly, the same
    bits in two calls: PointNeXt's samplings (12000 -> 8192, then / 4 down
    to 32), one plot (B 1) and the paper's training batch (B 32) at 12000
    -> 8192, the kernel's largest N (24576), one point, padded rows (far
    values), a sample with fewer valid rows than it samples, an all-masked
    one, exact duplicates in one CTA and in different CTAs of a cluster,
    an integer grid (exact ties everywhere) and starts other than 0; one
    launch a call. N past the cluster's registers and CPU tensors
    raise."""
    _card()
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops.neighbors import fps, fps_plain
    rng = np.random.default_rng(13)
    cases = [(4, 12000, 8192, 0, "uniform"), (4, 8192, 2048, 0, "uniform"),
             (3, 2048, 512, 0, "uniform"), (3, 512, 128, 5, "uniform"),
             (3, 128, 32, 0, "uniform"), (2, 24576, 4096, 0, "uniform"),
             (2, 1, 3, 0, "uniform"), (5, 3000, 2000, 0, "edges"),
             (1, 12000, 8192, 0, "uniform"), (32, 12000, 8192, 0, "uniform"),
             (4, 12000, 8192, 7777, "cross"), (16, 8192, 2048, 0, "cross"),
             (4, 12000, 8192, 0, "grid"), (3, 2048, 512, 3, "grid")]
    for b, n, ns, start, kind in cases:
        pos, mask = _fps_cloud(rng, b, n, kind)
        p = torch.from_numpy(pos).cuda()
        m = torch.from_numpy(mask).cuda()
        kernels.reset_launches()
        got = fps(p, m, ns, start)
        assert kernels.LAUNCHES["fps"] == 1
        again = kernels.fps(p, m, ns, start)
        assert kernels.LAUNCHES["fps"] == 2
        want = fps_plain(p, m, ns, start)
        assert got.dtype == torch.int64 and got.shape == (b, ns)
        assert torch.equal(got, want), (b, n, ns, kind)
        assert torch.equal(got, again), (b, n, ns, kind)
    with pytest.raises(ValueError, match="24577 points"):
        kernels.fps(torch.zeros(1, 24577, 3, device="cuda"),
                    torch.ones(1, 24577, dtype=torch.bool, device="cuda"), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.fps(torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=torch.bool),
                    4)


@pytest.mark.cuda
def test_fps_every_cluster_size_gives_the_plain_indices():
    """Each cluster size the kernel takes (1, 2, 4, 8 CTAs a sample, the
    plan's threads for it) on the cross-CTA duplicates and the integer
    grid: indices equal to `fps_plain`'s, one launch a call, and every CTA
    of the launch reporting its SM."""
    _card()
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops.neighbors import fps_plain
    rng = np.random.default_rng(17)
    for kind in ("cross", "grid"):
        pos, mask = _fps_cloud(rng, 4, 6000, kind)
        p = torch.from_numpy(pos).cuda()
        m = torch.from_numpy(mask).cuda()
        want = fps_plain(p, m, 1500, 11)
        for c in kernels.FPS_CLUSTERS:
            plan = kernels.fps_plan(6000, 4, cluster=c)
            smid = torch.full((plan["ctas"],), -1, dtype=torch.int32,
                              device="cuda")
            kernels.reset_launches()
            got = kernels.fps(p, m, 1500, 11, plan=plan, smid=smid)
            assert kernels.LAUNCHES["fps"] == 1
            assert torch.equal(got, want), (kind, c)
            assert (smid >= 0).all(), (kind, c)


@pytest.mark.cuda
def test_custom_ops_dispatch_to_the_kernels_and_pass_opcheck(tmp_path):
    """The five ops of `kernels/ops.py` on CUDA tensors: each launches its
    kernel once a call (the launch count moves, the plain version is not
    taken), equals its plain version on the CPU copies (exact; the stem
    within 1e-4 of max|plain|), and passes `torch.library.opcheck`; a
    narrow SENet14 exported on the card holds both sparse-level-0 ops and
    its loaded program launches each once a call."""
    _card()
    from dpcr_agb_tpu_torch import export_model, kernels
    from dpcr_agb_tpu_torch.kernels import ops as kops
    from dpcr_agb_tpu_torch.models.factory import build_model
    from dpcr_agb_tpu_torch.serving import save_checkpoint
    from dpcr_agb_tpu_torch import train
    g = torch.Generator().manual_seed(5)
    b, d, h, w, cin = 2, 10, 9, 11, 3
    vol = torch.randn(b, d, h, w, cin, generator=g)
    coords = torch.randint(0, 9, (b, 40, 3), generator=g, dtype=torch.int32)
    mask = torch.rand(b, 40, generator=g) > 0.3
    cases = {
        "stem_sites": (vol, coords, mask,
                       torch.randn(343, cin, 64, generator=g),
                       torch.randn(64, generator=g)),
        "max_pool_k3s2_rows": (coords, mask,
                               torch.randn(b, 40, 64, generator=g),
                               [d, h, w]),
        "max_pool_k3s2": (torch.randn(b, d, h, w, 64, generator=g),
                          (torch.rand(b, d, h, w, 1, generator=g) > 0.5
                           ).float()),
        "firewall_copy": (vol.permute(0, 3, 1, 2, 4),),
        "fps": (torch.rand(b, 300, 3, generator=g),
                torch.rand(b, 300, generator=g) > 0.2, 64, 0)}
    for name, args in cases.items():
        op = getattr(kops, name)
        cuda = tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                     for a in args)
        before = kernels.LAUNCHES[name]
        got = op(*cuda)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        want = op(*args)
        for gt, wt in zip(got if isinstance(got, tuple) else (got,),
                          want if isinstance(want, tuple) else (want,)):
            assert gt.is_cuda and gt.dtype == wt.dtype, name
            tol = 1e-4 * float(wt.abs().max()) if name == "stem_sites" \
                else 0.0
            torch.testing.assert_close(gt.cpu(), wt, rtol=0, atol=tol)
        torch.library.opcheck(op, cuda)

    option = train.model_option("SENet14", False, dense_dims=[24, 24, 16])
    net, _ = build_model(option, 2, 3, generator=g)
    save_checkpoint(str(tmp_path), "SENet14", net, option, 3,
                    train.MODELS["SENet14"][1](),
                    {"scale": [4.0, 8.0], "center": [100.0, 200.0],
                     "weights": [0.5, 0.5]}, ["BMag_ha", "V_ha"])
    path = export_model.main([f"checkpoint_dir={tmp_path}",
                              "model_name=SENet14",
                              f"output={tmp_path}/m.pt2", "batch_size=2",
                              "num_points=64"])
    program = export_model.load(path)
    coords = torch.full((2, 64, 3), export_model.PAD_COORD,
                        dtype=torch.int32)
    coords[:, :40] = torch.randint(0, 16, (2, 40, 3), generator=g)
    mask = torch.zeros(2, 64, dtype=torch.bool)
    mask[:, :40] = True
    kernels.reset_launches()
    with torch.no_grad():
        out = program(torch.zeros(2, 64, 3).cuda(),
                      torch.rand(2, 64, 3, generator=g).cuda(),
                      mask.cuda(), coords.cuda())
    torch.cuda.synchronize()
    assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "stem_sites": 1, "max_pool_k3s2_rows": 1}
