"""The redesigned kernels on the card (marked `cuda`; they skip without
one): `kpconv_fused` against its plain version where its tiles are all
shadow, ragged or wide, in every influence and aggregation mode, at C 3,
16 and 256 and K 40 and 70; `stem_sites_dw` at Cin 3 and 18 and with an
empty mask; and the sums that make a train step repeatable, each run twice
for the same bits: `stem_sites_dw`, `kpconv_fused_bwd`'s dx and dW, and
`gather_rows_bwd` (against its plain version too); and a KPConv train
step that builds each neighbour list's reverse index once and hands it to
every gather backward. This file imports no
JAX, so it runs on the GPU machine:

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
