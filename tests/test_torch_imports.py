"""Import rules of the port: no module of dpcr_agb_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax, the JAX package dpcr_agb_tpu, or a
package the GPU machine lacks (pandas, yaml, msgpack, sklearn, scipy). The kernel wrappers
take their plain versions on CPU tensors; tests marked `cuda` hold the
kernels against them where a card is present (this file imports no JAX,
so they run on the GPU machine, which has none)."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dpcr_agb_tpu", "pandas",
             "yaml", "msgpack", "sklearn", "scipy"}


def _sources():
    files = sorted((ROOT / "dpcr_agb_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_data_and_trainer_layers_are_scanned():
    """The modules of the dataset, the loader, the config reader and the
    trainer, and the loader of the KD-tree library, are among the sources
    the import rules read."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for rel in ("config/yaml.py", "config/engine.py", "data/table.py",
                "data/labels.py", "data/stats.py", "data/dataset.py",
                "data/loader.py", "metrics/meters.py",
                "metrics/base_tracker.py", "metrics/instance_tracker.py",
                "visualization/gpkg.py", "visualization/visualizer.py",
                "transforms/filters.py", "training/trainer.py", "eval.py",
                "calibrate_bn.py", "cli.py", "native.py"):
        assert f"dpcr_agb_tpu_torch/{rel}" in scanned, rel
    assert "kdtree.cpp" in (ROOT / "dpcr_agb_tpu_torch" / "native.py"
                            ).read_text()


def test_the_parallel_and_query_modules_are_scanned():
    """The data-parallel package and the label-query evaluator are among
    the sources the import rules read, and neither imports JAX or the
    JAX package (they import torch, numpy and the standard library)."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "data/query.py",
                "data/loader.py", "device.py"):
        assert f"dpcr_agb_tpu_torch/{rel}" in scanned, rel
        roots = set(_imported_roots(ROOT / "dpcr_agb_tpu_torch" / rel))
        assert roots <= {"__future__", "ast", "io", "re", "tokenize", "os",
                         "typing", "numpy", "torch", "dataclasses",
                         "queue", "threading", "collections",
                         "concurrent"}, (rel, roots)


def test_the_host_pyramid_layers_are_scanned():
    """KPConv's host pyramid, the neighbour-limit calibration and the
    loader of the point-ops library are among the sources the import rules
    read."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for rel in ("ops/host_pyramid.py", "utils/__init__.py",
                "utils/neighbor_calibration.py", "models/factory.py",
                "native.py"):
        assert f"dpcr_agb_tpu_torch/{rel}" in scanned, rel
    native = (ROOT / "dpcr_agb_tpu_torch" / "native.py").read_text()
    assert '"pointops.cpp"' in native
    assert (ROOT / "dpcr_agb_tpu_torch" / "native" / "pointops.cpp"
            ).exists()


def test_the_treeadd_and_map_mode_layers_are_scanned():
    """The object adder, the treeDB generator, map mode's voxel ops, host
    pyramid and model are among the sources the import rules read, and the
    point-ops library carries map mode's key half."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for rel in ("transforms/objects.py", "data/synthetic.py",
                "ops/voxel.py", "ops/host_pyramid.py", "models/minkowski.py",
                "models/factory.py", "native.py"):
        assert f"dpcr_agb_tpu_torch/{rel}" in scanned, rel
    src = (ROOT / "dpcr_agb_tpu_torch" / "native" / "pointops.cpp"
           ).read_text()
    for fn in ("build_sorted_keys", "key_kernel_map", "downsample_coords"):
        assert f"{fn}(" in src, fn


def test_importing_the_port_loads_no_jax():
    code = ("import sys, dpcr_agb_tpu_torch.predict, dpcr_agb_tpu_torch."
            "kernels, dpcr_agb_tpu_torch.weights, dpcr_agb_tpu_torch.train, "
            "dpcr_agb_tpu_torch.models.kpconv, dpcr_agb_tpu_torch.ops."
            "neighbors, dpcr_agb_tpu_torch.ops.kernel_points, "
            "dpcr_agb_tpu_torch.ops.dense_stem, dpcr_agb_tpu_torch.ops."
            "pool, dpcr_agb_tpu_torch.models.minkowski, "
            "dpcr_agb_tpu_torch.models.pointnet, "
            "dpcr_agb_tpu_torch.models.simplestnet, "
            "dpcr_agb_tpu_torch.native, dpcr_agb_tpu_torch.data.las_io, "
            "dpcr_agb_tpu_torch.training.msgpack, "
            "dpcr_agb_tpu_torch.training.state, "
            "dpcr_agb_tpu_torch.transforms.inference, "
            "dpcr_agb_tpu_torch.eval, dpcr_agb_tpu_torch.calibrate_bn, "
            "dpcr_agb_tpu_torch.training.trainer, "
            "dpcr_agb_tpu_torch.data.loader, dpcr_agb_tpu_torch.config, "
            "dpcr_agb_tpu_torch.ops.host_pyramid, "
            "dpcr_agb_tpu_torch.ops.voxel, "
            "dpcr_agb_tpu_torch.transforms.objects, "
            "dpcr_agb_tpu_torch.data.synthetic, "
            "dpcr_agb_tpu_torch.utils.neighbor_calibration; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r} or m.split('.')[0] == 'triton']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def _pool_inputs(device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 6, 9, 16)).astype(np.float32)
    occ = (rng.random((2, 7, 6, 9, 1)) < 0.3).astype(np.float32)
    return (torch.from_numpy(x * occ).to(device, dtype),
            torch.from_numpy(occ).to(device, dtype))


def test_pool_wrapper_takes_plain_version_on_cpu():
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                             masked_max_pool_plain)
    x, occ = _pool_inputs()
    before = dict(kernels.LAUNCHES)
    got = masked_max_pool(x, occ)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(),
                                  masked_max_pool_plain(x, occ).numpy())


def test_kernel_launchers_refuse_cpu_tensors():
    from dpcr_agb_tpu_torch import kernels
    x, occ = _pool_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool_k3s2(x, occ)


def _vol_bwd_inputs(device="cpu", dtype=torch.float32, shape=(2, 7, 6, 9),
                    c=16, seed=0):
    """x under a 30% occupancy, its pooled y, and a cotangent masked by the
    pooled occupancy; values rounded to `dtype`, so bf16 holds ties."""
    from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool
    from dpcr_agb_tpu_torch.ops.pool import masked_max_pool_plain
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, c)).astype(np.float32)
    occ = (rng.random((*shape, 1)) < 0.3).astype(np.float32)
    x = torch.from_numpy(x * occ).to(device, dtype)
    occ = torch.from_numpy(occ).to(device, dtype)
    y = masked_max_pool_plain(x, occ)
    ct = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
        np.float32)).to(device, dtype) * occupancy_pool(occ)
    return x, occ, y, ct


def test_new_wrappers_take_plain_versions_on_cpu_and_refuse_cpu_launches():
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import dense_stem, pool
    x, occ, y, ct = _vol_bwd_inputs()
    strided = x.permute(0, 4, 1, 2, 3)
    before = dict(kernels.LAUNCHES)
    copied = dense_stem.firewall_copy(strided)
    dx = pool.masked_max_pool_bwd_vol(x, occ, y, ct)
    assert kernels.LAUNCHES == before
    assert copied.is_contiguous() and torch.equal(copied, strided)
    assert torch.equal(dx, pool.masked_max_pool_bwd_vol_plain(x, occ, y, ct))
    assert dx.shape == x.shape and not dx[(occ == 0).expand_as(dx)].any()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.firewall_copy(strided)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool_k3s2_bwd_vol(x, occ, y, ct)
    assert set(kernels.LAUNCHES) >= {"firewall_copy", "max_pool_k3s2_bwd_vol"}


def test_two_entries_of_one_source_share_a_library(monkeypatch):
    from dpcr_agb_tpu_torch.kernels import build
    monkeypatch.setattr(build, "nvcc_version", lambda: "nvcc 12.8")
    assert build.library_path("max_pool_bwd") \
        == build.library_path("max_pool_bwd_vol")
    assert build.library_path("firewall_copy") \
        != build.library_path("max_pool_bwd")
    assert len({build.library_path(n) for n in build.LIBRARIES}) \
        == len({src for src, _, _ in build.LIBRARIES.values()}) == 8


@pytest.mark.parametrize("runtime,torch_cuda,ok", [
    (12080, "12.8", True), (12040, "12.6", True), (13000, "12.8", False),
    (12080, "13.0", False), (-35, "12.8", False)])
def test_kernel_library_must_share_pytorchs_cuda_major(runtime, torch_cuda,
                                                       ok):
    from dpcr_agb_tpu_torch.kernels import build

    class Lib:
        @staticmethod
        def dpcr_cuda_runtime_version():
            return runtime

    if ok:
        build._check_runtime(Lib(), "stem_sites", torch_cuda)
    else:
        with pytest.raises(RuntimeError, match="CUDA runtime"):
            build._check_runtime(Lib(), "stem_sites", torch_cuda)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels "
                    "at the main path's shapes")
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                             masked_max_pool_plain)
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites,
                                                    stem_conv_sites_plain)
    for dtype in (torch.float32, torch.bfloat16):
        x, occ = _pool_inputs("cuda", dtype)
        torch.testing.assert_close(masked_max_pool(x, occ),
                                   masked_max_pool_plain(x, occ),
                                   rtol=0, atol=0)
    rng = np.random.default_rng(1)
    coords = torch.from_numpy(rng.integers(0, 9, (2, 40, 3)).astype(
        np.int32)).cuda()
    mask = torch.from_numpy(rng.random((2, 40)) < 0.8).cuda()
    feats = torch.from_numpy(rng.normal(size=(2, 40, 3)).astype(
        np.float32)).cuda()
    wts = torch.from_numpy((rng.normal(size=(343, 3, 64)) * 0.1).astype(
        np.float32)).cuda()
    vol, _ = scatter_to_dense(coords, mask, feats, (9, 9, 9))
    torch.testing.assert_close(stem_conv_sites(vol, coords, mask, wts),
                               stem_conv_sites_plain(vol, coords, mask, wts),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_backward_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels "
                    "at the main path's shapes")
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool_bwd_rows,
                                             masked_max_pool_bwd_rows_plain,
                                             pooled_rows)
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites_dw,
                                                    stem_conv_sites_dw_plain)
    rng = np.random.default_rng(2)
    dims = (9, 8, 7)
    flat = np.stack([rng.choice(9 * 8 * 7, 40, replace=False)
                     for _ in range(2)])
    coords = torch.from_numpy(np.stack(
        [flat // 56, flat // 7 % 8, flat % 7], -1).astype(np.int32)).cuda()
    mask = torch.from_numpy(rng.random((2, 40)) < 0.8).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.from_numpy(rng.normal(size=(2, 40, 16)).astype(
            np.float32)).cuda().to(dtype)
        y, occ_l = pooled_rows(coords, mask, h, dims)
        ct = torch.randn(y.shape, device="cuda").to(dtype)
        torch.testing.assert_close(
            masked_max_pool_bwd_rows(coords, mask, h, y, occ_l, ct, dims),
            masked_max_pool_bwd_rows_plain(coords, mask, h, y, occ_l, ct,
                                           dims), rtol=0, atol=0)
        feats = torch.randn((2, 40, 3), device="cuda").to(dtype)
        vol, _ = scatter_to_dense(coords, mask, feats, dims)
        ct = torch.randn((2, 40, 64), device="cuda").to(dtype)
        want = stem_conv_sites_dw_plain(vol, coords, mask, ct)
        torch.testing.assert_close(stem_conv_sites_dw(vol, coords, mask, ct),
                                   want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


def _kpconv_case(rng, b, nq, ns, k, n_kp, c, cout, device="cpu",
                 shadow_rows=0.0):
    """Random clouds in the unit cube with neighbour lists that hold
    shadows (index ns), one query row of shadows only if there are two or
    more (and with
    `shadow_rows`, that share of all rows), and kernel points within the
    extent."""
    q = rng.uniform(0, 1, (b, nq, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (b, ns, 3)).astype(np.float32)
    nbr = rng.integers(0, ns + 1, (b, nq, k)).astype(np.int32)
    nbr[:, :, -1] = ns
    if nq > 1:
        nbr[:, nq // 2] = ns
    if shadow_rows:
        nbr[rng.random((b, nq)) < shadow_rows] = ns
    x = rng.standard_normal((b, ns, c)).astype(np.float32)
    kp = (rng.uniform(-1, 1, (n_kp, 3)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((n_kp, c, cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal((b, nq, cout)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, s, nbr, x, kp, w, g)]


def test_kpconv_wrappers_take_plain_versions_on_cpu():
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import kpconv
    q, s, nbr, x, kp, w, g = _kpconv_case(np.random.default_rng(0), 2, 9, 8,
                                          4, 5, 6, 7)
    rel = kpconv.shared_rel(q, s, nbr)
    before = dict(kernels.LAUNCHES)
    got = kpconv.kpconv_forward(x, nbr, rel, w, kp, 0.4)
    dx, dw = kpconv.kpconv_backward(x, nbr, rel, w, kp, g, 0.4)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), kpconv.kpconv_fused_plain(x, nbr, rel, w, kp, 0.4))
    assert dx.shape == x.shape and dw.shape == w.shape
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kpconv_fused(x, nbr, rel, w, kp, 0.4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kpconv_fused_bwd(x, nbr, rel, w, kp, g, 0.4)


# (B, Nq, Ns, K, Kp, C, Cout): the JAX tests' sizes, odd sizes, the first
# layer (3 -> 32), every Cout with its own thread mapping, more than one
# chunk of kernel points (17) and of channels (70), and the widest level
KPCONV_CARD_CASES = [
    (2, 24, 20, 7, 5, 6, 8), (1, 13, 9, 3, 4, 5, 3),
    (2, 50, 40, 40, 15, 3, 32), (2, 37, 64, 40, 15, 16, 16),
    (1, 33, 30, 20, 15, 64, 64),
    (1, 20, 25, 9, 17, 70, 24), (1, 17, 20, 5, 15, 32, 128),
    (1, 18, 30, 40, 15, 256, 256)]
# the backward's tiles of 64 rows: 90% of the rows all shadow (whole tiles
# skipped, real neighbours interleaved with shadows in the rest, rows not a
# multiple of 64) at level 0's widths, at the first layer's and at the
# widest; one row (with its real neighbours)
KPCONV_SPARSE_CARD_CASES = [
    (3, 150, 120, 40, 15, 16, 16), (2, 140, 130, 40, 15, 3, 32),
    (2, 90, 70, 40, 15, 256, 256), (1, 1, 5, 40, 15, 16, 16),
    (1, 1, 5, 40, 15, 3, 32)]


@pytest.mark.cuda
def test_kpconv_kernels_match_plain_versions_on_the_card():
    """f32: sums in another order, and dx and dW through f32 atomics: rtol
    1e-4 with atol 1e-4 of max|plain|. bf16: kernel and plain version round
    at the same places, but a sum taken in another order can land on the
    other side of a bf16 rounding (2^-8 of one term): atol 1e-2 of
    max|plain|. A query row of shadows only gives exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels "
                    "at the main path's shapes")
    from dpcr_agb_tpu_torch.ops import kpconv
    rng = np.random.default_rng(3)
    for case, shadow_rows in [(c, 0.0) for c in KPCONV_CARD_CASES] \
            + [(c, 0.9 * (c[1] > 1)) for c in KPCONV_SPARSE_CARD_CASES]:
        q, s, nbr, x, kp, w, g = _kpconv_case(rng, *case, device="cuda",
                                              shadow_rows=shadow_rows)
        rel = kpconv.shared_rel(q, s, nbr)
        modes = [(i, a) for i in kpconv.INFLUENCES
                 for a in kpconv.AGGREGATIONS] if case[5] <= 16 \
            else [("linear", "sum")]
        for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-4),
                                  (torch.bfloat16, 0.0, 1e-2)):
            xc = x.to(dtype)
            for influence, aggregation in modes:
                args = (xc, nbr, rel, w, kp)
                tail = (0.4, influence, aggregation)
                want = kpconv.kpconv_fused_plain(*args, *tail)
                got = kpconv.kpconv_forward(*args, *tail)
                what = f"{case} {dtype} {influence} {aggregation}"
                torch.testing.assert_close(
                    got, want, rtol=rtol, msg=lambda m: f"{what}: {m}",
                    atol=atol * want.abs().max().item())
                assert case[1] == 1 or not got[:, case[1] // 2].any(), what
                dx_w, dw_w = kpconv.kpconv_fused_bwd_plain(*args, g, *tail)
                dx, dw = kpconv.kpconv_backward(*args, g, *tail)
                torch.testing.assert_close(
                    dx, dx_w, rtol=rtol, msg=lambda m: f"dx {what}: {m}",
                    atol=atol * dx_w.abs().max().item())
                torch.testing.assert_close(
                    dw, dw_w, rtol=rtol, msg=lambda m: f"dW {what}: {m}",
                    atol=atol * dw_w.abs().max().item())
                # dW is summed in a fixed order: two runs, the same bits
                assert torch.equal(kpconv.kpconv_backward(*args, g, *tail)[1],
                                   dw), what


@pytest.mark.cuda
def test_firewall_and_volume_backward_kernels_on_the_card():
    """Both kernels of the dense level 0 against their plain versions,
    exactly: odd shapes, strided and misaligned sources, sizes with and
    without a 16-byte tail, both dtypes; the manual pool's 27-tap form
    within one rounding of the f32 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels "
                    "at the main path's shapes")
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import dense_stem, pool
    from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 7, 6, 9, 16), (3, 5, 7), (4099,), (2, 3, 4, 5, 3),
                      (1, 1, 1, 1, 1), (2, 0, 3)):
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            views = [x, x.flatten()[1:], x[..., ::2] if x.numel() else x]
            if x.dim() > 1:
                views += [x.transpose(0, -1),
                          x.permute(*range(1, x.dim()), 0),
                          x[:1].expand(3, *shape[1:])]
            for v in views:
                before = kernels.LAUNCHES["firewall_copy"]
                got = dense_stem.firewall_copy(v)
                assert kernels.LAUNCHES["firewall_copy"] - before \
                    == int(v.numel() > 0)
                assert got.is_contiguous() and got.shape == v.shape
                assert got.numel() == 0 or got.data_ptr() != v.data_ptr()
                assert torch.equal(got, dense_stem.firewall_copy_plain(v))
        # NCDHW buffers behind NDHWC views (the transpose kernel), sizes
        # ragged against its tiles (3 x 320 at C 3, 32 x 32 at C 64 and
        # C 33), also from a base one element past an aligned one
        for c, dhw in ((3, (5, 7, 11)), (64, (3, 5, 7)), (33, (2, 3, 5))):
            n = 2 * c * int(np.prod(dhw))
            flat = torch.randn(n + 1, generator=g, device="cuda").to(dtype)
            for base in (flat[:n], flat[1:]):
                v = base.view(2, c, *dhw).permute(0, 2, 3, 4, 1)
                got = dense_stem.firewall_copy(v)
                assert got.is_contiguous() and torch.equal(
                    got, dense_stem.firewall_copy_plain(v)), (c, dtype)
        t = torch.randn((3, 5, 4, 6, 8), generator=g, device="cuda").to(
            dtype).requires_grad_(True)
        ct = torch.randn((3, 8, 5, 4, 6), generator=g, device="cuda").to(
            dtype).permute(0, 2, 3, 4, 1)
        out = dense_stem.layout_firewall(t)
        out.backward(ct)
        assert torch.equal(out, t) and torch.equal(t.grad, ct)
        assert t.grad.is_contiguous()
        for shape, c in (((2, 7, 6, 9), 16), ((1, 12, 10, 9), 8),
                         ((3, 11, 9, 7), 64), ((2, 1, 1, 2), 8)):
            x, occ, y, ctm = _vol_bwd_inputs("cuda", dtype, shape, c, seed=1)
            got = pool.masked_max_pool_bwd_vol(x, occ, y, ctm)
            torch.testing.assert_close(
                got, pool.masked_max_pool_bwd_vol_plain(x, occ, y, ctm),
                rtol=0, atol=0)
            manual = pool.manual_max_pool_bwd_plain(
                x, occ, occupancy_pool(occ), y, ctm)
            torch.testing.assert_close(
                got, manual, rtol=1e-6 if dtype == torch.float32 else 1e-2,
                atol=1e-6)
            # through the autograd functions: the kernels both ways
            xr = x.clone().requires_grad_(True)
            before = dict(kernels.LAUNCHES)
            pool.pallas_max_pool(xr, occ, occupancy_pool(occ)).backward(ctm)
            assert kernels.LAUNCHES["max_pool_k3s2"] \
                == before["max_pool_k3s2"] + 1
            assert kernels.LAUNCHES["max_pool_k3s2_bwd_vol"] \
                == before["max_pool_k3s2_bwd_vol"] + 1
            torch.testing.assert_close(xr.grad, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dtype"):
        kernels.firewall_copy(torch.zeros(4, device="cuda",
                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="dimensions"):
        kernels.firewall_copy(torch.zeros((1,) * 6, device="cuda"))
