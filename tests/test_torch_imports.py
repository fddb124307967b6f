"""Import rules of the port: no module of dpcr_agb_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax, the JAX package dpcr_agb_tpu, or a
package the GPU machine lacks (pandas, yaml, msgpack). The kernel wrappers
take their plain versions on CPU tensors; a test marked `cuda` holds the
kernels against them where a card is present."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dpcr_agb_tpu", "pandas",
             "yaml", "msgpack"}


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


def test_importing_the_port_loads_no_jax():
    code = ("import sys, dpcr_agb_tpu_torch.predict, dpcr_agb_tpu_torch."
            "kernels, dpcr_agb_tpu_torch.weights; "
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
