"""Builds the port's CUDA kernels and binds them with ctypes.

Each `csrc/*.cu` file has plain C entry points (one, or two that share
their routing code) and is compiled by `nvcc` for `sm_90a` into its own
shared library under `build/torch_ext/` at the repository root (listed in
.gitignore). All missing libraries are compiled
at once, one `nvcc` process per source. A library's file name carries a
hash of its sources, flags and `nvcc --version`, so an edited source or
another toolkit rebuilds it and an unchanged one is reused. Nothing is compiled at import time: the first
kernel call (or an explicit `build()`) does it.

Binding through ctypes instead of `torch.utils.cpp_extension.load` keeps
PyTorch's headers out of the compile: a source with a plain C interface
builds in seconds, one that includes `torch/extension.h` in minutes."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
              "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# entry -> (source, C entry point, argtypes); entries of one source share
# its library
LIBRARIES = {
    "stem_sites": ("stem_sites.cu", "stem_sites_launch",
                   [_I, *[_P] * 7, *[_I] * 9, _P]),
    "max_pool": ("max_pool.cu", "max_pool_k3s2_launch",
                 [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "max_pool_rows": ("max_pool.cu", "max_pool_k3s2_rows_launch",
                      [_I, *[_P] * 7, *[_I] * 7, _P]),
    "max_pool_bwd": ("max_pool_bwd.cu", "max_pool_k3s2_bwd_launch",
                     [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P]),
    "stem_dw": ("stem_dw.cu", "stem_sites_dw_launch",
                [_I, *[_P] * 6, *[_I] * 7, _P]),
    "kpconv_fwd": ("kpconv_fwd.cu", "kpconv_fused_launch",
                   [_I, *[_P] * 9, *[_I] * 7, _F, *[_I] * 4, _P]),
    "kpconv_bwd": ("kpconv_bwd.cu", "kpconv_fused_bwd_launch",
                   [_I, *[_P] * 14, *[_I] * 7, _F, *[_I] * 4, _P]),
    "gather_rows_bwd": ("kpconv_bwd.cu", "gather_rows_bwd_launch",
                        [_I, *[_P] * 4, _I, _I, _I, _P]),
    "max_pool_bwd_vol": ("max_pool_bwd.cu", "max_pool_k3s2_bwd_vol_launch",
                         [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "firewall_copy": ("firewall_copy.cu", "firewall_copy_launch",
                      [_I, _P, _P, *[_L] * 10, _P]),
    "fps": ("fps.cu", "fps_launch", [*[_P] * 4, *[_I] * 7, _P]),
    "fps_occupancy": ("fps.cu", "fps_max_active_clusters", [_I, _I, _I]),
}

_ENTRY: Dict[str, object] = {}


@lru_cache(maxsize=None)
def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


@lru_cache(maxsize=None)
def nvcc_version() -> str:
    return subprocess.run([nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout


def library_path(name: str) -> Path:
    source = LIBRARIES[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every library that is not built yet, all in parallel.
    Returns {entry: {"seconds", "cached", "log"}}; raises with nvcc's
    output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, report = {}, {}
    paths = {name: library_path(name) for name in LIBRARIES}
    for name, (source, _, _) in LIBRARIES.items():
        path = paths[name]
        if path in procs:
            continue
        if path.exists():
            report[path] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_verbose
                                      else []),
               "-o", str(tmp), str(CSRC / source)]
        procs[path] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, source)
    failed = []
    for path, (proc, tmp, source) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source} (rc {proc.returncode})"
                          f":\n{log}")
            continue
        os.replace(tmp, path)
        report[path] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: report[path] for name, path in paths.items()}


def entry(name: str):
    """The C entry point of library `name`, built and loaded on first use."""
    if name not in _ENTRY:
        import torch
        torch.cuda.init()  # load PyTorch's CUDA runtime before the library
        path = library_path(name)
        if not path.exists():
            build()
        _, symbol, argtypes = LIBRARIES[name]
        lib = ctypes.CDLL(str(path))
        _check_runtime(lib, name, torch.version.cuda)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return _ENTRY[name]


def _check_runtime(lib, name: str, torch_cuda: str) -> None:
    """Raise unless the library's CUDA runtime has PyTorch's major version:
    with another major, the process would hold two runtimes."""
    got = lib.dpcr_cuda_runtime_version()
    if got <= 0:
        raise RuntimeError(f"{name}: the library's CUDA runtime does not "
                           f"start (CUDA error {-got})")
    if got // 1000 != int(torch_cuda.split(".")[0]):
        raise RuntimeError(
            f"{name}: the library links CUDA runtime {got // 1000}."
            f"{got % 1000 // 10}, PyTorch was built for CUDA {torch_cuda}; "
            f"point CUDA_HOME at a toolkit of major version "
            f"{torch_cuda.split('.')[0]}")
