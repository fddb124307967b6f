"""Device selection and the float32 precision of the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def numerics() -> dict:
    """The process's float32 settings that change what a card computes:
    TF32 in cuDNN's convolutions and in matmuls, cuDNN's choice of
    deterministic algorithms."""
    return {"cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_deterministic": bool(torch.backends.cudnn.deterministic)}


def pin_numerics() -> dict:
    """Full float32 on the card: TF32 off in cuDNN (PyTorch's default has
    it on for convolutions) and in matmuls, as the JAX reference computes
    on the CPU and as every tolerance of the port was taken. Returns
    `numerics()`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return numerics()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """CUDA by default; the CPU only when the caller names it. Pins the
    float32 precision (`pin_numerics`) either way.

    Raises when no CUDA device is present and the CPU was not asked for, so
    an entry point never carries on quietly on the CPU. Under a process
    group (`parallel.maybe_init_distributed`) the default is the process's
    own card, `cuda:{LOCAL_RANK}`; it raises when LOCAL_RANK names no card
    of this host."""
    import torch.distributed as dist
    pin_numerics()
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=cpu to run on the CPU")
    if device is None and dist.is_available() and dist.is_initialized():
        from .parallel import local_rank
        lr = local_rank()
        if lr >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {lr} names no card: this host has "
                f"{torch.cuda.device_count()}; start at most that many "
                "ranks a host, or name the device")
        return torch.device(f"cuda:{lr}")
    return torch.device(device if device is not None else "cuda")
