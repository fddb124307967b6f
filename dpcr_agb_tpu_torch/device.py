"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """CUDA by default; the CPU only when the caller names it.

    Raises when no CUDA device is present and the CPU was not asked for, so
    an entry point never carries on quietly on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=cpu to run on the CPU")
    return torch.device(device if device is not None else "cuda")
