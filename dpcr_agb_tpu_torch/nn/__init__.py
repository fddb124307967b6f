from .blocks import (ACTIVATIONS, DropPath, Dropout, SELayer, SeparateLinear,
                     TorchLinear)
from .norm import MaskedBatchNorm

__all__ = ["ACTIVATIONS", "DropPath", "Dropout", "SELayer", "SeparateLinear",
           "TorchLinear", "MaskedBatchNorm"]
