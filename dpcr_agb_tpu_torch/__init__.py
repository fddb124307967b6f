"""PyTorch/CUDA port of the DPCR-AGB serving path for NVIDIA Hopper.

A second package beside the JAX reference `dpcr_agb_tpu`: it imports torch,
numpy and the standard library only, and keeps its own copies of the host
layers it needs. Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`), as the CPU parity tests do.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
