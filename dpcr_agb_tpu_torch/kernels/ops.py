"""The five forward kernels as PyTorch custom ops (`torch.ops.dpcr_port`),
so that a `torch.export` program holds each as one node and launches the
hand-written kernel when it runs on the card.

Each op picks its implementation by the device of its inputs, through the
dispatcher (no Python `is_cuda` test, which a trace would freeze): the CUDA
kernel is the launcher in `kernels/__init__.py` (it counts `LAUNCHES` and
raises for what it cannot take), the CPU kernel the plain PyTorch version
in `dpcr_agb_tpu_torch.ops`, and the fake kernel gives the output's shape,
dtype and layout (contiguous, as both others allocate it) for tracing. No
output aliases an input. The backward kernels stay ctypes-bound inside the
autograd functions' backwards: an exported program is inference only.

Importing this module registers the ops. It imports torch and the
launchers only; the plain versions are imported when a CPU kernel first
runs."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from .. import kernels as _launch

NAMESPACE = "dpcr_port"
OPS = ("stem_sites", "max_pool_k3s2_rows", "max_pool_k3s2", "firewall_copy",
       "fps")


def _half_up(n: int) -> int:
    return -(-n // 2)


@custom_op(f"{NAMESPACE}::stem_sites", mutates_args=(), device_types="cuda")
def stem_sites(vol: Tensor, coords: Tensor, mask: Tensor, weights: Tensor,
               bias: Optional[Tensor] = None) -> Tensor:
    """k=7 stem conv at the sites: vol [B,D,H,W,Cin], coords [B,V,3]
    int32, mask [B,V] bool, weights [343,Cin,Cout], bias [Cout] ->
    [B,V,Cout] in vol's dtype."""
    return _launch.stem_sites(vol, coords, mask, weights, bias)


@stem_sites.register_kernel("cpu")
def _stem_sites_cpu(vol, coords, mask, weights, bias=None):
    from ..ops.sparse_stem import stem_conv_sites_plain
    return stem_conv_sites_plain(vol, coords, mask, weights, bias)


@stem_sites.register_fake
def _stem_sites_fake(vol, coords, mask, weights, bias=None):
    return vol.new_empty((*coords.shape[:2], weights.shape[-1]))


@custom_op(f"{NAMESPACE}::max_pool_k3s2_rows", mutates_args=(),
           device_types="cuda")
def max_pool_k3s2_rows(coords: Tensor, mask: Tensor, h_rows: Tensor,
                       dims: List[int]) -> Tuple[Tensor, Tensor]:
    """Rows [B,V,C] in the volume of `dims` -> (pooled [B,d1,h1,w1,C], its
    occupancy [B,d1,h1,w1,1]), both in h_rows' dtype."""
    return _launch.max_pool_k3s2_rows(coords, mask, h_rows, dims)


@max_pool_k3s2_rows.register_kernel("cpu")
def _max_pool_k3s2_rows_cpu(coords, mask, h_rows, dims):
    from ..ops.pool import masked_max_pool_rows_plain
    return masked_max_pool_rows_plain(coords, mask, h_rows, dims)


@max_pool_k3s2_rows.register_fake
def _max_pool_k3s2_rows_fake(coords, mask, h_rows, dims):
    l1 = (h_rows.shape[0], *(_half_up(int(n)) for n in dims))
    return (h_rows.new_empty((*l1, h_rows.shape[-1])),
            h_rows.new_empty((*l1, 1)))


@custom_op(f"{NAMESPACE}::max_pool_k3s2", mutates_args=(),
           device_types="cuda")
def max_pool_k3s2(x: Tensor, occ: Tensor) -> Tensor:
    """x [B,D,H,W,C], occupancy occ [B,D,H,W,1] of x's dtype ->
    [B,ceil(D/2),ceil(H/2),ceil(W/2),C]."""
    return _launch.max_pool_k3s2(x, occ)


@max_pool_k3s2.register_kernel("cpu")
def _max_pool_k3s2_cpu(x, occ):
    from ..ops.pool import masked_max_pool_plain
    return masked_max_pool_plain(x, occ)


@max_pool_k3s2.register_fake
def _max_pool_k3s2_fake(x, occ):
    b, d, h, w, c = x.shape
    return x.new_empty((b, _half_up(d), _half_up(h), _half_up(w), c))


@custom_op(f"{NAMESPACE}::firewall_copy", mutates_args=(),
           device_types="cuda")
def firewall_copy(x: Tensor) -> Tensor:
    """A fresh contiguous tensor with x's values, whatever x's strides."""
    return _launch.firewall_copy(x)


@firewall_copy.register_kernel("cpu")
def _firewall_copy_cpu(x):
    from ..ops.dense_stem import firewall_copy_plain
    return firewall_copy_plain(x)


@firewall_copy.register_fake
def _firewall_copy_fake(x):
    return x.new_empty(x.shape)


@custom_op(f"{NAMESPACE}::fps", mutates_args=(), device_types="cuda")
def fps(pos: Tensor, mask: Tensor, n_samples: int, start: int = 0
        ) -> Tensor:
    """Farthest point sampling: pos [B,N,3] f32, mask [B,N] bool ->
    [B,n_samples] int64 indices."""
    return _launch.fps(pos, mask, n_samples, start)


@fps.register_kernel("cpu")
def _fps_cpu(pos, mask, n_samples, start=0):
    from ..ops.neighbors import fps_plain
    return fps_plain(pos, mask, n_samples, start)


@fps.register_fake
def _fps_fake(pos, mask, n_samples, start=0):
    return pos.new_empty((pos.shape[0], n_samples), dtype=torch.int64)
