"""The masked Minkowski MaxPool (kernel 3, stride 2) forward (counterpart
of `pallas_max_pool`'s forward in `dpcr_agb_tpu/ops/pallas_pool.py` and of
the forward of `pooled_rows_fused` in `dpcr_agb_tpu/ops/sparse_stem.py`).

Output cell u is the max over the inputs {2u-1, 2u, 2u+1}^3 with empty or
out-of-range inputs excluded (-inf), zeroed where the pooled occupancy is 0
(no occupied child in {2u, 2u+1}^3). On CUDA tensors `masked_max_pool`
launches the hand-written `max_pool_k3s2` kernel; on CPU tensors it runs
`masked_max_pool_plain`."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .dense_grid import occupancy_pool, scatter_to_dense


def masked_max_pool_plain(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the `max_pool_k3s2` kernel: fill empty cells
    with -inf, pad by one cell (and to an even extent) with -inf, take the
    max of the 27 stride-2 slices, then zero where occupancy_pool(occ) is
    0, as pallas_max_pool does."""
    b, d, h, w, c = x.shape
    d1, h1, w1 = -(-d // 2), -(-h // 2), -(-w // 2)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    filled = torch.where(occ > 0, x, neg)
    fp = F.pad(filled, (0, 0, 1, 2 * w1 - w, 1, 2 * h1 - h, 1, 2 * d1 - d),
               value=float("-inf"))
    y = None
    for a in range(3):
        for e in range(3):
            for f in range(3):
                s = fp[:, a:a + 2 * d1 - 1:2, e:e + 2 * h1 - 1:2,
                       f:f + 2 * w1 - 1:2]
                y = s if y is None else torch.maximum(y, s)
    return torch.where(occupancy_pool(occ) > 0, y, torch.zeros_like(y))


def masked_max_pool(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """x [B,D,H,W,C], occupancy occ [B,D,H,W,1] of x's dtype ->
    [B,ceil(D/2),ceil(H/2),ceil(W/2),C]. The `max_pool_k3s2` kernel on CUDA
    tensors, the plain version on CPU ones."""
    if x.is_cuda:
        from .. import kernels
        return kernels.max_pool_k3s2(x, occ)
    return masked_max_pool_plain(x, occ)


def pooled_rows(coords: torch.Tensor, mask: torch.Tensor,
                h_rows: torch.Tensor, dims: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stem rows [B,V,C] -> (pooled level-1 volume [B,d1,h1,w1,C], its
    occupancy [B,d1,h1,w1,1]): scatter to the full-resolution volume,
    occupancy_pool, masked_max_pool."""
    hv, occ_v = scatter_to_dense(coords, mask, h_rows, dims)
    return masked_max_pool(hv, occ_v), occupancy_pool(occ_v)
