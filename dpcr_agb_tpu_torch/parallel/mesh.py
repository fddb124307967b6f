"""Data parallelism over processes, one card a process (counterpart of
`dpcr_agb_tpu/parallel/mesh.py`).

The JAX trainer runs one jitted program over a `data` mesh: the batch is
sharded, the parameters replicated, and every reduction over the batch is
global because GSPMD computes the whole-batch program (the masked BN
moments, the loss's target count, the gradient). Here each process runs
the step on its own contiguous slice of the global batch and the
reductions meet in explicit collectives:
  * `all_reduce_sum`: a differentiable SUM (its backward all-reduces the
    cotangent), for the BN moments and the loss's denominator;
  * `all_reduce_grads`: one SUM over every gradient in a fixed order, so
    the sum of the per-rank gradients is the global loss's gradient; a
    parameter that the step uses in bf16 hands the SUM its f32 partial
    and is rounded to bf16 once after it (`round_after_sum`,
    `parallel/rounding.py`), as one process rounds the global batch's
    sum once;
  * `all_gather_rows`: the step outputs' rows of every rank in rank order,
    so each rank's tracker sees the global rows;
  * `broadcast_state`: rank 0's parameters and buffers at start-up.
Every collective runs whenever a process group is initialized, world size
1 included; with no group each is the identity.

`maybe_init_distributed` starts the group from the variables `torchrun`
sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) when
DPCR_MULTIHOST=1: NCCL for CUDA devices, gloo for the CPU.
DPCR_DIST_BACKEND=gloo forces gloo on CUDA devices. NCCL refuses two ranks
on one device (its communicator init fails with a duplicate-GPU error), so
several ranks on one card run over gloo. Both backends take the card's
tensors as they are: gloo's CUDA collectives copy through the host
themselves, NCCL's run on the card."""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

# per-sample leaves that are shape tags, replicated on every rank
_TAG_KEYS = frozenset({"zcells"})


def maybe_init_distributed(device=None) -> bool:
    """Start the process group when DPCR_MULTIHOST=1 and none is running;
    returns whether this call started it (the caller then ends it with
    `destroy`). `device` is the entry point's device argument: the CPU
    takes gloo, anything else NCCL unless DPCR_DIST_BACKEND names the
    backend. A failed start raises."""
    if dist.is_initialized() or os.environ.get("DPCR_MULTIHOST",
                                               "0") != "1":
        return False
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"DPCR_MULTIHOST=1 without {missing}: launch "
                           "with torchrun (python -m torch.distributed.run)")
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = os.environ.get("DPCR_DIST_BACKEND") or (
        "gloo" if cpu else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"DPCR_DIST_BACKEND={backend!r}: nccl or gloo")
    if backend == "nccl" and cpu:
        raise ValueError("NCCL runs on CUDA devices only; the CPU takes gloo")
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def destroy() -> None:
    """End the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's card index on its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """SUM over ranks in place."""
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.detach().clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The SUM of `t` over ranks, differentiable: the backward all-reduces
    the cotangent, so a rank's gradient carries every rank's use of the
    sum. The identity without a group."""
    if not dist.is_initialized():
        return t
    return _AllReduceSum.apply(t)


def all_gather_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
    order; None stays None. Bool tensors travel as uint8."""
    if t is None or not dist.is_initialized():
        return t
    t = t.detach()
    is_bool = t.dtype == torch.bool
    send = (t.to(torch.uint8) if is_bool else t).contiguous()
    parts = [torch.empty_like(send) for _ in range(world_size())]
    dist.all_gather(parts, send)
    out = torch.cat(parts)
    return out.bool() if is_bool else out


# the attribute that marks a parameter whose gradient is an f32 partial of
# a sum that one process rounds once to the dtype it holds
_ROUND_ATTR = "_dpcr_round_grad_to"


def round_after_sum(dtype: torch.dtype, *params) -> None:
    """Mark each parameter given (None skipped): this step hands the
    gradient SUM the f32 partial of a sum that one process rounds to
    `dtype`, so `all_reduce_grads` rounds it to `dtype` (and back to f32)
    once after the SUM."""
    for p in params:
        if p is not None:
            setattr(p, _ROUND_ATTR, dtype)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its SUM over ranks: the gradients, in the
    order given, flattened into one buffer a dtype and reduced in one
    collective each, so the same run gives the same bits; then each
    parameter marked by `round_after_sum` rounded to its dtype once.
    Parameters without a gradient are left out (the same ones on every
    rank)."""
    if not dist.is_initialized():
        return
    params = list(params)
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        _all_reduce_(flat)
        i = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[i:i + n].view_as(p.grad))
            i += n
    for p in params:
        dtype = getattr(p, _ROUND_ATTR, None)
        if dtype is not None and p.grad is not None:
            p.grad.copy_(p.grad.to(dtype))


def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def shard_batch(batch, rank_: int, world: int):
    """This rank's contiguous slice of a global host or device `Batch`:
    every per-sample array (first dim the batch size, aux included) cut to
    rows [rank * local, (rank + 1) * local); shape tags (aux 'zcells') and
    arrays without the batch axis stay whole, as the JAX mesh's
    `batch_sharding` places them."""
    import dataclasses
    bs = batch.batch_size
    if bs % world:
        raise ValueError(f"batch_size {bs} must divide by the world size "
                         f"{world}")
    lo, hi = rank_ * (bs // world), (rank_ + 1) * (bs // world)

    def cut(v, tag=False):
        if v is None or tag:
            return v
        if isinstance(v, dict):
            return {k: cut(a, k in _TAG_KEYS) for k, a in v.items()}
        if np.ndim(v) >= 1 and v.shape[0] == bs:
            return v[lo:hi]
        return v
    return dataclasses.replace(batch, **{
        f.name: cut(getattr(batch, f.name))
        for f in dataclasses.fields(batch) if f.name != "ready"})
