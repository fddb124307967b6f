"""Sparse-voxel ResNet/SENet family (counterpart of
`dpcr_agb_tpu/models/minkowski.py`), on the dense-grid path or in map mode.

Level 0, sparse (the default at first_stride 1): the k=7 stem conv, BN and
activation on the occupied rows only (`stem_sites` kernel), the rows pooled
into the level-1 volume (`max_pool_k3s2` kernel; or one of the other
sparse-pool modes). Level 0, dense (DPCR_L0=dense, or first_stride 2): the
input scattered to the full-resolution volume, the stem conv over it
(cuDNN's 3-D conv, or folded between `firewall_copy` kernels), BN and
activation over the volume, and the volume-form pool (`max_pool_k3s2` and
`max_pool_k3s2_bwd_vol` kernels under DPCR_POOL_BWD=pallas). Then dense
masked k3 convs (`F.conv3d`) through 4 stages of basic or bottleneck
residual blocks with optional squeeze-excite, a masked global pool and a
SeparateLinear head. Submodule and parameter names are the flax ones, the
same for both level-0 forms, and conv kernels keep the JAX layout
[K^3, Cin, Cout] with z-fastest offsets.

The five execution modes are constructor arguments of `SparseResNet`; left
at None, each reads the JAX package's environment variable of the same
meaning when the model is built:
  l0_mode      DPCR_L0           sparse | dense
  stem_mode    DPCR_STEM_MODE    xla3d | zfold_firewall | zfold2d_firewall
  pool_bwd     DPCR_POOL_BWD     xla | manual | separable | pallas
  sparse_pool  DPCR_SPARSE_POOL  fused | scattermax | dense | rows
  pool_fwd     DPCR_POOL_FWD     dense | separable | scattermax (the fused
               sparse pool's forward) and separable | window3d (the manual
               pool's forward); unset: dense and separable

Training runs the same path with train-mode BN and live DropPath, and
rematerializes where the JAX package's `nn.remat` does: every residual
block of the dense-grid path and the dense level 0's stem conv keep only
their inputs for the backward, which runs them again (`remat`:
`torch.utils.checkpoint`, the recompute replaying the forward's DropPath
coins and leaving BN's running stats alone). The full-width nets train the
paper's bs32 on one 80 GB card that way. Eval, calibrate_bn (no gradients)
and export run the blocks directly; map mode and the sparse level 0's stem
are not rematerialized, as in the JAX package.

Map mode (`dense_dims=None`, the JAX package's sparse-voxel formulation,
MinkowskiEngine's way): the voxels stay rows [B, V, C] at every level, a
level's rows are unique(floor(coords / 2)) of the level below up to its
cap (`level_caps`, else DEFAULT_LEVEL_FRACS of the input's padded count),
and each conv gathers its input rows through a kernel map and multiplies
them by the offset's weights (`ops.voxel.sparse_conv_apply`, f32
accumulation), the stem's pool takes the max over 27 gathered rows
(`max_pool_apply`). The levels and maps come from `batch.aux` when the
host built them (`ops/host_pyramid.py`, the entry points' route), else
from the device (`build_levels`, `ops.voxel.kernel_map`). It has no volume,
so no voxel is dropped for lying outside one; it launches none of the
port's kernels. The parameters are the same as the dense path's, so one
state dict (and one JAX `.ckpt`) serves both."""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.blocks import (ACTIVATIONS, DropPath, Dropout, SELayer,
                         SeparateLinear, trunc_normal_)
from ..nn.norm import (MaskedBatchNorm, MaskedInstanceNorm, MaskedLayerNorm,
                       running_stats_frozen)
from ..ops.dense_grid import (POOL_BWD_MODES, STEM_MODES, dense_conv,
                              dense_max_pool, level_dims, occupancy_pool,
                              scatter_to_dense)
from ..ops.masked import GLOBAL_POOL
from ..ops.pool import pooled_rows
from ..ops.sparse_stem import (max_pool_sparse, pool_neighbor_map_batch,
                               scatter_max_pool_batch, stem_conv_rows)
from ..ops.host_pyramid import resnet_pyramid_plan
from ..ops.voxel import (build_grid, downsample, hypercube_offsets,
                         kernel_map, max_pool_apply, sparse_conv_apply)
from ..parallel.rounding import cast_widened, sums_rounded_once

DEFAULT_LEVEL_FRACS = (1.0, 0.75, 0.4, 0.2, 0.1, 0.05, 0.03)


def _remat_contexts(generator: Optional[torch.Generator]):
    """`checkpoint`'s context_fn: the forward's context notes `generator`'s
    state; the recompute's replays it (the same DropPath coins), puts the
    state the backward found back after, and freezes BN's running stats
    (one momentum update a step, as flax's remat drops the recompute's
    mutations)."""
    noted = {}

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            noted["state"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        held = None
        if generator is not None:
            held = generator.get_state()
            generator.set_state(noted["state"])
        try:
            with running_stats_frozen():
                yield
        finally:
            if held is not None:
                generator.set_state(held)
    return forward(), recompute()


def remat(fn, *args, generator: Optional[torch.Generator] = None):
    """fn(*args) rematerialized (the JAX package's `nn.remat`): only its
    inputs are kept for the backward, which runs it again. `generator` is
    the one fn draws DropPath's coins from; no default generator is
    drawn from inside, so theirs are not saved. Under a process group
    every rank's recompute issues BN's collectives in the same order (one
    backward graph on every rank)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_remat_contexts,
                                                   generator))


def build_levels(coords: torch.Tensor, mask: torch.Tensor,
                 caps: Sequence[int]) -> list:
    """The batch's resolution pyramid on the device: level l holds unit
    coords at tensor stride 2^l, at most caps[l] voxels a sample."""
    grids = [build_grid(coords, mask)]
    for cap in caps[1:]:
        grids.append(downsample(grids[-1], None, 2, cap)[0])
    return grids


class SparseConv(nn.Module):
    """Minkowski-style sparse convolution, kernel [K^3, Cin, Cout]; dense
    mode over occupancy volumes or sites mode at occupied rows."""

    def __init__(self, in_channels: int, features: int, kernel_volume: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = round(kernel_volume ** (1.0 / 3.0))
        self.dtype = dtype
        self.kernel = nn.Parameter(trunc_normal_(
            torch.empty(kernel_volume, in_channels, features), 0.02,
            generator))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward_dense(self, x: torch.Tensor, occ: torch.Tensor,
                      stride: int = 1,
                      stem_mode: str = "xla3d") -> torch.Tensor:
        """x [B,D,H,W,Cin], occ = output occupancy [B,D',H',W',1];
        `stem_mode` as in `dense_conv` (it acts on tiny-Cin convs only)."""
        if self.kernel_size == 1 and stride == 1:
            # the reference's f32-accumulating dot: output f32, masked
            # before and after the bias
            y = (x.to(self.dtype).float() @ self._k1_weight()) * occ
            if self.bias is not None:
                y = (y + self.bias.to(y.dtype)) * occ
            return y
        return dense_conv(x, occ, self.kernel, self.kernel_size, stride,
                          self.dtype, self.bias, stem_mode)

    def _k1_weight(self) -> torch.Tensor:
        """The pointwise conv's [Cin, Cout] weight rounded to the compute
        dtype and widened to f32; under a process group its gradient
        stays the f32 partial, rounded once after the SUM."""
        if sums_rounded_once(self.dtype):
            return cast_widened(self.kernel, self.dtype)[0]
        return self.kernel[0].to(self.dtype).float()

    def forward_map(self, x: torch.Tensor,
                    nbr_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Map mode: x [B,V_in,Cin] rows, nbr_idx [B,K,V_out] (None: the
        pointwise conv, K 1 and stride 1, a plain matmul) -> [B,V_out,Cout]
        f32 with the bias added at every row, as the JAX module does."""
        if nbr_idx is None:
            y = x.to(self.dtype).float() @ self._k1_weight()
        else:
            y = sparse_conv_apply(x.to(self.dtype), nbr_idx, self.kernel)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def forward_sites(self, x: torch.Tensor, coords: torch.Tensor,
                      mask: torch.Tensor, dims: Sequence[int]
                      ) -> torch.Tensor:
        """x [B,V,Cin] rows -> [B,V,Cout] at the occupied sites."""
        return stem_conv_rows(coords, mask, x, dims, self.kernel, self.bias,
                              self.dtype)


def make_norm(norm_type: str, features: int, bn_momentum: float):
    """The norm of a `norm_type`: masked BN (with or without its affine),
    layer norm (`ln`) or instance norm (`in`)."""
    if norm_type in ("bn", "bn_no_affine"):
        return MaskedBatchNorm(features, momentum=bn_momentum,
                               affine=norm_type == "bn")
    if norm_type == "ln":
        return MaskedLayerNorm(features)
    if norm_type == "in":
        return MaskedInstanceNorm(features)
    raise NotImplementedError(
        f"norm_type={norm_type!r} (bn, bn_no_affine, in, ln)")


class ResBlock(nn.Module):
    """BasicBlock or Bottleneck (+SE) over one or two resolution levels, in
    dense mode (`forward`) or map mode (`forward_map`).

    Dense mode reproduces the reference's dense-mode masking: each conv
    output is (conv + bias) * occupancy, BN normalizes every cell (empty
    ones too, without re-masking), and only the block output is zeroed
    outside the output occupancy. Map mode, likewise, adds the bias at
    every row and zeroes the block output outside the output mask. A
    bottleneck's first k1 conv and norm work at the input level; its
    output is planes * 4 wide."""

    def __init__(self, in_channels: int, planes: int, bottleneck: bool,
                 se: bool, act_name: str = "gelu", stride: int = 1,
                 drop_path: float = 0.0, use_bias: bool = True,
                 bn_momentum: float = 0.1, norm_type: str = "bn",
                 se_reduction: int = 16, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = ACTIVATIONS[act_name]
        self.stride = stride
        self.se_on = se
        self.bottleneck = bottleneck
        self.out_channels = planes * (4 if bottleneck else 1)
        conv = lambda cin, cout, kv: SparseConv(  # noqa: E731
            cin, cout, kv, use_bias, dtype, generator)
        norm = lambda width: make_norm(  # noqa: E731
            norm_type, width, bn_momentum)
        self.conv1 = conv(in_channels, planes, 1 if bottleneck else 27)
        self.norm1 = norm(planes)
        self.conv2 = conv(planes, planes, 27)
        self.norm2 = norm(planes)
        if bottleneck:
            self.conv3 = conv(planes, self.out_channels, 1)
            self.norm3 = norm(self.out_channels)
        if se:
            self.se = SELayer(self.out_channels, self.act, se_reduction,
                              generator)
        self.need_proj = stride != 1 or in_channels != self.out_channels
        if self.need_proj:
            self.downsample_conv = conv(in_channels, self.out_channels, 1)
            self.downsample_norm = norm(self.out_channels)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, occ_in: torch.Tensor,
                occ_out: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B,D,H,W,Cin]; occ_in/occ_out occupancy volumes [...,1] of the
        input and output level (occ_in is read by bottleneck blocks only);
        `generator` feeds DropPath in training."""
        m_out = occ_out[..., 0] > 0
        if self.bottleneck:
            out = self.conv1.forward_dense(x, occ_in)
            out = self.act(self.norm1(out, occ_in[..., 0] > 0))
            out = self.conv2.forward_dense(out, occ_out, self.stride)
            out = self.act(self.norm2(out, m_out))
            out = self.norm3(self.conv3.forward_dense(out, occ_out), m_out)
        else:
            out = self.conv1.forward_dense(x, occ_out, self.stride)
            out = self.act(self.norm1(out, m_out))
            out = self.conv2.forward_dense(out, occ_out)
            out = self.norm2(out, m_out)
        if self.se_on:
            b, c = out.shape[0], out.shape[-1]
            out = self.se(out.reshape(b, -1, c), m_out.reshape(b, -1)
                          ).reshape(out.shape)
        residual = x
        if self.need_proj:
            residual = self.downsample_conv.forward_dense(x, occ_out,
                                                          self.stride)
            residual = self.downsample_norm(residual, m_out)
        out = self.act(self.drop_path(out, generator) + residual)
        return torch.where(occ_out > 0, out, torch.zeros_like(out))

    def forward_map(self, x: torch.Tensor, in_mask: torch.Tensor,
                    out_mask: torch.Tensor, k3_map: torch.Tensor,
                    k3_out_map: torch.Tensor,
                    k1_map: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """Map mode: x [B,V_in,Cin] rows; k3_map [B,27,V_out] the (strided
        where the block is) map of the first 3^3 conv, k3_out_map the
        stride-1 map of the output level, k1_map [B,1,V_out] the strided
        shortcut's map (None at stride 1)."""
        if self.bottleneck:
            out = self.conv1.forward_map(x)
            out = self.act(self.norm1(out, in_mask))
            out = self.conv2.forward_map(out, k3_map)
            out = self.act(self.norm2(out, out_mask))
            out = self.norm3(self.conv3.forward_map(out), out_mask)
        else:
            out = self.conv1.forward_map(x, k3_map)
            out = self.act(self.norm1(out, out_mask))
            out = self.conv2.forward_map(out, k3_out_map)
            out = self.norm2(out, out_mask)
        if self.se_on:
            out = self.se(out, out_mask)
        residual = x
        if self.need_proj:
            residual = self.downsample_conv.forward_map(
                x, k1_map if self.stride != 1 else None)
            residual = self.downsample_norm(residual, out_mask)
        out = self.act(self.drop_path(out, generator) + residual)
        return torch.where(out_mask[..., None], out, torch.zeros_like(out))


# constructor argument -> (environment variable, default, values)
MODE_VARS = {
    "l0_mode": ("DPCR_L0", "sparse", ("sparse", "dense")),
    "stem_mode": ("DPCR_STEM_MODE", "xla3d", STEM_MODES),
    "pool_bwd": ("DPCR_POOL_BWD", "xla", POOL_BWD_MODES),
    "sparse_pool": ("DPCR_SPARSE_POOL", "fused",
                    ("fused", "scattermax", "dense", "rows")),
    "pool_fwd": ("DPCR_POOL_FWD", "unset",
                 ("unset", "dense", "separable", "scattermax", "window3d")),
}


def resolve_mode(name: str, value: Optional[str]) -> str:
    """`value`, or when it is None the mode's environment variable (read
    now), or its default; an unknown value raises."""
    var, default, allowed = MODE_VARS[name]
    if value is None:
        value = os.environ.get(var, default)
    if value not in allowed:
        raise ValueError(f"{name} ({var}) = {value!r}: one of {allowed}")
    return value


class SparseResNet(nn.Module):
    """ResNetBase on the dense grid, with a sparse or a dense level 0, or
    in map mode (dense_dims None)."""

    def __init__(self, num_reg_targets: int, block: str,
                 layers: Sequence[int], in_channels: int,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 planes: Sequence[int] = (64, 128, 256, 512),
                 init_dim: int = 64, activation: str = "gelu",
                 first_stride: int = 1, global_pool: str = "sum",
                 dropout: float = 0.0, drop_path: float = 0.0,
                 bn_momentum: float = 0.1, norm_type: str = "bn",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 dense_dims: Optional[Tuple[int, int, int]] = (88, 88, 104),
                 level_caps: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 l0_mode: Optional[str] = None,
                 stem_mode: Optional[str] = None,
                 pool_bwd: Optional[str] = None,
                 sparse_pool: Optional[str] = None,
                 pool_fwd: Optional[str] = None):
        super().__init__()
        self.l0_mode = resolve_mode("l0_mode", l0_mode)
        self.stem_mode = resolve_mode("stem_mode", stem_mode)
        self.pool_bwd = resolve_mode("pool_bwd", pool_bwd)
        self.sparse_pool = resolve_mode("sparse_pool", sparse_pool)
        self.pool_fwd = resolve_mode("pool_fwd", pool_fwd)
        self.first_stride = int(first_stride)
        self.dense_dims = None if dense_dims is None \
            else tuple(int(v) for v in dense_dims)
        self.strides = tuple(int(v) for v in strides)
        self.level_caps = None if level_caps is None \
            else [int(v) for v in level_caps]
        self.dtype = dtype
        self.global_pool = global_pool
        self.act = ACTIVATIONS[activation]
        bottleneck = "bottleneck" in block
        se = block.startswith("se")
        self.stem_conv = SparseConv(in_channels, init_dim, 343, use_bias,
                                    dtype, generator)
        self.stem_norm = make_norm(norm_type, init_dim, bn_momentum)
        self.block_names = []
        self.block_strides = []
        self.block_stages = []
        width = init_dim
        for si, (p, n_blocks, stride) in enumerate(zip(planes, layers,
                                                       strides)):
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                name = f"stage{si}_block{bi}"
                blk = ResBlock(
                    width, p, bottleneck, se, activation, s, drop_path,
                    use_bias, bn_momentum, norm_type, dtype=dtype,
                    generator=generator)
                self.add_module(name, blk)
                self.block_names.append(name)
                self.block_strides.append(s)
                self.block_stages.append(si)
                width = blk.out_channels
        self.dropout = Dropout(dropout)
        self.final = SeparateLinear(width, num_reg_targets, generator)

    @property
    def sparse_level0(self) -> bool:
        """Whether level 0 runs on the occupied rows (else on the volume)."""
        return self.l0_mode == "sparse" and self.first_stride == 1

    def level0_dims(self, batch) -> Tuple[int, int, int]:
        """(88, 88, min(zb, 104)) where aux['zcells'] has length zb."""
        d, h, w = self.dense_dims
        if isinstance(batch.aux, dict) and "zcells" in batch.aux:
            w = min(int(batch.aux["zcells"].shape[-1]), w)
        return d, h, w

    def _sparse_level0(self, feats, coords, mask, dims):
        """Stem conv, BN and activation at the occupied rows, then the
        rows pooled into the level-1 volume -> (h, occ_l)."""
        h_rows = self.stem_conv.forward_sites(feats, coords, mask, dims)
        h_rows = self.stem_norm(h_rows, mask)
        h_rows = self.act(h_rows) * mask[..., None].to(h_rows.dtype)
        if self.sparse_pool == "fused":
            # the row-space backward under one of three forward flavours
            flavour = self.pool_fwd if self.pool_fwd in (
                "separable", "scattermax") else "dense"
            return pooled_rows(coords, mask, h_rows, dims, flavour)
        if self.sparse_pool == "scattermax":
            return scatter_max_pool_batch(coords, mask, h_rows, dims)
        if self.sparse_pool == "dense":
            hv, occ_v = scatter_to_dense(coords, mask, h_rows, dims)
            occ_l = occupancy_pool(occ_v)
            return self._dense_pool(hv, occ_v, occ_l), occ_l
        # rows: the level-1 sites from a sort, each gathering its 27 rows
        grid1, _ = downsample(build_grid(coords, mask), None, 2,
                              coords.shape[1])
        nbr = pool_neighbor_map_batch(coords, mask, grid1.coords, grid1.mask,
                                      dims)
        rows1 = max_pool_sparse(h_rows, nbr, grid1.mask)
        return scatter_to_dense(grid1.coords, grid1.mask, rows1,
                                level_dims(dims, 1))

    def _dense_pool(self, x, occ_in, occ_out):
        return dense_max_pool(x, occ_in, occ_out, self.pool_bwd,
                              self.pool_fwd in ("unset", "separable"))

    def _rematerialized(self, fn, *args, generator=None):
        """fn(*args) through `remat` in training with gradients (where the
        JAX package's nn.remat is), else called directly."""
        if self.training and torch.is_grad_enabled():
            return remat(fn, *args, generator=generator)
        return fn(*args)

    def _dense_level0(self, feats, coords, mask, dims):
        """The input scattered to the full-resolution volume, the stem conv
        (stride first_stride) over it, BN over the occupied cells,
        activation, and the volume-form pool -> (h, occ_l)."""
        h, occ = scatter_to_dense(coords, mask, feats, dims)
        occ_stem = occ if self.first_stride == 1 else occupancy_pool(occ)
        h = self._rematerialized(self.stem_conv.forward_dense, h, occ_stem,
                                 self.first_stride, self.stem_mode)
        b, width = h.shape[0], h.shape[-1]
        h = self.stem_norm(h.reshape(b, -1, width),
                           occ_stem.reshape(b, -1) > 0).reshape(h.shape)
        h = self.act(h) * occ_stem.to(h.dtype)
        occ_l = occupancy_pool(occ_stem)
        return self._dense_pool(h, occ_stem, occ_l), occ_l

    def forward(self, batch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch: a `Batch` of tensors on one device -> raw head output
        [B, num_reg_targets] in f32. In training mode BN takes the batch
        moments over occupied cells and updates its running stats, and
        DropPath/Dropout draw from `generator` (on the batch's device)."""
        if batch.coords is None:
            raise ValueError("SparseResNet requires quantized coords "
                             "(use a sparse transform preset)")
        if self.dense_dims is None:
            return self._map_forward(batch, generator)
        coords, mask = batch.coords, batch.mask
        dims = self.level0_dims(batch)
        feats = batch.x.to(self.dtype)
        level0 = self._sparse_level0 if self.sparse_level0 \
            else self._dense_level0
        h, occ_l = level0(feats, coords, mask, dims)
        for name, s in zip(self.block_names, self.block_strides):
            occ_in = occ_l
            if s != 1:
                occ_l = occupancy_pool(occ_l)
            h = self._rematerialized(getattr(self, name), h, occ_in, occ_l,
                                     generator, generator=generator)
        hf = h.float()
        b = hf.shape[0]
        g = GLOBAL_POOL[self.global_pool](hf.reshape(b, -1, hf.shape[-1]),
                                          occ_l.reshape(b, -1) > 0)
        return self.final(self.dropout(g, generator))

    def pyramid_plan(self, v0: int) -> dict:
        """Map mode's levels on batches padded to v0 voxels (the input's,
        the stem pool's, one a stride-2 stage and, at first_stride 2, the
        stem's own) and their caps (`host_pyramid.resnet_pyramid_plan`)."""
        return resnet_pyramid_plan(self.first_stride, self.strides, v0,
                                   DEFAULT_LEVEL_FRACS, self.level_caps)

    def _map_forward(self, batch, generator):
        coords, mask = batch.coords, batch.mask
        x = batch.x.to(self.dtype)
        plan = self.pyramid_plan(coords.shape[1])
        n_levels = plan["n_levels"]
        stem_level = 0 if self.first_stride == 1 else 1
        aux = batch.aux if isinstance(batch.aux, dict) \
            and "pool_map" in batch.aux else None
        if aux is not None:  # built on the host
            masks = [aux[f"mask{l}"].bool() for l in range(n_levels)]
            stem_map, pool_map = aux["stem_map"], aux["pool_map"]

            def get_s1(lv):
                return aux[f"s1_map{lv}"]

            def get_down(si):
                return aux[f"down_k3_{si}"], aux[f"down_k1_{si}"]
        else:  # built here, with the same rules
            off27 = hypercube_offsets(3)
            grids = build_levels(coords, mask, plan["caps"])
            masks = [g.mask for g in grids]
            stem_map = kernel_map(grids[0], grids[stem_level],
                                  hypercube_offsets(7), self.first_stride)
            pool_map = kernel_map(grids[stem_level], grids[stem_level + 1],
                                  off27, 2)
            s1_cache = {}

            def get_s1(lv):
                if lv not in s1_cache:
                    s1_cache[lv] = kernel_map(grids[lv], grids[lv], off27, 1)
                return s1_cache[lv]

            down_level = {}
            lv = stem_level + 1
            for si, st in enumerate(self.strides):
                if st != 1:
                    down_level[si] = lv
                    lv += 1

            def get_down(si):
                lv = down_level[si]
                return (kernel_map(grids[lv], grids[lv + 1], off27, 2),
                        kernel_map(grids[lv], grids[lv + 1],
                                   hypercube_offsets(1), 2))

        level = stem_level
        h = self.stem_conv.forward_map(x, stem_map)
        h = self.act(self.stem_norm(h, masks[level]))
        h = max_pool_apply(h, pool_map, masks[level + 1])
        level += 1
        for name, s, si in zip(self.block_names, self.block_strides,
                               self.block_stages):
            in_mask = masks[level]
            if s != 1:
                k3, k1 = get_down(si)
                level += 1
                k3_out = get_s1(level)
            else:
                k3 = k3_out = get_s1(level)
                k1 = None
            h = getattr(self, name).forward_map(h, in_mask, masks[level], k3,
                                                k3_out, k1, generator)
        g = GLOBAL_POOL[self.global_pool](h.float(), masks[level])
        return self.final(self.dropout(g, generator))


_ARCHS = {
    # name -> (block, layers)
    "ResNet14_": ("basic", (1, 1, 1, 1)),
    "ResNet18_": ("basic", (2, 2, 2, 2)),
    "ResNet34_": ("basic", (3, 4, 6, 3)),
    "ResNet50_": ("bottleneck", (3, 4, 6, 3)),
    "ResNet101_": ("bottleneck", (3, 4, 23, 3)),
    "SENet14": ("se_basic", (1, 1, 1, 1)),
    "SENet18": ("se_basic", (2, 2, 2, 2)),
    "SENet34": ("se_basic", (3, 4, 6, 3)),
    "SENet50": ("se_bottleneck", (3, 4, 6, 3)),
    "SENet101": ("se_bottleneck", (3, 4, 23, 3)),
}

_ARCH_EXTRAS = {
    "SENet17_6deep": dict(block="se_basic", layers=(1, 1, 1, 1, 2, 1),
                          strides=(1, 2, 2, 2, 2, 2), init_dim=32,
                          planes=(32, 64, 128, 256, 512, 1024)),
    "SENet17_5deep": dict(block="se_basic", layers=(1, 1, 1, 2, 2),
                          strides=(1, 2, 2, 2, 2), init_dim=64,
                          planes=(64, 128, 256, 512, 1024)),
}


def build_resnet(arch_name: str, option: dict, num_reg_targets: int,
                 in_channels: int,
                 generator: Optional[torch.Generator] = None
                 ) -> SparseResNet:
    """The model of one `conf/models` entry, with the defaults of the JAX
    builder; extra_options.bf16 selects the bf16 compute dtype,
    extra_options.dense_dims null map mode (with extra_options.level_caps)."""
    extra = dict(option.get("extra_options", {}) or {})
    dense_dims = extra.get("dense_dims", (88, 88, 104))
    common = dict(
        num_reg_targets=num_reg_targets,
        in_channels=in_channels,
        activation=option.get("activation", "relu"),
        first_stride=int(option.get("first_stride", 2)),
        global_pool=option.get("global_pool", "mean"),
        dropout=float(option.get("dropout", 0.0)),
        drop_path=float(option.get("drop_path", 0.0)),
        bn_momentum=float(option.get("bn_momentum", 0.1)),
        norm_type=option.get("norm_type", "bn"),
        use_bias=bool(option.get("bias", True)),
        dtype=torch.bfloat16 if extra.get("bf16", False) else torch.float32,
        dense_dims=None if dense_dims is None else tuple(dense_dims),
        level_caps=extra.get("level_caps"),
        generator=generator,
    )
    if arch_name in _ARCHS:
        block, layers = _ARCHS[arch_name]
        return SparseResNet(block=block, layers=layers, **common)
    if arch_name in _ARCH_EXTRAS:
        return SparseResNet(**{**common, **_ARCH_EXTRAS[arch_name]})
    raise ValueError(f"Unknown minkowski arch: {arch_name}. "
                     f"Known: {sorted(_ARCHS) + sorted(_ARCH_EXTRAS)}")
