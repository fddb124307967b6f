"""Sparse-voxel ResNet/SENet family on the dense-grid path (counterpart of
`dpcr_agb_tpu/models/minkowski.py`, `SparseResNet._dense_forward`).

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

Training runs the same path with train-mode BN and live DropPath; the
JAX package's `nn.remat` around the stem conv and the blocks has no numeric
effect and is not ported (bs16 fits on one 80 GB card without it).

Not ported yet: map mode (`dense_dims=None`)."""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.blocks import (ACTIVATIONS, DropPath, Dropout, SELayer,
                         SeparateLinear, trunc_normal_)
from ..nn.norm import MaskedBatchNorm
from ..ops.dense_grid import (POOL_BWD_MODES, STEM_MODES, dense_conv,
                              dense_max_pool, level_dims, occupancy_pool,
                              scatter_to_dense)
from ..ops.masked import GLOBAL_POOL
from ..ops.pool import pooled_rows
from ..ops.sparse_stem import (max_pool_sparse, pool_neighbor_map_batch,
                               scatter_max_pool_batch, stem_conv_rows)
from ..ops.voxel import build_grid, downsample

_LATER = "a later slice of the port"


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
            y = (x.to(self.dtype).float()
                 @ self.kernel[0].to(self.dtype).float()) * occ
            if self.bias is not None:
                y = (y + self.bias.to(y.dtype)) * occ
            return y
        return dense_conv(x, occ, self.kernel, self.kernel_size, stride,
                          self.dtype, self.bias, stem_mode)

    def forward_sites(self, x: torch.Tensor, coords: torch.Tensor,
                      mask: torch.Tensor, dims: Sequence[int]
                      ) -> torch.Tensor:
        """x [B,V,Cin] rows -> [B,V,Cout] at the occupied sites."""
        return stem_conv_rows(coords, mask, x, dims, self.kernel, self.bias,
                              self.dtype)


def make_norm(norm_type: str, features: int, bn_momentum: float):
    if norm_type in ("bn", "bn_no_affine"):
        return MaskedBatchNorm(features, momentum=bn_momentum,
                               affine=norm_type == "bn")
    raise NotImplementedError(f"norm_type={norm_type!r} is left for {_LATER}"
                              " (ported: bn, bn_no_affine)")


class ResBlock(nn.Module):
    """BasicBlock or Bottleneck (+SE) in dense mode over one or two
    resolution levels.

    It reproduces the reference's dense-mode masking: each conv output is
    (conv + bias) * occupancy, BN normalizes every cell (empty ones too,
    without re-masking), and only the block output is zeroed outside the
    output occupancy. A bottleneck's first k1 conv and norm work at the
    input occupancy; its output is planes * 4 wide."""

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
    """ResNetBase on the dense grid, with a sparse or a dense level 0."""

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
                 generator: Optional[torch.Generator] = None,
                 l0_mode: Optional[str] = None,
                 stem_mode: Optional[str] = None,
                 pool_bwd: Optional[str] = None,
                 sparse_pool: Optional[str] = None,
                 pool_fwd: Optional[str] = None):
        super().__init__()
        if dense_dims is None:
            raise NotImplementedError(
                f"map mode (dense_dims=None) is left for {_LATER}")
        self.l0_mode = resolve_mode("l0_mode", l0_mode)
        self.stem_mode = resolve_mode("stem_mode", stem_mode)
        self.pool_bwd = resolve_mode("pool_bwd", pool_bwd)
        self.sparse_pool = resolve_mode("sparse_pool", sparse_pool)
        self.pool_fwd = resolve_mode("pool_fwd", pool_fwd)
        self.first_stride = int(first_stride)
        self.dense_dims = tuple(int(v) for v in dense_dims)
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

    def _dense_level0(self, feats, coords, mask, dims):
        """The input scattered to the full-resolution volume, the stem conv
        (stride first_stride) over it, BN over the occupied cells,
        activation, and the volume-form pool -> (h, occ_l)."""
        h, occ = scatter_to_dense(coords, mask, feats, dims)
        occ_stem = occ if self.first_stride == 1 else occupancy_pool(occ)
        h = self.stem_conv.forward_dense(h, occ_stem, self.first_stride,
                                         self.stem_mode)
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
            h = getattr(self, name)(h, occ_in, occ_l, generator)
        hf = h.float()
        b = hf.shape[0]
        g = GLOBAL_POOL[self.global_pool](hf.reshape(b, -1, hf.shape[-1]),
                                          occ_l.reshape(b, -1) > 0)
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
    builder; extra_options.bf16 selects the bf16 compute dtype."""
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
        generator=generator,
    )
    if arch_name in _ARCHS:
        block, layers = _ARCHS[arch_name]
        return SparseResNet(block=block, layers=layers, **common)
    if arch_name in _ARCH_EXTRAS:
        return SparseResNet(**{**common, **_ARCH_EXTRAS[arch_name]})
    raise ValueError(f"Unknown minkowski arch: {arch_name}. "
                     f"Known: {sorted(_ARCHS) + sorted(_ARCH_EXTRAS)}")
