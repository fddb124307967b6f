"""Sparse-voxel ResNet/SENet family on the dense-grid path (counterpart of
`dpcr_agb_tpu/models/minkowski.py`, `SparseResNet._dense_forward` with the
sparse level 0 and the fused pool).

Forward: the k=7 stem conv, BN and activation on the occupied rows only
(`stem_sites` kernel), the rows pooled into the level-1 volume
(`max_pool_k3s2` kernel), then dense masked k3 convs (`F.conv3d`) through
4 stages of residual blocks with squeeze-excite, a masked global pool and a
SeparateLinear head. Submodule and parameter names are the flax ones, and
conv kernels keep the JAX layout [K^3, Cin, Cout] with z-fastest offsets.

Training runs the same path with train-mode BN and live DropPath; the
JAX package's `nn.remat` around the blocks has no numeric effect and is not
ported (bs16 and bs32 fit on one 80 GB card without it).

Not ported yet: map mode (`dense_dims=None`), the dense level 0
(`DPCR_L0=dense`, `first_stride` 2), the other sparse-pool modes and the
bottleneck blocks (ResNet50/101, SENet50/101)."""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.blocks import (ACTIVATIONS, DropPath, Dropout, SELayer,
                         SeparateLinear, trunc_normal_)
from ..nn.norm import MaskedBatchNorm
from ..ops.dense_grid import dense_conv, occupancy_pool
from ..ops.masked import GLOBAL_POOL
from ..ops.pool import pooled_rows
from ..ops.sparse_stem import stem_conv_rows

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
                      stride: int = 1) -> torch.Tensor:
        """x [B,D,H,W,Cin], occ = output occupancy [B,D',H',W',1]."""
        if self.kernel_size == 1 and stride == 1:
            # the reference's f32-accumulating dot: output f32, masked
            # before and after the bias
            y = (x.to(self.dtype).float()
                 @ self.kernel[0].to(self.dtype).float()) * occ
            if self.bias is not None:
                y = (y + self.bias.to(y.dtype)) * occ
            return y
        return dense_conv(x, occ, self.kernel, self.kernel_size, stride,
                          self.dtype, self.bias)

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
    """BasicBlock (+SE) in dense mode over one or two resolution levels.

    It reproduces the reference's dense-mode masking: each conv output is
    (conv + bias) * occupancy, BN normalizes every cell (empty ones too,
    without re-masking), and only the block output is zeroed outside the
    output occupancy."""

    def __init__(self, in_channels: int, planes: int, bottleneck: bool,
                 se: bool, act_name: str = "gelu", stride: int = 1,
                 drop_path: float = 0.0, use_bias: bool = True,
                 bn_momentum: float = 0.1, norm_type: str = "bn",
                 se_reduction: int = 16, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if bottleneck:
            raise NotImplementedError(
                f"bottleneck blocks (ResNet50/101, SENet50/101) are left for "
                f"{_LATER}")
        self.act = ACTIVATIONS[act_name]
        self.stride = stride
        self.se_on = se
        conv = lambda cin, kv: SparseConv(  # noqa: E731
            cin, planes, kv, use_bias, dtype, generator)
        self.conv1 = conv(in_channels, 27)
        self.norm1 = make_norm(norm_type, planes, bn_momentum)
        self.conv2 = conv(planes, 27)
        self.norm2 = make_norm(norm_type, planes, bn_momentum)
        if se:
            self.se = SELayer(planes, self.act, se_reduction, generator)
        self.need_proj = stride != 1 or in_channels != planes
        if self.need_proj:
            self.downsample_conv = conv(in_channels, 1)
            self.downsample_norm = make_norm(norm_type, planes, bn_momentum)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, occ_in: torch.Tensor,
                occ_out: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B,D,H,W,Cin]; occ_in/occ_out occupancy volumes [...,1] of the
        input and output level (occ_in is read by bottleneck blocks only);
        `generator` feeds DropPath in training."""
        m_out = occ_out[..., 0] > 0
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


class SparseResNet(nn.Module):
    """ResNetBase on the dense grid with a sparse level 0 and fused pool."""

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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dense_dims is None:
            raise NotImplementedError(
                f"map mode (dense_dims=None) is left for {_LATER}")
        if first_stride != 1 or os.environ.get("DPCR_L0", "sparse") \
                != "sparse":
            raise NotImplementedError(
                f"the dense level 0 (DPCR_L0=dense or first_stride != 1) is "
                f"left for {_LATER}")
        if os.environ.get("DPCR_SPARSE_POOL", "fused") != "fused":
            raise NotImplementedError(
                f"sparse pool modes other than 'fused' are left for {_LATER}")
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
                self.add_module(name, ResBlock(
                    width, p, bottleneck, se, activation, s, drop_path,
                    use_bias, bn_momentum, norm_type, dtype=dtype,
                    generator=generator))
                self.block_names.append(name)
                self.block_strides.append(s)
                width = p
        self.dropout = Dropout(dropout)
        self.final = SeparateLinear(width, num_reg_targets, generator)

    def level0_dims(self, batch) -> Tuple[int, int, int]:
        """(88, 88, min(zb, 104)) where aux['zcells'] has length zb."""
        d, h, w = self.dense_dims
        if isinstance(batch.aux, dict) and "zcells" in batch.aux:
            w = min(int(batch.aux["zcells"].shape[-1]), w)
        return d, h, w

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
        h_rows = self.stem_conv.forward_sites(feats, coords, mask, dims)
        h_rows = self.stem_norm(h_rows, mask)
        h_rows = self.act(h_rows) * mask[..., None].to(h_rows.dtype)
        h, occ_l = pooled_rows(coords, mask, h_rows, dims)
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
