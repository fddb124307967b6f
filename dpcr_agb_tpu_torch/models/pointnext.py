"""PointNeXt and the openpoints PointNet encoder on dense padded clouds
(counterpart of `dpcr_agb_tpu/models/pointnext.py`): the `PointNext` and
`PointNet` entries of `conf/models/instance/`, both `pointnext.PointNext`.

  * `PointNext` (arch `pointnext_s`, `pointnext_b`): farthest point
    sampling of the input down to `num_points` when it has more, a stem
    (linear + masked BN + act), then per stage either a set abstraction
    (FPS to N // stride, a ball query of `nsample` neighbours within the
    radius, dp_fj grouping with dp / radius, MLPs with BN over the valid
    neighbours, a max over them, and with `sa_use_res` a linear skip of
    the sampled features) that doubles the width and scales the radius, or
    InvResMLP blocks (local aggregation, an expansion-4 pointwise MLP, a
    residual); a global masked max, the ClsHead (linear, BN over the
    batch, act, dropout per width) and the SeparateLinear head.
  * `PointNetEncoderModel` (arch `pointnet`): shared MLPs 64-64-64-128-1024
    over [pos, x], a global masked max, the ClsHead [512, 256, 128, 128].

Farthest point sampling runs as the `fps` kernel on CUDA tensors
(`ops.neighbors.fps`); the ball query is `ops.neighbors.radius_neighbors`,
whose shadow index Ns marks the empty slots. Both models run in f32 (the
JAX models have no dtype field). Submodule names are the flax names
(`stem.conv`, `sa1.agg.conv0.bn`, `sa1.skip`, `stage5_block0.pw1`,
`head0_lin`, `final`, ...), so `weights.from_flax` maps the parameters as
they are. Dropout draws from the generator the caller passes."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.blocks import ACTIVATIONS, Dropout, SeparateLinear, TorchLinear
from ..nn.norm import MaskedBatchNorm
from ..ops import neighbors
from ..ops.masked import masked_max

def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,N,...] rows picked by idx [B,...] (per sample)."""
    rows = torch.arange(x.shape[0], device=x.device).view(
        -1, *[1] * (idx.dim() - 1))
    return x[rows, idx.long()]


class _ConvNormAct(nn.Module):
    def __init__(self, in_features: int, features: int,
                 act_name: str = "relu", use_act: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = TorchLinear(in_features, features, use_bias=False,
                                generator=generator)
        self.bn = MaskedBatchNorm(features)
        self.act = ACTIVATIONS[act_name] if use_act else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x), mask)
        return self.act(x) if self.act is not None else x


class _LocalAggregation(nn.Module):
    """Ball query + dp_fj grouping + MLP + max over the neighbours
    (openpoints LocalAggregation, feature_type dp_fj, normalize_dp)."""

    def __init__(self, in_features: int, features: int, radius: float,
                 nsample: int, act_name: str = "relu", layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.radius, self.nsample, self.layers = radius, nsample, layers
        width = 3 + in_features
        for li in range(layers):
            self.add_module(f"conv{li}", _ConvNormAct(
                width, features, act_name, generator=generator))
            width = features

    def forward(self, q_pos, q_mask, s_pos, s_mask, s_feats):
        b, ns = s_pos.shape[:2]
        nbr = neighbors.radius_neighbors(q_pos, q_mask, s_pos, s_mask,
                                         self.radius, self.nsample)
        s_pos_pad = torch.cat([s_pos, s_pos.new_zeros(b, 1, 3)], 1)
        s_f_pad = torch.cat([s_feats, s_feats.new_zeros(
            b, 1, s_feats.shape[-1])], 1)
        grouped_pos = _gather_rows(s_pos_pad, nbr)           # [B,Nq,K,3]
        grouped_f = _gather_rows(s_f_pad, nbr)               # [B,Nq,K,C]
        dp = (grouped_pos - q_pos[:, :, None, :]) / self.radius
        h = torch.cat([dp, grouped_f], -1)
        valid = nbr < ns                                     # [B,Nq,K]
        vm = valid.reshape(b, -1)
        for li in range(self.layers):
            hm = getattr(self, f"conv{li}")(h.reshape(b, -1, h.shape[-1]),
                                            vm)
            h = hm.reshape(*valid.shape, hm.shape[-1])
        out = masked_max(h, valid, axis=-2)                  # [B,Nq,C]
        return torch.where(q_mask[..., None], out, torch.zeros_like(out))


class _SetAbstraction(nn.Module):
    """Strided SA block: FPS to N // stride, local aggregation, and with
    sa_use_res a linear skip of the sampled features."""

    def __init__(self, in_features: int, features: int, stride: int,
                 radius: float, nsample: int, sa_layers: int = 2,
                 sa_use_res: bool = True, act_name: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.act = ACTIVATIONS[act_name]
        self.agg = _LocalAggregation(in_features, features, radius, nsample,
                                     act_name, sa_layers, generator)
        self.skip = TorchLinear(in_features, features, use_bias=False,
                                generator=generator) if sa_use_res else None

    def forward(self, pos, mask, feats):
        n_out = max(pos.shape[1] // self.stride, 1)
        idx = neighbors.fps(pos, mask, n_out)                # [B,n_out]
        q_pos = _gather_rows(pos, idx)
        q_mask = _gather_rows(mask, idx)
        agg = self.agg(q_pos, q_mask, pos, mask, feats)
        if self.skip is not None:
            agg = self.act(agg + self.skip(_gather_rows(feats, idx)))
        return q_pos, q_mask, agg


class _InvResMLP(nn.Module):
    """openpoints InvResMLP: local aggregation, an expansion-4 pointwise
    MLP, a residual."""

    def __init__(self, features: int, radius: float, nsample: int,
                 expansion: int = 4, act_name: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = ACTIVATIONS[act_name]
        self.agg = _LocalAggregation(features, features, radius, nsample,
                                     act_name, 1, generator)
        self.pw1 = _ConvNormAct(features, features * expansion, act_name,
                                generator=generator)
        self.pw2 = _ConvNormAct(features * expansion, features, act_name,
                                use_act=False, generator=generator)

    def forward(self, pos, mask, feats):
        h = self.agg(pos, mask, pos, mask, feats)
        h = self.pw2(self.pw1(h, mask), mask)
        return self.act(h + feats)


def _build_head(model: nn.Module, in_features: int, mlps: Sequence[int],
                num_reg_targets: int, dropout: float,
                generator: Optional[torch.Generator]) -> None:
    """The ClsHead on `model` itself, so that the names stay flat as in
    flax: `head{i}_lin`, `head{i}_bn` per width, one dropout, `final`."""
    width = in_features
    for mi, w in enumerate(mlps):
        model.add_module(f"head{mi}_lin", TorchLinear(
            width, w, use_bias=False, generator=generator))
        model.add_module(f"head{mi}_bn", MaskedBatchNorm(w))
        width = w
    model.n_mlps = len(mlps)
    model.dropout = Dropout(dropout)
    model.final = SeparateLinear(width, num_reg_targets, generator)


def _head(model: nn.Module, g: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """The ClsHead on the pooled features g [B,C]: per width linear, BN
    over the batch (every row valid), act, dropout; then `final`."""
    every = torch.ones(g.shape[:-1], dtype=torch.bool, device=g.device)
    for mi in range(model.n_mlps):
        g = getattr(model, f"head{mi}_bn")(
            getattr(model, f"head{mi}_lin")(g), every)
        g = model.dropout(model.act(g), generator)
    return model.final(g)


def _sample_input(pos, mask, num_points: int, *others):
    """FPS of the input down to num_points when it has more rows: (pos,
    mask, *others) gathered at the sampled rows, else as they are."""
    if not num_points or pos.shape[1] <= num_points:
        return (pos, mask, *others)
    idx = neighbors.fps(pos, mask, num_points)
    return tuple(_gather_rows(t, idx) for t in (pos, mask, *others))


class PointNext(nn.Module):
    """PointNeXt-S/B encoder + ClsHead + SeparateLinear."""

    def __init__(self, num_reg_targets: int, in_channels: int,
                 blocks: Sequence[int] = (1, 1, 1, 1, 1, 1),
                 strides: Sequence[int] = (1, 4, 4, 4, 4, 1),
                 width: int = 32, radius: float = 0.0125,
                 radius_scaling: float = 2.0, nsample: int = 32,
                 sa_layers: int = 2, sa_use_res: bool = True,
                 expansion: int = 4, activation: str = "relu",
                 head_mlps: Sequence[int] = (512, 256),
                 dropout: float = 0.5, num_points: int = 8192,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.num_points = num_points
        self.stem = _ConvNormAct(in_channels, width, activation,
                                 generator=generator)
        # (name, module) in forward order
        self.order = []
        r = radius
        for si, (n_blocks, stride) in enumerate(
                zip(blocks[1:], strides[1:]), start=1):
            if stride > 1:
                self._add(f"sa{si}", _SetAbstraction(
                    width, width * 2, stride, r, nsample, sa_layers,
                    sa_use_res, activation, generator))
                width *= 2
                r *= radius_scaling
                extra = n_blocks - 1
            else:
                extra = n_blocks
            for bi in range(extra):
                self._add(f"stage{si}_block{bi}", _InvResMLP(
                    width, r, nsample, expansion, activation, generator))
        _build_head(self, width, head_mlps, num_reg_targets, dropout,
                    generator)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, batch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch: a `Batch` of tensors on one device -> raw head output
        [B, num_reg_targets] in f32. `generator` draws the dropout coins in
        training."""
        pos, mask, feats = _sample_input(batch.pos.float(), batch.mask,
                                         self.num_points, batch.x.float())
        h = self.stem(feats, mask)
        for name in self.order:
            block = getattr(self, name)
            if isinstance(block, _SetAbstraction):
                pos, mask, h = block(pos, mask, h)
            else:
                h = block(pos, mask, h)
        return _head(self, masked_max(h, mask), generator)


class PointNetEncoderModel(nn.Module):
    """openpoints 'pointnet': shared MLPs 64-64-64-128-1024 over [pos, x],
    a global masked max, ClsHead [512, 256, 128, 128] (input transform
    off, as the reference config has it)."""

    WIDTHS = (64, 64, 64, 128, 1024)

    def __init__(self, num_reg_targets: int, in_channels: int,
                 activation: str = "relu",
                 head_mlps: Sequence[int] = (512, 256, 128, 128),
                 dropout: float = 0.4, num_points: int = 8192,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.num_points = num_points
        width = 3 + in_channels
        for i, w in enumerate(self.WIDTHS):
            self.add_module(f"enc{i}", _ConvNormAct(width, w, activation,
                                                    generator=generator))
            width = w
        _build_head(self, width, head_mlps, num_reg_targets, dropout,
                    generator)

    def forward(self, batch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pos = batch.pos.float()
        feats = torch.cat([pos, batch.x.float()], -1)
        _, mask, h = _sample_input(pos, batch.mask, self.num_points, feats)
        for i in range(len(self.WIDTHS)):
            h = getattr(self, f"enc{i}")(h, mask)
        return _head(self, masked_max(h, mask), generator)


def build_pointnext(option: dict, num_reg_targets: int, in_channels: int,
                    generator: Optional[torch.Generator] = None):
    """A `pointnext.PointNext` entry of `conf/models` -> its model, with
    the JAX builder's defaults (arch pointnext_s, relu, num_points 8192,
    stride 4, radius 0.1, radius_scaling 2, nsample 32, the head's MLPs
    unless use_mlps is false)."""
    arch = str(option.get("arch", "pointnext_s"))
    common = dict(num_reg_targets=num_reg_targets, in_channels=in_channels,
                  activation=option.get("activation", "relu"),
                  num_points=int(option.get("num_points", 8192)),
                  generator=generator)
    if arch == "pointnet":
        return PointNetEncoderModel(**common)
    stride = int(option.get("stride", 4))
    kwargs = dict(
        strides=(1, stride, stride, stride, stride, 1),
        radius=float(option.get("radius", 0.1)),
        radius_scaling=float(option.get("radius_scaling", 2.0)),
        nsample=int(option.get("nsample", 32)),
        head_mlps=(512, 256) if option.get("use_mlps", True) else (),
        **common)
    if arch == "pointnext_s":
        return PointNext(blocks=(1, 1, 1, 1, 1, 1), sa_layers=2,
                         sa_use_res=True, **kwargs)
    if arch == "pointnext_b":
        return PointNext(blocks=(1, 2, 3, 2, 1, 1), sa_layers=1,
                         sa_use_res=False, **kwargs)
    raise ValueError(f"Unknown pointnext arch: {arch}")
