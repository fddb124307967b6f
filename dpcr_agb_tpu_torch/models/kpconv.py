"""KPConv (kernel-point convolution) regression net (counterpart of
`dpcr_agb_tpu/models/kpconv.py`: `KPConvOp`, `BatchNormBlock`, `UnaryBlock`,
`KPCNN`, `build_kpconv`), rigid kernels on the fused path.

The pyramid (points, conv neighbours and pool neighbours of every level) is
built on the batch's device by `ops/neighbors.py` inside the forward, or
taken from `batch.aux` when it holds one (`KPCNN.device_pyramid` returns
that form). Every rigid KPConv runs `ops.kpconv.kpconv_fused`: the relative
neighbour positions `rel` are computed once per (level, conv or pool
geometry) and shared, the influences are computed inside the op, and
neither the influences nor the gathered or weighted features are built.

Semantics kept from the reference: layer radius r_l = first_subsampling_dl
* conv_radius * 2^l, pooling grid dl_{l+1} = 2 r_l / conv_radius; influence
extent r * KP_extent / conv_radius; neighbour lists sorted by distance and
cropped to per-level caps; channel plan simple -> out/2, resnetb bottleneck
out/4, out_dim doubling per strided layer, head UnaryBlock(out_dim -> 1024,
no BN) and SeparateLinear; BN over valid points with momentum 0.02; KPConv
weights U(+-1/sqrt(Cin*Cout)); features zeroed at masked-out points after
every block. Submodule and parameter names are the flax ones.

Mixed precision (`dtype=torch.bfloat16`) is the compute dtype inside the
fused op only; everything around it stays f32.

In a forward on the card that takes gradients, each neighbour list also
gets its reverse edge index (`ops.kpconv.reverse_edges`, once per list, shared by
every op over it), over which the backward sums dx of every KPConv and of
the strided shortcut's gather in a fixed order.

Not ported yet: deformable and modulated kernels, the host pyramid (native
pointops), the neighbour-limit calibration."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.blocks import ACTIVATIONS, SeparateLinear, TorchLinear
from ..nn.norm import MaskedBatchNorm
from ..ops.kernel_points import load_kernel_points
from ..ops.kpconv import (gather_rows, kpconv_fused, reverse_edges,
                          shared_rel)
from ..ops.masked import masked_mean, masked_sum
from ..ops.neighbors import grid_subsample, radius_neighbors

DEFAULT_POINT_FRACS = (1.0, 0.7, 0.35, 0.18, 0.1, 0.06)
SHADOW_POS = 1e6
_LATER = "a later slice of the port"


def max_pool_zero_shadow_batched(x: torch.Tensor, nbr: torch.Tensor,
                                 rev=None) -> torch.Tensor:
    """Strided-shortcut max pool: x [B,Ns,C], nbr [B,Nq,K] -> [B,Nq,C], the
    max over each row's neighbours with a zero row for the shadow (its
    backward splits a tie evenly, as jnp.max's; the gather's backward sums
    over rev, nbr's reverse edge index, in a fixed order)."""
    return gather_rows(x, nbr, rev).amax(dim=2)


class KPConvOp(nn.Module):
    """One rigid kernel-point convolution, weights [Kp, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_points: np.ndarray, extent: float,
                 influence: str = "linear", aggregation: str = "sum",
                 deformable: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if deformable:
            raise NotImplementedError(
                f"deformable and modulated KPConv are left for {_LATER}")
        self.extent = float(extent)
        self.influence = influence
        self.aggregation = aggregation
        self.dtype = dtype
        # the disposition is static, not a parameter: kept out of state_dict
        self.register_buffer(
            "kernel_points",
            torch.from_numpy(np.ascontiguousarray(kernel_points, np.float32)),
            persistent=False)
        bound = 1.0 / np.sqrt(in_channels * out_channels)
        self.weights = nn.Parameter(torch.empty(
            kernel_points.shape[0], in_channels, out_channels).uniform_(
                -bound, bound, generator=generator))

    def forward(self, nbr: torch.Tensor, x: torch.Tensor,
                rel: torch.Tensor, rev=None) -> torch.Tensor:
        """nbr [B,Nq,K], x [B,Ns,Cin], rel [B,Nq,K,3] -> [B,Nq,Cout] f32;
        rev: nbr's reverse edge index for the backward (optional)."""
        return kpconv_fused(x, nbr, rel, self.weights, self.kernel_points,
                            self.extent, self.influence, self.aggregation,
                            self.dtype, rev)


class BatchNormBlock(nn.Module):
    """BN over valid points, or a bias when use_bn is False."""

    def __init__(self, features: int, use_bn: bool = True,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.use_bn = use_bn
        if use_bn:
            self.bn = MaskedBatchNorm(features, momentum=bn_momentum)
        else:
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.bn(x, mask) if self.use_bn else x + self.bias


class UnaryBlock(nn.Module):
    """Linear without bias, BatchNormBlock, activation unless no_relu."""

    def __init__(self, in_features: int, features: int,
                 act_name: str = "relu", use_bn: bool = True,
                 bn_momentum: float = 0.02, no_relu: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = TorchLinear(in_features, features, use_bias=False,
                               generator=generator)
        self.norm = BatchNormBlock(features, use_bn, bn_momentum)
        self.act = None if no_relu else ACTIVATIONS[act_name]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.mlp(x), mask)
        return x if self.act is None else self.act(x)


class KPCNN(nn.Module):
    """Regression encoder built from an architecture string list over the
    device pyramid."""

    def __init__(self, architecture: Sequence[str], num_reg_targets: int,
                 in_features_dim: int, first_features_dim: int = 64,
                 num_kernel_points: int = 15,
                 first_subsampling_dl: float = 0.0125,
                 conv_radius: float = 2.5, kp_extent: float = 1.0,
                 kp_influence: str = "linear", aggregation_mode: str = "sum",
                 fixed_kernel_points: str = "center",
                 activation: str = "relu", use_batch_norm: bool = True,
                 batch_norm_momentum: float = 0.02,
                 point_fracs: Optional[Sequence[float]] = None,
                 neighborhood_limits: Optional[Sequence[int]] = None,
                 kernel_seed: int = 42, kp_disposition: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.architecture = list(architecture)
        self.first_subsampling_dl = first_subsampling_dl
        self.conv_radius = conv_radius
        self.point_fracs = point_fracs
        self.neighborhood_limits = neighborhood_limits
        self.dtype = dtype
        self.act = ACTIVATIONS[activation]
        self.levels, self.global_block = self._layer_plan()
        if any("deformable" in b for lv in self.levels for b in lv):
            raise NotImplementedError(
                f"deformable and modulated KPConv are left for {_LATER}")
        common = dict(act_name=activation, use_bn=use_batch_norm,
                      bn_momentum=batch_norm_momentum, generator=generator)

        def kpconv(cin, cout, kp_disp, extent):
            return KPConvOp(cin, cout, kp_disp, extent, kp_influence,
                            aggregation_mode, dtype=dtype,
                            generator=generator)

        # the channel plan of the reference (architectures.py:91-125)
        in_dim, out_dim = in_features_dim, first_features_dim
        r = first_subsampling_dl * conv_radius
        bi = 0
        self.blocks: List[Tuple[int, str, int, int, int]] = []
        for l, layer_blocks in enumerate(self.levels):
            extent = r * kp_extent / conv_radius
            kp_disp = load_kernel_points(r, num_kernel_points,
                                         fixed_kernel_points,
                                         seed=kernel_seed + l,
                                         method=kp_disposition)
            for block in layer_blocks:
                self.blocks.append((bi, block, l, in_dim, out_dim))
                name = f"block{bi}"
                if block.startswith("simple"):
                    width = out_dim // 2
                    self.add_module(f"{name}_kpconv",
                                    kpconv(in_dim, width, kp_disp, extent))
                    self.add_module(f"{name}_norm", BatchNormBlock(
                        width, use_batch_norm, batch_norm_momentum))
                    in_dim = width
                elif block.startswith("resnetb"):
                    quarter = out_dim // 4
                    if in_dim != quarter:
                        self.add_module(f"{name}_unary1", UnaryBlock(
                            in_dim, quarter, **common))
                    self.add_module(f"{name}_kpconv",
                                    kpconv(quarter, quarter, kp_disp, extent))
                    self.add_module(f"{name}_normconv", BatchNormBlock(
                        quarter, use_batch_norm, batch_norm_momentum))
                    self.add_module(f"{name}_unary2", UnaryBlock(
                        quarter, out_dim, no_relu=True, **common))
                    if in_dim != out_dim:
                        self.add_module(f"{name}_shortcut", UnaryBlock(
                            in_dim, out_dim, no_relu=True, **common))
                    in_dim = out_dim
                elif block == "unary":
                    self.add_module(f"{name}_unary", UnaryBlock(
                        in_dim, out_dim, **common))
                    in_dim = out_dim
                else:
                    raise ValueError(f"Unknown KPConv block: {block}")
                bi += 1
            r *= 2
            if layer_blocks and _strided(layer_blocks[-1]):
                out_dim *= 2
        self.head_mlp = UnaryBlock(in_dim, 1024, act_name=activation,
                                   use_bn=False, generator=generator)
        self.final = SeparateLinear(1024, num_reg_targets, generator)

    def _layer_plan(self):
        """Split the architecture into per-level block lists; returns
        (levels, global_block)."""
        levels: List[List[str]] = [[]]
        global_block = None
        for block in self.architecture:
            if "global" in block:
                global_block = block
                break
            if "upsample" in block:
                break
            levels[-1].append(block)
            if _strided(block):
                levels.append([])
        if levels and not levels[-1]:
            levels.pop()
        return levels, global_block

    def level_caps(self, n0: int) -> List[int]:
        """Point caps per level for a batch padded to n0 points."""
        fracs = list(self.point_fracs or DEFAULT_POINT_FRACS)
        return [max(16, int(-(-int(n0 * fracs[min(l, len(fracs) - 1)]) // 8)
                            * 8)) for l in range(len(self.levels))]

    @torch.no_grad()
    def device_pyramid(self, pos: torch.Tensor,
                       mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pyramid of pos [B,N,3], mask [B,N] in the form `batch.aux`
        carries it: kp_pts{l} [B,N_l,3], kp_mask{l}, kp_conv{l} [B,N_l,K]
        and kp_pool{l} [B,N_{l+1},K] (queries of level l+1 over level l)."""
        n_levels = len(self.levels)
        caps = self.level_caps(pos.shape[1])
        klims = list(self.neighborhood_limits or [40] * n_levels)
        out: Dict[str, torch.Tensor] = {}
        p_l, m_l = pos.float(), mask
        r = self.first_subsampling_dl * self.conv_radius
        for l in range(n_levels):
            out[f"kp_pts{l}"], out[f"kp_mask{l}"] = p_l, m_l
            out[f"kp_conv{l}"] = radius_neighbors(p_l, m_l, p_l, m_l, r,
                                                  klims[l])
            if l < n_levels - 1:
                dl = 2 * r / self.conv_radius
                p_n, m_n = grid_subsample(p_l, m_l, dl, caps[l + 1])
                out[f"kp_pool{l}"] = radius_neighbors(p_n, m_n, p_l, m_l, r,
                                                      klims[l])
                p_l, m_l = p_n, m_n
            r *= 2
        return out

    def forward(self, batch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch: a `Batch` of tensors on one device -> raw head output
        [B, num_reg_targets] in f32. `generator` is unused: KPCNN has no
        dropout."""
        del generator
        aux = batch.aux if isinstance(batch.aux, dict) \
            and "kp_conv0" in batch.aux else None
        if aux is None:
            aux = self.device_pyramid(batch.pos, batch.mask)
        x = batch.x.float()
        rel_cache: Dict[Tuple[int, bool], torch.Tensor] = {}
        # each list's reverse edge index, for the card's fixed-order
        # backward sums; built only where a gradient will be taken on the
        # card (the CPU's plain versions do not read it)
        rev_cache: Dict[Tuple[int, bool], tuple] = {}
        for bi, block, l, in_dim, out_dim in self.blocks:
            name = f"block{bi}"
            p_l, m_l = aux[f"kp_pts{l}"].float(), aux[f"kp_mask{l}"]
            strided = _strided(block)
            if strided:
                q_pts, q_mask = aux[f"kp_pts{l + 1}"].float(), \
                    aux[f"kp_mask{l + 1}"]
                nbr = aux[f"kp_pool{l}"]
            else:
                q_pts, q_mask, nbr = p_l, m_l, aux[f"kp_conv{l}"]
            if (l, strided) not in rel_cache:
                rel_cache[(l, strided)] = shared_rel(q_pts, p_l, nbr,
                                                     SHADOW_POS)
                if torch.is_grad_enabled() and nbr.is_cuda:
                    rev_cache[(l, strided)] = reverse_edges(nbr,
                                                            p_l.shape[1])
            rel = rel_cache[(l, strided)]
            rev = rev_cache.get((l, strided))
            if block.startswith("simple"):
                x = getattr(self, f"{name}_kpconv")(nbr, x, rel, rev)
                x = self.act(getattr(self, f"{name}_norm")(x, q_mask))
            elif block.startswith("resnetb"):
                x = self._resnet_block(name, x, in_dim, out_dim, nbr, rel,
                                       rev, m_l, q_mask, strided)
            else:
                x = getattr(self, f"{name}_unary")(x, q_mask)
            x = torch.where(q_mask[..., None], x, torch.zeros_like(x))
        final_mask = aux[f"kp_mask{len(self.levels) - 1}"]
        pool = masked_mean if self.global_block == "global_average" \
            else masked_sum
        g = pool(x, final_mask)
        g = self.head_mlp(g, torch.ones(g.shape[:-1], dtype=torch.bool,
                                        device=g.device))
        return self.final(g)

    def _resnet_block(self, name: str, x, in_dim: int, out_dim: int, nbr,
                      rel, rev, in_mask, q_mask,
                      strided: bool) -> torch.Tensor:
        """ResnetBottleneckBlock (blocks.py:594-680)."""
        h = x
        if in_dim != out_dim // 4:
            h = getattr(self, f"{name}_unary1")(h, in_mask)
        h = getattr(self, f"{name}_kpconv")(nbr, h, rel, rev)
        h = self.act(getattr(self, f"{name}_normconv")(h, q_mask))
        h = getattr(self, f"{name}_unary2")(h, q_mask)
        shortcut = max_pool_zero_shadow_batched(x, nbr, rev) if strided \
            else x
        if in_dim != out_dim:
            shortcut = getattr(self, f"{name}_shortcut")(shortcut, q_mask)
        return self.act(h + shortcut)


def _strided(block: str) -> bool:
    return "pool" in block or "strided" in block


def build_kpconv(option: dict, num_reg_targets: int, in_channels: int,
                 generator: Optional[torch.Generator] = None) -> KPCNN:
    """The model of the `conf/models/instance/kpconv.yaml` entry, with the
    defaults of the JAX `build_kpconv`; extra_options.bf16 selects the bf16
    compute dtype of the fused op."""
    config = option["config"]
    in_dim = config.get("in_features_dim", "FEAT")
    if isinstance(in_dim, str):            # the FEAT placeholder
        in_dim = max(in_channels, 1)
    extra = dict(option.get("extra_options", {}) or {})
    if bool(config.get("modulated", False)):
        raise NotImplementedError(
            f"deformable and modulated KPConv are left for {_LATER}")
    return KPCNN(
        architecture=list(config["architecture"]),
        num_reg_targets=num_reg_targets,
        in_features_dim=int(in_dim),
        first_features_dim=int(config.get("first_features_dim", 64)),
        num_kernel_points=int(config.get("num_kernel_points", 15)),
        first_subsampling_dl=float(config.get("first_subsampling_dl",
                                              0.0125)),
        conv_radius=float(config.get("conv_radius", 2.5)),
        kp_extent=float(config.get("KP_extent", 1.0)),
        kp_influence=config.get("KP_influence", "linear"),
        aggregation_mode=config.get("aggregation_mode", "sum"),
        fixed_kernel_points=config.get("fixed_kernel_points", "center"),
        activation=config.get("activation", "relu"),
        use_batch_norm=bool(config.get("use_batch_norm", True)),
        batch_norm_momentum=float(config.get("batch_norm_momentum", 0.02)),
        point_fracs=extra.get("point_fracs"),
        neighborhood_limits=extra.get("neighborhood_limits"),
        kp_disposition=extra.get("kp_disposition", "auto"),
        dtype=torch.bfloat16 if extra.get("bf16", False) else torch.float32,
        generator=generator)
