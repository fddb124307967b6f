"""The folded dense stem behind layout firewalls (counterpart of
`layout_firewall`, `zfold_conv`, `zfold2d_conv` and `stem_conv_folded` in
`dpcr_agb_tpu/ops/dense_stem.py`).

The k^3 stem conv of a tiny-Cin volume is rewritten with its first-axis
taps folded into channels: k shifted slices of the padded volume are
concatenated into k*Cin channels, and a conv over the two remaining axes
finishes the sum (`zfold_conv`: a depth-1 3D conv; `zfold2d_conv`: a true
2D conv over [B*D', k*Cin, H, W]). The folded computation runs between two
`layout_firewall`s: each is a copy into a fresh buffer, contiguous in the
logical NDHWC order, so whatever memory format the convolution library
chose for the folded tensors stops there, forward and (through the
firewall's backward) on the cotangent. On CUDA tensors the copy is the
hand-written `firewall_copy` kernel; on CPU tensors its plain version."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..parallel import round_after_sum
from ..parallel import rounding


def firewall_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the `firewall_copy` kernel: a fresh
    contiguous tensor filled from x in logical order."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out.copy_(x)
    return out


def firewall_copy(x: torch.Tensor) -> torch.Tensor:
    """x of any strides -> a fresh contiguous tensor of equal values. The
    op `dpcr_port::firewall_copy`: the `firewall_copy` kernel on CUDA
    tensors, the plain version on CPU ones."""
    return kernel_ops.firewall_copy(x)


class _LayoutFirewall(torch.autograd.Function):
    """Identity whose forward and backward are both the copy."""

    @staticmethod
    def forward(ctx, x):
        return firewall_copy(x)

    @staticmethod
    def backward(ctx, ct):
        return firewall_copy(ct)


def layout_firewall(x: torch.Tensor) -> torch.Tensor:
    """x -> a contiguous copy of x; the cotangent is copied likewise."""
    return _LayoutFirewall.apply(x)


def _fold(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """[B,D,H,W,Cin] -> [B,D',H,W,k*Cin]: the first axis padded by k//2 and
    its k taps, sampled every `stride`, concatenated tap-major into the
    channels."""
    d = x.shape[1]
    pad = k // 2
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad))
    n_out = (d + 2 * pad - k) // stride + 1
    last = (n_out - 1) * stride
    return torch.cat([xp[:, dd:dd + last + 1:stride] for dd in range(k)], -1)


def _folded_weight(w_dense: torch.Tensor) -> torch.Tensor:
    """[k,k,k,Cin,Cout] -> [Cout, k*Cin, k, k]: the first-axis tap outside
    Cin in the folded channel, as `_fold` concatenates them."""
    k, _, _, cin, cout = w_dense.shape
    return w_dense.permute(4, 0, 3, 1, 2).reshape(cout, k * cin, k, k)


def zfold_conv(x: torch.Tensor, w_dense: torch.Tensor, k: int,
               stride: int) -> torch.Tensor:
    """k^3 conv (pad k//2) of x [B,D,H,W,Cin] with w_dense
    [k,k,k,Cin,Cout], as one depth-1 3D conv over k*Cin channels ->
    [B,D',H',W',Cout] in x's dtype."""
    xs = _fold(x, k, stride)
    stride3, pad3 = (1, stride, stride), (0, k // 2, k // 2)
    if rounding.sums_rounded_once(x.dtype):
        y = rounding.conv(xs.permute(0, 4, 1, 2, 3),
                          _folded_weight(w_dense)[:, :, None], None,
                          stride3, pad3)
    else:
        wf = _folded_weight(w_dense.to(x.dtype))[:, :, None]
        y = F.conv3d(xs.permute(0, 4, 1, 2, 3), wf, stride=stride3,
                     padding=pad3)
    return y.permute(0, 2, 3, 4, 1)


def zfold2d_conv(x: torch.Tensor, w_dense: torch.Tensor, k: int,
                 stride: int) -> torch.Tensor:
    """The same conv as one true 2D k x k conv over [B*D', k*Cin, H, W]."""
    xs = _fold(x, k, stride)
    b, n_out, h, w, kc = xs.shape
    x2 = xs.reshape(b * n_out, h, w, kc).permute(0, 3, 1, 2)
    if rounding.sums_rounded_once(x.dtype):
        y = rounding.conv(x2, _folded_weight(w_dense), None, stride,
                          [k // 2] * 2)
    else:
        y = F.conv2d(x2, _folded_weight(w_dense.to(x.dtype)),
                     stride=stride, padding=k // 2)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(b, n_out, *y.shape[1:])


def stem_conv_folded(x: torch.Tensor, occ_out: torch.Tensor,
                     weights: torch.Tensor, kernel_size: int, stride: int,
                     compute_dtype: torch.dtype,
                     two_d: bool = False) -> torch.Tensor:
    """The firewalled folded stem conv, with `dense_grid.dense_conv`'s
    contract (without the bias): x [B,D,H,W,Cin], weights [K^3,Cin,Cout]
    -> conv * occ_out in compute_dtype. Under a process group a bf16
    conv's weight gradient is rounded once, after the SUM."""
    k = kernel_size
    cin, cout = weights.shape[-2:]
    w5 = weights.reshape(k, k, k, cin, cout)
    if rounding.sums_rounded_once(compute_dtype):
        round_after_sum(compute_dtype, weights)
    else:
        w5 = w5.to(compute_dtype)
    xi = layout_firewall(x.to(compute_dtype))
    y = (zfold2d_conv if two_d else zfold_conv)(xi, w5, k, stride)
    y = layout_firewall(y)
    return y * occ_out.to(y.dtype)
