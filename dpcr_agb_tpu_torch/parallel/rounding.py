"""One bf16 rounding of a replicated tensor's gradient under a process
group.

A bf16 net casts its f32 parameters (and BN's f32 moments) to bf16, and
the cotangent of such a cast is a sum over the batch's rows that one
process rounds to bf16 once: cuDNN's bf16 weight gradient, the broadcast
sums of BN's affine, the backward of `.float()` after an f32 matmul. The
JAX mesh step rounds the global batch's sum once too. Under a process
group each rank holds only its rows, so rounding there would round every
rank's partial sum before the SUM. The functions here own the cast and
the sum over the rows, and hand the SUM the f32 partial instead:

  * a parameter's partial goes to `all_reduce_grads`, which rounds it
    once after the SUM (the caller marks it with `round_after_sum`);
  * BN's mean and variance feed the moments' own differentiable SUM
    (`all_reduce_sum`), so `batch_norm` sums their partials itself in its
    backward, rounds once, and hands the result to rank 0's cotangent
    (zero on the others: the moments' SUM gives every rank the same
    global value, exactly).

The forward values are the one-process path's bit for bit; only where the
sums are rounded moves. `sums_rounded_once(dtype)` says when these
functions are taken: a process group, a compute dtype other than f32, and
gradients being recorded. Without a group every caller keeps its
one-process code, its kernels and its bits."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import rank, round_after_sum


def sums_rounded_once(dtype: torch.dtype) -> bool:
    """Whether a cast to `dtype` under this step hands the SUM f32
    partials: a process group, a compute dtype below f32, and autograd
    recording."""
    return (dtype != torch.float32 and dist.is_initialized()
            and torch.is_grad_enabled())


def _rows_sum(t: torch.Tensor) -> torch.Tensor:
    """The f32 sum of t [..., C] over every axis but the last."""
    return t.float().sum(tuple(range(t.dim() - 1)))


class _CastWidened(torch.autograd.Function):
    """w -> w rounded to `dtype` and widened back to f32; the backward
    passes the f32 cotangent through unrounded."""

    @staticmethod
    def forward(ctx, w, dtype):
        return w.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def cast_widened(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`w.to(dtype).float()` whose gradient stays the f32 partial; marks
    `w` for one rounding after the SUM. For an f32 product of bf16-valued
    operands (the k1 convs, map mode's convs)."""
    round_after_sum(dtype, w)
    return _CastWidened.apply(w, dtype)


class _AddBias(torch.autograd.Function):
    """y [..., C] + bias [C] cast to y's dtype; the bias's cotangent is the
    f32 sum over the rows."""

    @staticmethod
    def forward(ctx, y, bias):
        return y + bias.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, _rows_sum(g)


def add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """`y + bias.to(y.dtype)` with the bias's gradient the f32 partial;
    marks `bias` for one rounding after the SUM."""
    round_after_sum(y.dtype, bias)
    return _AddBias.apply(y, bias)


def _conv_call(x, w, b, stride, padding):
    n = x.dim() - 2
    return torch.ops.aten.convolution(x, w, b, [stride] * n
                                      if isinstance(stride, int) else stride,
                                      padding, [1] * n, False, [0] * n, 1)


class _ConvSumRounded(torch.autograd.Function):
    """An N-d convolution of x [B, Cin, ...] (compute dtype) with f32 w
    [Cout, Cin, ...] and optional f32 b, both cast to x's dtype. `widen`
    runs it in f32 on the exactly widened operands and rounds the output
    (the CPU's route). The backward takes dx as the one-process route
    does (the compute dtype's dgrad, or the f32 one rounded), and dw, db
    in f32 from the widened operands: the partials, unrounded."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, widen):
        wc = w.to(x.dtype)
        bc = None if b is None else b.to(x.dtype)
        if widen:
            y = _conv_call(x.float(), wc.float(),
                           None if bc is None else bc.float(), stride,
                           padding).to(x.dtype)
        else:
            y = _conv_call(x, wc, bc, stride, padding)
        ctx.save_for_backward(x, wc)
        ctx.args = (stride, padding, widen, None if b is None
                    else list(b.shape))
        return y

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        stride, padding, widen, bias_sizes = ctx.args
        n = x.dim() - 2
        stride = [stride] * n if isinstance(stride, int) else list(stride)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        fixed = (stride, list(padding), [1] * n, False, [0] * n, 1)
        dx = dw = db = None
        if widen:
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.float(), x.float(), wc.float(), bias_sizes, *fixed,
                [need_x, need_w, need_b and bias_sizes is not None])
            dx = None if dx is None else dx.to(x.dtype)
        else:
            if need_x:
                dx = torch.ops.aten.convolution_backward(
                    g, x, wc, None, *fixed, [True, False, False])[0]
            if need_w or need_b:
                _, dw, db = torch.ops.aten.convolution_backward(
                    g.float(), x.float(), wc.float(), bias_sizes, *fixed,
                    [False, need_w, need_b and bias_sizes is not None])
        return dx, dw, db, None, None, None


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         stride, padding: Sequence[int], widen: bool = False
         ) -> torch.Tensor:
    """`F.conv{2,3}d(x, w.to(x.dtype), b.to(x.dtype), stride, padding)`
    (with `widen`: in f32, the output rounded to x's dtype) whose weight
    and bias gradients are the f32 partials. The caller marks the
    parameters behind w and b with `round_after_sum`."""
    return _ConvSumRounded.apply(x, w, b, stride, list(padding), widen)


class _BatchNormSumRounded(torch.autograd.Function):
    """(x - mean) * rsqrt(var + eps) [* scale + bias], every f32 operand
    cast to x's dtype and the arithmetic in it, as `MaskedBatchNorm` takes
    it. The backward's per-element products are autograd's, in x's dtype;
    its sums over the rows are f32 partials: scale's and bias's go to the
    parameters; the cotangents of rsqrt's output and of the mean are
    SUMmed over ranks here, rounded once, and continued as one process
    continues them (rsqrt's backward in x's dtype), on rank 0."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, eps):
        dt = x.dtype
        mb, vb = mean.to(dt), var.to(dt)
        xm = x - mb
        r = torch.rsqrt(vb + eps)
        y = xm * r
        sb = None
        if scale is not None:
            sb = scale.to(dt)
            ctx.save_for_backward(xm, r, vb, y, sb)
            y = y * sb + bias.to(dt)
        else:
            ctx.save_for_backward(xm, r, vb, y, sb)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        xm, r, vb, y0, sb = ctx.saved_tensors
        need_x, need_mean, need_var, need_scale, need_bias = \
            ctx.needs_input_grad[:5]
        d_scale = d_bias = d_mean = d_var = None
        if sb is not None:
            if need_scale:
                d_scale = _rows_sum(g * y0)
            if need_bias:
                d_bias = _rows_sum(g)
            g = g * sb
        gxm = g * r
        if need_mean or need_var:
            part = torch.cat([_rows_sum(g * xm), _rows_sum(-gxm)])
            dist.all_reduce(part)
            c = xm.shape[-1]
            g_r, g_mean = part[:c].to(xm.dtype), part[c:].to(xm.dtype)
            with torch.enable_grad():
                leaf = vb.detach().requires_grad_(True)
                (g_var,) = torch.autograd.grad(torch.rsqrt(leaf + ctx.eps),
                                               leaf, g_r)
            first = rank() == 0
            d_mean = g_mean.float() if first else torch.zeros_like(part[c:])
            d_var = g_var.float() if first else torch.zeros_like(part[c:])
        return (gxm if need_x else None, d_mean, d_var, d_scale, d_bias,
                None)


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """`MaskedBatchNorm`'s normalization in x's dtype with one rounding
    of every sum over the global batch; marks scale and bias for one
    rounding after the SUM."""
    round_after_sum(x.dtype, scale, bias)
    return _BatchNormSumRounded.apply(x, mean, var, scale, bias, eps)
