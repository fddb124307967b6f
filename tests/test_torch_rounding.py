"""One bf16 rounding of the global batch's sums under a process group
(`dpcr_agb_tpu_torch/parallel/rounding.py`), site by site, on the CPU: two
gloo ranks in two processes, each on its half of a global batch, against
one process on the whole batch.

Each site is a bf16 module whose parameter cotangents (and, for BN, the
mean's and variance's) are sums over the batch's rows that one process
rounds to bf16 once: the k3 conv (the CPU's f32 route of the cuDNN conv),
the folded stem conv and its bias, the sparse stem (`stem_sites`' plain
version), the pointwise convs of the dense and map paths, map mode's
gathered conv, and masked BN. Under the group each rank hands the SUM its
f32 partial and the sum is rounded once after it, so the 2-rank gradients
equal the one-process rounding elementwise, except where the two f32
orders of a sum straddle a rounding boundary (one ulp; the share is
printed and held under 1%), or where a sum cancels to below f32's
resolution of its tensor. Rounding each rank's partial before the SUM
(the route before) misses in most elements; the test shows that too. The
squeeze-excite layer and KPConv's fused op take f32 weights into f32 sums
(nothing rounds), so their 2-rank gradients equal one process to f32
rounding.

The module imports only torch, numpy and the port, so the rank
processes import its site builders; one launch of two ranks (~10 s)
serves every case."""
import os
import sys

import numpy as np
import pytest
import torch

from dpcr_agb_tpu_torch import parallel
from dpcr_agb_tpu_torch.models.minkowski import SparseConv
from dpcr_agb_tpu_torch.nn.blocks import ACTIVATIONS, SELayer
from dpcr_agb_tpu_torch.nn.norm import MaskedBatchNorm
from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool
from dpcr_agb_tpu_torch.ops.kpconv import kpconv_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
F32_EPS = float(torch.finfo(torch.float32).eps)


class _KPConv(torch.nn.Module):
    def __init__(self, c, cout, kp):
        super().__init__()
        self.weights = torch.nn.Parameter(torch.randn(kp, c, cout) * 0.1)
        self.kernel_points = torch.randn(kp, 3) * 0.5

    def forward(self, x, nbr, rel):
        return kpconv_fused(x, nbr, rel, self.weights, self.kernel_points,
                            1.0, compute_dtype=BF16)


def _bf16_values(rng, shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(BF16)


def _occupancy(rng, b, d, share=0.4):
    return torch.from_numpy(
        (rng.random((b, d, d, d, 1)) < share).astype(np.float32)).to(BF16)


def _rows(rng, b, v, cin, dims):
    """Sparse rows: unique in-volume coords of b samples, some masked."""
    coords = np.full((b, v, 3), -(2 ** 20), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        n = int(rng.integers(v // 2, v))
        flat = rng.choice(int(np.prod(dims)), size=n, replace=False)
        coords[i, :n] = np.stack([flat // (dims[1] * dims[2]),
                                  (flat // dims[2]) % dims[1],
                                  flat % dims[2]], 1)
        mask[i, :n] = True
    feats = rng.normal(size=(b, v, cin)).astype(np.float32)
    feats[~mask] = 0
    return (torch.from_numpy(coords), torch.from_numpy(mask),
            torch.from_numpy(feats).to(BF16))


def site_case(name: str, seed: int = 20):
    """(module, inputs: global batch tensors, apply(module, *inputs) ->
    output) of a site; the module from a seed, so every process builds the
    same one."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    b = 4
    if name == "conv":       # a k3 stride-2 conv with bias, dense grid
        mod = SparseConv(8, 16, 27, True, BF16)
        occ = _occupancy(rng, b, 6)
        x = _bf16_values(rng, (b, 6, 6, 6, 8)) * occ
        return mod, (x, occupancy_pool(occ)), \
            lambda m, x, o: m.forward_dense(x, o, 2)
    if name == "conv_folded":  # the dense level 0's folded k7 stem + bias
        mod = SparseConv(3, 16, 343, True, BF16)
        occ = _occupancy(rng, b, 10)
        x = _bf16_values(rng, (b, 10, 10, 10, 3)) * occ
        return mod, (x, occ), \
            lambda m, x, o: m.forward_dense(x, o, 1, "zfold2d_firewall")
    if name == "stem":       # the sparse level 0's stem at the rows
        mod = SparseConv(3, 16, 343, True, BF16)
        coords, mask, feats = _rows(rng, b, 60, 3, (8, 8, 8))
        return mod, (feats, coords, mask), \
            lambda m, f, c, k: m.forward_sites(f, c, k, (8, 8, 8))
    if name == "k1":         # a pointwise conv of the dense grid
        mod = SparseConv(8, 16, 1, True, BF16)
        occ = _occupancy(rng, b, 5)
        return mod, (_bf16_values(rng, (b, 5, 5, 5, 8)) * occ, occ), \
            lambda m, x, o: m.forward_dense(x, o)
    if name == "k1_map":     # a pointwise conv of map mode
        mod = SparseConv(8, 16, 1, True, BF16)
        return mod, (_bf16_values(rng, (b, 50, 8)),), \
            lambda m, x: m.forward_map(x)
    if name == "map":        # map mode's gathered k3 conv
        mod = SparseConv(8, 16, 27, True, BF16)
        nbr = torch.from_numpy(rng.integers(0, 41, (b, 27, 30)))
        return mod, (_bf16_values(rng, (b, 40, 8)), nbr), \
            lambda m, x, n: m.forward_map(x, n)
    if name == "bn":         # masked BN in train mode, the moments global
        mod = MaskedBatchNorm(16)
        with torch.no_grad():
            mod.scale.uniform_(0.5, 1.5)
            mod.bias.uniform_(-0.5, 0.5)
        mask = torch.from_numpy(rng.random((b, 50)) < 0.7)
        return mod, (_bf16_values(rng, (b, 50, 16), 2.0) + 1.0, mask), \
            lambda m, x, k: m(x, k)
    if name == "se":         # squeeze-excite: f32 weights, f32 sums
        mod = SELayer(32, ACTIVATIONS["gelu"], 4)
        mask = torch.from_numpy(rng.random((b, 40)) < 0.8)
        return mod, (_bf16_values(rng, (b, 40, 32)), mask), \
            lambda m, x, k: m(x, k)
    if name == "kpconv":     # KPConv's fused op: f32 weights into f32 dW
        mod = _KPConv(8, 16, 5)
        ns, nq, k = 30, 20, 6
        nbr = torch.from_numpy(rng.integers(0, ns + 1, (b, nq, k)).astype(
            np.int32))
        rel = torch.from_numpy(rng.normal(size=(b, nq, k, 3)).astype(
            np.float32) * 0.5)
        return mod, (_bf16_values(rng, (b, ns, 8)), nbr, rel), \
            lambda m, x, n, r: m(x, n, r)
    raise KeyError(name)


ROUNDED = ("conv", "conv_folded", "stem", "k1", "k1_map", "map", "bn")
# parameters of the rounded sites that take no cast: the pointwise and map
# convs add their f32 bias to the f32 product, an f32 sum
F32_PARAMS = {("k1", "bias"), ("k1_map", "bias"), ("map", "bias")}
F32_SUMS = ("se", "kpconv")
SITES = ROUNDED + F32_SUMS


def site_grads(name: str, part=None) -> dict:
    """The site's gradients for a cotangent drawn from a seed, of the whole
    batch or (part = (rank, world)) of that rank's slice of it: its
    parameters' (summed over ranks by `all_reduce_grads` when a group
    runs) and its input's rows ("dx")."""
    mod, inputs, apply = site_case(name)
    mod.train()
    b = inputs[0].shape[0]
    lo, hi = 0, b
    if part is not None:
        r, w = part
        lo, hi = r * b // w, (r + 1) * b // w
    x = inputs[0][lo:hi].clone().requires_grad_(True)
    y = apply(mod, x, *[t[lo:hi] for t in inputs[1:]])
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(b, *y.shape[1:])).astype(np.float32))
    (y.float() * g[lo:hi]).sum().backward()
    parallel.all_reduce_grads(list(mod.parameters()))
    return {"dx": x.grad, **{k: p.grad.clone()
                             for k, p in mod.named_parameters()}}


WORKER = r"""
import os, sys
repo, out = sys.argv[1:3]
sys.path.insert(0, repo)
import torch
torch.set_num_threads(2)
from dpcr_agb_tpu_torch import parallel
from tests.test_torch_rounding import SITES, site_grads

assert parallel.maybe_init_distributed("cpu")
r, w = parallel.rank(), parallel.world_size()
res = {name: site_grads(name, (r, w)) for name in SITES}
assert "jax" not in sys.modules
torch.save(res, os.path.join(out, f"rank{r}.pt"))
parallel.destroy()
print("RANK-OK", flush=True)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tests.test_torch_parallel import run_ranks
    tmp = tmp_path_factory.mktemp("rounding")
    run_ranks([sys.executable, "-c", WORKER, REPO, str(tmp)], 2)
    return [torch.load(str(tmp / f"rank{r}.pt")) for r in range(2)]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart a and b are once each is rounded to
    bf16, elementwise."""
    def key(t):
        u = t.to(BF16).view(torch.int16).int()
        return torch.where(u < 0, -(u & 0x7FFF), u)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize("name", ROUNDED)
def test_sums_rounded_once_equal_the_one_process_rounding(ranks, name):
    """Each rounded parameter's 2-rank gradient (both ranks) against one
    process: bf16 values, elementwise equal but for a one-ulp straddle or
    a sum below f32's resolution of its tensor; the rounding of each
    rank's partial before the SUM misses in most elements."""
    one = site_grads(name)
    halves = [site_grads(name, (r, 2)) for r in range(2)] \
        if name != "bn" else None
    # the input's rows: BN's through the mean's and variance's cotangents,
    # rounded once after their SUM
    if one["dx"] is not None:    # the stem's input rows are data
        dx = torch.cat([got[name]["dx"] for got in ranks])
        assert int(bf16_ulps(dx, one["dx"]).max()) <= 1
    for k, b in one.items():
        if k == "dx":
            continue
        for got in ranks:
            a = got[name][k]
            assert torch.equal(a, got[name][k]) and torch.equal(
                a, ranks[1][name][k]), k
            if (name, k) in F32_PARAMS:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
                continue
            assert torch.equal(a.to(BF16).float(), a), k  # bf16 values
            ulps = bf16_ulps(a, b)
            noise = (a - b).abs() <= F32_EPS * b.abs().max()
            assert not ((ulps > 1) & ~noise).any(), (k, int(ulps.max()))
            share = float((ulps > 0).float().mean())
            print(f"{name}.{k}: {int((ulps == 1).sum())} of {a.numel()} "
                  f"one ulp apart, {int(((ulps > 1) & noise).sum())} "
                  f"below f32 resolution")
            assert share <= 1e-2, (k, share)
        if halves is not None and (name, k) not in F32_PARAMS:
            before = halves[0][k].to(BF16).float() \
                + halves[1][k].to(BF16).float()
            missed = float((bf16_ulps(before, b) > 0).float().mean())
            assert missed > 0.2, (k, missed)


@pytest.mark.parametrize("name", F32_SUMS)
def test_f32_sums_need_no_rounding(ranks, name):
    """The squeeze-excite layer and KPConv's fused op: the weights stay
    f32 and their gradients are f32 sums, so the 2-rank SUM is the one
    process's gradient to f32 rounding."""
    one = site_grads(name)
    for k, b in one.items():
        if k == "dx":
            continue
        for got in ranks:
            a = got[name][k]
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * float(b.abs().max()),
                                       err_msg=f"{name}.{k}")
