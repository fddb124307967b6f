"""Parity of the port's nn layers (dpcr_agb_tpu_torch.nn) with the flax
modules of the JAX package on the CPU: the same numpy inputs and the same
weights, carried across by the weight bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.nn.blocks import ACTIVATIONS as J_ACT
from dpcr_agb_tpu.nn.blocks import SELayer as JSE
from dpcr_agb_tpu.nn.blocks import SeparateLinear as JSepLin
from dpcr_agb_tpu.nn.blocks import TorchLinear as JLin
from dpcr_agb_tpu.nn.norm import MaskedBatchNorm as JBN
from dpcr_agb_tpu_torch.nn import (ACTIVATIONS, MaskedBatchNorm, SELayer,
                                   SeparateLinear, TorchLinear)
from dpcr_agb_tpu_torch.weights import from_flax

T = torch.from_numpy


def _load(module, variables):
    sd = from_flax(variables["params"], variables.get("batch_stats", {}))
    missing, unexpected = module.load_state_dict(sd, strict=True)
    assert not missing and not unexpected


@pytest.mark.parametrize("name", sorted(J_ACT))
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(J_ACT[name](jnp.asarray(x)))
    got = ACTIVATIONS[name](T(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = T(np.linspace(-4, 4, 101).astype(np.float32))
    exact = torch.nn.functional.gelu(x)
    assert (ACTIVATIONS["gelu"](x) - exact).abs().max() > 1e-5


def _bn_case(affine_noise=True):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32) * 2 + 1
    mask = rng.random((2, 7)) < 0.6
    jbn = JBN(5)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                 use_running_average=True)
    v = jax.tree.map(np.asarray, v)
    if affine_noise:
        v["params"] = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                       "bias": rng.normal(size=5).astype(np.float32)}
        v["batch_stats"] = {
            "mean": rng.normal(size=5).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 5).astype(np.float32)}
    return jbn, v, x, mask


def test_masked_batchnorm_eval_matches_jax():
    jbn, v, x, mask = _bn_case()
    want = np.asarray(jbn.apply(v, jnp.asarray(x), jnp.asarray(mask),
                                use_running_average=True))
    bn = MaskedBatchNorm(5)
    _load(bn, v)
    bn.eval()
    got = bn(T(x), T(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_masked_batchnorm_train_moments_match_jax():
    """Train mode: masked moments normalize, running stats update with the
    unbiased variance (kept for BN calibration in a later slice)."""
    jbn, v, x, mask = _bn_case()
    want, upd = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask),
                          use_running_average=False, mutable=["batch_stats"])
    bn = MaskedBatchNorm(5)
    _load(bn, v)
    bn.train()
    got = bn(T(x), T(mask)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


def test_masked_batchnorm_bf16_eval_close():
    jbn, v, x, mask = _bn_case()
    want = np.asarray(jbn.apply(v, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(mask), use_running_average=True),
                      np.float32)
    bn = MaskedBatchNorm(5)
    _load(bn, v)
    bn.eval()
    got = bn(T(x).bfloat16(), T(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_se_layer_matches_jax():
    rng = np.random.default_rng(1)
    c = 32
    x = rng.normal(size=(2, 9, c)).astype(np.float32)
    mask = rng.random((2, 9)) < 0.7
    jse = JSE(c, J_ACT["gelu"])
    v = jax.tree.map(np.asarray, jse.init(jax.random.PRNGKey(1),
                                          jnp.asarray(x), jnp.asarray(mask)))
    want = np.asarray(jse.apply(v, jnp.asarray(x), jnp.asarray(mask)))
    se = SELayer(c, ACTIVATIONS["gelu"])
    _load(se, v)
    got = se(T(x), T(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_separate_linear_and_torch_linear_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 12)).astype(np.float32)
    jsl = JSepLin(3)
    v = jax.tree.map(np.asarray, jsl.init(jax.random.PRNGKey(2),
                                          jnp.asarray(x)))
    v["params"] = jax.tree.map(
        lambda a: (a + rng.normal(size=a.shape) * 0.1).astype(np.float32),
        v["params"])
    want = np.asarray(jsl.apply(v, jnp.asarray(x)))
    sl = SeparateLinear(12, 3)
    _load(sl, v)
    np.testing.assert_allclose(sl(T(x)).detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)

    jl = JLin(5)
    vl = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(3),
                                          jnp.asarray(x)))
    lin = TorchLinear(12, 5)
    _load(lin, vl)
    np.testing.assert_allclose(lin(T(x)).detach().numpy(),
                               np.asarray(jl.apply(vl, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_torch_linear_default_init_bounds():
    g = torch.Generator().manual_seed(0)
    lin = TorchLinear(16, 4, generator=g)
    assert lin.kernel.abs().max() <= 0.25 and lin.bias.abs().max() <= 0.25
    sl = SeparateLinear(16, 2, generator=g)
    assert sl.linear_0.bias.abs().max() == 0
    assert sl.linear_0.kernel.abs().max() <= 0.04
