"""Parity of the port's instance, layer and global-response norms with the
JAX package on the CPU (`nn/norm.py`: `MaskedInstanceNorm`,
`MaskedLayerNorm`, `MaskedGRN`), and of the sparse-voxel nets built with
`norm_type` `in` and `ln`: a narrow SENet14 (planes 16,16,32,32, init 16)
on the sparse level 0 (first_stride 1), the dense level 0 (first_stride
2) and in map mode (`dense_dims=None`), the JAX weights carried across by
`weights.from_flax`. Padding rows of the layer norm are garbage in both
packages (the norm is per row and unmasked): the ops are compared at the
valid rows, the nets at their pooled output."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models import minkowski as jmink
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.nn import norm as jnorm
from dpcr_agb_tpu.ops import host_pyramid as jhp
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import make_train_step
from dpcr_agb_tpu_torch import train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models import minkowski as tmink
from dpcr_agb_tpu_torch.models.factory import make_post_collate
from dpcr_agb_tpu_torch.nn import norm as tnorm
from dpcr_agb_tpu_torch.weights import from_flax, to_flax

STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}
PAD = -(2 ** 20)


def _rows(rng, shape=(3, 20, 6)):
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    mask = np.ones(shape[:-1], bool)
    mask[1, 13:] = False
    mask[2, 4:] = False
    return x, mask


def _affine(module, rng):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.normal(0.5, 0.5, tuple(p.shape))
                                     .astype(np.float32)))
    return module


OPS = {"in": (jnorm.MaskedInstanceNorm, tnorm.MaskedInstanceNorm),
       "ln": (jnorm.MaskedLayerNorm, tnorm.MaskedLayerNorm),
       "grn": (jnorm.MaskedGRN, tnorm.MaskedGRN)}


@pytest.mark.parametrize("name", sorted(OPS))
def test_norm_op_and_its_vjp_match_jax(name):
    """Forward and the VJP in x and in the parameters (a random cotangent
    on the valid rows), f32: rtol 1e-5, atol 1e-5 of the largest value."""
    rng = np.random.default_rng(len(name))
    x, mask = _rows(rng)
    jcls, tcls = OPS[name]
    t = _affine(tcls(6), rng)
    params = {k: v.detach().numpy() for k, v in t.named_parameters()}
    cot = np.where(mask[..., None], rng.standard_normal(x.shape), 0
                   ).astype(np.float32)

    def jfn(p, xx):
        return jcls(6).apply({"params": p}, xx, mask)

    want, vjp = jax.vjp(jfn, params, x)
    jg, jgx = vjp(cot)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t(xt, torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    m = mask[..., None] & np.ones(x.shape, bool)
    w = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy()[m], w[m], rtol=1e-5,
                               atol=1e-5 * np.abs(w[m]).max())
    for k, g in jg.items():
        g = np.asarray(g)
        np.testing.assert_allclose(
            dict(t.named_parameters())[k].grad.numpy(), g, rtol=1e-5,
            atol=1e-5 * np.abs(g).max(), err_msg=k)
    gx = np.asarray(jgx)
    np.testing.assert_allclose(xt.grad.numpy()[m], gx[m], rtol=1e-5,
                               atol=1e-5 * np.abs(gx).max())


@pytest.mark.parametrize("name", ["in", "ln"])
def test_norm_op_bf16_matches_jax(name):
    """bf16 activations: the instance norm in f32 and back to bf16, the
    layer norm's moments in bf16 and its f32 affine promoting the output
    to f32, as in JAX (the same dtype out); within 2e-2 of the largest
    value."""
    rng = np.random.default_rng(7)
    x, mask = _rows(rng)
    jcls, tcls = OPS[name]
    t = _affine(tcls(6), rng)
    params = {k: v.detach().numpy() for k, v in t.named_parameters()}
    jout = jcls(6).apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                         mask)
    want = np.asarray(jout.astype(jnp.float32))
    with torch.no_grad():
        got = t(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    assert str(got.dtype).split(".")[-1] == str(jout.dtype)
    m = mask[..., None] & np.ones(x.shape, bool)
    np.testing.assert_allclose(got.float().numpy()[m], want[m], rtol=0,
                               atol=2e-2 * np.abs(want[m]).max())


def test_instance_norm_over_a_volume_is_the_flat_rows_norm():
    """The dense paths hand the JAX norm [B, V, C] rows flattened from the
    volume; the port's instance norm takes the volume as it is: the same
    values."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    occ = rng.uniform(size=(2, 3, 4, 5)) < 0.4
    t = _affine(tnorm.MaskedInstanceNorm(6), rng)
    params = {k: v.detach().numpy() for k, v in t.named_parameters()}
    want = np.asarray(jnorm.MaskedInstanceNorm(6).apply(
        {"params": params}, x.reshape(2, -1, 6), occ.reshape(2, -1)))
    with torch.no_grad():
        got = t(torch.from_numpy(x), torch.from_numpy(occ)).numpy()
    np.testing.assert_allclose(got.reshape(2, -1, 6), want, rtol=1e-5,
                               atol=1e-5)


# --- narrow SENet14 with in / ln ---------------------------------------------

NARROW = dict(block="se_basic", layers=(1, 1, 1, 1),
              planes=(16, 16, 32, 32), init_dim=16, activation="gelu",
              global_pool="sum", drop_path=0.0)
# route -> (first_stride, dense_dims)
ROUTES = {"sparse_l0": (1, (12, 12, 12)), "dense_l0": (2, (12, 12, 12)),
          "map": (1, None)}


def _fields(rng, b=2, v=96):
    coords = np.full((b, v, 3), PAD, np.int32)
    mask = np.zeros((b, v), bool)
    for i, n in enumerate((80, 57)[:b]):
        flat = rng.choice(12 * 12 * 8, size=n, replace=False)
        coords[i, :n] = np.stack([flat // 96, flat // 8 % 12, flat % 8], 1)
        mask[i, :n] = True
    x = np.where(mask[..., None], rng.uniform(0, 1, (b, v, 3)), 0
                 ).astype(np.float32)
    return dict(pos=np.zeros((b, v, 3), np.float32), x=x, mask=mask,
                y_reg=rng.uniform(50, 300, (b, 2)).astype(np.float32),
                y_reg_mask=np.ones((b, 2), bool),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool), coords=coords)


def _nets(route, norm_type):
    first_stride, dims = ROUTES[route]
    kw = dict(num_reg_targets=2, first_stride=first_stride,
              dense_dims=dims, norm_type=norm_type, **NARROW)
    net = tmink.SparseResNet(in_channels=3, generator=torch.Generator()
                             .manual_seed(0), **kw)
    rng = np.random.default_rng(11)
    _affine(net, rng)            # every weight random, norms' affine too
    return net, jmink.SparseResNet(**kw)


def _batches(route, net):
    fields = _fields(np.random.default_rng(5))
    if ROUTES[route][1] is None:
        first_stride = ROUTES[route][0]
        plan = jhp.resnet_pyramid_plan(first_stride, (1, 2, 2, 2), 96,
                                       jmink.DEFAULT_LEVEL_FRACS, None)
        jaux = jhp.collate_sparse_aux(fields["coords"], fields["mask"], plan)
        port = make_post_collate(net)(Batch(**fields))
    else:
        jaux = {"zcells": np.zeros(8, np.int8)}
        port = Batch(**{**fields, "aux": jaux})
    jb = JBatch(**{k: jax.tree.map(jnp.asarray, f)
                   for k, f in {**fields, "aux": jaux}.items()})
    return port, jb


def _scale_weights(net):
    """Weights of a size that keeps the activations O(1) through the
    stages (the convs' fan-in is 27-343 rows)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("kernel") and p.dim() == 3:
                p.mul_(0.5 / np.sqrt(p.shape[0] * p.shape[1]))


@pytest.mark.parametrize("norm_type", ["in", "ln"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_senet14_with_norm_type_matches_jax(route, norm_type):
    """Eval forward rtol 1e-4 / atol 1e-4 of max|out|; on the sparse
    level 0 also one step of the paper's recipe (loss 1e-5, updated
    parameters rtol 1e-4 / atol 1e-5). No running stats: batch_stats is
    empty, and the eval and train forwards normalize alike."""
    net, jnet = _nets(route, norm_type)
    _scale_weights(net)
    params, stats = to_flax(net.state_dict())
    assert stats == {}
    port, jb = _batches(route, net)
    want = np.asarray(jax.jit(lambda p, b: jnet.apply(
        {"params": p, "batch_stats": {}}, b, train=False))(params, jb))
    net.eval()
    with torch.no_grad():
        got = net(port.to("cpu")).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    if route != "sparse_l0":
        return
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(s, np.float32)
                                       for k, s in STATS.items()})
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))
    p2, _, _, out = make_train_step(jnet, spec, tx)(
        params, {}, tx.init(params), jb, np.int32(0))
    runner = train.build_runner(net, STATS, seed=0)
    got = runner.train(port)
    np.testing.assert_allclose(float(got["loss"]), float(out["loss"]),
                               rtol=1e-5)
    sd = runner.net.state_dict()
    for k, w in from_flax(jax.tree.map(np.asarray, p2), {}).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_build_resnet_takes_in_and_ln_and_calibration_leaves_them():
    """`build_resnet` builds every norm of the net as the type says (the
    stem's and each block's, shortcut included), the parameters keep the
    flax names (`scale`, `bias`), and a train-mode forward without
    gradients (calibrate_bn) leaves the model's state as it was: the
    norms have no running stats."""
    for norm_type, cls in (("in", tnorm.MaskedInstanceNorm),
                           ("ln", tnorm.MaskedLayerNorm)):
        net = tmink.build_resnet("SENet14", {
            "first_stride": 1, "norm_type": norm_type,
            "extra_options": {"dense_dims": (12, 12, 12)}}, 2, 3)
        norms = [m for m in net.modules()
                 if isinstance(m, (tnorm.MaskedBatchNorm,
                                   tnorm.MaskedInstanceNorm,
                                   tnorm.MaskedLayerNorm))]
        assert len(norms) == 12 and all(isinstance(m, cls) for m in norms)
        assert "stem_norm.scale" in net.state_dict()
        runner = train.build_runner(net, STATS, seed=0)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        fields = _fields(np.random.default_rng(2))
        runner.calibrate(Batch(**{**fields,
                                  "aux": {"zcells": np.zeros(8, np.int8)}}))
        assert all(torch.equal(before[k], v)
                   for k, v in net.state_dict().items())
