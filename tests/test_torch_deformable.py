"""Parity of the port's deformable and modulated KPConv with the JAX
package on the CPU.

The op (`KPConvOp(deformable=True)`) with and without modulations, at the
JAX init and with offsets a fraction of the extent; a narrow deformable
KPCNN (the architecture of the JAX package's own deformable test, simple,
resnetb_deformable, resnetb_deformable_strided, resnetb, global_sum, at
first_subsampling_dl 0.05 and neighbour caps 12, first width 16 and 5
kernel points) forward and one train step with the sown regularizer, on
the device pyramid and on the host pyramid, each against the same route
of the JAX package; and a rigid architecture with `modulated: True`.

The JAX package's repulsive term takes the square root of 0 on the
diagonal of the kernel points' pairwise distances, so its gradient is NaN
there (0 * inf) and every gradient upstream of a deformable op is NaN
(`test_reference_repulsive_gradient_is_nan`). The port gives the
diagonal a zero gradient. Its gradients are held against the JAX ones
taken with a square root whose derivative at 0 is 0 (`_safe_sqrt`, put
into the JAX kpconv module's `jnp` for the test alone): the same values
everywhere, the same gradients wherever the JAX ones are finite.

Clouds are random in the unit cube, so no two neighbours of a query are
equidistant from a deformed kernel point (no ties in the min over K)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models import factory as jfactory
from dpcr_agb_tpu.models import kpconv as jkp
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
from dpcr_agb_tpu.ops.kernel_points import load_kernel_points
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import _forward
from dpcr_agb_tpu_torch import train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models.kpconv import (SHADOW_POS, KPCNN, KPConvOp,
                                              build_kpconv)
from dpcr_agb_tpu_torch.ops.kpconv import shared_rel
from dpcr_agb_tpu_torch.weights import from_flax

ARCH = ["simple", "resnetb_deformable", "resnetb_deformable_strided",
        "resnetb", "global_sum"]
NARROW = dict(architecture=ARCH, num_reg_targets=2, in_features_dim=3,
              first_features_dim=16, num_kernel_points=5,
              first_subsampling_dl=0.05, neighborhood_limits=[12, 12])
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}


@jax.custom_jvp
def _safe_sqrt(x):
    return jnp.sqrt(x)


@_safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    x, = primals
    y = jnp.sqrt(x)
    pos = x > 0
    return y, jnp.where(pos, 0.5 / jnp.where(pos, y, 1.0), 0.0) * tangents[0]


@pytest.fixture
def safe_jax_sqrt(monkeypatch):
    """The JAX kpconv module with `jnp.sqrt` -> `_safe_sqrt` (its other
    functions untouched)."""
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.sqrt = _safe_sqrt
    monkeypatch.setattr(jkp, "jnp", proxy)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- the op ------------------------------------------------------------------

def _op_inputs(rng, b=2, nq=24, ns=40, k=8, cin=6):
    """Queries and supports in the unit cube, each query's k nearest
    supports as its neighbours (the nearest ones, so that kernel points
    of radius 0.5 and extent 0.25 weigh most of them) with a shadow tail
    on every third row, features, a cotangent."""
    q = rng.uniform(0, 1, (b, nq, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (b, ns, 3)).astype(np.float32)
    d = np.linalg.norm(q[:, :, None] - s[:, None], axis=-1)
    nbr = np.argsort(d, axis=-1)[..., :k].astype(np.int32)
    nbr[:, ::3, k - 3:] = ns                       # shadow neighbours
    x = rng.standard_normal((b, ns, cin)).astype(np.float32)
    return q, s, nbr, x


KP_RADIUS, EXTENT = 0.5, 0.25


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("offset_scale", [0.0, 0.3])
def test_deformable_op_matches_jax(modulated, offset_scale, safe_jax_sqrt):
    """Output rtol 1e-4 / atol 1e-5 of max|out|; the sown regularizer
    rtol 1e-5; the gradients of out * cotangent + regularizer in x,
    weights, offset_weights and offset_bias 1e-4 relative L2. offset_scale
    0 keeps the JAX init (offsets ~1e-2 of the extent); 0.3 scales the
    offset weights up so the kernel points move by a third of the
    extent."""
    rng = np.random.default_rng(1 + modulated)
    q, s, nbr, x = _op_inputs(rng)
    kp = load_kernel_points(KP_RADIUS, 5, "center", seed=3)
    extent = EXTENT
    jop = jkp.KPConvOp(7, kp, extent, deformable=True, modulated=modulated)
    v = jax.tree.map(np.asarray, jop.init(jax.random.PRNGKey(0), q, s, nbr,
                                          x))["params"]
    if offset_scale:
        v = {**v, "offset_weights": (v["offset_weights"] * offset_scale
                                     / np.abs(v["offset_weights"]).mean()
                                     * 0.1).astype(np.float32),
             "offset_bias": rng.normal(0, 0.2, v["offset_bias"].shape)
             .astype(np.float32)}
    cot = rng.standard_normal((2, 24, 7)).astype(np.float32)

    def jfn(params, xx):
        out, mut = jop.apply({"params": params}, q, s, nbr, xx,
                             mutable=["losses"])
        reg = mut["losses"]["deform_reg"]
        return jnp.sum(out * cot) + reg, (out, reg)

    (_, (jout, jreg)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(v, x)

    op = KPConvOp(6, 7, kp, extent, deformable=True, modulated=modulated)
    op.load_state_dict(from_flax(v, None), strict=True)
    op.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    nbr_t = torch.from_numpy(nbr)
    rel = shared_rel(torch.from_numpy(q), torch.from_numpy(s), nbr_t,
                     SHADOW_POS)
    out = op(nbr_t, xt, rel)
    reg = op.loss
    (torch.sum(out * torch.from_numpy(cot)) + reg).backward()
    jout = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(float(reg.detach()), float(jreg), rtol=1e-5)
    assert float(reg.detach()) > 0
    grads = {**{n: p.grad.numpy() for n, p in op.named_parameters()},
             "x": xt.grad.numpy()}
    want = {**{n: np.asarray(g) for n, g in jg.items()},
            "x": np.asarray(jgx)}
    assert set(grads) == set(want)
    for name, g in want.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 1e-3, name
        assert _rel(grads[name], g) < 1e-4, (name, _rel(grads[name], g))
    op.eval()
    with torch.no_grad():
        again = op(nbr_t, xt, rel)
    assert op.loss is None
    np.testing.assert_array_equal(again.numpy(), out.detach().numpy())


def test_reference_repulsive_gradient_is_nan():
    """What the port does not copy: the JAX op's gradient is NaN in its
    offset weights (the repulsive term's sqrt at 0); the port's is
    finite, and the regularizer's value is the same."""
    rng = np.random.default_rng(5)
    q, s, nbr, x = _op_inputs(rng, b=1, nq=8, ns=16, k=6, cin=4)
    kp = load_kernel_points(KP_RADIUS, 5, "center", seed=3)
    jop = jkp.KPConvOp(3, kp, EXTENT, deformable=True)
    v = jop.init(jax.random.PRNGKey(0), q, s, nbr, x)["params"]

    def reg_of(params):
        return jop.apply({"params": params}, q, s, nbr, x,
                         mutable=["losses"])[1]["losses"]["deform_reg"]

    jreg, jg = jax.jit(jax.value_and_grad(reg_of))(v)
    assert np.isnan(np.asarray(jg["offset_weights"])).all()
    op = KPConvOp(4, 3, kp, EXTENT, deformable=True)
    op.load_state_dict(from_flax(jax.tree.map(np.asarray, v), None))
    op.train()
    nbr_t = torch.from_numpy(nbr)
    op(nbr_t, torch.from_numpy(x), shared_rel(
        torch.from_numpy(q), torch.from_numpy(s), nbr_t, SHADOW_POS))
    op.loss.backward()
    assert torch.isfinite(op.offset_weights.grad).all()
    np.testing.assert_allclose(float(op.loss.detach()), float(jreg),
                               rtol=1e-5)


# --- the narrow deformable KPCNN ---------------------------------------------

def _fields(rng, b=2, n=128):
    """Clouds in a cube of side 0.4 (~6 points within a kernel's extent
    of 0.05 at level 0's deform radius), the second with a masked tail at
    the collate's padding (0.0): padded query rows."""
    pos = rng.uniform(0, 0.4, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 100:] = False
    pos[~mask] = 0.0
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x[~mask] = 0.0
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    return dict(pos=pos, x=x, mask=mask, y_reg=y,
                y_reg_mask=np.ones((b, 2), bool),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool))


def _host_aux(fields, modulated):
    post = jfactory.make_post_collate(JNet(modulated=modulated, **NARROW))
    aux = post(JBatch(**fields)).aux
    return {**fields, "aux": {k: np.asarray(a) for k, a in aux.items()}}


def _jbatch(fields):
    return JBatch(**{k: ({n: jnp.asarray(a) for n, a in v.items()}
                         if isinstance(v, dict) else jnp.asarray(v))
                     for k, v in fields.items()})


JNet = jkp.KPCNN


@pytest.fixture(scope="module")
def nets():
    """Per (route, modulated): the batch, the JAX variables (init, then
    non-trivial BN affine and running stats, offsets scaled up to move the
    kernel points), and the JAX eval forward, train loss, regularizer,
    gradients and one step of the paper's recipe, all with `_safe_sqrt`."""
    mp = pytest.MonkeyPatch()
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.sqrt = _safe_sqrt
    mp.setattr(jkp, "jnp", proxy)
    out = {}
    try:
        for route in ("device", "host"):
            for modulated in (False, True):
                rng = np.random.default_rng(7 + modulated)
                fields = _fields(rng)
                if route == "host":
                    fields = _host_aux(fields, modulated)
                out[(route, modulated)] = _jax_case(fields, modulated, rng)
    finally:
        mp.undo()
    return out


def _jax_case(fields, modulated, rng):
    jnet = JNet(modulated=modulated, **NARROW)
    jb = _jbatch(fields)
    v = jax.tree.map(np.asarray, jax.jit(jnet.init, static_argnames="train")(
        jax.random.PRNGKey(0), jb, train=False))

    def perturb(path, a):
        name = path[-1].key
        if name == "offset_weights":
            return (a * 0.1 / np.abs(a).mean()).astype(np.float32)
        if name == "offset_bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return (a + rng.normal(size=a.shape) * 0.05).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(s, np.float32)
                                       for k, s in STATS.items()})
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))
    eval_out = np.asarray(jax.jit(
        lambda vv, b: jnet.apply(vv, b, train=False))(
            {"params": params, "batch_stats": stats}, jb))

    def loss_fn(p, s, batch):
        # the loss of make_train_step's loss_fn
        reg_out, new_stats, internal = _forward(jnet, spec, p, s, batch,
                                                train=True)
        return jloss(spec, reg_out, batch.y_reg, batch.y_reg_mask,
                     True) + internal, (internal, new_stats)

    @jax.jit
    def step(p, s, batch):
        # make_train_step's update, with the gradients handed out
        (loss, (internal, s2)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, s, batch)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, internal, grads, optax.apply_updates(p, updates), s2

    loss, internal, grads, p2, s2 = step(params, stats, jb)
    return dict(fields=fields, params=params, stats=stats, eval=eval_out,
                loss=float(loss), internal=float(internal),
                grads=jax.tree.map(np.asarray, grads),
                after=(jax.tree.map(np.asarray, p2),
                       jax.tree.map(np.asarray, s2)))


def _net(case, modulated):
    net = KPCNN(modulated=modulated, **NARROW)
    net.load_state_dict(from_flax(case["params"], case["stats"]),
                        strict=True)
    return net


@pytest.mark.parametrize("modulated", [False, True], ids=["rigid_gate",
                                                          "modulated"])
@pytest.mark.parametrize("route", ["device", "host"])
def test_narrow_deformable_kpcnn_forward_matches_jax(nets, route,
                                                     modulated):
    """Eval forward rtol/atol 2e-4 (the rigid KPCNN's tolerance)."""
    case = nets[(route, modulated)]
    net = _net(case, modulated)
    net.eval()
    with torch.no_grad():
        got = net(Batch(**case["fields"]).to("cpu")).numpy()
    assert net.internal_losses() == {}
    np.testing.assert_allclose(got, case["eval"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("modulated", [False, True], ids=["rigid_gate",
                                                          "modulated"])
@pytest.mark.parametrize("route", ["device", "host"])
def test_narrow_deformable_kpcnn_train_step_matches_jax(nets, route,
                                                        modulated):
    """One step of the paper's recipe from the same weights: the loss with
    the deformable ops' regularizer rtol 1e-5 (the regularizer alone 1e-5),
    each gradient 1e-4 relative L2 (floored at 1e-3 of the global norm),
    the updated parameters and BN stats rtol 1e-4 / atol 1e-5."""
    case = nets[(route, modulated)]
    runner = train.build_runner(_net(case, modulated), STATS, seed=0)
    out = runner.train(Batch(**case["fields"]))
    terms = runner.net.internal_losses()
    assert sorted(terms) == ["block1_kpconv", "block2_kpconv"]
    np.testing.assert_allclose(
        sum(float(t.detach()) for t in terms.values()), case["internal"],
        rtol=1e-5)
    np.testing.assert_allclose(float(out["loss"]), case["loss"], rtol=1e-5)
    want = from_flax(jax.tree.map(lambda g: np.clip(g, -100, 100),
                                  case["grads"]), None)
    got = dict(runner.net.named_parameters())
    assert set(want) == set(got)
    total = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in want.values()))
    for name, g in want.items():
        a, b = got[name].grad.numpy(), g.numpy()
        assert np.isfinite(a).all(), name
        if "kpconv" in name:
            assert np.abs(b).max() > 0, name
        assert np.linalg.norm(a - b) < 1e-4 * max(np.linalg.norm(b),
                                                  1e-3 * total), \
            (name, _rel(a, b))
    sd = runner.net.state_dict()
    for name, w in from_flax(*case["after"]).items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_host_and_device_routes_park_padded_queries_differently(nets):
    """The fitting term averages over padded query rows too, as the JAX
    package's does: on the host pyramid they sit at the shadow with
    all-shadow neighbours (min_d2 = |kp + offset|^2), on the device
    pyramid at the collate's 0.0 with the shadow 1e6 away."""
    assert nets[("host", False)]["internal"] < 1e3
    assert nets[("device", False)]["internal"] > 1e9


def test_modulated_on_a_rigid_architecture_equals_the_rigid_net():
    """`modulated: True` changes nothing where no block is deformable, as
    in the JAX builder: same parameters from the same generator, same
    output."""
    arch = ["simple", "resnetb", "resnetb_strided", "resnetb", "global_sum"]
    option = {"config": {"architecture": arch, "first_features_dim": 16,
                         "num_kernel_points": 5,
                         "first_subsampling_dl": 0.1}}
    nets = [build_kpconv({"config": {**option["config"], "modulated": m}},
                         2, 3, torch.Generator().manual_seed(0))
            for m in (False, True)]
    assert nets[1].blocks == nets[0].blocks
    a, b = (n.state_dict() for n in nets)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    fields = _fields(np.random.default_rng(3), n=64)
    outs = []
    for n in nets:
        n.eval()
        with torch.no_grad():
            outs.append(n(Batch(**fields).to("cpu")))
    assert torch.equal(outs[0], outs[1])
    jnet = jkp.build_kpconv({"config": {**option["config"],
                                        "modulated": True}},
                            types.SimpleNamespace(feature_dimension=3,
                                                  num_reg_classes=2))
    assert jnet.modulated and not any("deformable" in b for b in
                                      jnet.architecture)
