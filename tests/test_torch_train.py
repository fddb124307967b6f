"""Parity of the port's training path with the JAX package on the CPU: the
clip + AdaBelief + CosineAnnealingWarmRestarts chain against optax, the
standardized regression loss, and one train step of a narrow SENet14
(planes 16,16,32,32, init_dim 16, drop_path 0, dense_dims (12,12,12), z
bucket 8) from the same weights: loss, every gradient, the updated
parameters and the BN running stats, from a fresh state and after 5 JAX
steps whose optimizer state is carried across; then evaluate and calibrate
against `make_eval_step`. Inputs are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import (_forward, make_eval_step,
                                        make_train_step)
from dpcr_agb_tpu_torch import train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models.base import InstanceSpec, compute_reg_loss
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet
from dpcr_agb_tpu_torch.training import optim
from dpcr_agb_tpu_torch.training.state import load_named_optimizer_state
from dpcr_agb_tpu_torch.weights import from_flax, opt_state_from_optax

CAWR = {"class": "CosineAnnealingWarmRestarts",
        "params": {"T_0": 10, "T_mult": 2}}


# ---- schedules and optimizer ----------------------------------------------

@pytest.mark.parametrize("cfg,update_on", [
    (CAWR, "on_num_batch"),
    ({"class": "CosineAnnealingWarmRestarts", "params": {"T_0": 7}},
     "on_num_batch"),
    (CAWR, "on_epoch"),
    (None, "on_num_batch"),
])
def test_lr_schedule_matches_jax(cfg, update_on):
    """f32 closed forms, rel 1e-6, across two warm restarts."""
    mine = optim.make_lr_fn(cfg, 5e-3, update_on, batches_per_epoch=3)
    ref = joptim.make_lr_fn(cfg, 5e-3, update_on, batches_per_epoch=3)
    for count in range(0, 95):
        np.testing.assert_allclose(float(mine(count)), float(ref(count)),
                                   rtol=1e-6, atol=0)


def test_bn_momentum_schedule_matches_jax():
    cfg = {"params": {"bn_momentum": 0.1, "bn_decay": 0.5, "decay_step": 3,
                      "bn_clip": 0.02}}
    mine, ref = optim.bn_momentum_fn(cfg), joptim.bn_momentum_fn(cfg)
    assert [mine(e) for e in range(12)] == [ref(e) for e in range(12)]
    assert optim.bn_momentum_fn(None) is None


def _sma(step):
    """num_sma of AdaBelief's rectification at update `step` (f32)."""
    s = np.float32(step)
    lb = np.float32(np.log(0.999))
    return np.float32(1999.0) - np.float32(2.0) * s * np.exp(s * lb) \
        / -np.expm1(s * lb)


def test_clip_adabelief_cawr_match_the_optax_chain():
    """8 updates of a small tree with weight decay on, crossing the SGD ->
    adaptive switch of the rectification; gradients include values beyond
    the clip at 100. rel 1e-6 on the parameters and the moments."""
    assert _sma(5) < 5 <= _sma(6)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.make_lr_fn(CAWR, 5e-3, "on_num_batch"), weight_decay=1e-2))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = optim.AdaBelief(list(params.values()), optim.make_lr_fn(
        CAWR, 5e-3, "on_num_batch"), weight_decay=1e-2)
    for step in range(8):
        grads = {k: (rng.normal(size=s) * (300.0 if step % 3 == 0 else 1.0)
                     ).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        torch.nn.utils.clip_grad_value_(params.values(), 100.0)
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7)
        ada = jstate[1]
        assert opt.param_groups[0]["count"] == int(ada.count) == step + 1
        for k, p in params.items():
            for name in ("exp_avg", "exp_avg_var"):
                np.testing.assert_allclose(
                    opt.state[p][name].numpy(),
                    np.asarray(getattr(ada, name)[k]), rtol=1e-6, atol=1e-12)


# ---- loss -------------------------------------------------------------------

@pytest.mark.parametrize("losses,double,training", [
    (("smoothl1",), False, True),
    (("smoothl1", "l2", "l1", "mape", "smape"), False, True),
    (("smoothl1",), True, True),
    (("l2", "smape"), True, True),
    (("smoothl1",), True, False),
], ids=["smoothl1", "all-five", "double-batch", "double-two-losses",
        "double-eval"])
def test_reg_loss_matches_jax(losses, double, training):
    """NaN targets behind the mask, a partly masked sample, a sample with no
    target, large errors (the linear part of smooth-L1); rel 1e-6."""
    rng = np.random.default_rng(1)
    b, t = 6, 2
    out = (rng.normal(size=(b, t)) * 2).astype(np.float32)
    y = rng.uniform(50, 300, (b, t)).astype(np.float32)
    y[0, 1] = y[3, 0] = np.nan
    ymask = ~np.isnan(y)
    ymask[4] = False
    ymask[1, 0] = False
    y[5, 1] = 0.0                      # mape's zero-target branch
    kw = dict(num_reg_targets=t, scale=np.array([40.0, 80.0], np.float32),
              center=np.array([120.0, 200.0], np.float32),
              weights=np.array([0.3, 0.9], np.float32), loss_names=losses,
              double_batch=double)
    want = float(jloss(JSpec(**kw), jnp.asarray(out), jnp.asarray(y),
                       jnp.asarray(ymask), training=training))
    got = compute_reg_loss(InstanceSpec(**kw), torch.from_numpy(out),
                           torch.from_numpy(y), torch.from_numpy(ymask),
                           training=training)
    assert got.dtype == torch.float32 and np.isfinite(want)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_reg_loss_of_an_all_masked_batch_is_zero():
    kw = dict(num_reg_targets=1, scale=np.ones(1, np.float32),
              center=np.zeros(1, np.float32), weights=np.ones(1, np.float32))
    got = compute_reg_loss(InstanceSpec(**kw), torch.ones(3, 1),
                           torch.full((3, 1), float("nan")),
                           torch.zeros(3, 1, dtype=torch.bool), True)
    assert float(got) == 0.0


# ---- the train step of a narrow SENet14 -------------------------------------

NARROW = dict(block="se_basic", layers=(1, 1, 1, 1), planes=(16, 16, 32, 32),
              init_dim=16, activation="gelu", first_stride=1,
              global_pool="sum", drop_path=0.0, dense_dims=(12, 12, 12))
ZB = 8
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}


def _fields(rng, b=4, v=96):
    coords = np.full((b, v, 3), -(2 ** 20), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        n = int(rng.integers(50, 90))
        flat = rng.choice(12 * 12 * ZB, size=n, replace=False)
        coords[i, :n] = np.stack([flat // (12 * ZB), (flat // ZB) % 12,
                                  flat % ZB], 1)
        mask[i, :n] = True
    x = np.where(mask[..., None], rng.uniform(0, 1, (b, v, 3)), 0)
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    y[1, 0] = np.nan
    return dict(pos=np.zeros((b, v, 3), np.float32), x=x.astype(np.float32),
                mask=mask, y_reg=y, y_reg_mask=~np.isnan(y),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool), coords=coords,
                aux={"zcells": np.zeros(ZB, np.int8)})


def _jbatch(fields):
    return JBatch(**{k: jax.tree.map(jnp.asarray, f)
                     for k, f in fields.items()})


def _jspec():
    return JSpec(num_reg_targets=2, **{k: np.asarray(v, np.float32)
                                       for k, v in STATS.items()})


def _jtx():
    return optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_run():
    """JAX: init, the grads of step 1, 6 steps, and eval/calibrate after
    step 5 on a fresh batch."""
    rng = np.random.default_rng(0)
    batches = [_fields(rng) for _ in range(7)]
    jnet = JNet(num_reg_targets=2, **NARROW)
    variables = _np(jax.jit(lambda b: jnet.init(
        jax.random.PRNGKey(0), b, train=False))(_jbatch(batches[0])))
    # non-trivial BN affine and running stats
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    spec, tx = _jspec(), _jtx()

    def loss_fn(p, s, batch):
        reg_out, _, _ = _forward(jnet, spec, p, s, batch, train=True)
        return jloss(spec, reg_out, batch.y_reg, batch.y_reg_mask, True)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    step = make_train_step(jnet, spec, tx)
    p, s, o = params, stats, tx.init(params)
    states, losses, grads = [(params, stats, _np(o))], [], []
    for i in range(6):
        loss, g = grad_fn(p, s, _jbatch(batches[i]))
        grads.append(_np(g))
        p, s, o, out = step(p, s, o, _jbatch(batches[i]), np.int32(i))
        losses.append(float(out["loss"]))
        assert np.isclose(losses[-1], float(loss), rtol=1e-6)
        p, s, o = _np(p), _np(s), _np(o)
        states.append((p, s, o))
    p5, s5, _ = states[5]
    eval_out = make_eval_step(jnet, spec)(p5, s5, _jbatch(batches[6]),
                                          np.int32(0))[1]
    calib_stats, calib_out = make_eval_step(jnet, spec, train_mode=True)(
        p5, s5, _jbatch(batches[6]), np.int32(0))
    return dict(batches=batches, states=states, losses=losses, grads=grads,
                eval=_np(eval_out), calib=(_np(calib_stats), _np(calib_out)))


def _runner(params, stats, opt_state=None, step=0):
    net = SparseResNet(num_reg_targets=2, in_channels=3, **NARROW)
    net.load_state_dict(from_flax(params, stats), strict=True)
    runner = train.build_runner(net, STATS, seed=0)
    if opt_state is not None:
        load_named_optimizer_state(runner, opt_state_from_optax(opt_state))
        runner.step = step
    return runner


def _check_step(runner, jax_run, i):
    """Port step i from JAX state i: loss, clipped grads, new params and BN
    running stats (f32: loss rel 1e-5, each gradient rel-L2 1e-4, params
    and stats rel 1e-4)."""
    out = runner.train(Batch(**jax_run["batches"][i]))
    np.testing.assert_allclose(float(out["loss"]), jax_run["losses"][i],
                               rtol=1e-5)
    want_g = from_flax(jax.tree.map(lambda g: np.clip(g, -100, 100),
                                    jax_run["grads"][i]), None)
    got = dict(runner.net.named_parameters())
    assert set(want_g) == set(got)
    total = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in want_g.values()))
    zero = set()
    for name, g in want_g.items():
        a, b = got[name].grad.numpy(), g.numpy()
        if np.linalg.norm(b) < 1e-6 * total:
            # a conv bias ahead of a train-mode BN: its gradient is zero up
            # to f32 rounding on both sides
            assert np.linalg.norm(a) < 1e-6 * total, name
            zero.add(name)
        else:
            assert _rel(a, b) < 1e-4, (name, _rel(a, b))
    p, s, _ = jax_run["states"][i + 1]
    want = from_flax(p, s)
    sd = runner.net.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert 0 < len(zero) < len(want_g) // 4
    return zero


def test_train_step_from_a_fresh_state_matches_jax(jax_run):
    params, stats, _ = jax_run["states"][0]
    runner = _runner(params, stats)
    _check_step(runner, jax_run, 0)
    assert runner.step == 1 and runner.num_samples == 4


def test_train_step_after_carrying_the_optax_state_matches_jax(jax_run):
    """5 JAX steps (the SGD branch), the state carried across with
    opt_state_from_optax, then step 6 (the adaptive branch) on both."""
    params, stats, opt_state = jax_run["states"][5]
    runner = _runner(params, stats, opt_state, step=5)
    assert runner.optimizer.param_groups[0]["count"] == 5
    zero = _check_step(runner, jax_run, 5)
    named = opt_state_from_optax(jax_run["states"][6][2])
    for name, prm in runner.net.named_parameters():
        st = runner.optimizer.state[prm]
        for k in ("exp_avg", "exp_avg_var"):
            a, b = st[k].numpy(), named[k][name].numpy()
            if name in zero:   # moments of f32 rounding noise, both tiny
                assert np.abs(a).max() < 1e-7 and np.abs(b).max() < 1e-7
            else:
                assert _rel(a, b) < 1e-4, (name, k, _rel(a, b))


def test_evaluate_and_calibrate_match_make_eval_step(jax_run):
    params, stats, _ = jax_run["states"][5]
    batch = Batch(**jax_run["batches"][6])
    runner = _runner(params, stats)
    out = runner.evaluate(batch)
    np.testing.assert_allclose(float(out["loss"]),
                               float(jax_run["eval"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(out["reg_out"].numpy(),
                               jax_run["eval"]["reg_out"], rtol=1e-4)
    cal = runner.calibrate(batch)
    calib_stats, calib_out = jax_run["calib"]
    np.testing.assert_allclose(cal["reg_out"].numpy(), calib_out["reg_out"],
                               rtol=1e-4)
    sd = runner.net.state_dict()
    for name, w in from_flax({}, calib_stats).items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # calibrate leaves the parameters and the optimizer alone
    for name, w in from_flax(params, {}).items():
        np.testing.assert_array_equal(sd[name].numpy(), w.numpy())
    assert runner.step == 0 and not runner.net.training
