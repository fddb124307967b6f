"""Parity of the port's KPConv train step with the JAX package on the CPU:
one step of the paper's recipe (elementwise clip at 100, AdaBelief 5e-3 with
weight decay 1e-2, CosineAnnealingWarmRestarts) on the narrow 5-block KPCNN
(first_features_dim 16, 5 kernel points, first_subsampling_dl 0.1) against
`make_train_step` over `KPCNN(fused_kernel=True)` (the Pallas kernels in
interpret mode, forward and backward) from the same weights: loss, every
gradient, the updated parameters and the BN running stats; a second step
from the carried optax state; the bf16 compute dtype; the training entry
point with `model_name=KPConv device=cpu`, and how many times a step goes
through the fused op."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
from dpcr_agb_tpu.models.kpconv import KPCNN as JNet
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import _forward, make_train_step
from dpcr_agb_tpu_torch import predict, train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.models.kpconv import KPCNN
from dpcr_agb_tpu_torch.ops import kpconv
from dpcr_agb_tpu_torch.training.state import (TRAIN_STATE_KEY,
                                               load_named_optimizer_state)
from dpcr_agb_tpu_torch.weights import from_flax, opt_state_from_optax

ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "global_sum"]
NARROW = dict(architecture=ARCH, num_reg_targets=2, in_features_dim=3,
              first_features_dim=16, num_kernel_points=5,
              first_subsampling_dl=0.1, use_batch_norm=True)
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}


def _fields(rng, b=3, n=64):
    pos = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 50:] = False
    mask[2, 41:] = False
    pos[~mask] = 0.0
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x[~mask] = 0.0
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    y[1, 0] = np.nan
    return dict(pos=pos, x=x, mask=mask, y_reg=y, y_reg_mask=~np.isnan(y),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool))


def _jbatch(fields):
    return JBatch(**{k: jnp.asarray(f) for k, f in fields.items()})


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_run():
    """JAX: init, then two train steps with the gradients of each."""
    rng = np.random.default_rng(0)
    batches = [_fields(rng) for _ in range(2)]
    jnet = JNet(fused_kernel=True, **NARROW)
    variables = _np(jnet.init(jax.random.PRNGKey(0), _jbatch(batches[0]),
                              train=False))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(v, np.float32)
                                       for k, v in STATS.items()})
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))

    def loss_fn(p, s, batch):
        reg_out, _, _ = _forward(jnet, spec, p, s, batch, train=True)
        return jloss(spec, reg_out, batch.y_reg, batch.y_reg_mask, True)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    step = make_train_step(jnet, spec, tx)
    p, s, o = params, stats, tx.init(params)
    states, losses, grads = [(params, stats, _np(o))], [], []
    for i in range(2):
        loss, g = grad_fn(p, s, _jbatch(batches[i]))
        grads.append(_np(g))
        p, s, o, out = step(p, s, o, _jbatch(batches[i]), np.int32(i))
        losses.append(float(out["loss"]))
        assert np.isclose(losses[-1], float(loss), rtol=1e-6)
        p, s, o = _np(p), _np(s), _np(o)
        states.append((p, s, o))
    return dict(batches=batches, states=states, losses=losses, grads=grads)


def _runner(params, stats, opt_state=None, step=0, **overrides):
    net = KPCNN(**{**NARROW, **overrides})
    net.load_state_dict(from_flax(params, stats), strict=True)
    runner = train.build_runner(net, STATS, seed=0)
    if opt_state is not None:
        load_named_optimizer_state(runner, opt_state_from_optax(opt_state))
        runner.step = step
    return runner


def _check_step(runner, jax_run, i):
    """Port step i from JAX state i (f32): loss rel 1e-5, each gradient
    rel-L2 1e-4, the updated parameters and BN stats rtol 1e-4."""
    out = runner.train(Batch(**jax_run["batches"][i]))
    np.testing.assert_allclose(float(out["loss"]), jax_run["losses"][i],
                               rtol=1e-5)
    want_g = from_flax(jax.tree.map(lambda g: np.clip(g, -100, 100),
                                    jax_run["grads"][i]), None)
    got = dict(runner.net.named_parameters())
    assert set(want_g) == set(got)
    total = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in want_g.values()))
    for name, g in want_g.items():
        a, b = got[name].grad.numpy(), g.numpy()
        assert np.linalg.norm(a - b) < 1e-4 * max(np.linalg.norm(b),
                                                  1e-3 * total), \
            (name, _rel(a, b))
    p, s, _ = jax_run["states"][i + 1]
    sd = runner.net.state_dict()
    for name, w in from_flax(p, s).items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    return got


def test_kpconv_train_step_from_a_fresh_state_matches_jax(jax_run):
    params, stats, _ = jax_run["states"][0]
    runner = _runner(params, stats)
    got = _check_step(runner, jax_run, 0)
    assert runner.step == 1 and runner.num_samples == 3
    # every KPConv weight got a gradient that is not rounding noise
    for name, p in got.items():
        if name.endswith("_kpconv.weights"):
            assert float(p.grad.abs().max()) > 1e-6, name


def test_kpconv_train_step_after_carrying_the_optax_state_matches_jax(
        jax_run):
    params, stats, opt_state = jax_run["states"][1]
    runner = _runner(params, stats, opt_state, step=1)
    assert runner.optimizer.param_groups[0]["count"] == 1
    _check_step(runner, jax_run, 1)
    named = opt_state_from_optax(jax_run["states"][2][2])
    total = {k: np.sqrt(sum(float((v.double() ** 2).sum())
                            for v in named[k].values()))
             for k in ("exp_avg", "exp_avg_var")}
    for name, prm in runner.net.named_parameters():
        st = runner.optimizer.state[prm]
        for k in ("exp_avg", "exp_avg_var"):
            a, b = st[k].numpy(), named[k][name].numpy()
            assert np.linalg.norm(a - b) < 1e-4 * max(
                np.linalg.norm(b), 1e-3 * total[k]), (name, k, _rel(a, b))


def test_bf16_train_step_stays_close_to_the_f32_one(jax_run):
    """bf16 is the compute dtype of the fused op only: parameters,
    gradients and BN stats stay f32, and one step lands near the f32 step
    (loss 2e-2; all gradients as one vector 5e-2, each rounding is 2^-8
    and four KPConvs follow one another)."""
    params, stats, _ = jax_run["states"][0]
    batch = Batch(**jax_run["batches"][0])
    r32, r16 = _runner(params, stats), _runner(params, stats,
                                               dtype=torch.bfloat16)
    l32, l16 = float(r32.train(batch)["loss"]), float(r16.train(batch)["loss"])
    np.testing.assert_allclose(l16, l32, rtol=2e-2)
    g32 = torch.cat([p.grad.reshape(-1) for p in r32.net.parameters()])
    g16 = torch.cat([p.grad.reshape(-1) for p in r16.net.parameters()])
    assert g16.dtype == torch.float32 and torch.isfinite(g16).all()
    assert _rel(g16.numpy(), g32.numpy()) < 5e-2
    assert all(t.dtype in (torch.float32, torch.int64)
               for t in r16.net.state_dict().values())


def _write_plots(root, n=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, bm, v = generate_plot(rng, radius=6.0, density=3.0)
        np.savez(os.path.join(root, f"p{i}.npz"),
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=np.nan if i == 1 else v)


@pytest.mark.parametrize("bf16", ["false", "true"], ids=["f32", "bf16"])
def test_train_entry_point_trains_kpconv_and_predict_serves_it(
        tmp_path, monkeypatch, bf16):
    """Full width on tiny plots: 2 steps at bs2, 14 passes through the
    fused op a forward and 14 through its backward a step, a checkpoint
    that records the model and the xy preset, and finite predictions."""
    calls = {"fwd": 0, "bwd": 0, "dtypes": set()}
    fwd, bwd = kpconv.kpconv_forward, kpconv.kpconv_backward

    def count_fwd(x, *a, **k):
        calls["fwd"] += 1
        calls["dtypes"].add(x.dtype)
        return fwd(x, *a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(kpconv, "kpconv_forward", count_fwd)
    monkeypatch.setattr(kpconv, "kpconv_backward", count_bwd)
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots)
    out = train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                      "model_name=KPConv", "steps=2", "batch_size=2",
                      "device=cpu", f"bf16={bf16}"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert calls["fwd"] == 28 and calls["bwd"] == 28
    assert calls["dtypes"] == {torch.bfloat16 if bf16 == "true"
                               else torch.float32}
    saved = torch.load(out["checkpoint"], map_location="cpu",
                       weights_only=True)
    assert saved["model_name"] == "KPConv"
    assert saved["data"]["transform_type"] == "xy"
    assert saved["option"]["class"] == "kpconv.KPConv"
    assert bool(saved["option"]["extra_options"].get("bf16", False)) \
        == (bf16 == "true")
    assert saved[TRAIN_STATE_KEY]["step"] == 2
    path = predict.main([f"checkpoint_dir={ckpt}", "model_name=KPConv",
                         f"input={plots}/*.npz", f"output={tmp_path}/p.csv",
                         "device=cpu"])
    assert calls["fwd"] == 28 + 14
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    preds = np.array([[float(x) for x in r[1:]] for r in rows])
    assert preds.shape == (3, 2) and np.isfinite(preds).all()


def test_unknown_model_names_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="KPConv"):
        train.model_option("PointNeXt", bf16=False)
