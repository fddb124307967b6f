"""Every branch of the port's AdaBelief against the JAX `adabelief`: the 16
combinations of rectify, degenerated_to_sgd, decoupled_decay and
fixed_decay over 8 clipped updates that cross the rectification's num_sma
switch (rel 1e-6 on the parameters and both moments, as
tests/test_torch_train.py holds the default branch); `make_optimizer` with
the branch options against the JAX trainer's `_make_tx`; and a head group
with rectify=False against the JAX trainer's optax.multi_transform, the
port resuming from the JAX state through `load_jax_state`."""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.trainer import Trainer as JTrainer
from dpcr_agb_tpu_torch.training import optim

CAWR = {"class": "CosineAnnealingWarmRestarts",
        "params": {"T_0": 10, "T_mult": 2}}
BRANCHES = ("rectify", "degenerated_to_sgd", "decoupled_decay",
            "fixed_decay")
COMBOS = [dict(zip(BRANCHES, c))
          for c in itertools.product((True, False), repeat=4)]


def _sma(step):
    """num_sma of the rectification at update `step` (f32)."""
    s = np.float32(step)
    lb = np.float32(np.log(0.999))
    return np.float32(1999.0) - np.float32(2.0) * s * np.exp(s * lb) \
        / -np.expm1(s * lb)


def _grads(rng, shapes, step):
    # every third step beyond the clip at 100
    return {k: (rng.normal(size=s) * (300.0 if step % 3 == 0 else 1.0)
                ).astype(np.float32) for k, s in shapes.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("opts", COMBOS, ids=lambda o: "-".join(
    k if v else f"no_{k}" for k, v in o.items()))
def test_adabelief_branch_matches_the_optax_chain(opts):
    assert _sma(5) < 5 <= _sma(6)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.make_lr_fn(CAWR, 5e-3, "on_num_batch"), weight_decay=1e-2,
        **opts))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = optim.AdaBelief(list(params.values()), optim.make_lr_fn(
        CAWR, 5e-3, "on_num_batch"), weight_decay=1e-2, **opts)
    for step in range(8):
        grads = _grads(rng, shapes, step)
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        torch.nn.utils.clip_grad_value_(params.values(), 100.0)
        opt.step()
        ada = jstate[1]
        assert opt.param_groups[0]["count"] == int(ada.count) == step + 1
        for k, p in params.items():
            what = f"{opts} step {step} {k}"
            _close(p.detach().numpy(), np.asarray(jparams[k]), what)
            for name in ("exp_avg", "exp_avg_var"):
                np.testing.assert_allclose(
                    opt.state[p][name].numpy(),
                    np.asarray(getattr(ada, name)[k]), rtol=1e-6,
                    atol=1e-12, err_msg=f"{what} {name}")
    moved = [k for k in init if not np.array_equal(
        params[k].detach().numpy(), init[k])]
    assert moved


def test_make_optimizer_passes_the_branch_options_as_make_tx():
    """`training.optim.optimizer.params` with rectify=False and
    fixed_decay=True (and its `lr`, which both drop) through
    make_optimizer and through the JAX trainer's _make_tx (clip 0.05)."""
    params = {"lr": 5e-3, "weight_decay": 1e-2, "rectify": False,
              "fixed_decay": True}
    jlr = joptim.make_lr_fn(CAWR, 5e-3, "on_num_batch")
    tx = JTrainer._make_tx(None, "AdaBelief",
                           {k: v for k, v in params.items() if k != "lr"},
                           0.05, jlr)
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (6,)}
    jp = {k: rng.normal(size=s).astype(np.float32)
          for k, s in shapes.items()}
    st = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in jp.items()}
    opt = optim.make_optimizer("AdaBelief", tparams.values(),
                               optim.make_lr_fn(CAWR, 5e-3, "on_num_batch"),
                               dict(params))
    assert not opt.rectify and opt.fixed_decay and opt.decoupled_decay
    for step in range(8):
        grads = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
                 for k, s in shapes.items()}
        upd, st = tx.update(grads, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        torch.nn.utils.clip_grad_value_(tparams.values(), 0.05)
        opt.step()
        for k, p in tparams.items():
            _close(p.detach().numpy(), np.asarray(jp[k]), f"step {step} {k}")


def test_head_group_without_rectification_resumes_from_the_jax_state():
    """head_optim_settings {rectify: False, lr: 1e-3} over the `final`
    parameters, the backbone on the schedule: the JAX trainer's
    multi_transform (`_build_optimizer` on a stand-in trainer) takes 4
    steps, the port loads its state leaves through load_jax_state and
    both take 4 more."""
    jlr = joptim.make_lr_fn(CAWR, 5e-3, "on_num_batch")
    head = {"rectify": False, "lr": 1e-3}
    stand_in = types.SimpleNamespace(
        bundle=types.SimpleNamespace(head_optim_settings=head,
                                     backbone_optim_settings={},
                                     head_namespace="final"),
        lr_fn=jlr, _make_tx=lambda *a: JTrainer._make_tx(None, *a))
    optim_cfg = {"grad_clip": 100, "optimizer": {
        "class": "AdaBelief", "params": {"lr": 5e-3, "weight_decay": 1e-2}}}
    tx = JTrainer._build_optimizer(stand_in, optim_cfg)
    rng = np.random.default_rng(2)
    shapes = {"conv": {"kernel": (3, 4), "bias": (4,)},
              "final": {"kernel": (4, 2), "bias": (2,)}}
    jp = {m: {n: rng.normal(size=s).astype(np.float32)
              for n, s in v.items()} for m, v in shapes.items()}
    st = tx.init(jp)

    def grads_of(step):
        return {m: {n: (rng.normal(size=s) * (300.0 if step % 3 == 0
                                              else 1.0)).astype(np.float32)
                    for n, s in v.items()} for m, v in shapes.items()}

    steps = [grads_of(s) for s in range(8)]
    for g in steps[:4]:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
    tparams = {f"{m}.{n}": torch.nn.Parameter(torch.tensor(np.asarray(a)))
               for m, v in jp.items() for n, a in v.items()}
    opt = optim.make_grouped_optimizer(
        "AdaBelief", tparams, optim.make_lr_fn(CAWR, 5e-3, "on_num_batch"),
        {"lr": 5e-3, "weight_decay": 1e-2}, head, {})
    assert not opt.optimizers["head"].rectify
    assert opt.optimizers["backbone"].rectify
    opt.load_jax_state(tparams, jax.tree_util.tree_leaves(st))
    for step, g in enumerate(steps[4:], start=4):
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        for key, p in tparams.items():
            m, n = key.split(".")
            p.grad = torch.tensor(g[m][n])
        torch.nn.utils.clip_grad_value_(tparams.values(), 100.0)
        opt.step()
        for key, p in tparams.items():
            m, n = key.split(".")
            _close(p.detach().numpy(), np.asarray(jp[m][n]),
                   f"step {step} {key}")
    for g, w in zip(opt.jax_state(tparams), jax.tree_util.tree_leaves(st)):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=1e-6,
                                   atol=1e-12)
