"""The configuration surface of the port against the JAX package's: every
name a config can give, with every keyword, works in both. For each of
the 65 registered transforms, for AdaBelief (the JAX `adabelief`'s
`learning_rate` is the port's `lr_fn`) and for each scheduler that
`make_lr_fn` builds, every parameter of the JAX callable is a parameter of
the port's with the same kind and an equal default (the port may take
more); `bn_momentum_fn` reads the same keys with the same defaults."""
import inspect

import pytest

from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.transforms import TRANSFORM_REGISTRY as JREG
from dpcr_agb_tpu_torch.training import optim as toptim
from dpcr_agb_tpu_torch.transforms import TRANSFORM_REGISTRY as TREG


def _params(fn, rename=None):
    """name -> (kind, default) of fn's parameters, `self` left out."""
    rename = rename or {}
    return {rename.get(p.name, p.name): (p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name != "self"}


def _assert_covers(want_fn, got_fn, rename=None):
    want = _params(want_fn, rename)
    got = _params(got_fn)
    for name, (kind, default) in want.items():
        assert name in got, f"{name} missing"
        assert got[name][0] == kind, (name, got[name][0], kind)
        assert got[name][1] == default, (name, got[name][1], default)


def test_the_registries_hold_the_same_65_names():
    assert set(TREG) == set(JREG) and len(JREG) == 65


@pytest.mark.parametrize("name", sorted(JREG))
def test_transform_takes_every_jax_keyword(name):
    _assert_covers(JREG[name].__init__, TREG[name].__init__)


def test_adabelief_takes_every_jax_keyword():
    # the JAX transform takes the params after learning_rate; the port's
    # optimizer takes the torch parameters before them
    _assert_covers(joptim.adabelief, toptim.AdaBelief.__init__,
                   rename={"learning_rate": "lr_fn"})
    got = list(_params(toptim.AdaBelief.__init__))
    assert got[:2] == ["params", "lr_fn"]


def _builder(module, entry):
    """The named schedule function behind a SCHEDULERS entry (an entry
    may be a lambda around one)."""
    if entry.__name__ != "<lambda>":
        return entry
    called = [getattr(module, n) for n in entry.__code__.co_names
              if inspect.isfunction(getattr(module, n, None))]
    assert len(called) == 1, entry.__code__.co_names
    return called[0]


def test_make_lr_fn_builds_the_same_schedulers():
    assert set(toptim.SCHEDULERS) == set(joptim.SCHEDULERS)
    _assert_covers(joptim.make_lr_fn, toptim.make_lr_fn)


@pytest.mark.parametrize("name", sorted(joptim.SCHEDULERS))
def test_scheduler_takes_every_jax_keyword(name):
    want = _builder(joptim, joptim.SCHEDULERS[name])
    got = _builder(toptim, toptim.SCHEDULERS[name])
    assert want.__name__ == got.__name__
    _assert_covers(want, got)


def test_bn_momentum_fn_reads_the_same_keys_and_defaults():
    _assert_covers(joptim.bn_momentum_fn, toptim.bn_momentum_fn)
    for params in ({}, {"bn_momentum": 0.3}, {"bn_decay": 0.5},
                   {"decay_step": 2}, {"bn_clip": 0.2}):
        cfg = {"params": params}
        want, got = joptim.bn_momentum_fn(cfg), toptim.bn_momentum_fn(cfg)
        assert [got(e) for e in range(40)] == [want(e) for e in range(40)]
