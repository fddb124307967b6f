"""The trainer's options against the JAX package on the CPU: the parameter
regularizers (`training/regularizers.py`: values, gradients and the set
of exempt parameters on SENet14, KPConv and PointNeXt-S at full width),
per-group optimizer settings (`head_optim_settings`,
`backbone_optim_settings`: the JAX trainer's optax.multi_transform) with a
regularizer through the root grammar on MPointNet (24 synthetic plots,
bs4): the JAX trainer trains epoch 1 and writes its `.ckpt`; both
trainers resume from it (the port reads the multi_transform state) and
take one step of epoch 2; the two `.ckpt` files then hold the same
optimizer leaves
in the same order (so each package reads the other's) and the same
weights, each tensor within 1e-4 relative L2. Then a per-group `.pt`
train state round trip, and the visualizer's tensorboard and wandb
panels against stub modules put into `sys.modules`, and with neither
package importable."""
import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dpcr_agb_tpu.config import load_config as jload  # noqa: E402
from dpcr_agb_tpu.ops import layout as jlayout  # noqa: E402
from dpcr_agb_tpu.training import regularizers as jreg  # noqa: E402
from dpcr_agb_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from dpcr_agb_tpu.visualization.visualizer import \
    Visualizer as JVisualizer  # noqa: E402
from dpcr_agb_tpu_torch import train as ttrain  # noqa: E402
from dpcr_agb_tpu_torch.config import load_config as tload  # noqa: E402
from dpcr_agb_tpu_torch.models.factory import build_model  # noqa: E402
from dpcr_agb_tpu_torch.training import optim as toptim  # noqa: E402
from dpcr_agb_tpu_torch.training import regularizers as treg  # noqa: E402
from dpcr_agb_tpu_torch.training.state import (  # noqa: E402
    Checkpoint, load_named_optimizer_state, load_train_state,
    save_train_checkpoint)
from dpcr_agb_tpu_torch.training.trainer import Trainer as TTrainer  # noqa
from dpcr_agb_tpu_torch.visualization.visualizer import \
    Visualizer as TVisualizer  # noqa: E402
from dpcr_agb_tpu_torch.weights import (opt_state_from_optax,  # noqa: E402
                                        to_flax)

CONF = os.path.join(ROOT, "conf")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _jax_layout_restored():
    """The JAX trainer's StepRunner sets the JAX package's batch layout
    (`dpcr_agb_tpu.ops.layout`) for its 8-device mesh and leaves it set:
    the files that run after this one in the same test worker get it back
    as it was (a leaked per-sample layout moved the JAX reference of
    `tests/test_torch_train.py` past its tolerance)."""
    saved = (jlayout.BATCH_LOCAL, jlayout.DATA_PARALLEL_DEGREE)
    yield
    jlayout.set_batch_local(*saved)


# --- regularizers ------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """SENet14, KPConv and PointNeXt-S at full width, seeded weights."""
    out = {}
    for name in ("SENet14", "KPConv", "PointNext"):
        net, _ = build_model(ttrain.model_option(name, bf16=False), 2, 3,
                             generator=torch.Generator().manual_seed(1))
        out[name] = net
    return out


@pytest.mark.parametrize("name", ["SENet14", "KPConv", "PointNext"])
def test_regularizers_exempt_the_same_parameters_as_jax(models, name):
    """Each parameter filled with its own index: the JAX package's
    penalized leaves are the port's penalized names, and the norms'
    parameters (some of them) are the exempt ones."""
    net = models[name]
    named = dict(net.named_parameters())
    index = {n: i for i, n in enumerate(sorted(named))}
    tagged = {n: torch.full((1,), float(index[n])) for n in named}
    params, _ = to_flax(tagged)
    want = sorted(int(np.asarray(a)[0]) for a in
                  jreg._penalized_leaves(params))
    got = sorted(index[n] for n in treg.penalized_names(named))
    assert got == want
    exempt = set(named) - set(treg.penalized_names(named))
    assert exempt and all("norm" in n.lower() or "bn" in n for n in exempt)


@pytest.mark.parametrize("name,reg", [
    ("SENet14", {"type": "elastic", "lambda": 1e-4}),
    ("KPConv", {"type": "elastic", "lambda": 1e-4}),
    ("PointNext", {"type": "elastic", "lambda": 1e-4}),
    ("KPConv", {"type": "L1", "lambda": 1e-3}),
    ("KPConv", {"type": "L2", "lambda": 1e-2}),
    ("KPConv", {"type": "ELASTIC", "lambda": 1e-4, "alpha": 0.3})],
    ids=["elastic-SENet14", "elastic-KPConv", "elastic-PointNext",
         "L1-KPConv", "L2-KPConv", "ELASTIC_alpha-KPConv"])
def test_regularizer_value_and_gradient_match_jax(models, name, reg):
    """The penalty rtol 1e-6 and its gradient in every parameter 1e-6
    relative L2 (the norms' exactly 0; L1's derivative at a zero weight
    +1, as jnp.abs's)."""
    net = models[name]
    fn = treg.build_regularizer({"regularizers": reg})
    jfn = jreg.build_regularizer({"regularizers": reg})
    named = dict(net.named_parameters())
    net.zero_grad()
    value = fn(named)
    value.backward()
    params, _ = to_flax({n: p.detach() for n, p in named.items()})
    jvalue, jgrad = jax.jit(jax.value_and_grad(jfn))(
        jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(float(value.detach()), float(jvalue),
                               rtol=1e-6)
    flat = dict(_leaves(jgrad))
    for n, p in named.items():
        want = np.asarray(flat[n])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        if not np.any(want):
            assert not np.any(got), n
        else:
            assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(
                want), n


def test_build_regularizer_edges():
    for build in (treg.build_regularizer, jreg.build_regularizer):
        assert build({}) is None
        assert build({"regularizers": {"type": "L2", "lambda": 0.0}}) is None
        with pytest.raises(ValueError, match="Unknown regularizer"):
            build({"regularizers": {"type": "L3", "lambda": 1.0}})


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# --- per-group optimizer settings through the root grammar -------------------

GROUP_OPTS = ["+models.MPointNet.head_optim_settings={lr: 1e-4}",
              "+models.MPointNet.backbone_optim_settings="
              "{weight_decay: 0.02, b1: 0.8}",
              "+models.MPointNet.regularizers={type: elastic, lambda: 1e-4}"]


def _overrides(data, run, epochs, *extra):
    return ["task=instance", "models=instance/minkowski_baseline",
            "model_name=MPointNet", "data=instance/synthetic/reg",
            "data.transform_type=sparse_xy", "data.synthetic_plots=24",
            f"data.dataroot={data}", "training=nfi/minkowski",
            f"training.epochs={epochs}", "training.batch_size=4",
            "training.num_workers=2", "lr_scheduler=cosineawr",
            "update_lr_scheduler_on=on_num_batch", "visualization=eval",
            f"run_dir={run}", *GROUP_OPTS, *extra]


def _ckpt(path):
    with open(path, "rb") as f:
        return Checkpoint.from_bytes(f.read())


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    data, j1 = str(tmp / "data"), str(tmp / "j1")
    jt = JTrainer(jload(CONF, "config", _overrides(data, j1, 1)))
    jt.train()
    # epoch 2: one step, then the val and test stages on one batch each
    resume = (f"training.checkpoint_dir={j1}", "debugging.num_batches=1")
    JTrainer(jload(CONF, "config", _overrides(data, str(tmp / "j2"), 2,
                                              *resume))).train()
    port = TTrainer(tload(CONF, "config", _overrides(
        data, str(tmp / "t2"), 2, *resume)), device=CPU)
    port.train()
    return {"tmp": tmp, "port": port, "jax_opt_state": jt.state.opt_state}


def test_grouped_optimizer_splits_at_the_head_namespace(grouped):
    opt = grouped["port"].runner.optimizer
    assert isinstance(opt, toptim.MultiTransform)
    assert opt.names["head"] == [n for n in opt.names["head"]
                                 if n.startswith("final.")]
    assert len(opt.names["head"]) == 4 and len(opt.names["backbone"]) == 15
    assert opt.scheduled == ["backbone"]
    head = opt.optimizers["head"].param_groups[0]
    back = opt.optimizers["backbone"].param_groups[0]
    assert head["lr"] == pytest.approx(1e-4) and head["weight_decay"] == 0.01
    assert back["b1"] == 0.8 and back["weight_decay"] == 0.02
    assert grouped["port"].runner.regularizer is not None


def test_the_jax_multi_transform_state_reads_into_the_port(grouped):
    """The JAX trainer's epoch-1 state (`backbone`, then `head`, each a
    masked clip + AdaBelief chain) through `opt_state_from_optax` and
    through the `.ckpt` leaves name the same tensors."""
    named = opt_state_from_optax(grouped["jax_opt_state"])
    assert sorted(named) == ["backbone", "head"]
    assert all(k.startswith("final.") for k in named["head"]["exp_avg"])
    assert not any(k.startswith("final.")
                   for k in named["backbone"]["exp_avg"])
    tr = grouped["port"]
    load_named_optimizer_state(tr.runner, named)
    flat = toptim.jax_state(tr.runner.optimizer,
                            dict(tr.net.named_parameters()))
    leaves = jax.tree_util.tree_leaves(grouped["jax_opt_state"])
    assert [np.shape(a) for a in flat] == [np.shape(a) for a in leaves]
    for a, b in zip(flat, leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_resumed_step_with_groups_and_a_regularizer_matches_jax(grouped):
    """One step of epoch 2 by both trainers from the JAX epoch-1 `.ckpt`
    (over a whole epoch MPointNet's two trainers drift apart by ~3e-4 with
    or without the options): the same optimizer name, the same number,
    order and shapes of optimizer leaves (each group's count exact), every
    leaf and every weight of `latest` within 1e-4 relative L2."""
    tmp = grouped["tmp"]
    j, t = (_ckpt(tmp / d / "MPointNet.ckpt") for d in ("j2", "t2"))
    assert j.optimizer[0] == t.optimizer[0]
    jl = j.optimizer[1]["opt_state"]["flat"]
    tl = t.optimizer[1]["opt_state"]["flat"]
    assert [np.shape(a) for a in tl] == [np.shape(a) for a in jl]
    for i, (a, b) in enumerate(zip(tl, jl)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.ndim == 0:
            assert a == b, i
        else:
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), i
    jw, tw = (dict(_leaves(c.get_model_state("latest")["params"]))
              for c in (j, t))
    assert sorted(jw) == sorted(tw)
    for k in jw:
        a, b = np.asarray(tw[k], np.float64), np.asarray(jw[k], np.float64)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), k


def test_a_grouped_train_state_round_trips_through_the_pt(grouped, tmp_path):
    tr = grouped["port"]
    path = save_train_checkpoint(
        str(tmp_path), "MPointNet", tr.runner, tr.option, 3, {},
        {"scale": [1.0, 1.0], "center": [0.0, 0.0], "weights": [0.5, 0.5]},
        ["BMag_ha", "V_ha"])
    assert os.path.exists(path)
    fresh = TTrainer(tload(CONF, "config", _overrides(
        str(grouped["tmp"] / "data"), str(tmp_path / "run"), 1)),
        device=CPU)
    load_train_state(fresh.runner, str(tmp_path), "MPointNet")
    for k in toptim.GROUPS:
        a = fresh.runner.optimizer.optimizers[k]
        b = tr.runner.optimizer.optimizers[k]
        assert a.param_groups[0]["count"] == b.param_groups[0]["count"] > 0
        for pa, pb in zip(a.param_groups[0]["params"],
                          b.param_groups[0]["params"]):
            assert torch.equal(a.state[pa]["exp_avg"], b.state[pb]["exp_avg"])


# --- the visualizer's panels -------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []


def _stubs(rec):
    tb = types.ModuleType("torch.utils.tensorboard")

    class SummaryWriter:
        def __init__(self, log_dir):
            rec.calls.append(("writer", os.path.basename(log_dir)))

        def add_mesh(self, tag, vertices, colors=None, config_dict=None,
                     global_step=None):
            rec.calls.append(("mesh", tag, np.asarray(vertices),
                              np.asarray(colors), config_dict, global_step))

    tb.SummaryWriter = SummaryWriter
    wandb = types.ModuleType("wandb")
    wandb.run = object()
    wandb.Object3D = lambda a: ("obj3d", np.asarray(a))
    wandb.log = lambda d, commit=True: rec.calls.append(
        ("wandb", sorted(d), [v[1] for v in d.values()], commit))
    return {"torch.utils.tensorboard": tb, "wandb": wandb}


def _drive(cls, save_dir):
    rng = np.random.default_rng(0)
    viz = cls({"format": ["csv", "tensorboard", "wandb"],
               "num_samples_per_epoch": 3, "wandb_max_points": 40},
              {"test": 2}, 4, str(save_dir))
    assert viz.wants_pos and viz.is_active
    viz.reset(2, "test")
    for _ in range(2):
        pos = rng.uniform(0, 10, (4, 60, 3)).astype(np.float32)
        pos_mask = np.ones((4, 60), bool)
        pos_mask[1, 30:] = False
        viz.save_visuals(rng.normal(size=(4, 2)), rng.normal(size=(4, 2)),
                         np.zeros(4, np.int32), np.arange(4),
                         ["SYNTH"], ["BMag_ha", "V_ha"],
                         sample_mask=np.array([True, True, False, True]),
                         pos=pos, pos_mask=pos_mask)
    viz.finalize_epoch(None)


def test_tensorboard_and_wandb_panels_equal_jax(tmp_path, monkeypatch):
    """The same panels as the JAX visualizer's: the first three kept
    samples of the stage, masked points dropped, z colours, the wandb
    cloud cut to 40 points, in the same order."""
    recs = {}
    for name, cls in (("jax", JVisualizer), ("port", TVisualizer)):
        rec = _Recorder()
        with monkeypatch.context() as mp:
            for mod, stub in _stubs(rec).items():
                mp.setitem(sys.modules, mod, stub)
            _drive(cls, tmp_path / name)
        recs[name] = rec.calls
        assert os.path.exists(tmp_path / name / "SYNTH_test_preds.csv")
    assert len(recs["port"]) == len(recs["jax"]) == 7
    for a, b in zip(recs["port"], recs["jax"]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(x, list):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
            elif isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    assert recs["port"][0] == ("writer", "tensorboard_viz")
    assert recs["port"][1][2].shape == (1, 60, 3)
    assert recs["port"][2][2][0].shape == (40, 6)


def test_missing_tensorboard_and_wandb_warn_once_and_go_on(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    with caplog.at_level(logging.WARNING):
        _drive(TVisualizer, tmp_path)
    warned = [r.getMessage() for r in caplog.records
              if "3D export unavailable" in r.getMessage()]
    assert len(warned) == 2 and warned[0].startswith("tensorboard") \
        and warned[1].startswith("wandb")
    assert os.path.exists(tmp_path / "SYNTH_test_preds.csv")
