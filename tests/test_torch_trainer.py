"""The port's trainer and its entry points against the JAX package's on the
CPU, at a narrow, shallow SENet14 (se_basic blocks, planes 16,16,32,32,
init_dim 16, registered under the name SENetTiny in both packages'
architecture tables for this test and selected by
`models.SENet14.model_name=SENetTiny`), dense dims (24,24,24), drop_path 0,
f32, 30 synthetic plots, batch size 4, one voxel bucket.

The JAX Trainer trains epoch 1 and writes its `.ckpt`; both trainers resume
from it and run epoch 2 with its val and test stages. Compared: the
metrics JSONL records (same stages and keys) and the `.ckpt`'s stats
elementwise with rtol 1e-4 (absolute floor 1e-5 of the largest value), the
weight names (`latest`, `best_val_*`), the prediction CSVs row for row
(predictions rtol 1e-4, every other cell equal), and each parameter, BN
variance and optimizer slot by its relative L2 error, 1e-4. Two kinds of
tensor are held otherwise, and the docstring of `_same_states` says why:
the biases of the convs that feed a train-mode BN (stem_conv, conv1, conv2,
downsample_conv) are not compared, and the BN running means within 1e-3.
Then `eval.main` and `calibrate_bn.main` of both packages on the same
`.ckpt` (same tolerances), every `conf/lr_scheduler/` file's `make_lr_fn`
over the first 400 counts (absolute 1e-7), the optimizers and gradient
accumulation against the optax chains the JAX trainer builds, the
README's MPointNet command on the CPU (f32 under `enable_mixed`), and the
entry points' refusals."""
import csv
import glob
import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import calibrate_bn as jcalibrate  # noqa: E402
import eval as jeval  # noqa: E402
from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.models import minkowski as jmink
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.trainer import Trainer as JTrainer
from dpcr_agb_tpu_torch import calibrate_bn as tcalibrate
from dpcr_agb_tpu_torch import eval as teval
from dpcr_agb_tpu_torch import train as ttrain
from dpcr_agb_tpu_torch.config import load_config as tload
from dpcr_agb_tpu_torch.data.dataset import instantiate_dataset
from dpcr_agb_tpu_torch.models import minkowski as tmink
from dpcr_agb_tpu_torch.models.base import build_instance_spec
from dpcr_agb_tpu_torch.training import optim as toptim
from dpcr_agb_tpu_torch.training.state import Checkpoint
from dpcr_agb_tpu_torch.training.trainer import Trainer as TTrainer

CONF = os.path.join(ROOT, "conf")
RTOL = 1e-4
TINY = dict(block="se_basic", layers=(1, 1, 1, 1), strides=(1, 2, 2, 2),
            init_dim=16, planes=(16, 16, 32, 32))
CPU = torch.device("cpu")


def _overrides(data, run, epochs, *extra):
    return ["task=instance", "models=instance/minkowski_baseline",
            "model_name=SENet14", "data=instance/synthetic/reg",
            "data.transform_type=sparse_xy", "data.synthetic_plots=30",
            f"data.dataroot={data}", "training=nfi/minkowski",
            f"training.epochs={epochs}", "training.batch_size=4",
            "training.num_workers=2", "training.enable_mixed=False",
            "lr_scheduler=cosineawr", "update_lr_scheduler_on=on_num_batch",
            "visualization=eval", "models.SENet14.model_name=SENetTiny",
            "models.SENet14.drop_path=0.0",
            "models.SENet14.extra_options={dense_dims: [24, 24, 24]}",
            "+data.buckets=[16384]", f"run_dir={run}", *extra]


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    data, j1 = str(tmp / "data"), str(tmp / "j1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmink._ARCH_EXTRAS, "SENetTiny", TINY)
        mp.setitem(tmink._ARCH_EXTRAS, "SENetTiny", TINY)
        JTrainer(jload(CONF, "config", _overrides(data, j1, 1))).train()
        resume = f"training.checkpoint_dir={j1}"
        JTrainer(jload(CONF, "config", _overrides(
            data, str(tmp / "j2"), 2, resume))).train()
        port = TTrainer(tload(CONF, "config", _overrides(
            data, str(tmp / "t2"), 2, resume)), device=CPU)
        port.train()
        evals = {}
        for name, main in (("j", jeval.main), ("t", teval.main)):
            extra = ["device=cpu"] if name == "t" else []
            evals[name] = main([f"checkpoint_dir={tmp / 'j2'}",
                                "model_name=SENet14", "weight_name=latest",
                                f"run_dir={tmp / ('eval_' + name)}",
                                "pretty_print=False", *extra])
            # BN on the batch's own moments, two voting runs
            evals[name + "bn"] = main([
                f"checkpoint_dir={tmp / 'j2'}", "model_name=SENet14",
                "weight_name=latest", "enable_bn=True", "voting_runs=2",
                "eval_stages=[test]", f"run_dir={tmp / ('evalbn_' + name)}",
                "pretty_print=False", *extra])
        for name, main in (("j", jcalibrate.main), ("t", tcalibrate.main)):
            extra = ["device=cpu"] if name == "t" else []
            main([f"checkpoint_dir={tmp / 'j2'}", "model_name=SENet14",
                  f"run_dir={tmp / ('cal_' + name)}", "pretty_print=False",
                  *extra])
    return {"tmp": tmp, "port": port, "evals": evals}


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-5 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


def _ckpt(path):
    with open(path, "rb") as f:
        return Checkpoint.from_bytes(f.read())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


BN_FED_BIAS = ("stem_conv/bias", "conv1/bias", "conv2/bias",
               "downsample_conv/bias")


def _same_states(got, want, what):
    """Every tensor of two model states by its relative L2 error: 1e-4,
    except two kinds. A conv bias that feeds a train-mode BN has a
    gradient of zero up to f32 rounding in both frameworks (BN subtracts
    the batch mean), and AdaBelief's normalized step turns that rounding
    noise into moves of the order of the lr, different in each: such
    biases are not compared (they exist in both, with the same shapes).
    A BN running mean follows the batch means of its conv's output, that
    bias included, so it carries the same noise, scaled by the BN
    momentum: running means are held within 1e-3."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for k in w:
        assert np.shape(g[k]) == np.shape(w[k]), f"{what}{k}"
        if k.endswith(BN_FED_BIAS):
            continue
        tol = 1e-3 if k.endswith("/mean") else 1e-4
        assert _rel_l2(g[k], w[k]) <= tol, (f"{what}{k}",
                                            _rel_l2(g[k], w[k]))


def test_resumed_epoch_metrics_equal_jax(runs):
    want = _records(runs["tmp"] / "j2")
    got = _records(runs["tmp"] / "t2")
    assert [(r["epoch"], r["stage"]) for r in got] == [
        (2, "train"), (2, "val"), (2, "test")]
    assert [(r["epoch"], r["stage"], sorted(r)) for r in got] == [
        (r["epoch"], r["stage"], sorted(r)) for r in want]
    for g, w in zip(got, want):
        for k in w:
            if k not in ("epoch", "stage"):
                _close(g[k], w[k], f"{w['stage']} {k}")
    train = runs["port"].history[0]
    assert train["stage"] == "train" and train["batches"] == 6
    assert np.isfinite(train["tracked_losses"]).all()


def test_resumed_checkpoint_equals_jax(runs):
    want = _ckpt(runs["tmp"] / "j2" / "SENet14.ckpt")
    got = _ckpt(runs["tmp"] / "t2" / "SENet14.ckpt")
    assert sorted(got.models) == sorted(want.models)
    assert "latest" in got.models and any(
        k.startswith("best_val_") for k in got.models)
    for stage in ("train", "val", "test"):
        assert [sorted(s) for s in got.stats[stage]] == [
            sorted(s) for s in want.stats[stage]], stage
        for g, w in zip(got.stats[stage], want.stats[stage]):
            for k in w:
                _close(g[k], w[k], f"stats {stage} {k}")
    for name in want.models:
        _same_states(got.models[name], want.models[name], name)
    assert got.optimizer[0] == want.optimizer[0] == "AdaBelief"
    for k in ("step", "epoch", "num_samples"):
        assert got.optimizer[1][k] == want.optimizer[1][k], k
    gflat = got.optimizer[1]["opt_state"]["flat"]
    wflat = want.optimizer[1]["opt_state"]["flat"]
    assert [np.shape(x) for x in gflat] == [np.shape(x) for x in wflat]
    # [count, exp_avg..., exp_avg_var...], parameters in flax path order
    names = [k for k, _ in _leaves(want.models["latest"]["params"])]
    assert len(wflat) == 1 + 2 * len(names)
    assert int(np.asarray(gflat[0])) == int(np.asarray(wflat[0]))
    for i, (g, w) in enumerate(zip(gflat[1:], wflat[1:])):
        name = names[i % len(names)]
        if not name.endswith(BN_FED_BIAS):
            assert _rel_l2(g, w) <= 1e-4, (i, name, _rel_l2(g, w))
    assert got.dataset_properties == want.dataset_properties
    assert got.run_config["models"] == want.run_config["models"]


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csvs(got_dir, want_dir):
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(want_dir, "*_preds.csv")))
    assert names and names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(got_dir, "*_preds.csv")))
    for name in names:
        want = _csv_rows(os.path.join(want_dir, name))
        got = _csv_rows(os.path.join(got_dir, name))
        assert got[0] == want[0] and len(got) == len(want), name
        for g, w in zip(got[1:], want[1:]):
            for col, a, b in zip(want[0], g, w):
                if col.startswith("pred_"):
                    _close(float(a), float(b), f"{name} {col}")
                else:
                    assert a == b, (name, col)


def test_resumed_prediction_csvs_equal_jax(runs):
    _same_csvs(runs["tmp"] / "t2", runs["tmp"] / "j2")


def test_eval_main_equals_jax(runs):
    want, got = runs["evals"]["j"], runs["evals"]["t"]
    assert list(got) == list(want) == ["val", "test"]
    for stage in want:
        assert sorted(got[stage]) == sorted(want[stage])
        for k in want[stage]:
            _close(got[stage][k], want[stage][k], f"eval {stage} {k}")
    _same_csvs(runs["tmp"] / "eval_t", runs["tmp"] / "eval_j")


def test_eval_with_batch_moments_and_voting_equals_jax(runs):
    want, got = runs["evals"]["jbn"], runs["evals"]["tbn"]
    assert list(got) == list(want) == ["test"]
    assert sorted(got["test"]) == sorted(want["test"])
    for k in want["test"]:
        _close(got["test"][k], want["test"][k], f"enable_bn {k}")
    # the batch's own moments, not the running stats: other predictions
    assert got["test"]["test_loss"] != runs["evals"]["t"]["test"]["test_loss"]
    # two voting runs: every test plot twice in the csv
    rows = _csv_rows(runs["tmp"] / "evalbn_t" / "SYNTH_test_preds.csv")[1:]
    once = _csv_rows(runs["tmp"] / "eval_t" / "SYNTH_test_preds.csv")[1:]
    assert len(rows) == 2 * len(once)
    _same_csvs(runs["tmp"] / "evalbn_t", runs["tmp"] / "evalbn_j")


def test_calibrate_bn_equals_jax(runs):
    src = _ckpt(runs["tmp"] / "j2" / "SENet14.ckpt").models["latest"]
    want = _ckpt(runs["tmp"] / "cal_j" / "SENet14.ckpt").models["latest"]
    got = _ckpt(runs["tmp"] / "cal_t" / "SENet14.ckpt").models["latest"]
    # one calibration epoch from the same weights: no optimizer noise
    for k, v in _leaves(want["batch_stats"]):
        _close(dict(_leaves(got["batch_stats"]))[k], v, f"calibrated {k}")
    for k, v in _leaves(got["params"]):
        np.testing.assert_array_equal(v, dict(_leaves(src["params"]))[k])
    moved = [k for k, v in _leaves(got["batch_stats"])
             if not np.array_equal(v, dict(_leaves(src["batch_stats"]))[k])]
    assert moved


SCHEDULER_FILES = sorted(glob.glob(os.path.join(CONF, "lr_scheduler",
                                                "*.yaml")))


@pytest.mark.parametrize("path", SCHEDULER_FILES, ids=os.path.basename)
@pytest.mark.parametrize("update_on", ["on_epoch", "on_num_batch",
                                       "on_num_sample"])
def test_lr_schedules_equal_jax(path, update_on):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    kw = dict(batches_per_epoch=7, batch_size=4)
    want = joptim.make_lr_fn(cfg, 5e-3, update_on, **kw)
    got = toptim.make_lr_fn(cfg, 5e-3, update_on, **kw)
    for count in range(400):
        assert abs(float(got(count)) - float(want(count))) <= 1e-7, count


def _jax_tx(name, params, clip, lr_fn, accum):
    # the JAX trainer's optax chain (Trainer._make_tx reads nothing of self)
    tx = JTrainer._make_tx(None, name, params, clip, lr_fn)
    return optax.MultiSteps(tx, every_k_schedule=accum) if accum > 1 else tx


@pytest.mark.parametrize("name,params,clip,accum", [
    ("AdaBelief", {"weight_decay": 1e-2}, 0.05, 1),
    ("SGD", {"momentum": 0.9, "weight_decay": 1e-3}, -1, 1),
    ("SGD", {}, -1, 1),
    ("Adam", {}, 0.05, 1),
    ("AdamW", {"weight_decay": 1e-2}, -1, 1),
    ("AdaBelief", {"weight_decay": 1e-2}, 0.05, 3),
])
def test_optimizers_equal_the_optax_chains(name, params, clip, accum):
    """Eight steps of random gradients on two parameters: the updated
    parameters (rtol 1e-5) and the state leaves in the `.ckpt` layout."""
    rng = np.random.default_rng(4)
    shapes = {"a": {"kernel": (3, 4)}, "b": {"scale": (5,)}}
    init = {k: {n: rng.normal(size=s).astype(np.float32)
                for n, s in v.items()} for k, v in shapes.items()}
    cawr = {"class": "CosineAnnealingWarmRestarts",
            "params": {"T_0": 3, "T_mult": 2}}
    jlr = joptim.make_lr_fn(cawr, 5e-3, "on_num_batch",
                            steps_per_update=accum)
    tlr = toptim.make_lr_fn(cawr, 5e-3, "on_num_batch",
                            steps_per_update=accum)
    tx = _jax_tx(name, dict(params), clip, jlr, accum)
    jp = jax.tree.map(np.asarray, init)
    st = tx.init(jp)
    tparams = {f"{k}.{n}": torch.nn.Parameter(torch.tensor(a))
               for k, v in init.items() for n, a in v.items()}
    opt = toptim.make_optimizer(name, tparams.values(), tlr, dict(params))
    acc = toptim.Accumulator(accum) if accum > 1 else None
    for step in range(8):
        grads = {k: {n: (rng.normal(size=s) * 0.1).astype(np.float32)
                     for n, s in v.items()} for k, v in shapes.items()}
        upd, st = tx.update(grads, st, jp)
        jp = optax.apply_updates(jp, upd)
        for key, p in tparams.items():
            k, n = key.split(".")
            p.grad = torch.tensor(grads[k][n])
        plist = list(tparams.values())
        if acc is None or acc.add(plist):
            if clip > 0:
                torch.nn.utils.clip_grad_value_(plist, clip)
            opt.step()
        for key, p in tparams.items():
            k, n = key.split(".")
            np.testing.assert_allclose(p.detach().numpy(), jp[k][n],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} step {step} {key}")
    leaves = toptim.jax_state(opt, tparams)
    if acc is not None:
        leaves = acc.jax_leaves(leaves, tparams)
    want = jax.tree_util.tree_leaves(st)
    assert [np.shape(x) for x in leaves] == [np.shape(x) for x in want]
    for g, w in zip(leaves, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=1e-4,
                                   atol=1e-9)


def test_readme_mpointnet_command_on_the_cpu_stays_f32(tmp_path):
    trainer = ttrain.main([
        "task=instance", "models=instance/minkowski_baseline",
        "model_name=MPointNet", "data=instance/synthetic/reg",
        "data.transform_type=sparse_xy", "data.synthetic_plots=12",
        f"data.dataroot={tmp_path / 'data'}", "training=nfi/minkowski",
        "training.epochs=1", "training.batch_size=4",
        "lr_scheduler=cosineawr", "update_lr_scheduler_on=on_num_batch",
        f"run_dir={tmp_path / 'run'}", "device=cpu"])
    assert trainer.training_cfg.get("enable_mixed") is True
    assert "bf16" not in (trainer.option.get("extra_options") or {})
    assert all(p.dtype == torch.float32 for p in trainer.net.parameters())
    assert (tmp_path / "run" / "MPointNet.ckpt").exists()
    assert trainer.device == CPU


def test_input_route_target_stats_are_the_one_area_rule(tmp_path):
    """train.target_stats over plots equals build_instance_spec over the
    same targets in one area (all of them in train), to the targets'
    float32 rounding."""
    cfg = tload(CONF, "config", [
        "task=instance", "models=instance/minkowski_baseline",
        "model_name=SENet14", "data=instance/synthetic/reg",
        "data.transform_type=sparse_xy", "data.synthetic_plots=12",
        f"data.dataroot={tmp_path}", "+data.areas.SYNTH.val_ratio=0.0",
        "+data.areas.SYNTH.test_ratio=0.0", "run_dir=unused"])
    ds = instantiate_dataset(cfg["data"])
    assert ds.datasets["val"] is None and ds.datasets["test"] is None
    samples = [ds.datasets["train"].get(i)
               for i in range(len(ds.datasets["train"]))]
    want = ttrain.target_stats(samples)
    spec = build_instance_spec(ds, {})
    np.testing.assert_allclose(spec.center, want["center"], rtol=1e-6)
    np.testing.assert_allclose(spec.scale, want["scale"], rtol=1e-6)


@pytest.mark.parametrize("main,extra", [
    (ttrain.main, ["task=instance", "models=instance/minkowski_baseline",
                   "model_name=SENet14", "data=instance/synthetic/reg",
                   "data.transform_type=sparse_xy"]),
    (teval.main, ["checkpoint_dir=nowhere", "model_name=SENet14"]),
    (tcalibrate.main, ["checkpoint_dir=nowhere", "model_name=SENet14"]),
])
def test_entry_points_refuse_without_cuda(main, extra):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device=cpu"):
        main(extra)


def test_kpconv_without_limits_calibrates_them_at_start_up(tmp_path):
    """The repository's KPConv entry (full width, no neighborhood_limits)
    through the root grammar: the trainer calibrates one cap a level from
    16 training plots at the entry's calibrate_percentile (90), builds its
    net with them, and writes them into its
    checkpoint's run_config (tests/test_torch_kpconv_calibration.py holds
    them against the JAX trainer's and the pyramid's lists against them)."""
    from dpcr_agb_tpu_torch.utils.neighbor_calibration import \
        run_find_neighbour_dist
    cfg = tload(CONF, "config", [
        "task=instance", "models=instance/kpconv", "model_name=KPConv",
        "data=instance/synthetic/reg", "data.transform_type=xy",
        "data.synthetic_plots=8", f"data.dataroot={tmp_path}",
        "training=nfi/kpconv", "training.batch_size=4",
        f"run_dir={tmp_path / 'run'}"])
    option = cfg["models"]["KPConv"].to_dict()
    assert "neighborhood_limits" not in option["extra_options"]
    trainer = TTrainer(cfg, device=CPU)
    limits = trainer.option["extra_options"]["neighborhood_limits"]
    assert limits == run_find_neighbour_dist(trainer.dataset, option, 16,
                                             90.0)
    assert len(limits) == 5 and limits != [40] * 5
    assert trainer.net.neighborhood_limits == limits
    assert trainer.checkpoint.checkpoint.run_config["models"]["KPConv"][
        "extra_options"]["neighborhood_limits"] == limits


def test_visualizer_exports_equal_jax(tmp_path):
    """The prediction writer against the JAX Visualizer on the same
    predictions and label table: the csv text, the gpkg rows and the ply
    files, byte for byte; a label index missing from the table joins as
    missing values in both."""
    import pandas as pd

    from dpcr_agb_tpu.visualization.visualizer import Visualizer as JViz
    from dpcr_agb_tpu_torch.data.table import Table
    from dpcr_agb_tpu_torch.visualization.visualizer import \
        Visualizer as TViz

    rng = np.random.default_rng(9)
    labels = pd.DataFrame({
        "fid": np.arange(1, 7), "las_file": [f"p{i}" for i in range(6)],
        "BMag_ha": rng.uniform(10, 400, 6), "V_ha": rng.uniform(10, 900, 6),
        "x": rng.uniform(5e5, 6e5, 6), "y": rng.uniform(6e6, 6.1e6, 6),
        "split": ["train", "test", "test", "val", "test", "train"]})
    labels = labels.drop(index=[4])

    class Areas:
        def __init__(self, table):
            self.table = table

        def get_labels(self, area):
            return self.table

    cfg = {"format": ["csv", "gpkg", "ply"]}
    reg_out = rng.normal(200, 50, (5, 2)).astype(np.float32)
    y = rng.normal(200, 50, (5, 2)).astype(np.float32)
    y[1, 0] = np.nan
    pos = rng.normal(size=(5, 30, 3)).astype(np.float32)
    pos_mask = rng.random((5, 30)) < 0.8
    args = (reg_out, y, np.zeros(5, np.int32),
            np.array([1, 2, 4, 5, 2]), ["SYNTH"], ["BMag_ha", "V_ha"])
    kw = dict(sample_mask=np.array([1, 1, 1, 1, 0], bool), pos=pos,
              pos_mask=pos_mask)
    table = Table({c: labels[c].to_numpy() for c in labels.columns},
                  labels.index.to_numpy())
    for name, viz, areas in (("j", JViz(cfg, {}, 4, str(tmp_path / "j")),
                              Areas(labels)),
                             ("t", TViz(cfg, {}, 4, str(tmp_path / "t")),
                              Areas(table))):
        for epoch in (1, 2):
            viz.reset(epoch, "test")
            viz.save_visuals(*args, **kw)
            viz.finalize_epoch(areas)
    with open(tmp_path / "j" / "SYNTH_test_preds.csv") as a, \
            open(tmp_path / "t" / "SYNTH_test_preds.csv") as b:
        assert b.read() == a.read()
    from dpcr_agb_tpu.visualization.gpkg import read_gpkg
    pd.testing.assert_frame_equal(
        read_gpkg(str(tmp_path / "t" / "SYNTH_preds.gpkg")),
        read_gpkg(str(tmp_path / "j" / "SYNTH_preds.gpkg")))
    plys = sorted(p.relative_to(tmp_path / "j")
                  for p in (tmp_path / "j").rglob("*.ply"))
    assert len(plys) == 8
    assert plys == sorted(p.relative_to(tmp_path / "t")
                          for p in (tmp_path / "t").rglob("*.ply"))
    for rel in plys:
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes()
