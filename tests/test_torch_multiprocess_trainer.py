"""The port's trainer on two ranks (two processes over loopback gloo on
one shared, initially empty data root; tests/test_multihost.py gives the
JAX trainer's ranks a root each) against one process, on the root
grammar's MPointNet command (24 plots, batch size 4, f32).

The JAX trainer trains epoch 1 (on the conftest's virtual devices: a
4-device mesh) and writes its `.ckpt`; the JAX trainer, the port in one
process and the port on two ranks each resume from it for epoch 2 with its
val and test stages. Every numeric metric of the two ranks' run (rank 0's
metrics.jsonl) is within rtol 1e-3 of the one-process port run's and of
the JAX trainer's (the JAX multihost test's yardstick); rank 0 writes the
checkpoint, the metrics and the prediction CSVs, rank 1 none of them.
Then `calibrate_bn.main` on two ranks gives the one-process BN statistics
(each stat's relative L2 error 1e-5: the same moments summed in another
order) and the same weights. About 80 s on one worker."""
import glob
import json
import os
import sys

import numpy as np
import pytest

from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.training.trainer import Trainer as JTrainer
from dpcr_agb_tpu_torch import calibrate_bn as tcalibrate
from dpcr_agb_tpu_torch import train as ttrain
from dpcr_agb_tpu_torch.training.state import Checkpoint
from tests.test_torch_parallel import REPO, run_ranks

CONF = os.path.join(REPO, "conf")
WORLD = 2


def _overrides(data, run, epochs, *extra):
    return ["task=instance", "models=instance/minkowski_baseline",
            "model_name=MPointNet", "data=instance/synthetic/reg",
            "data.transform_type=sparse_xy", "data.synthetic_plots=24",
            f"data.dataroot={data}", "training=nfi/minkowski",
            f"training.epochs={epochs}", "training.batch_size=4",
            "training.num_workers=1", "lr_scheduler=cosineawr",
            "update_lr_scheduler_on=on_num_batch", "visualization=eval",
            f"run_dir={run}", "pretty_print=False", *extra]


def _ranks(module: str, per_rank):
    return run_ranks([sys.executable, "-m", module], WORLD,
                     per_rank_args=lambda r: per_rank(r) + ["device=cpu"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_trainer")
    saved = (jlayout.BATCH_LOCAL, jlayout.DATA_PARALLEL_DEGREE)
    try:
        JTrainer(jload(CONF, "config", _overrides(
            str(tmp / "data"), str(tmp / "j1"), 1))).train()
        resume = f"training.checkpoint_dir={tmp / 'j1'}"
        JTrainer(jload(CONF, "config", _overrides(
            str(tmp / "data"), str(tmp / "j2"), 2, resume))).train()
    finally:
        jlayout.set_batch_local(*saved)
    ttrain.main(_overrides(str(tmp / "data"), str(tmp / "t2"), 2, resume,
                           "device=cpu"))
    # both ranks on one empty data root: each generates and processes the
    # dataset there at the same time (the data layer's writes are atomic)
    _ranks("dpcr_agb_tpu_torch.train", lambda r: _overrides(
        str(tmp / "shared_data"), str(tmp / f"rank{r}" / "run"), 2,
        resume))
    cal = ["model_name=MPointNet", f"checkpoint_dir={tmp / 't2'}",
           "epochs=1", "pretty_print=False"]
    tcalibrate.main([*cal, f"run_dir={tmp / 'cal1'}", "device=cpu"])
    _ranks("dpcr_agb_tpu_torch.calibrate_bn",
           lambda r: [*cal, f"run_dir={tmp / f'cal_rank{r}'}"])
    return tmp


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if isinstance(v, (int, float))}
            for r in recs]


@pytest.mark.parametrize("against", ["t2", "j2"],
                         ids=["port-one-process", "jax-trainer"])
def test_two_rank_metrics_match(runs, against):
    got, want = _metrics(runs / "rank0" / "run"), _metrics(runs / against)
    assert [r["epoch"] for r in got] == [2, 2, 2]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)


def test_rank0_owns_the_files(runs):
    r0, r1 = runs / "rank0" / "run", runs / "rank1" / "run"
    for name in ("MPointNet.ckpt", "metrics.jsonl", "SYNTH_test_preds.csv",
                 "SYNTH_val_preds.csv"):
        assert (r0 / name).exists(), name
    assert not glob.glob(str(r1 / "*")), os.listdir(r1)
    # the two ranks' test predictions are the one-process run's rows
    with open(r0 / "SYNTH_test_preds.csv") as f:
        got = f.read().splitlines()
    with open(runs / "t2" / "SYNTH_test_preds.csv") as f:
        want = f.read().splitlines()
    assert len(got) == len(want) and got[0] == want[0]


def test_two_rank_calibrate_bn_gives_the_one_process_stats(runs):
    def stats(d):
        with open(d / "MPointNet.ckpt", "rb") as f:
            return Checkpoint.from_bytes(f.read()).models["latest"]

    want, got = stats(runs / "cal1"), stats(runs / "cal_rank0")
    assert not glob.glob(str(runs / "cal_rank1" / "*.ckpt"))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    w, g = dict(leaves(want["batch_stats"])), dict(leaves(got["batch_stats"]))
    assert w.keys() == g.keys() and w
    for k in w:
        # the moments of the same rows summed in another order: each
        # stat's relative L2 error
        a, b = g[k].astype(np.float64), w[k].astype(np.float64)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), k
    for (k, a), (_, b) in zip(leaves(got["params"]), leaves(want["params"])):
        np.testing.assert_array_equal(a, b, err_msg=k)
