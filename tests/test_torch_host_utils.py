"""The three host modules nothing on the main path imports, against the
JAX package's: the streaming confusion matrix (counts, IoU, accuracies and
the per-class stats; its heatmaps written with matplotlib, and a clear
error naming matplotlib without it), the experiment browser over a run
directory that the port's trainer wrote (histories, best epochs, the
`.ckpt` read back by the port's Checkpoint), and the timing helpers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dpcr_agb_tpu.metrics import confusion_matrix as jcm
from dpcr_agb_tpu.utils import timer as jtimer
from dpcr_agb_tpu.visualization import experiment_manager as jem
from dpcr_agb_tpu_torch.metrics import confusion_matrix as tcm
from dpcr_agb_tpu_torch.training.state import Checkpoint
from dpcr_agb_tpu_torch.utils import timer as ttimer
from dpcr_agb_tpu_torch.visualization import experiment_manager as tem


@pytest.mark.parametrize("names", [4, ["ground", "low", "mid", "high",
                                       "top"]])
def test_confusion_matrix_equals_jax(names):
    rng = np.random.default_rng(2)
    n = names if isinstance(names, int) else len(names)
    j, t = jcm.ConfusionMatrix(names), tcm.ConfusionMatrix(names)
    for _ in range(3):
        gt = rng.integers(0, n - 1, 50)          # the last class never true
        pr = rng.integers(0, n, 50)
        j.count_predicted_batch(gt, pr)
        t.count_predicted_batch(gt, pr)
    np.testing.assert_array_equal(t.get_confusion_matrix(),
                                  j.get_confusion_matrix())
    for fn in ("get_overall_accuracy", "get_mean_class_accuracy",
               "get_average_intersection_union"):
        assert getattr(t, fn)() == getattr(j, fn)(), fn
    assert t.get_average_intersection_union(True) == \
        j.get_average_intersection_union(True)
    for a, b in zip(t.get_intersection_union_per_class(),
                    j.get_intersection_union_per_class()):
        np.testing.assert_array_equal(a, b)
    (ts, tc, tm), (js, jc, jm) = t.get_stats(), j.get_stats()
    assert ts == js and tc == jc
    np.testing.assert_array_equal(tm, jm)
    m = tcm.ConfusionMatrix.create_from_matrix(j.get_confusion_matrix())
    assert m.get_overall_accuracy() == j.get_overall_accuracy()
    with pytest.raises(ValueError):
        t.count_predicted_batch([0], [n])


def test_save_confusion_matrix_writes_svgs_or_names_matplotlib(tmp_path,
                                                               monkeypatch):
    cm = np.array([[5, 1, 0], [2, 7, 1], [0, 0, 3]])
    pytest.importorskip("matplotlib")
    tcm.save_confusion_matrix(cm, str(tmp_path), ["a", "b", "c"])
    for name in ("precision.svg", "recall.svg"):
        assert (tmp_path / name).read_text().lstrip().startswith("<?xml")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tcm.save_confusion_matrix(cm, str(tmp_path), ["a", "b", "c"])


def _run_dir(root):
    """A run directory as the port's trainer leaves it: metrics.jsonl, a
    .ckpt written by the port's Checkpoint, a prediction csv."""
    run = os.path.join(root, "exp", "run1")
    os.makedirs(os.path.join(run, "eval"))
    recs = [{"epoch": e, "stage": "val", "val_loss": 1.0 / e,
             "val_total_BMag_ha_rmse": [9.0, 7.5, 8.25][e - 1]}
            for e in (1, 2, 3)]
    with open(os.path.join(run, "metrics.jsonl"), "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs) + "\n")
    ck = Checkpoint(run_config={"model_name": "SENet14"},
                    dataset_properties={"reg_targets": ["BMag_ha"]})
    ck.models["latest"] = {"params": {"w": np.arange(3, dtype=np.float32)}}
    ck.stats["val"] = [{"epoch": 3, "val_loss": 0.25}]
    with open(os.path.join(run, "SENet14.ckpt"), "wb") as f:
        f.write(ck.to_bytes())
    open(os.path.join(run, "eval", "SYNTH_test_preds.csv"), "w").close()
    return run


def test_experiment_manager_equals_jax(tmp_path):
    run = _run_dir(str(tmp_path))
    tm, jm = tem.ExperimentManager(str(tmp_path)), \
        jem.ExperimentManager(str(tmp_path))
    assert [r.run_dir for r in tm.find_runs()] == \
        [r.run_dir for r in jm.find_runs()] == [run]
    assert tm.summarize() == jm.summarize()
    t, j = tem.ExperimentFolder(run), jem.ExperimentFolder(run)
    assert t.model_name == j.model_name == "SENet14"
    assert t.metrics_history() == j.metrics_history()
    assert t.best_epoch("val_total_BMag_ha_rmse") == (2, 7.5)
    assert t.best_epoch("val_loss", "max") == j.best_epoch("val_loss", "max")
    assert t.best_epoch("missing") is None
    assert t.prediction_files() == j.prediction_files()
    ck = t.load_checkpoint()
    assert ck.run_config["model_name"] == "SENet14"
    assert ck.dataset_properties == {"reg_targets": ["BMag_ha"]}
    assert ck.stats["val"] == [{"epoch": 3, "val_loss": 0.25}]
    np.testing.assert_array_equal(
        np.asarray(ck.models["latest"]["params"]["w"]),
        np.arange(3, dtype=np.float32))
    with pytest.raises(FileNotFoundError):
        tem.ExperimentFolder(str(tmp_path)).load_checkpoint()


def test_timer_equals_jax():
    xs = [0.5, 2.0, 3.25, -1.0, 4.0]
    j, t = jtimer.RunningStats(), ttimer.RunningStats()
    assert t.mean() == 0.0 and t.std() == 0.0
    for x in xs:
        j.push(x)
        t.push(x)
        assert (t.mean(), t.variance(), t.std()) == \
            (j.mean(), j.variance(), j.std())
    assert t.std() == pytest.approx(np.std(xs, ddof=1), rel=1e-12)

    @ttimer.time_func(name="twice")
    def twice(v):
        return 2 * v

    assert [twice(i) for i in range(4)] == [0, 2, 4, 6]
    assert twice.stats.n == 4 and twice.stats.mean() >= 0
    t.clear()
    assert t.n == 0


def test_importing_the_modules_loads_no_plotting_library():
    code = ("import sys\n"
            "import dpcr_agb_tpu_torch.metrics.confusion_matrix\n"
            "import dpcr_agb_tpu_torch.visualization.experiment_manager\n"
            "import dpcr_agb_tpu_torch.utils.timer\n"
            "assert 'matplotlib' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
