"""KPConv's neighbour-limit calibration in the port against the JAX package
on the CPU, and a JAX-written KPConv `.ckpt` served by both CLIs over the
same host pyramid.

- `calibrate_neighborhood_limits` returns the JAX function's limits on the
  same samples.
- Trainer start-up on a tiny synthetic dataset (20 plots, the narrow
  architecture simple, resnetb, resnetb_strided, resnetb, global_sum;
  first_features_dim 16, 5 kernel points), read after construction, before
  any epoch: the port's Trainer calibrates the JAX Trainer's limits,
  builds its net and its host pyramid with them and writes them into the
  `.ckpt` run_config, which the root `eval.py`'s config composition reads
  back (and the JAX Trainer in eval mode builds its net with);
  `auto_calibrate_limits: False`, explicit limits,
  `calibrate_percentile` and DPCR_KP_CALIB_PCT act as in the JAX package;
  `debugging.find_neighbour_dist` logs the limits at the start of `train`.
- A JAX `.ckpt` of a narrow KPConv whose run_config carries limits, served
  by `python -m dpcr_agb_tpu_torch.predict` and by the root `predict.py` on
  the same `.laz` plots: both build the same host pyramid, and the
  predictions agree within 4e-6 of max|pred - center| (measured here:
  1.5e-5 of 50.6, 3.0e-7, half an f32 ulp of the ~250-wide predictions),
  far inside the 1e-4 + 2e-4·|pred - center| that
  `tests/test_torch_checkpoint.py` allows the port's former device
  route."""
import logging
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import predict as jax_predict  # noqa: E402
from dpcr_agb_tpu import native as jnative
from dpcr_agb_tpu.config import compose_from_checkpoint as jcompose
from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.data import instantiate_dataset as jdataset
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.training.trainer import Trainer as JTrainer
from dpcr_agb_tpu.utils import neighbor_calibration as jcal
from dpcr_agb_tpu_torch import predict
from dpcr_agb_tpu_torch.config import load_config as tload
from dpcr_agb_tpu_torch.training.trainer import Trainer as TTrainer
from dpcr_agb_tpu_torch.utils import neighbor_calibration as tcal
from tests import test_torch_checkpoint as tck

CONF = os.path.join(ROOT, "conf")
CPU = torch.device("cpu")
ARCH = "[simple,resnetb,resnetb_strided,resnetb,global_sum]"


def _overrides(data, run, *extra):
    return ["task=instance", "models=instance/kpconv", "model_name=KPConv",
            "data=instance/synthetic/reg", "data.transform_type=xy",
            "data.synthetic_plots=20", f"data.dataroot={data}",
            "training=nfi/kpconv", "training.batch_size=4",
            "training.num_workers=1",
            f"models.KPConv.config.architecture={ARCH}",
            "models.KPConv.config.first_features_dim=16",
            "models.KPConv.config.num_kernel_points=5", f"run_dir={run}",
            *extra]


def _port(tmp, name, *extra):
    return TTrainer(tload(CONF, "config", _overrides(
        tmp / "data", tmp / name, *extra)), device=CPU)


def _limits(trainer):
    return trainer.option.get("extra_options", {}).get("neighborhood_limits")


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
def base(tmp_path_factory):
    """The synthetic dataset (generated by the port's trainer) and the
    limits both trainers calibrate on it at the default percentile."""
    assert jnative.is_available()
    tmp = tmp_path_factory.mktemp("calibration")
    port = _port(tmp, "port")
    jax_trainer = JTrainer(jload(CONF, "config", _overrides(
        tmp / "data", tmp / "jax")))
    return {"tmp": tmp, "port": port,
            "jax_limits": list(jax_trainer.bundle.option["extra_options"][
                "neighborhood_limits"])}


@pytest.mark.parametrize("percentile,layers,max_k",
                         [(90.0, 2, 256), (50.0, 3, 256), (99.0, 4, 32)])
def test_calibrate_neighborhood_limits_equals_jax(percentile, layers, max_k):
    rng = np.random.default_rng(int(percentile))
    samples = [{"pos": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
               for n in (300, 800, 1500)]
    samples.append({"pos": np.repeat(samples[0]["pos"][:40], 5, axis=0)})
    args = (samples, 0.02, 2.5, layers, percentile, max_k)
    got = tcal.calibrate_neighborhood_limits(*args)
    assert jnative.is_available()
    assert got == jcal.calibrate_neighborhood_limits(*args)
    assert len(got) == layers and all(isinstance(v, int) for v in got)


def test_trainer_calibrates_the_jax_trainers_limits(base):
    port = base["port"]
    limits = _limits(port)
    assert limits == base["jax_limits"]
    assert limits != [40, 40] and all(v >= 1 for v in limits)
    assert port.net.neighborhood_limits == limits
    batch = next(iter(port.loaders["test"].epoch(0)))
    assert [batch.aux[f"kp_conv{l}"].shape[-1] for l in range(2)] == limits
    assert batch.aux["kp_pool0"].shape[-1] == limits[0]


def test_limits_go_into_the_ckpt_that_the_root_eval_reads(base):
    """The port's `.ckpt` (its run_config and `latest` weights) composed
    by the JAX package's `compose_from_checkpoint`, as the root eval.py
    does, and given to the JAX Trainer in eval mode: it builds its net with
    the calibrated limits and calibrates nothing."""
    port = base["port"]
    ckpt = port.checkpoint
    assert ckpt.checkpoint.run_config["models"]["KPConv"][
        "extra_options"]["neighborhood_limits"] == _limits(port)
    ckpt.save_best_models_under_current_metrics(
        port.runner, "train", 1, {}, {}, port.optimizer_name)
    run_dir = str(base["tmp"] / "port")
    cfg = jcompose([f"checkpoint_dir={run_dir}", "model_name=KPConv"])
    assert cfg["models"]["KPConv"]["extra_options"][
        "neighborhood_limits"] == _limits(port)
    cfg["training"] = {"epochs": 0, "batch_size": 4, "num_workers": 0,
                       "shuffle": False, "checkpoint_dir": run_dir,
                       "weight_name": "latest",
                       "optim": {"base_lr": 1e-3, "optimizer": {
                           "class": "AdaBelief", "params": {}}}}
    jax_eval = JTrainer(cfg, eval_mode=True)
    assert list(jax_eval.bundle.net.neighborhood_limits) == _limits(port)


@pytest.mark.parametrize("case", ["auto_off", "explicit", "percentile",
                                  "env"])
def test_calibration_switches(base, case, monkeypatch):
    tmp = base["tmp"]
    if case == "auto_off":
        port = _port(tmp, case, "+models.KPConv.auto_calibrate_limits=False")
        assert _limits(port) is None and port.net.neighborhood_limits is None
        batch = next(iter(port.loaders["test"].epoch(0)))
        assert batch.aux["kp_conv0"].shape[-1] == 40
        assert "neighborhood_limits" not in (
            port.checkpoint.checkpoint.run_config["models"]["KPConv"].get(
                "extra_options") or {})
        return
    if case == "explicit":
        port = _port(tmp, case,
                     "models.KPConv.extra_options.neighborhood_limits=[5,9]")
        assert _limits(port) == [5, 9] == port.net.neighborhood_limits
        return
    if case == "percentile":
        extra, pct = ["models.KPConv.calibrate_percentile=50"], 50.0
    else:
        monkeypatch.setenv("DPCR_KP_CALIB_PCT", "75")
        # the variable wins over the option
        extra, pct = ["models.KPConv.calibrate_percentile=50"], 75.0
    port = _port(tmp, case, *extra)
    jax_ds = jdataset(jload(CONF, "config", _overrides(
        tmp / "data", tmp / "unused"))["data"])
    option = tload(CONF, "config", _overrides(tmp / "data", tmp / "unused")
                   )["models"]["KPConv"].to_dict()
    want = jcal.run_find_neighbour_dist(jax_ds, option, 16, pct)
    assert _limits(port) == want == tcal.run_find_neighbour_dist(
        port.dataset, option, 16, pct)
    assert want != base["jax_limits"]
    if case == "env":
        assert port.checkpoint.checkpoint.run_config["dpcr_env"][
            "DPCR_KP_CALIB_PCT"] == "75"


def test_find_neighbour_dist_logs_the_limits(base, caplog, monkeypatch):
    port = _port(base["tmp"], "debug", "debugging.find_neighbour_dist=True",
                 "+debugging.num_find_neighbour_samples=4",
                 "training.epochs=0")
    tested = []
    monkeypatch.setattr(port, "_test_epoch",
                        lambda epoch, stage: tested.append(stage))
    with caplog.at_level(logging.INFO):
        port.train()
    want = tcal.run_find_neighbour_dist(port.dataset, port.option, 4)
    assert f"calibrated neighborhood_limits: {want}" in caplog.text
    assert tested == ["test"]


def test_jax_checkpoint_with_limits_served_by_both_clis(tmp_path,
                                                       monkeypatch):
    run_config = tck._run_config

    def with_limits(model_name, transform_type=None):
        rc = run_config(model_name, transform_type)
        rc["models"][model_name]["extra_options"][
            "neighborhood_limits"] = [14, 30]
        return rc

    monkeypatch.setattr(tck, "_run_config", with_limits)
    files = tck._write_plots(str(tmp_path / "plots"))
    ckpt = str(tmp_path / "ckpt")
    tck._write_jax_checkpoint(ckpt, "KPConv", files)
    bundle = predict.load_serving_bundle(ckpt, "KPConv", device="cpu")
    assert bundle.net.neighborhood_limits == [14, 30]
    batch, _ = predict.make_batches(
        bundle, predict.load_samples(bundle, files)[0], 16)[0]
    assert batch.aux["kp_conv0"].shape[-1] == 14
    assert batch.aux["kp_conv1"].shape[-1] == 30
    args = ["checkpoint_dir=" + ckpt, "model_name=KPConv",
            f"input={tmp_path}/plots/*.laz"]
    got = predict.main(args + [f"output={tmp_path}/port.csv", "device=cpu"])
    want = jax_predict.main(args + [f"output={tmp_path}/jax.csv"])
    (gh, gf, gp), (wh, wf, wp) = tck._read_csv(got), tck._read_csv(want)
    assert gh == wh and gf == wf == [os.path.basename(f) for f in files]
    assert np.isfinite(gp).all() and np.ptp(wp[:, 0]) > 1e-3
    center = np.asarray(tck.PROPS["target_stats"]["center"])
    scale = float(np.abs(wp - center).max())
    err = float(np.abs(gp - wp).max())
    assert err <= 4e-6 * scale, (err, scale)
