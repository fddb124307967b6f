"""The port's training host layer and entry point on the CPU: every
augmentation of the sparse_xy train chain gives the JAX package's sample
from the same numpy seed (alone, forced on, and as the whole chain); the
train chain mirrors the YAML; `python -m dpcr_agb_tpu_torch.train ...
device=cpu` takes its steps and writes a checkpoint that `predict` serves
and whose train state resumes, and raises without device=cpu where there
is no CUDA."""
import csv
import glob
import os

import numpy as np
import pytest
import torch

from dpcr_agb_tpu.config import load_config
from dpcr_agb_tpu.transforms import instantiate_transforms as jtransforms
from dpcr_agb_tpu.transforms.core import _flatten
from dpcr_agb_tpu_torch import predict, train
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.serving import nfi_sparse_xy_data_cfg
from dpcr_agb_tpu_torch.training.state import (TRAIN_STATE_KEY,
                                               load_train_state)
from dpcr_agb_tpu_torch.transforms import instantiate_transforms

CONF = os.path.join(os.path.dirname(__file__), "..", "conf")
SKIP = ["y_mol", "y_mol_mask", "y_cls", "y_cls_mask", "y_reg", "y_reg_mask"]
HEXAGON = nfi_sparse_xy_data_cfg()["train_transform"][10]["params"][
    "polygons"]


def _sample(seed=0, density=8.0):
    """A plot in unit coordinates with per-point features and targets."""
    rng = np.random.default_rng(seed)
    pts, bm, v = generate_plot(rng, density=density)
    pos = (pts / np.array([30.0, 30.0, 40.0], np.float32) + np.array(
        [0.5, 0.5, 0.0], np.float32)).astype(np.float32)
    n = len(pos)
    return {"pos": pos, "x": rng.normal(size=(n, 3)).astype(np.float32),
            "y": rng.integers(0, 5, n).astype(np.int64),
            "y_reg": np.array([bm, v], np.float32),
            "y_reg_mask": np.ones(2, bool)}


def _quantized(seed=0):
    s = _sample(seed)
    s["coords"] = np.round(s["pos"] / 0.0125).astype(np.int32)
    return s


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


AUGMENTATIONS = [
    ("RandomGroundRemoval", {"min_v": 0.05, "max_v": 0.5, "p": 1.0,
                             "min_points": 500, "skip_list": SKIP}, False),
    ("RandomGroundRemoval", {"min_v": 0.05, "max_v": 0.5, "p": 1.0,
                             "min_points": 10 ** 6, "skip_list": SKIP}, False),
    ("RandomDropout", {"dropout_ratio": 0.2, "dropout_application_ratio": 1.0,
                       "min_points": 500, "skip_list": SKIP}, False),
    ("RandomNoise", {"sigma": 0.0025}, False),
    ("Random3AxisRotation", {"apply_rotation": True, "rot_x": 0, "rot_y": 0,
                             "rot_z": 180}, False),
    ("Random3AxisRotation", {"rot_x": 10, "rot_y": 20, "rot_z": 180,
                             "p": 0.7}, False),
    ("RandomShiftPos", {"p": 1.0, "max_x": 0.01, "max_y": 0.01,
                        "max_z": 0.0}, False),
    ("AddRandomPoints", {"n_max_points": 12000, "add_ratio_min": 0.01,
                         "add_ratio_max": 0.2, "p": 1.0}, False),
    ("AddRandomPoints", {"n_max_points": 100, "add_ratio_min": 0.01,
                         "add_ratio_max": 0.2, "p": 1.0}, False),
    ("CopyJitterRandomPoints", {"n_max_points": 12000, "add_ratio_min": 0.01,
                                "add_ratio_max": 0.2, "p": 1.0,
                                "sigma": 0.005, "clip": 0.015}, False),
    ("RandomPolygon2dExtend", {"polygons": HEXAGON, "rotate": 180,
                               "skip_list": SKIP}, False),
    ("RandomPolygon2dExtend", {"polygons": HEXAGON + ["None"],
                               "size_min": 0.5, "size_max": 0.9,
                               "rotate": 90, "skip_list": SKIP}, False),
    ("RandomCoordsFlip", {"ignored_axis": "z", "p": 0.5}, True),
    ("RandomCoordsFlip", {"ignored_axis": [], "p": 1.0}, True),
    ("ShiftVoxels", {"p": 1.0}, True),
    ("ShiftVoxels", {}, True),
]


@pytest.mark.parametrize("name,params,quantized", AUGMENTATIONS,
                         ids=[f"{a[0]}-{i}" for i, a in
                              enumerate(AUGMENTATIONS)])
def test_augmentation_equals_jax_from_one_seed(name, params, quantized):
    """Five draws from one generator on each side: equal arrays, equal
    dtypes, and the generators left in the same state."""
    cfg = [{"transform": name, "params": params}]
    mine, ref = instantiate_transforms(cfg), jtransforms(cfg)
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(5):
        s = _quantized(i) if quantized else _sample(i)
        _assert_same(mine(rng, dict(s)), ref(jrng, dict(s)))
    assert rng.random() == jrng.random()


def test_train_chain_mirrors_the_yaml_and_equals_jax():
    cfg = load_config(CONF, "config", [
        "task=instance", "data=instance/NFI/reg", "model_name=SENet14",
        "models=instance/minkowski_baseline",
        "data.transform_type=sparse_xy"]).data.to_dict()
    chain = nfi_sparse_xy_data_cfg()["train_transform"]
    assert chain == list(_flatten(cfg["sparse_xy"]["train_transform"]))
    mine, ref = instantiate_transforms(chain), jtransforms(chain)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(4):
        s = _sample(i)
        del s["x"], s["y"]
        out = mine(rng, dict(s))
        _assert_same(out, ref(jrng, dict(s)))
        assert out["x"].shape[1] == 3 and out["coords"].dtype == np.int32


def _write_plots(root, n=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, bm, v = generate_plot(rng, radius=6.0, density=3.0)
        np.savez(os.path.join(root, f"p{i}.npz"),
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=np.nan if i == 1 else v)


def test_train_entry_point_writes_a_checkpoint_predict_serves(tmp_path):
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots)
    out = train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                      "steps=2", "batch_size=2", "device=cpu",
                      "dense_dims=40,40,48"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    saved = torch.load(out["checkpoint"], map_location="cpu",
                       weights_only=True)
    assert saved[TRAIN_STATE_KEY]["step"] == 2
    assert saved[TRAIN_STATE_KEY]["num_samples"] == 4
    # standardization over the training plots, NaN targets left out
    ys = [np.load(os.path.join(plots, f"p{i}.npz")) for i in range(3)]
    v = np.array([float(z["V_ha"]) for z in ys])
    np.testing.assert_allclose(saved["target_stats"]["center"][1],
                               np.nanmean(v), rtol=1e-6)
    np.testing.assert_allclose(saved["target_stats"]["scale"][1],
                               np.nanstd(v), rtol=1e-6)
    path = predict.main([f"checkpoint_dir={ckpt}", "model_name=SENet14",
                         f"input={plots}/*.npz",
                         f"output={tmp_path}/p.csv", "device=cpu"])
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    preds = np.array([[float(x) for x in r[1:]] for r in rows])
    assert preds.shape == (3, 2) and np.isfinite(preds).all()

    # the train state resumes into a fresh runner of the same model
    run = train.setup(sorted(glob.glob(f"{plots}/*.npz")), batch_size=2,
                      dense_dims=(40, 40, 48), seed=1, device="cpu")
    load_train_state(run.runner, ckpt, "SENet14")
    assert run.runner.step == 2 and run.runner.num_samples == 4
    assert run.runner.optimizer.param_groups[0]["count"] == 2
    for name, t in run.runner.net.state_dict().items():
        torch.testing.assert_close(t, saved["weights"]["latest"][name],
                                   rtol=0, atol=0)
    opt = saved[TRAIN_STATE_KEY]["optimizer"]["state"]
    state = run.runner.optimizer.state
    for i, p in enumerate(run.runner.net.parameters()):
        torch.testing.assert_close(state[p]["exp_avg_var"],
                                   opt[i]["exp_avg_var"], rtol=0, atol=0)
    assert float(run.runner.train(run.stream.next())["loss"]) >= 0


def test_train_raises_without_cuda_unless_cpu_is_asked(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plots = str(tmp_path / "plots")
    _write_plots(plots, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([f"input={plots}/*.npz",
                    f"checkpoint_dir={tmp_path}/ck", "steps=1"])
