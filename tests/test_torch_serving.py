"""The port's host layer and serving entry point on the CPU: the NFI data
config, the synthetic plot generator, the pre/eval transforms, collate and
the dense-path post_collate must give arrays equal to the JAX package's;
`python -m dpcr_agb_tpu_torch.predict ... device=cpu` must write the
predictions of a direct forward, and must raise without device=cpu where
there is no CUDA."""
import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import predict as jax_predict
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.config import load_config
from dpcr_agb_tpu.data.batch import CollateSpec as JSpec
from dpcr_agb_tpu.data.batch import collate as jcollate
from dpcr_agb_tpu.data.synthetic import generate_plot as jgenerate_plot
from dpcr_agb_tpu.models.factory import make_post_collate as jpost_collate
from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet
from dpcr_agb_tpu.transforms import instantiate_transforms as jtransforms
from dpcr_agb_tpu.transforms.core import _flatten
from dpcr_agb_tpu_torch import predict
from dpcr_agb_tpu_torch.data.batch import collate
from dpcr_agb_tpu_torch.data.synthetic import generate_plot
from dpcr_agb_tpu_torch.models.factory import collate_spec, make_post_collate
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet, build_resnet
from dpcr_agb_tpu_torch.serving import nfi_sparse_xy_data_cfg, save_checkpoint
from dpcr_agb_tpu_torch.transforms import instantiate_transforms


@pytest.fixture(autouse=True, scope="module")
def _jax_layout_restored():
    """The JAX trainer behind the root CLIs (eval.py, predict.py) sets the
    JAX package's batch layout (`dpcr_agb_tpu.ops.layout`) for its
    8-device mesh and keeps it: the files after this one in the same test
    worker get it back as it was, as tests/test_torch_trainer.py does (a
    leaked per-sample layout fails tests/test_sparse_stem.py's chunked
    pool backward)."""
    saved = (jlayout.BATCH_LOCAL, jlayout.DATA_PARALLEL_DEGREE)
    yield
    jlayout.set_batch_local(*saved)


CONF = os.path.join(os.path.dirname(__file__), "..", "conf")


def _write_plots(tmp_path, n, density=12.0, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        pts, _, _ = generate_plot(rng, density=density)
        p = tmp_path / f"plot_{i:02d}.npz"
        np.savez(p, pos=pts + np.array([5e5, 6e6, 120.0], np.float32))
        paths.append(str(p))
    return paths


def test_data_config_mirrors_the_yaml():
    cfg = load_config(CONF, "config", [
        "task=instance", "data=instance/NFI/reg", "model_name=SENet14",
        "models=instance/minkowski_baseline",
        "data.transform_type=sparse_xy"]).data.to_dict()
    mine = nfi_sparse_xy_data_cfg()
    assert mine["pre_transform"] == cfg["pre_transform"]
    assert mine["test_transform"] == list(
        _flatten(cfg["sparse_xy"]["test_transform"]))
    for k in ("x_scale", "y_scale", "z_scale", "x_center", "y_center",
              "first_subsampling"):
        assert mine[k] == cfg[k]


def test_generate_plot_matches_jax():
    a = generate_plot(np.random.default_rng(4), density=20.0)
    b = jgenerate_plot(np.random.default_rng(4), density=20.0)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


def test_host_layer_equals_jax(tmp_path):
    """3 plots: file reading + centering + pre_transform, the eval chain
    (one rng through all plots), collate and the dense-path post_collate."""
    files = _write_plots(tmp_path, 3)
    cfg = nfi_sparse_xy_data_cfg()
    pre, ev = (instantiate_transforms(cfg["pre_transform"]),
               instantiate_transforms(cfg["test_transform"]))
    jpre, jev = (jtransforms(cfg["pre_transform"]),
                 jtransforms(cfg["test_transform"]))
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    samples, jsamples = [], []
    for f in files:
        s = predict.sample_from_file(f, [], None, pre)
        js = jax_predict._sample_from_file(f, [], None, jpre)
        assert s.keys() == js.keys()
        for k in s:
            np.testing.assert_array_equal(s[k], js[k])
        samples.append(ev(rng, s))
        jsamples.append(jev(jrng, js))
    for s, js in zip(samples, jsamples):
        assert s.keys() == js.keys()
        for k in s:
            np.testing.assert_array_equal(s[k], js[k])
        assert s["x"].shape[1] == 3 and s["coords"].dtype == np.int32

    spec = collate_spec("SPARSE", cfg)
    jspec = JSpec(conv_type="sparse", use_coords=True,
                  buckets=(4096, 8192, 16384), min_bucket=1024)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    net = SparseResNet(2, "se_basic", (1, 1, 1, 1), 3,
                       planes=(16, 16, 32, 32), init_dim=16)
    jnet = JNet(num_reg_targets=2, block="se_basic", layers=(1, 1, 1, 1))
    got = make_post_collate(net)(collate(samples, spec, pad_to_batch=4))
    want = jpost_collate(jnet)(jcollate(jsamples, jspec, pad_to_batch=4))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "aux":
            np.testing.assert_array_equal(a["zcells"], b["zcells"])
        elif b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def _tiny_checkpoint(tmp_path):
    option = {"class": "minkowski.MinkowskiBaselineModel",
              "conv_type": "SPARSE", "model_name": "SENet14",
              "activation": "gelu", "first_stride": 1, "dropout": 0.0,
              "drop_path": 0.01, "global_pool": "sum",
              "extra_options": {"dense_dims": [16, 16, 16]}}
    g = torch.Generator().manual_seed(0)
    net = build_resnet("SENet14", option, 2, 3, generator=g)
    for name, buf in net.named_buffers():
        if name.endswith(".mean"):
            buf.normal_(0.0, 0.1, generator=g)
        else:
            buf.uniform_(0.5, 1.5, generator=g)
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), "SENet14", net, option, 3,
                    nfi_sparse_xy_data_cfg(),
                    {"scale": [40.0, 80.0], "center": [100.0, 200.0],
                     "weights": [0.5, 0.5]}, ["BMag_ha", "V_ha"])
    return str(ckpt)


def test_predict_on_cpu_writes_direct_forward(tmp_path):
    ckpt = _tiny_checkpoint(tmp_path)
    files = _write_plots(tmp_path, 3, density=3.0, seed=1)
    out = predict.main([f"checkpoint_dir={ckpt}", "model_name=SENet14",
                        f"input={tmp_path}/*.npz",
                        f"output={tmp_path}/preds.csv", "batch_size=2",
                        "device=cpu"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["file", "pred_BMag_ha", "pred_V_ha"]
    assert [r[0] for r in rows[1:]] == [os.path.basename(p) for p in files]
    got = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    assert np.isfinite(got).all()

    # direct forward of the same three plots as one batch
    bundle = predict.load_serving_bundle(ckpt, "SENet14", device="cpu")
    samples, _ = predict.load_samples(bundle, files)
    (batch, n), = predict.make_batches(bundle, samples, 3)
    with torch.no_grad():
        raw = bundle.net(batch.to("cpu"))
    want = predict.predictions(bundle, raw)[:n]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_predict_raises_without_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    ckpt = _tiny_checkpoint(tmp_path)
    _write_plots(tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([f"checkpoint_dir={ckpt}", "model_name=SENet14",
                      f"input={tmp_path}/*.npz"])
