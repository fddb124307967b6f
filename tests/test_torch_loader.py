"""The port's Loader against the JAX package's: two epochs over the same
dataset with the same transform chain and seed give the same index streams
and the same collated batches (every array bit-equal), with 1 and 3 worker
threads, shuffled with drop_last (train) and in order with a padded last
batch (eval). A batch copied by `device_put` on the CPU is the same batch
as tensors; a shard (1, 2) gives the second half of each batch, and a
batch size or double batch that a shard cannot split raises as the JAX
loader does."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.data import dataset as jds
from dpcr_agb_tpu.data.batch import CollateSpec as JSpec
from dpcr_agb_tpu.data.loader import Loader as JLoader
from dpcr_agb_tpu_torch.config import load_config as tload
from dpcr_agb_tpu_torch.data import dataset as tds
from dpcr_agb_tpu_torch.data.batch import CollateSpec as TSpec
from dpcr_agb_tpu_torch.data.batch import device_put, wait_ready
from dpcr_agb_tpu_torch.data.loader import Loader as TLoader

CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader")
    ov = ["task=instance", "models=instance/minkowski_baseline",
          "model_name=SENet14", "data=instance/synthetic/reg",
          "data.transform_type=sparse_xy", "data.synthetic_plots=20",
          f"data.dataroot={root}", "run_dir=unused"]
    jd = jds.instantiate_dataset(jload(CONF, "config", ov)["data"])
    td = tds.instantiate_dataset(tload(CONF, "config", ov)["data"])
    return jd, td


def _spec(cls):
    return cls(conv_type="sparse", use_coords=True,
               buckets=(4096, 8192, 16384), min_bucket=1024)


def assert_same_batch(jb, tb):
    for f in dataclasses.fields(jb):
        want = getattr(jb, f.name)
        got = getattr(tb, f.name)
        if want is None:
            assert got is None, f.name
            continue
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("split,shuffle", [("train", True), ("val", False),
                                           ("test", False)])
def test_loader_batches_equal_jax(datasets, workers, split, shuffle):
    jd, td = datasets
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=shuffle, seed=11,
              num_workers=workers)
    jl = JLoader(jd.datasets[split], jd.transform_for(split),
                 spec=_spec(JSpec), **kw)
    tl = TLoader(td.datasets[split], td.transform_for(split),
                 spec=_spec(TSpec), **kw)
    assert len(tl) == len(jl)
    for epoch in (0, 1):
        np.testing.assert_array_equal(tl._epoch_indices(epoch),
                                      jl._epoch_indices(epoch))
        jbs, tbs = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jbs) == len(tbs) > 0
        for jb, tb in zip(jbs, tbs):
            assert_same_batch(jb, tb)


def test_double_batch_stream_equals_jax(datasets):
    jd, td = datasets
    kw = dict(batch_size=4, shuffle=True, double_batch=True, seed=5,
              num_workers=2)
    jl = JLoader(jd.datasets["train"], jd.transform_for("train"),
                 spec=_spec(JSpec), **kw)
    tl = TLoader(td.datasets["train"], td.transform_for("train"),
                 spec=_spec(TSpec), **kw)
    for jb, tb in zip(jl.epoch(3), tl.epoch(3)):
        assert tb.is_double.any()
        assert_same_batch(jb, tb)


def test_device_put_on_the_cpu_and_shards(datasets):
    _, td = datasets
    tl = TLoader(td.datasets["val"], td.transform_for("val"), batch_size=2,
                 spec=_spec(TSpec),
                 put_fn=lambda b: device_put(b, torch.device("cpu"), None))
    plain = TLoader(td.datasets["val"], td.transform_for("val"),
                    batch_size=2, spec=_spec(TSpec))
    for moved, host in zip(tl.epoch(0), plain.epoch(0)):
        assert moved.ready is None and isinstance(moved.pos, torch.Tensor)
        assert wait_ready(moved) is moved
        assert_same_batch(host, moved)
    # a shard is the process's half of each batch (its reassembly is
    # held in tests/test_torch_parallel.py); the JAX loader's refusals
    half = TLoader(td.datasets["val"], td.transform_for("val"), batch_size=2,
                   spec=_spec(TSpec), shard=(1, 2))
    assert half.local_batch_size == 1
    for got, host in zip(half.epoch(0), plain.epoch(0)):
        np.testing.assert_array_equal(got.label_idx, host.label_idx[1:])
    with pytest.raises(ValueError, match="divide"):
        TLoader(td.datasets["val"], td.transform_for("val"), batch_size=3,
                spec=_spec(TSpec), shard=(1, 2))
    with pytest.raises(ValueError, match="double_batch"):
        TLoader(td.datasets["val"], td.transform_for("val"), batch_size=2,
                spec=_spec(TSpec), double_batch=True, shard=(1, 2))
