"""Several ranks on one dataroot: every file the port's data layer writes
there goes through `data/atomic.atomic_write` (a temporary name beside the
target, then `os.replace`). A failed write or rename leaves no file and
raises; a stray temporary file beside `done.flag` is neither read nor
breaks the cache's numeric sort; and three processes that start 50 ms
apart on one empty root, each generating the synthetic NFI dataset,
processing it and reading every sample back, read the samples of a
one-process build and leave a cache that gives them to the port and the
JAX `LasDataset`, and no temporary file. About 10 s on one worker."""
import hashlib
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.data import dataset as jds
from dpcr_agb_tpu_torch.config import load_config as tload
from dpcr_agb_tpu_torch.data import atomic
from dpcr_agb_tpu_torch.data import dataset as tds
from tests.test_torch_dataset import CONF, assert_same_samples
from tests.test_torch_parallel import REPO

SPLITS = os.path.join("synthetic", "processed_nfi_reg")


def _overrides(root):
    return ["task=instance", "models=instance/minkowski_baseline",
            "model_name=SENet14", "data=instance/synthetic/reg",
            "data.transform_type=sparse_xy", "data.synthetic_plots=10",
            f"data.dataroot={root}", "data.in_memory=False",
            "run_dir=unused"]


def _port(root):
    return tds.instantiate_dataset(tload(CONF, "config",
                                         _overrides(root))["data"])


def _temp_files(root):
    return [os.path.join(d, f) for d, _, files in os.walk(root)
            for f in files if f.endswith(".tmp")]


def test_temp_name_is_hidden_and_unique_to_the_writer(tmp_path):
    name = atomic.temp_name(str(tmp_path / "7.npz"))
    assert os.path.dirname(name) == str(tmp_path)
    assert os.path.basename(name) == (
        f".7.npz.{os.getpid()}.{threading.get_ident()}.tmp")
    other = []
    t = threading.Thread(target=lambda: other.append(
        atomic.temp_name(str(tmp_path / "7.npz"))))
    t.start()
    t.join()
    assert other[0] != name


def test_a_failed_rename_raises_and_leaves_no_file(tmp_path, monkeypatch):
    target = tmp_path / "0.npz"

    def refuse(src, dst):
        raise OSError("rename refused")
    monkeypatch.setattr(os, "replace", refuse)
    with pytest.raises(OSError, match="rename refused"):
        with atomic.atomic_write(target) as tmp, open(tmp, "wb") as fh:
            np.savez_compressed(fh, a=np.arange(3))
    assert os.listdir(tmp_path) == []


def test_a_failed_write_raises_and_leaves_no_file(tmp_path):
    with pytest.raises(ValueError, match="half written"):
        with atomic.atomic_write(tmp_path / "nfi.gpkg") as tmp:
            with open(tmp, "wb") as fh:
                fh.write(b"SQLite")
            raise ValueError("half written")
    assert os.listdir(tmp_path) == []


def test_a_write_lands_whole_under_its_name(tmp_path):
    target = tmp_path / "3.npz"
    with atomic.atomic_write(target) as tmp, open(tmp, "wb") as fh:
        np.savez_compressed(fh, a=np.arange(5))
    assert os.listdir(tmp_path) == ["3.npz"]
    np.testing.assert_array_equal(np.load(target)["a"], np.arange(5))


def test_a_stray_temp_file_is_not_read(tmp_path):
    root = str(tmp_path / "data")
    want = _port(root)
    area = os.path.join(root, SPLITS, "train", "SYNTH")
    assert os.path.exists(os.path.join(area, "done.flag"))
    stray = os.path.join(area, f".7.npz.{os.getpid()}.{threading.get_ident()}"
                         ".tmp")
    with open(stray, "wb") as fh:
        fh.write(b"PK\x03\x04 half a zip")
    got = _port(root)
    assert not any(str(f).endswith(".tmp")
                   for f in got.datasets["train"]._files)
    assert_same_samples(want, got)


def _digest(ds):
    """sha256 over every sample's arrays, split by split."""
    h = hashlib.sha256()
    for split in ("train", "val", "test"):
        for i in range(len(ds.datasets[split])):
            for k, v in sorted(ds.datasets[split].get(i).items()):
                h.update(k.encode() + np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


# one process of the shared root: it builds the dataset when its gate
# opens, reads every sample back and prints their digest
CHILD = """
import hashlib, json, os, sys, time
import numpy as np
from dpcr_agb_tpu_torch.config import load_config
from dpcr_agb_tpu_torch.data import dataset
conf, gate, me, overrides = sys.argv[1:5]
cfg = load_config(conf, "config", json.loads(overrides))["data"]
open(os.path.join(gate, "ready" + me), "w").close()
while not os.path.exists(os.path.join(gate, "go" + me)):
    time.sleep(0.001)
""" + inspect.getsource(_digest) + """
print(_digest(dataset.instantiate_dataset(cfg)))
"""
# the processes start 50 ms apart: each later one generates and
# processes while the earlier ones read the files it rewrites (with
# in-place writes a process then reads a truncated file and fails)
STAGGER_S = 0.05


def test_three_processes_build_one_root_as_one_process(tmp_path):
    shared, gate = str(tmp_path / "shared"), tmp_path / "gate"
    gate.mkdir()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, CONF, str(gate), str(r),
         json.dumps(_overrides(shared))], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(3)]
    try:
        deadline = time.monotonic() + 120
        while len(os.listdir(gate)) < 3 and time.monotonic() < deadline \
                and all(p.poll() is None for p in procs):
            time.sleep(0.01)
        for r in range(3):
            (gate / f"go{r}").touch()
            time.sleep(STAGGER_S)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{out[-3000:]}"
    assert _temp_files(shared) == []
    one = _port(str(tmp_path / "one"))
    assert [o.strip().splitlines()[-1] for o in outs] == [_digest(one)] * 3
    got = _port(shared)
    assert_same_samples(one, got)
    jax_reads = jds.instantiate_dataset(jload(CONF, "config",
                                              _overrides(shared))["data"])
    assert_same_samples(jax_reads, one)
