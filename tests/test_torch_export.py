"""The port's export (`dpcr_agb_tpu_torch.export_model`, the custom ops of
`kernels/ops.py`, `models.factory.export_aux`) held against the JAX
package's on the CPU.

- The five ops pass `torch.library.opcheck` (schema, fake kernel against
  the CPU kernel, autograd registration, AOT dispatch) on small CPU
  inputs: a [2,6,5,7,3] volume with 9 sites a sample, 16-channel rows and
  volumes of its size, a permuted volume for the copy, 40 points for fps.
- `export_aux` equals the JAX one for the cases of `tests/test_models.py`'s
  `TestExportAux`: the full z extent of a dense-grid SENet14 (24,24,104),
  map mode and KPConv refused naming predict, a point model's None.
- Artifact parity: one JAX-layout `.ckpt` a model (the port's seeded
  init, parameters moved by 0.05 normal noise, random BN running stats,
  `to_flax`) goes through the JAX package's `scripts/export_model.main`
  (StableHLO, run with `.call`) and through
  `export_model.main(..., "device=cpu")` (the `.pt2`, run after `load`).
  Both get the same padded inputs, made with numpy from a seed: batch 2,
  one sample padded. SENet14 at full width over a (16,16,16) volume with
  512 rows, through the sparse level 0 and through the dense one (both
  packages under DPCR_L0=dense, DPCR_STEM_MODE=zfold2d_firewall,
  DPCR_POOL_BWD=pallas: the JAX package's module globals, the port's
  environment when the net is built); MPointNet on the same rows;
  PointNeXt-S (num_points 512, nsample 8) on 640 tie-free points, so the
  input FPS runs. Tolerances: those `tests/test_torch_checkpoint.py`
  holds each model's predictions to (atol 1e-4 at the targets' scale
  (4, 8), rtol 1e-5 for MPointNet), and for PointNeXt-S
  `tests/test_torch_pointnext.py`'s (1e-5 of max|pred - center| plus one
  f32 ulp). The sidecars agree key for key but for `platforms` and the
  port's own keys.
- The exported graph calls each op as often as `chip_smoke.py`'s export
  phase counts its kernel's launches (sparse level 0: stem_sites and
  max_pool_k3s2_rows once; dense: firewall_copy twice, max_pool_k3s2
  once; PointNeXt-S: fps 5 times; MPointNet none) and no other op of the
  namespace.
- One fresh process loads the four `.pt2`s through `load` with no module
  of `models/`, `training/` or `data/` imported, and gives the same
  outputs.
- KPConv and map mode refuse to export, and the entry point without
  CUDA and without `device=cpu` raises, as `load` to CUDA does."""
import importlib.util
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.models import factory as jfactory
from dpcr_agb_tpu.models.kpconv import KPCNN as JKPCNN
from dpcr_agb_tpu.models.minkowski import build_resnet as jbuild_resnet
from dpcr_agb_tpu.models.pointnet import MPointNet as JMPointNet
from dpcr_agb_tpu.ops import dense_grid as jgrid
from dpcr_agb_tpu.training.state import Checkpoint as JCheckpoint
from dpcr_agb_tpu_torch import export_model, train
from dpcr_agb_tpu_torch.kernels import ops as kops
from dpcr_agb_tpu_torch.models.factory import build_model, export_aux
from dpcr_agb_tpu_torch.models.minkowski import build_resnet
from dpcr_agb_tpu_torch.serving import save_checkpoint
from tests import test_torch_checkpoint as tck
from tests import test_torch_pointnext as tpn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf")
DIMS = (16, 16, 16)
B, V, N_POINTS = 2, 512, 640
DENSE_ENV = {"DPCR_L0": "dense", "DPCR_STEM_MODE": "zfold2d_firewall",
             "DPCR_POOL_BWD": "pallas"}
JAX_GLOBALS = {"DPCR_L0": "L0_MODE", "DPCR_STEM_MODE": "STEM_MODE",
               "DPCR_POOL_BWD": "POOL_BWD_MODE"}
# case -> (model_name, environment, op calls in the exported graph)
CASES = {
    "SENet14": ("SENet14", {}, {"stem_sites": 1, "max_pool_k3s2_rows": 1}),
    "SENet14-denseL0": ("SENet14", DENSE_ENV,
                        {"firewall_copy": 2, "max_pool_k3s2": 1}),
    "MPointNet": ("MPointNet", {}, {}),
    "PointNext": ("PointNext", {}, {"fps": 5}),
}
PORT_KEYS = {"modes", "dtype", "numerics"}


def _jax_export_main():
    spec = importlib.util.spec_from_file_location(
        "jax_export_model", os.path.join(ROOT, "scripts", "export_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


# ---- the ops ---------------------------------------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)
    b, d, h, w, cin = 2, 6, 5, 7, 3
    vol = torch.randn(b, d, h, w, cin, generator=g)
    coords = torch.randint(0, 6, (b, 9, 3), generator=g, dtype=torch.int32)
    mask = torch.rand(b, 9, generator=g) > 0.3
    wts = torch.randn(343, cin, 64, generator=g)
    rows = torch.randn(b, 9, 16, generator=g)
    x = torch.randn(b, d, h, w, 16, generator=g)
    occ = (torch.rand(b, d, h, w, 1, generator=g) > 0.5).float()
    pos = torch.rand(b, 40, 3, generator=g)
    return {
        "stem_sites": (kops.stem_sites, (vol, coords, mask, wts,
                                         torch.randn(64, generator=g))),
        "stem_sites-no-bias": (kops.stem_sites, (vol, coords, mask, wts)),
        "max_pool_k3s2_rows": (kops.max_pool_k3s2_rows,
                               (coords, mask, rows, [d, h, w])),
        "max_pool_k3s2": (kops.max_pool_k3s2, (x, occ)),
        "firewall_copy": (kops.firewall_copy, (x.permute(0, 2, 1, 3, 4),)),
        "fps": (kops.fps, (pos, torch.rand(b, 40, generator=g) > 0.2, 10,
                           3)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_op_passes_opcheck(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    assert op._qualname == f"{kops.NAMESPACE}::{name.split('-')[0]}"


def test_ops_take_the_plain_version_on_the_cpu_and_alias_nothing():
    for name, (op, args) in _op_cases().items():
        out = op(*args)
        for o in (out if isinstance(out, tuple) else (out,)):
            assert o.is_contiguous() and all(
                o.data_ptr() != a.data_ptr() for a in args
                if isinstance(a, torch.Tensor)), name
    assert set(kops.OPS) == {n.split("-")[0] for n in _op_cases()}


# ---- export_aux --------------------------------------------------------------

def _aux_nets(case):
    """(port net, JAX net) of one TestExportAux case."""
    if case in ("dense", "map"):
        dd = (24, 24, 104) if case == "dense" else None
        option = {"activation": "gelu", "first_stride": 1,
                  "global_pool": "sum", "extra_options": {"dense_dims": dd}}

        class _DS:
            num_reg_classes = 2

        return (build_resnet("SENet14", option, 2, 3),
                jbuild_resnet("SENet14", option, _DS()))
    if case == "kpconv":
        net, _ = build_model(train.model_option("KPConv", False), 2, 3)
        return net, JKPCNN(architecture=["simple", "global_sum"],
                           num_reg_targets=2, in_features_dim=1)
    net, _ = build_model(train.model_option("MPointNet", False), 2, 3)
    return net, JMPointNet(num_reg_targets=2)


@pytest.mark.parametrize("case", ["dense", "map", "kpconv", "point"])
def test_export_aux_matches_jax(case):
    mine, ref = _aux_nets(case)
    if case in ("map", "kpconv"):
        with pytest.raises(ValueError, match="predict"):
            export_aux(mine)
        with pytest.raises(ValueError, match="predict"):
            jfactory.export_aux(ref)
        return
    got, want = export_aux(mine), jfactory.export_aux(ref)
    if want is None:
        assert got is None
        return
    assert set(got) == set(want) == {"zcells"}
    assert got["zcells"].dtype == want["zcells"].dtype == np.int8
    np.testing.assert_array_equal(got["zcells"], want["zcells"])
    assert got["zcells"].shape == (104,)


# ---- artifacts ----------------------------------------------------------------

def _rc(model_name):
    if model_name == "PointNext":
        rc = jload(CONF, "config", [
            "task=instance", "data=instance/NFI/reg", "model_name=PointNext",
            "models=instance/pointnext", "data.transform_type=fixed_xy"]
        ).to_dict()
        rc["models"]["PointNext"].update(tpn.CUT)
        return rc
    rc = tck._run_config(model_name)
    if model_name == "SENet14":
        rc["models"]["SENet14"]["extra_options"]["dense_dims"] = list(DIMS)
    return rc


def _write_ckpt(ckpt_dir, model_name):
    rc = _rc(model_name)
    net, _ = build_model(rc["models"][model_name], 2, 3,
                         generator=torch.Generator().manual_seed(0))
    params, stats = tpn._perturbed(net.state_dict(),
                                   np.random.default_rng(0))
    ck = JCheckpoint(rc, dict(tck.PROPS))
    ck.models["latest"] = {"params": params, "batch_stats": stats}
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, f"{model_name}.ckpt"), "wb") as f:
        f.write(ck.to_bytes())


def _inputs(model_name, seed=0):
    """(pos, x, mask, coords) numpy arrays: sample 0 full, sample 1
    padded from two thirds on (zeros, PAD_COORD)."""
    rng = np.random.default_rng(seed)
    n = N_POINTS if model_name == "PointNext" else V
    mask = np.zeros((B, n), bool)
    mask[0], mask[1, :2 * n // 3] = True, True
    coords = np.full((B, n, 3), export_model.PAD_COORD, np.int32)
    if model_name == "PointNext":
        # a 0.1 cube: ~0.012 between points, the first radius 0.0125
        pos = rng.uniform(0.0, 0.1, (B, n, 3)).astype(np.float32)
    else:
        for i in range(B):
            k = int(mask[i].sum())
            flat = rng.choice(int(np.prod(DIMS)), size=k, replace=False)
            coords[i, :k] = np.stack(np.unravel_index(flat, DIMS), 1)
        pos = (coords * 0.05).astype(np.float32)
    x = np.concatenate([np.ones((B, n, 1)), pos[..., 2:] * 2.0,
                        rng.uniform(0, 1, (B, n, 1))], -1).astype(np.float32)
    pos, x = (np.where(mask[..., None], a, 0).astype(np.float32)
              for a in (pos, x))
    return pos, x, mask, coords


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """case -> both packages' artifacts of the case, their sidecars and
    their outputs on the case's inputs (each made once, when first
    asked for)."""
    jax_export, made = _jax_export_main(), {}

    def get(case):
        if case not in made:
            made[case] = _export_case(case, tmp_path_factory.mktemp(case),
                                      jax_export)
        return made[case]
    return get


def _export_case(case, root, jax_export) -> dict:
    model_name, env, _ = CASES[case]
    ckpt = str(root / "ckpt")
    _write_ckpt(ckpt, model_name)
    n = N_POINTS if model_name == "PointNext" else V
    args = [f"checkpoint_dir={ckpt}", f"model_name={model_name}",
            f"batch_size={B}", f"num_points={n}"]
    inputs = _inputs(model_name)
    with pytest.MonkeyPatch.context() as mp:
        for var, value in env.items():
            mp.setenv(var, value)
            mp.setattr(jgrid, JAX_GLOBALS[var], value)
        jpath = jax_export(args + [f"output={root}/model.stablehlo"])
        from jax import export as jexport
        with open(jpath, "rb") as f:
            back = jexport.deserialize(f.read())
        want = np.asarray(back.call(*inputs))
        ppath = export_model.main(args + [f"output={root}/model.pt2",
                                          "device=cpu"])
    with torch.no_grad():
        got = export_model.load(ppath)(
            *(torch.from_numpy(a) for a in inputs)).numpy()
    sidecars = []
    for p in (jpath, ppath):
        with open(p + ".json") as f:
            sidecars.append(json.load(f))
    return dict(case=case, model_name=model_name, root=root, path=ppath,
                inputs=inputs, got=got, want=want, sidecars=sidecars)


@pytest.fixture(params=list(CASES))
def exported(request, artifacts):
    return artifacts(request.param)


def test_artifact_matches_the_jax_export(exported):
    got, want = exported["got"], exported["want"]
    name = exported["model_name"]
    center = np.asarray(tck.PROPS["target_stats"]["center"])
    assert got.shape == want.shape == (B, 2) and got.dtype == np.float32
    assert np.isfinite(got).all() and np.ptp(want[:, 0]) > 1e-4
    if name == "PointNext":
        tpn._agree(got, want, center, exported["case"])
    else:
        np.testing.assert_allclose(got - center, want - center,
                                   rtol=tck.RTOL[name], atol=1e-4)


def test_sidecar_matches_the_jax_sidecar(exported):
    jside, pside = exported["sidecars"]
    assert set(pside) == set(jside) | PORT_KEYS
    for key in set(jside) - {"platforms"}:
        assert pside[key] == jside[key], key
    assert pside["platforms"] == ["cpu"]
    env = CASES[exported["case"]][1]
    if exported["model_name"] == "SENet14":
        assert pside["modes"]["sparse_level0"] == (not env)
        assert pside["modes"]["stem_mode"] == env.get("DPCR_STEM_MODE",
                                                      "xla3d")
    else:
        assert pside["modes"] is None


def test_graph_holds_the_ops(exported):
    program = torch.export.load(exported["path"])
    calls = Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function"
        and str(n.target).startswith(kops.NAMESPACE + "."))
    assert dict(calls) == CASES[exported["case"]][2]


LOADER = """
import sys
import numpy as np
import torch
from dpcr_agb_tpu_torch import export_model
for path, inputs, out in zip(*(iter(sys.argv[1:]),) * 3):
    m = export_model.load(path)
    with np.load(inputs) as z:
        args = [torch.from_numpy(z[k]) for k in ("pos", "x", "mask",
                                                  "coords")]
    with torch.no_grad():
        np.save(out, m(*args).numpy())
loaded = sorted(k for k in sys.modules if k.startswith((
    "dpcr_agb_tpu_torch.models", "dpcr_agb_tpu_torch.training",
    "dpcr_agb_tpu_torch.data")))
assert not loaded, loaded
"""


def test_a_fresh_process_serves_the_artifacts_without_the_model_code(
        artifacts):
    """One process loads all four artifacts."""
    argv = []
    for case in CASES:
        a = artifacts(case)
        np.savez(a["root"] / "in.npz", **dict(zip(
            ("pos", "x", "mask", "coords"), a["inputs"])))
        argv += [a["path"], str(a["root"] / "in.npz"),
                 str(a["root"] / "out.npy")]
    subprocess.run([sys.executable, "-c", LOADER, *argv], check=True,
                   cwd=ROOT, timeout=300,
                   env={**os.environ, "PYTHONPATH": ROOT})
    for case in CASES:
        a = artifacts(case)
        np.testing.assert_allclose(np.load(a["root"] / "out.npy"), a["got"],
                                   rtol=1e-6, atol=0, err_msg=case)


# ---- refusals and devices ------------------------------------------------------

@pytest.mark.parametrize("model_name,dense_dims", [("KPConv", None),
                                                   ("SENet14", "null")])
def test_kpconv_and_map_mode_refuse_to_export(tmp_path, model_name,
                                              dense_dims):
    option = train.model_option(model_name, False, dense_dims=dense_dims)
    net, _ = build_model(option, 2, 3)
    save_checkpoint(str(tmp_path), model_name, net, option, 3,
                    train.MODELS[model_name][1](), tck.PROPS["target_stats"],
                    tck.PROPS["reg_targets"])
    with pytest.raises(ValueError, match="predict"):
        export_model.main([f"checkpoint_dir={tmp_path}",
                           f"model_name={model_name}",
                           f"output={tmp_path}/m.pt2", "device=cpu"])
    assert not os.path.exists(tmp_path / "m.pt2")


def test_load_pins_the_float32_precision(monkeypatch, tmp_path):
    """`load` turns TF32 off as the entry points do (PyTorch's default
    has it on in cuDNN's convolutions)."""
    option = train.model_option("MPointNet", False)
    net, _ = build_model(option, 2, 3)
    save_checkpoint(str(tmp_path), "MPointNet", net, option, 3,
                    train.MODELS["MPointNet"][1](),
                    tck.PROPS["target_stats"], tck.PROPS["reg_targets"])
    path = export_model.main([
        f"checkpoint_dir={tmp_path}", "model_name=MPointNet",
        f"output={tmp_path}/m.pt2", "batch_size=2", "num_points=64",
        "device=cpu"])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    export_model.load(path)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_export_and_load_without_cuda_raise(tmp_path):
    option = train.model_option("MPointNet", False)
    net, _ = build_model(option, 2, 3)
    save_checkpoint(str(tmp_path), "MPointNet", net, option, 3,
                    train.MODELS["MPointNet"][1](),
                    tck.PROPS["target_stats"], tck.PROPS["reg_targets"])
    args = [f"checkpoint_dir={tmp_path}", "model_name=MPointNet",
            f"output={tmp_path}/m.pt2", "batch_size=2", "num_points=64"]
    with pytest.raises(RuntimeError, match="device=cpu"):
        export_model.main(args)
    export_model.main(args + ["device=cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.load(f"{tmp_path}/m.pt2", device="cuda")
    with pytest.raises(ValueError, match="output="):
        export_model.main(args[:2])
