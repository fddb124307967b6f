"""Data parallelism of the port (`dpcr_agb_tpu_torch.parallel`) on the CPU:
two ranks in two processes over loopback gloo, each on its contiguous half
of a global batch, against one process on the whole batch and against the
JAX package's step over a 2-device mesh.

One launch of two ranks (module fixture, ~15 s) runs every case and saves
what it computed; the tests compare:
  * `all_reduce_sum`'s forward (the sum) and backward (the cotangent
    summed over ranks);
  * the synced `MaskedBatchNorm` forward, its gradients of x, scale and
    bias and its running statistics against one process on the
    concatenated batch, and `MaskedGRN` the same way (rtol 1e-6);
  * the loss with different target counts on the two ranks (and its
    double-batch form): the ranks' losses add up to the global loss, their
    gradients are its gradient;
  * DropPath's and Dropout's coins: the global batch's, each rank its rows;
  * the z bucket pinned to the full extent when the world holds 2 ranks;
  * one train step of a narrow SENet14 (sparse level 0), a narrow rigid
    KPCNN on the host pyramid and MPointNet against `StepRunner(
    mesh=make_mesh(2))` of the JAX package on the global batch (SENet14's
    blocks rematerialized on each rank), with the
    tolerances of tests/test_torch_train.py (loss rel 1e-5, each gradient
    rel-L2 1e-4, parameters and BN stats rtol 1e-4, atol 1e-5), the JAX
    layout flag restored after;
  * SENet14 in bf16: the 2-rank step no farther from the JAX mesh step
    than the one-process step is, and within the f32 row of
    chip_smoke.py's STEP_TOL of the one-process step with every gradient
    element within one bf16 ulp of it (each rank hands the SUM its f32
    partials; every sum over the global batch is rounded to bf16 once,
    `parallel/rounding.py`);
  * a narrow deformable KPCNN with an elastic penalty: the deformable
    terms and the penalty, 1/world of each a rank, give the one-process
    step.
In this process: the loader's shards put together are the unsharded
batches and the JAX loader's shard batches bit for bit, and every
refusal (loader, trainer, device, process-group start, the input= form).
About 65 s on one worker, most of it the four JAX compiles."""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.data import dataset as jds
from dpcr_agb_tpu.data.batch import CollateSpec as JSpec
from dpcr_agb_tpu.data.loader import Loader as JLoader
from dpcr_agb_tpu.models.base import InstanceSpec as JInstanceSpec
from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
from dpcr_agb_tpu.models.kpconv import KPCNN as JKPCNN
from dpcr_agb_tpu.models.minkowski import SparseResNet as JSENet
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.parallel.mesh import make_mesh
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.state import TrainState
from dpcr_agb_tpu.training.step import StepRunner as JRunner
from dpcr_agb_tpu.training.step import _forward
from dpcr_agb_tpu_torch import device as tdevice
from dpcr_agb_tpu_torch import parallel, train
from dpcr_agb_tpu_torch.config import load_config as tload
from dpcr_agb_tpu_torch.data import dataset as tds
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.data.batch import CollateSpec as TSpec
from dpcr_agb_tpu_torch.data.loader import Loader as TLoader
from dpcr_agb_tpu_torch.models.base import InstanceSpec, compute_reg_loss
from dpcr_agb_tpu_torch.models.kpconv import KPCNN
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet
from dpcr_agb_tpu_torch.models.pointnet import MPointNet
from dpcr_agb_tpu_torch.nn.blocks import DropPath, Dropout
from dpcr_agb_tpu_torch.nn.norm import MaskedBatchNorm, MaskedGRN
from dpcr_agb_tpu_torch.training.regularizers import build_regularizer
from dpcr_agb_tpu_torch.weights import from_flax
from tests.test_torch_deformable import NARROW as DEFORM_NARROW
from tests.test_torch_deformable import _fields as deform_fields
from tests.test_torch_deformable import _host_aux as deform_aux
from tests.test_torch_host_pyramid import _Jitted, _with_aux
from tests.test_torch_kpconv_train import NARROW as KP_NARROW
from tests.test_torch_kpconv_train import _fields as kp_fields
from tests.test_torch_pointnet import EMBED
from tests.test_torch_pointnet import _fields as pn_fields
from tests.test_torch_pointnet import _nets as pn_nets
from tests.test_torch_rounding import bf16_ulps
from tests.test_torch_train import NARROW as SE_NARROW
from tests.test_torch_train import STATS
from tests.test_torch_train import _fields as se_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = {"senet": lambda kw: SparseResNet(num_reg_targets=2, in_channels=3,
                                         **kw),
        "kpcnn": lambda kw: KPCNN(**kw),
        "mpointnet": lambda kw: MPointNet(2, 3, **kw)}
CONF = os.path.join(REPO, "conf")
WORLD = 2

# the ranks' side: only torch, numpy and the port (no JAX in a worker)
WORKER = r"""
import os, sys
repo, inp, out = sys.argv[1:4]
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(2)
from dpcr_agb_tpu_torch import parallel, train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models.base import InstanceSpec, compute_reg_loss
from dpcr_agb_tpu_torch.models.factory import make_post_collate
from dpcr_agb_tpu_torch.models.kpconv import KPCNN
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet
from dpcr_agb_tpu_torch.models.pointnet import MPointNet
from dpcr_agb_tpu_torch.nn.blocks import DropPath, Dropout
from dpcr_agb_tpu_torch.nn.norm import MaskedBatchNorm, MaskedGRN
from dpcr_agb_tpu_torch.training.regularizers import build_regularizer

from dpcr_agb_tpu_torch.models import minkowski

assert parallel.maybe_init_distributed("cpu")
r, w = parallel.rank(), parallel.world_size()
cases = torch.load(inp, weights_only=False)
# the rematerialized regions a step runs (the sparse-voxel nets' blocks)
REMAT = [0]
_remat = minkowski.remat


def counted_remat(fn, *a, **k):
    REMAT[0] += 1
    return _remat(fn, *a, **k)


minkowski.remat = counted_remat


def half(a):
    n = a.shape[0] // w
    return a[r * n:(r + 1) * n]


def allreduce(c):
    t = half(c["x"]).clone().requires_grad_(True)
    y = parallel.all_reduce_sum(t)
    (y * half(c["g"])).sum().backward()
    return {"y": y.detach(), "grad": t.grad}


def norm(c):
    mod = {"bn": MaskedBatchNorm, "grn": MaskedGRN}[c["module"]](
        c["x"].shape[-1])
    mod.load_state_dict(c["state"])
    mod.train()
    x = half(c["x"]).clone().requires_grad_(True)
    y = mod(x, half(c["mask"]))
    (y * half(c["g"])).sum().backward()
    parallel.all_reduce_grads(mod.parameters())
    return {"y": y.detach(), "dx": x.grad,
            "params": {k: p.grad for k, p in mod.named_parameters()},
            "buffers": {k: b.clone() for k, b in mod.named_buffers()}}


def loss(c):
    out = half(c["out"]).clone().requires_grad_(True)
    l = compute_reg_loss(InstanceSpec(**c["spec"]), out, half(c["y"]),
                         half(c["ymask"]), training=c["training"])
    l.backward()
    return {"local": l.detach(), "total": parallel.all_reduce_sum(
        l.detach()), "grad": out.grad}


def coins(c):
    g = torch.Generator().manual_seed(7)
    dp, do = DropPath(0.5), Dropout(0.3)
    x = half(c["x"])
    return {"drop_path": dp(x, generator=g), "dropout": do(x, generator=g)}


def zbucket(c):
    net = SparseResNet(num_reg_targets=2, in_channels=3, **c["kwargs"])
    b = make_post_collate(net)(Batch(**c["fields"]))
    return {"zb": len(b.aux["zcells"])}


NETS = {"senet": lambda kw: SparseResNet(num_reg_targets=2, in_channels=3,
                                         **kw),
        "kpcnn": lambda kw: KPCNN(**kw),
        "mpointnet": lambda kw: MPointNet(2, 3, **kw)}


def step(c):
    net = NETS[c["net"]](c["kwargs"])
    net.load_state_dict(c["state"], strict=True)
    runner = train.build_runner(net, c["stats"], seed=0)
    runner.regularizer = build_regularizer(c)
    local = parallel.shard_batch(Batch(**c["fields"]), r, w)
    before = REMAT[0]
    out = runner.train(local)
    return {"remat_calls": REMAT[0] - before,
            "loss": out["loss"], "reg_out": out["reg_out"],
            "label_idx": out["sample_meta"]["label_idx"],
            "valid": out["sample_meta"]["valid"],
            "grads": {k: p.grad for k, p in net.named_parameters()},
            "state": {k: v.clone() for k, v in net.state_dict().items()},
            "num_samples": runner.num_samples}


KINDS = {"allreduce": allreduce, "norm": norm, "loss": loss,
         "coins": coins, "zbucket": zbucket, "step": step}
res = {name: KINDS[c["kind"]](c) for name, c in cases.items()}
torch.save(res, os.path.join(out, f"rank{r}.pt"))
parallel.destroy()
print("RANK-OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, world: int, extra_env=None, per_rank_args=None,
              timeout: int = 600):
    """`world` processes of `argv` (plus each rank's own arguments) with
    the variables torchrun sets and DPCR_MULTIHOST=1; returns their
    outputs, failing if any rank failed."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "DPCR_MULTIHOST": "1",
               "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
               **(extra_env or {})}
        args = list(argv) + list(per_rank_args(r) if per_rank_args else [])
        procs.append(subprocess.Popen(args, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _jspec():
    return JInstanceSpec(num_reg_targets=2, **{
        k: np.asarray(v, np.float32) for k, v in STATS.items()})


def _jtx():
    return optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))


def _jbatch(fields):
    from dpcr_agb_tpu.data.batch import Batch as JBatch
    return JBatch(**{k: ({n: jnp.asarray(a) for n, a in v.items()}
                         if isinstance(v, dict) else jnp.asarray(v))
                     for k, v in fields.items()})


def _perturbed(variables, rng):
    params = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        size=a.shape) * 0.05).astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def _jax_mesh_step(jnet, params, stats, fields):
    """The JAX package's step over a 2-device mesh on the global batch
    (the state after it, its loss and outputs) and the gradient of its
    loss; the layout flag its StepRunner sets is restored after."""
    spec, tx = _jspec(), _jtx()
    saved = (jlayout.BATCH_LOCAL, jlayout.DATA_PARALLEL_DEGREE)
    try:
        runner = JRunner(net=jnet, spec=spec, tx=tx, mesh=make_mesh(WORLD),
                         seed=0)
        state = TrainState(params=params, batch_stats=stats,
                           opt_state=tx.init(params))
        state, out = runner.train(state, _jbatch(fields))

        def loss_fn(p):
            reg_out, _, _ = _forward(jnet, spec, p, stats, _jbatch(fields),
                                     train=True)
            return jloss(spec, reg_out, jnp.asarray(fields["y_reg"]),
                         jnp.asarray(fields["y_reg_mask"]), True)

        grads = jax.jit(jax.grad(loss_fn))(params)
    finally:
        jlayout.set_batch_local(*saved)
    return {"params": jax.tree.map(np.asarray, state.params),
            "stats": jax.tree.map(np.asarray, state.batch_stats),
            "loss": float(out["loss"]),
            "reg_out": np.asarray(out["reg_out"]),
            "grads": jax.tree.map(lambda g: np.clip(np.asarray(g), -100, 100),
                                  grads)}


def _models(rng):
    """(name, port net key, constructor kwargs, JAX net, global fields)
    of the nets at the test widths, batch 4 (2 a rank): the three nets in
    f32, then SENet14 in bf16."""
    kp = _with_aux(kp_fields(rng, b=4))
    return [("senet", "senet", SE_NARROW,
             JSENet(num_reg_targets=2, **SE_NARROW), se_fields(rng, b=4)),
            ("kpcnn", "kpcnn", KP_NARROW,
             JKPCNN(fused_kernel=True, **KP_NARROW), kp),
            ("mpointnet", "mpointnet", {"embedding_channel": EMBED},
             pn_nets("MPointNet")[0], pn_fields(rng, b=4)),
            ("senet_bf16", "senet", {**SE_NARROW, "dtype": torch.bfloat16},
             JSENet(num_reg_targets=2, dtype=jnp.bfloat16, **SE_NARROW),
             se_fields(rng, b=4))]


def _deformable_case(rng):
    """A narrow deformable KPCNN (the port's init from a seed) on the host
    pyramid with an elastic parameter penalty: both terms that each rank
    adds 1/world of."""
    torch.manual_seed(19)
    net = KPCNN(**DEFORM_NARROW)
    return {"kind": "step", "net": "kpcnn", "kwargs": DEFORM_NARROW,
            "state": {k: v.clone() for k, v in net.state_dict().items()},
            "stats": STATS, "fields": deform_aux(deform_fields(rng, b=4),
                                                 False),
            "regularizers": {"type": "elastic", "lambda": 1e-3,
                             "alpha": 0.3}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(19)
    cases, want = {}, {}
    x = torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))
    cases["allreduce"] = {"kind": "allreduce", "x": x,
                          "g": torch.from_numpy(rng.normal(
                              size=(4, 5)).astype(np.float32))}
    mask = torch.from_numpy(rng.random((4, 30)) < 0.7)
    mask[3, 20:] = False
    for module in ("bn", "grn"):
        mod = MaskedBatchNorm(6) if module == "bn" else MaskedGRN(6)
        with torch.no_grad():
            for p in list(mod.parameters()) + list(mod.buffers()):
                p.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, p.shape).astype(np.float32)))
        cases[module] = {"kind": "norm", "module": module,
                         "state": {k: v.clone() for k, v in
                                   mod.state_dict().items()},
                         "x": torch.from_numpy(rng.normal(
                             2.0, 3.0, (4, 30, 6)).astype(np.float32)),
                         "mask": mask, "g": torch.from_numpy(rng.normal(
                             size=(4, 30, 6)).astype(np.float32))}
    # rank 0 holds 3 present targets of 8, rank 1 holds 7
    y = rng.uniform(50, 300, (8, 2)).astype(np.float32)
    ymask = np.ones((8, 2), bool)
    ymask[0, :] = ymask[1, 0] = ymask[2, 1] = ymask[3, 1] = False
    ymask[5, 1] = False
    y[~ymask] = np.nan
    spec = dict(num_reg_targets=2, scale=np.array([40.0, 80.0], np.float32),
                center=np.array([120.0, 200.0], np.float32),
                weights=np.array([0.3, 0.9], np.float32))
    out = torch.from_numpy((rng.normal(size=(8, 2)) * 2).astype(np.float32))
    for name, double, training in (("loss", False, True),
                                   ("loss_double", True, True),
                                   ("loss_eval", True, False)):
        cases[name] = {"kind": "loss", "out": out, "y": torch.from_numpy(y),
                       "ymask": torch.from_numpy(ymask), "training": training,
                       "spec": {**spec, "double_batch": double,
                                "loss_names": ("smoothl1", "l2")}}
    cases["coins"] = {"kind": "coins", "x": torch.from_numpy(
        rng.normal(size=(8, 3, 4)).astype(np.float32))}
    zf = se_fields(rng, b=4)
    cases["zbucket"] = {"kind": "zbucket", "kwargs": SE_NARROW,
                        "fields": {**zf, "aux": None}}
    for name, net, kwargs, jnet, fields in _models(rng):
        variables = _Jitted(jnet).init(jax.random.PRNGKey(0),
                                       _jbatch(fields), train=False)
        params, stats = _perturbed(variables, rng)
        cases[name] = {"kind": "step", "net": net, "kwargs": kwargs,
                       "state": from_flax(params, stats), "stats": STATS,
                       "fields": fields}
        want[name] = _jax_mesh_step(jnet, params, stats, fields)
    cases["kpcnn_deform"] = _deformable_case(rng)
    inp = str(tmp / "cases.pt")
    torch.save(cases, inp)
    run_ranks([sys.executable, "-c", WORKER, REPO, inp, str(tmp)], WORLD)
    got = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return cases, got, want


def _cat(got, name, key):
    return torch.cat([g[name][key] for g in got]).numpy()


def test_all_reduce_sum_forward_and_backward(runs):
    cases, got, _ = runs
    x, g = cases["allreduce"]["x"].numpy(), cases["allreduce"]["g"].numpy()
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["allreduce"]["y"].numpy(),
                                   x[:2] + x[2:], rtol=1e-6)
        np.testing.assert_allclose(got[r]["allreduce"]["grad"].numpy(),
                                   g[:2] + g[2:], rtol=1e-6)


@pytest.mark.parametrize("module", ["bn", "grn"])
def test_synced_norm_matches_one_process(runs, module):
    """Forward, dx and the parameters' gradients (summed over ranks) and
    the running stats against one process on the concatenated batch."""
    cases, got, _ = runs
    c = cases[module]
    mod = MaskedBatchNorm(6) if module == "bn" else MaskedGRN(6)
    mod.load_state_dict(c["state"])
    mod.train()
    x = c["x"].clone().requires_grad_(True)
    y = mod(x, c["mask"])
    (y * c["g"]).sum().backward()
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_cat(got, module, "y"), y.detach().numpy(),
                               **tol)
    np.testing.assert_allclose(_cat(got, module, "dx"), x.grad.numpy(), **tol)
    for r in range(WORLD):
        for k, p in mod.named_parameters():
            np.testing.assert_allclose(got[r][module]["params"][k].numpy(),
                                       p.grad.numpy(), rtol=1e-6, atol=1e-5,
                                       err_msg=k)
        for k, b in mod.named_buffers():
            np.testing.assert_allclose(got[r][module]["buffers"][k].numpy(),
                                       b.numpy(), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["loss", "loss_double", "loss_eval"])
def test_reg_loss_with_unequal_target_counts_is_the_global_loss(runs, name):
    """Rank 0 holds fewer present targets than rank 1: the ranks' losses
    add up to the one-process loss on the whole batch, and their gradients
    put together are its gradient (a mean of the ranks' means would be
    another number)."""
    cases, got, _ = runs
    c = cases[name]
    out = c["out"].clone().requires_grad_(True)
    want = compute_reg_loss(InstanceSpec(**c["spec"]), out, c["y"],
                            c["ymask"], training=c["training"])
    want.backward()
    locals_ = [float(g[name]["local"]) for g in got]
    want = want.detach()
    np.testing.assert_allclose(sum(locals_), float(want), rtol=1e-6)
    for g in got:
        np.testing.assert_allclose(float(g[name]["total"]), float(want),
                                   rtol=1e-6)
    np.testing.assert_allclose(_cat(got, name, "grad"), out.grad.numpy(),
                               rtol=1e-6, atol=1e-7)
    if name == "loss":
        per_rank_means = []
        for r in range(WORLD):
            sl = slice(4 * r, 4 * r + 4)
            per_rank_means.append(float(compute_reg_loss(
                InstanceSpec(**c["spec"]), c["out"][sl], c["y"][sl],
                c["ymask"][sl], training=True)))
        assert abs(np.mean(per_rank_means) - float(want)) > 1e-3


def test_dropout_coins_are_the_global_batchs(runs):
    cases, got, _ = runs
    g = torch.Generator().manual_seed(7)
    dp, do = DropPath(0.5), Dropout(0.3)
    x = cases["coins"]["x"]
    want_dp, want_do = dp(x, generator=g), do(x, generator=g)
    np.testing.assert_array_equal(_cat(got, "coins", "drop_path"),
                                  want_dp.numpy())
    np.testing.assert_array_equal(_cat(got, "coins", "dropout"),
                                  want_do.numpy())
    assert (want_dp == 0).any() and (want_dp != 0).any()


def test_z_bucket_is_pinned_under_two_ranks(runs):
    _, got, _ = runs
    assert all(g["zbucket"]["zb"] == SE_NARROW["dense_dims"][2] for g in got)


def _params_and_stats(want):
    return from_flax(want["params"], want["stats"])


@pytest.mark.parametrize("name", ["senet", "kpcnn", "mpointnet"])
def test_two_rank_step_matches_the_jax_mesh_step(runs, name):
    """Loss, outputs (gathered in global order), each gradient (summed
    over ranks), the parameters after the step and the BN stats, on every
    rank; both ranks end with the same bits."""
    _, got, want = runs
    w = want[name]
    total = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                        for g in jax.tree_util.tree_leaves(w["grads"])))
    want_g = from_flax(w["grads"], None)
    for r in range(WORLD):
        g = got[r][name]
        np.testing.assert_allclose(float(g["loss"]), w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["reg_out"].numpy(), w["reg_out"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g["label_idx"].numpy(), np.arange(4))
        assert g["num_samples"] == 4
        # SENet14's four blocks rematerialized on each rank
        assert g["remat_calls"] == (4 if name == "senet" else 0)
        assert set(g["grads"]) == set(want_g)
        for k, b in want_g.items():
            a, b = g["grads"][k].numpy(), b.numpy()
            if np.linalg.norm(b) < 1e-6 * total:
                # a bias ahead of a train-mode BN: rounding noise both ways
                assert np.linalg.norm(a) < 1e-6 * total, k
            else:
                rel = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert rel < 1e-4, (k, rel)
        for k, v in _params_and_stats(w).items():
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in got[0][name]["state"].items():
        assert torch.equal(v, got[1][name]["state"][k]), k


def _one_process_step(case):
    """The port's step on the whole batch in this process (no group)."""
    net = NETS[case["net"]](case["kwargs"])
    net.load_state_dict(case["state"], strict=True)
    runner = train.build_runner(net, case["stats"], seed=0)
    runner.regularizer = build_regularizer(case)
    out = runner.train(Batch(**case["fields"]))
    return net, runner, {
        "loss": float(out["loss"]),
        "grads": {k: p.grad for k, p in net.named_parameters()},
        "state": {k: v.clone() for k, v in net.state_dict().items()}}


def _step_errors(got, want):
    """chip_smoke.py's STEP_TOL quantities: the loss (relative), all
    gradients as one vector and all parameters as one (relative L2), and
    the worst BN statistic (relative L2 of each)."""
    names = sorted(want["grads"])
    pnames = sorted(k for k in want["state"] if k in want["grads"])
    snames = sorted(k for k in want["state"] if k not in want["grads"]
                    and want["state"][k].is_floating_point())

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def flat(d, ks):
        return torch.cat([d[k].reshape(-1) for k in ks])
    return {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grads": rel(flat(got["grads"], names),
                         flat(want["grads"], names)),
            "params": rel(flat(got["state"], pnames),
                          flat(want["state"], pnames)),
            "stat": max(rel(got["state"][k], want["state"][k])
                        for k in snames)}


# chip_smoke.py's STEP_TOL, f32 row (loss, parameters, BN stats)
F32_STEP_TOL = {"loss": 1e-5, "params": 1e-5, "stat": 1e-5}
F32_EPS = float(torch.finfo(torch.float32).eps)


def test_two_rank_bf16_step_is_as_close_to_the_jax_mesh_step(runs):
    """SENet14 in bf16. bf16 rounds at other places in the two
    frameworks, so the port's one-process step is itself some way from the
    JAX mesh step on the global batch; the 2-rank step is no farther from
    it (within 25% on each STEP_TOL quantity). Against the one-process
    step it is within the f32 row of chip_smoke.py's STEP_TOL (loss,
    parameters, BN stats) and every gradient element within one bf16 ulp:
    each rank hands the SUM its f32 partials and every sum over the global
    batch is rounded to bf16 once, as one process (and the JAX program)
    rounds it. An element may still land one ulp away where the two f32
    orders of a sum straddle a rounding boundary, or further where the sum
    cancels to below f32's resolution of its tensor (its largest element
    times f32's epsilon: noise in both); together at most 1e-3 of the
    elements, their counts printed."""
    cases, got, want = runs
    w = want["senet_bf16"]
    jax_want = {"loss": w["loss"], "grads": from_flax(w["grads"], None),
                "state": _params_and_stats(w)}
    _, _, one = _one_process_step(cases["senet_bf16"])
    one_off = _step_errors(one, jax_want)
    for r in range(WORLD):
        g = got[r]["senet_bf16"]
        g = {"loss": float(g["loss"]), "grads": g["grads"],
             "state": g["state"]}
        off = _step_errors(g, jax_want)
        assert all(off[k] <= 1.25 * one_off[k] + 1e-7 for k in off), \
            (off, one_off)
        drift = _step_errors(g, one)
        assert all(drift[k] <= tol for k, tol in F32_STEP_TOL.items()), \
            drift
        moved = cancelled = n = 0
        for k, b in one["grads"].items():
            a = g["grads"][k]
            ulps = bf16_ulps(a, b)
            # a sum that cancels to below f32's resolution of its tensor
            # is rounding noise in both orders
            noise = (a - b).abs() <= F32_EPS * b.abs().max()
            assert not ((ulps > 1) & ~noise).any(), \
                (k, int(ulps.max()), a[ulps > 1][:4], b[ulps > 1][:4])
            n += ulps.numel()
            moved += int((ulps == 1).sum())
            cancelled += int(((ulps > 1) & noise).sum())
        assert moved + cancelled <= 1e-3 * n, (moved, cancelled, n)
        print(f"rank {r}: of {n} gradient elements {moved} one bf16 ulp "
              f"from the one-process step, {cancelled} further apart "
              f"below f32 resolution; drift {drift}")
    for k, v in got[0]["senet_bf16"]["state"].items():
        assert torch.equal(v, got[1]["senet_bf16"]["state"][k]), k


def test_two_rank_deformable_step_with_a_regularizer_matches_one_process(
        runs):
    """Deformable KPConv's fitting and repulsive terms and the elastic
    penalty are global terms, each rank adding 1/world of them: the
    2-rank step gives the one-process step's loss, gradients and
    parameters (tests/test_torch_train.py's tolerances)."""
    cases, got, _ = runs
    net, runner, one = _one_process_step(cases["kpcnn_deform"])
    terms = sum(float(t.detach()) for t in net.internal_losses().values())
    penalty = float(runner.regularizer(
        dict(net.named_parameters())).detach())
    # each term moves the loss past its tolerance if a rank added it whole
    assert min(terms, penalty) > 1e-3 * one["loss"], (terms, penalty)
    total = float(torch.linalg.vector_norm(torch.cat(
        [v.reshape(-1) for v in one["grads"].values()])))
    for r in range(WORLD):
        g = got[r]["kpcnn_deform"]
        np.testing.assert_allclose(float(g["loss"]), one["loss"], rtol=1e-5)
        for k, b in one["grads"].items():
            a = g["grads"][k]
            if float(torch.linalg.vector_norm(b)) < 1e-6 * total:
                assert float(torch.linalg.vector_norm(a)) < 1e-6 * total, k
            else:
                rel = float(torch.linalg.vector_norm(a - b)
                            / torch.linalg.vector_norm(b))
                assert rel < 1e-4, (k, rel)
        for k, v in one["state"].items():
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# ---- in this process ---------------------------------------------------------

@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    ov = ["task=instance", "models=instance/minkowski_baseline",
          "model_name=SENet14", "data=instance/synthetic/reg",
          "data.transform_type=sparse_xy", "data.synthetic_plots=20",
          f"data.dataroot={root}", "run_dir=unused"]
    jd = jds.instantiate_dataset(jload(CONF, "config", ov)["data"])
    td = tds.instantiate_dataset(tload(CONF, "config", ov)["data"])
    return jd, td


def _loaders(d, cls, spec_cls, split, shard, **kw):
    spec = spec_cls(conv_type="sparse", use_coords=True, buckets=(16384,),
                    min_bucket=1024)
    return cls(d.datasets[split], d.transform_for(split), spec=spec,
               seed=7, num_workers=2, shard=shard, **kw)


@pytest.mark.parametrize("split,kw", [
    ("train", dict(batch_size=4, shuffle=True, drop_last=True,
                   double_batch=True)),
    ("val", dict(batch_size=4, shuffle=False, drop_last=False))],
    ids=["train-double-batch", "eval-ragged"])
def test_loader_shards_reassemble_bit_for_bit(datasets, split, kw):
    """The two shards put together are the unsharded batches (a ragged
    last batch: the second rank's all-padding batch, n_valid 0), and each
    shard is the JAX loader's shard=(p, 2) batch."""
    jd, td = datasets
    if split == "val":
        kw["batch_size"] = len(td.datasets["val"]) + 2
    full = _loaders(td, TLoader, TSpec, split, None, **kw)
    parts = [_loaders(td, TLoader, TSpec, split, (p, WORLD), **kw)
             for p in range(WORLD)]
    jparts = [_loaders(jd, JLoader, JSpec, split, (p, WORLD), **kw)
              for p in range(WORLD)]
    seen = 0
    for epoch in (0, 1):
        for bf, *rest in zip(full.epoch(epoch),
                             *[p.epoch(epoch) for p in parts],
                             *[p.epoch(epoch) for p in jparts]):
            mine, theirs = rest[:WORLD], rest[WORLD:]
            for f in dataclasses.fields(bf):
                if f.name in ("aux", "ready"):
                    continue
                want = getattr(bf, f.name)
                if want is None:
                    continue
                got = np.concatenate([getattr(b, f.name) for b in mine])
                np.testing.assert_array_equal(got, want, err_msg=f.name)
                for b, jb in zip(mine, theirs):
                    np.testing.assert_array_equal(
                        getattr(b, f.name), np.asarray(getattr(jb, f.name)),
                        err_msg=f.name)
            seen += 1
    assert seen >= 2
    if split == "val":
        last = list(parts[1].epoch(0))[-1]
        assert not last.valid.any()


def test_loader_refusals():
    class _DS:
        def __len__(self):
            return 10

    with pytest.raises(ValueError, match="divide"):
        TLoader(_DS(), lambda r, s: s, batch_size=6, spec=TSpec(),
                shard=(0, 4))
    with pytest.raises(ValueError, match="double_batch"):
        TLoader(_DS(), lambda r, s: s, batch_size=2, spec=TSpec(),
                double_batch=True, shard=(0, 2))


def _trainer_cfg(tmp, model="MPointNet", bs=4):
    return tload(CONF, "config", [
        "task=instance", "models=instance/minkowski_baseline",
        f"model_name={model}", "data=instance/synthetic/reg",
        "data.transform_type=sparse_xy", "data.synthetic_plots=12",
        f"data.dataroot={tmp}/data", "training=nfi/minkowski",
        f"training.batch_size={bs}", "training.num_workers=1",
        f"run_dir={tmp}/run"])


@pytest.mark.parametrize("case", ["batch_size", "dense_collate",
                                  "pre_batch_collate"])
def test_trainer_refusals_under_two_ranks(tmp_path, monkeypatch, case):
    """What the JAX trainer refuses under several processes: a batch size
    the world does not divide, a dense collate without num_points, a
    pre_batch_collate hook."""
    from dpcr_agb_tpu_torch.training import trainer as ttrainer
    monkeypatch.setattr(ttrainer, "world_size", lambda: WORLD)
    monkeypatch.setattr(ttrainer, "rank", lambda: 0)
    monkeypatch.setattr(ttrainer, "is_main", lambda: True)
    if case == "batch_size":
        cfg, match = _trainer_cfg(tmp_path, bs=3), "divide by the world"
    elif case == "dense_collate":
        # rows padded to a power of two of the local batch's count (the
        # conf's presets all reach a num_points through data.fixed)
        cfg, match = _trainer_cfg(tmp_path), "dense collate"
        monkeypatch.setattr(ttrainer, "collate_spec", lambda *a: TSpec(
            conv_type="dense", num_points=None))
    else:
        cfg, match = _trainer_cfg(tmp_path, "SENet14"), "pre_batch_collate"
        saved = ttrainer.instantiate_dataset

        def with_hook(data_cfg):
            d = saved(data_cfg)
            d.pre_batch_collate_transform = lambda samples: samples
            return d
        monkeypatch.setattr(ttrainer, "instantiate_dataset", with_hook)
    with pytest.raises(ValueError, match=match):
        ttrainer.Trainer(cfg, device=torch.device("cpu"))


def test_process_group_and_device_refusals(monkeypatch, tmp_path):
    """DPCR_MULTIHOST=1 without torchrun's variables, NCCL on the CPU, an
    unknown backend, a LOCAL_RANK past the host's cards, and the input=
    form under several processes all raise; without DPCR_MULTIHOST no
    group starts and every collective is the identity."""
    from dpcr_agb_tpu_torch import train
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "DPCR_MULTIHOST", "DPCR_DIST_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.maybe_init_distributed("cpu") is False
    t = torch.ones(3)
    assert parallel.all_reduce_sum(t) is t
    assert parallel.all_gather_rows(t) is t
    assert (parallel.world_size(), parallel.rank(), parallel.is_main()) == \
        (1, 0, True)
    monkeypatch.setenv("DPCR_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.maybe_init_distributed("cpu")
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "3"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DPCR_DIST_BACKEND", "nccl")
    with pytest.raises(ValueError, match="CUDA devices only"):
        parallel.maybe_init_distributed("cpu")
    monkeypatch.setenv("DPCR_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError, match="nccl or gloo"):
        parallel.maybe_init_distributed("cpu")
    with pytest.raises(ValueError, match="one process"):
        train.main([f"input={tmp_path}/*.npz", "device=cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3 names no card"):
        tdevice.resolve_device()
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdevice.resolve_device() == torch.device("cuda:1")
    assert tdevice.resolve_device("cuda:0") == torch.device("cuda:0")
