"""PointNeXt and the PointNet encoder in the port against the JAX package on
the CPU. Inputs come from numpy seeds; weights cross by `weights.from_flax`
/ `to_flax` (the port's seeded init, perturbed, becomes the JAX variables,
so no JAX init is compiled).

- `fps`: `ops.neighbors.fps_plain` returns the JAX `fps`'s indices exactly,
  vmapped over a batch with padded rows, a sample with fewer valid rows
  than n_samples, an all-masked sample and exact duplicate points, N 64 to
  2048; the CPU dispatch and `kernels.fps_plan(n, b)` at the main path's
  shapes and at B 1, 16 and 32.
- `_LocalAggregation`, `_SetAbstraction`, `_InvResMLP` with train-mode and
  eval-mode BN: outputs and running stats, rtol 1e-5 with atol 1e-5 of
  max|JAX| (the sampled positions and mask exactly).
- A narrow PointNeXt-S (width 8, strides (1,2,2,2,2,1), nsample 8,
  num_points 128 below N 160, so the input FPS runs), PointNeXt-B at the
  same width, and the PointNet encoder: the eval forward (same
  tolerance); the train-mode forward and its BN stats, and one train step
  with dropout 0 against `jax.value_and_grad` of the JAX step's loss and
  the same optax chain: loss rel 1e-5, all gradients and each gradient
  rel-L2 1e-4, the updated parameters and BN stats rtol 1e-4, atol 1e-5
  (those of `tests/test_torch_pointnet.py`), where the train-mode
  forward, the loss and the gradients are widened to 4x what a one-ulp
  change of the input features does to them on the port, measured in the
  test (the head's BN over 4 rows makes them that sensitive).
- Padding rows change nothing (`tests/test_pointnext.py`'s check, eval
  and train, and the running stats).
- The conf entries' parameter and stat names and shapes against
  `jax.eval_shape` of the JAX init, `from_flax(to_flax(.))` the identity,
  and `weights.in_channels_of`.
- The slice: a JAX-layout `PointNext` `.ckpt` on `.laz` plots through the
  port's `predict.main` and the root `predict.py`, within 1e-5 of
  max|pred - center| plus one f32 ulp of max|pred|; the port's
  root-grammar `train` of both conf entries (`models=instance/pointnext
  model_name=PointNext`, and `pointnet` / `PointNet`;
  `data.transform_type=fixed_xy training=nfi/pointnet`), then
  its `eval`, `calibrate_bn` and `predict` on the `.ckpt`, which the root
  `eval.py` reads to the port's test predictions within the same share.
  These runs cut `num_points` (to 512) and `nsample` (to 8) through the
  overrides; the fixed_xy chains still give 12000 points a plot."""
import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import eval as jeval  # noqa: E402
import predict as jax_predict  # noqa: E402
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.config import load_config as jload
from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models import pointnext as jpn
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
from dpcr_agb_tpu.ops.neighbors import fps as jfps
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.state import Checkpoint as JCheckpoint
from dpcr_agb_tpu.training.step import _forward
from dpcr_agb_tpu_torch import calibrate_bn as tcalibrate
from dpcr_agb_tpu_torch import eval as teval
from dpcr_agb_tpu_torch import kernels, predict, train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models import pointnext as tpn
from dpcr_agb_tpu_torch.models.factory import build_model, f32_only
from dpcr_agb_tpu_torch.ops import neighbors
from dpcr_agb_tpu_torch.weights import from_flax, in_channels_of, to_flax
from tests import test_torch_checkpoint as tck


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


CONF = os.path.join(ROOT, "conf")
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}
TOL = 1e-5           # forward and BN stats: rtol, and atol of max|JAX|
ARCHS = ("pointnext_s", "pointnext_b", "pointnet")
# the slice runs' cuts of the conf entries (the chains keep 12000 points)
CUT = {"num_points": 512, "nsample": 8}
SLICE_TOL = 1e-5     # share of max|pred - center| between the two CLIs


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for the file: the plain fps loop is thousands of
    small ops, and with the test workers sharing the cores each op's
    OpenMP barrier made the root-grammar run take 47 times as long as
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- fps ---------------------------------------------------------------

def _fps_case(rng, n):
    """B 5 at N points, n_samples N // 2: a full sample, one with its last
    third padded (far values), one with fewer valid rows than n_samples,
    an all-masked one, and one with a block of exact duplicates."""
    b, ns = 5, n // 2
    pos = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 2 * n // 3:] = False
    pos[1, 2 * n // 3:] = rng.uniform(-1e6, 1e6, (n - 2 * n // 3, 3))
    mask[2, ns // 3:] = False
    mask[3] = False
    k = n // 8
    pos[4, k:2 * k] = pos[4, :k]
    return pos, mask, ns


@pytest.mark.parametrize("n", [64, 300, 1024, 2048])
def test_fps_plain_matches_jax(n):
    rng = np.random.default_rng(n)
    pos, mask, ns = _fps_case(rng, n)
    start = 0 if n != 300 else 7
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, m: jfps(p, m, ns, start)))(pos, mask))
    got = neighbors.fps_plain(torch.from_numpy(pos), torch.from_numpy(mask),
                              ns, start)
    assert got.dtype == torch.int64 and got.shape == (5, ns)
    np.testing.assert_array_equal(got.numpy(), want)
    got = got.numpy()
    # the fewer-valid sample repeats valid rows; the all-masked one gives 0
    # after the start; of two duplicates the lower index is taken
    assert mask[2][got[2]].all() and len(set(got[2])) == mask[2].sum()
    assert got[3][0] == start and (got[3][1:] == 0).all()
    assert not set(got[4]) & set(range(n // 8, 2 * (n // 8)))


def test_fps_dispatch_and_kernel_plan():
    """On CPU tensors `ops.neighbors.fps` is the plain version and the
    kernel's wrapper refuses them; the kernel's plan at the serving batch's
    samplings (bs16: a cluster of 8 CTAs, 128 CTAs in all, on the 12000-
    and 8192-point ones), and a refusal naming N past the cluster's
    registers."""
    rng = np.random.default_rng(3)
    pos, mask, ns = _fps_case(rng, 128)
    p, m = torch.from_numpy(pos), torch.from_numpy(mask)
    assert torch.equal(neighbors.fps(p, m, ns), neighbors.fps_plain(p, m, ns))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.fps(p, m, ns)
    plans = {n: kernels.fps_plan(n, 16) for n in (12000, 8192, 2048, 512,
                                                  128, 24576, 1)}
    assert {n: (pl["cluster"], pl["threads"], pl["per"])
            for n, pl in plans.items()} == {
        12000: (8, 128, 12), 8192: (8, 128, 8), 2048: (4, 128, 4),
        512: (1, 32, 16), 128: (1, 32, 4), 24576: (8, 128, 24),
        1: (1, 32, 1)}
    assert plans[12000]["ctas"] == 128 and kernels.FPS_MAX_POINTS == 24576
    assert kernels.fps_plan(12000, 32)["cluster"] == 8
    assert kernels.fps_plan(2048, 16, cluster=1)["cluster"] == 1
    with pytest.raises(ValueError, match="24577 points"):
        kernels.fps_plan(24577, 16)
    for c in (1, 3):   # 12000 points need 2 CTAs' registers; 3 is no size
        with pytest.raises(ValueError, match=f"a cluster of {c} for 12000"):
            kernels.fps_plan(12000, 16, cluster=c)


@pytest.mark.parametrize("b", [1, 16, 32])
@pytest.mark.parametrize("n", [12000, 8192, 2048, 512, 128, 32, 1])
def test_fps_plan_covers_a_sample(n, b):
    """`kernels.fps_plan(n, b)` at the main path's samplings and at one
    plot served, the serving batch and the paper's training batch: the
    cluster's CTAs cover n, each of them holds points, the cluster is a
    portable size (<= 8) with at most 128 slots, registers hold the
    template's points with no spill budget at its threads, shared memory
    fits a CTA, the B clusters are resident at once (one wave) by the
    plan's count of registers and threads, and one point past the limit
    is refused naming N."""
    plan = kernels.fps_plan(n, b)
    c, t, per = plan["cluster"], plan["threads"], plan["per"]
    assert c in kernels.FPS_CLUSTERS and c <= 8
    assert plan["ctas"] == b * c
    assert c * t * per >= n and (c - 1) * t * per < n
    assert plan["points_per_cta"] == -(-n // c) <= t * per
    assert per in kernels.FPS_WIDTHS and t % 32 == 0 and 32 <= t
    assert c * (t // 32) <= kernels.FPS_MAX_SLOTS
    assert t <= kernels.fps_max_threads(per)
    regs = kernels.FPS_REGISTERS[per]
    assert 4 * per < regs <= min(255, 65536 // kernels.fps_max_threads(per))
    assert t * regs <= 65536
    assert plan["smem_bytes"] <= kernels.SMEM_PER_BLOCK
    assert b <= plan["resident_clusters"]
    assert -(-n // c) <= kernels.FPS_CTA_POINTS or c == 8
    with pytest.raises(ValueError, match=f"{kernels.FPS_MAX_POINTS + 1} "
                                         f"points"):
        kernels.fps_plan(kernels.FPS_MAX_POINTS + 1, b)


# ---- modules ---------------------------------------------------------------

def _perturbed(state_dict, rng):
    """(params, batch_stats) of a port state_dict, parameters moved off
    their init and BN stats random (mean ~0.1, var 0.5-1.5)."""
    params, stats = to_flax(state_dict)
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), params)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        stats)
    return params, stats


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def _cloud(rng, b=2, n=128, c=8):
    pos = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 90:] = False
    pos[1, 90:] = 1e6
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    return pos, mask, feats


MODULES = {
    "LocalAggregation": (
        lambda: jpn._LocalAggregation(16, 0.2, 8, "relu", layers=2),
        lambda: tpn._LocalAggregation(8, 16, 0.2, 8, "relu", 2)),
    "SetAbstraction": (
        lambda: jpn._SetAbstraction(16, 2, 0.2, 8, 2, True, "relu"),
        lambda: tpn._SetAbstraction(8, 16, 2, 0.2, 8, 2, True, "relu")),
    "InvResMLP": (
        lambda: jpn._InvResMLP(8, 0.2, 8, 4, "relu"),
        lambda: tpn._InvResMLP(8, 0.2, 8, 4, "relu")),
}


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name, train_mode):
    rng = np.random.default_rng(11)
    pos, mask, feats = _cloud(rng)
    torch.manual_seed(0)
    jmod, tmod = (f() for f in MODULES[name])
    params, stats = _perturbed(tmod.state_dict(), rng)
    tmod.load_state_dict(from_flax(params, stats), strict=True)
    variables = {"params": params, "batch_stats": stats}
    if name == "LocalAggregation":
        q = (pos[:, ::2], mask[:, ::2])
        jargs, targs = (*q, pos, mask, feats), (*q, pos, mask, feats)
    else:
        jargs = targs = (pos, mask, feats)
    want = jmod.apply(variables, *map(jnp.asarray, jargs), train_mode,
                      mutable=["batch_stats"] if train_mode else False)
    if train_mode:
        want, mutated = want
    tmod.train(train_mode)
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, targs))
    if name == "SetAbstraction":
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        got, want = got[2], want[2]
    assert np.abs(np.asarray(want)).max() > 0
    _close(got.numpy(), want)
    if train_mode:
        want_stats = from_flax({}, jax.tree.map(np.asarray,
                                                mutated["batch_stats"]))
        sd = tmod.state_dict()
        assert want_stats and set(want_stats) <= set(sd)
        for key, w in want_stats.items():
            _close(sd[key].numpy(), w.numpy(), key)


# ---- whole models ----------------------------------------------------------

def _nets(arch):
    """(JAX module, port module) of one arch at the test's width."""
    narrow = dict(width=8, strides=(1, 2, 2, 2, 2, 1), radius=0.15,
                  nsample=8, num_points=128, dropout=0.0)
    if arch == "pointnext_s":
        return (jpn.PointNext(num_reg_targets=2, **narrow),
                tpn.PointNext(2, 3, **narrow))
    if arch == "pointnext_b":
        b = dict(blocks=(1, 2, 3, 2, 1, 1), sa_layers=1, sa_use_res=False,
                 **narrow)
        return (jpn.PointNext(num_reg_targets=2, **b),
                tpn.PointNext(2, 3, **b))
    return (jpn.PointNetEncoderModel(num_reg_targets=2, num_points=128,
                                     dropout=0.0),
            tpn.PointNetEncoderModel(2, 3, num_points=128, dropout=0.0))


def _fields(rng, b=4, n=160):
    """A padded batch: ragged masks (padding rows hold values too), three
    features, targets with a NaN. Every sample has at least the 128 valid
    rows that the input FPS keeps: with fewer, FPS repeats a point, its
    copies tie exactly in the neighbourhood max, and which copy a max
    routes its gradient to turns on one-ulp differences between the two
    frameworks' GEMMs (the gradients of everything before that layer then
    part by ~3e-2 for one weight draw); the fps tests hold those
    repeats."""
    mask = np.zeros((b, n), bool)
    for i, k in enumerate((160, 150, 140, 130)[:b]):
        mask[i, :k] = True
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    y[1, 0] = np.nan
    return dict(pos=rng.uniform(0, 1, (b, n, 3)).astype(np.float32),
                x=rng.normal(size=(b, n, 3)).astype(np.float32),
                mask=mask, y_reg=y, y_reg_mask=~np.isnan(y),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool))


def _jbatch(fields):
    return JBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


def _jtx():
    return optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))


@pytest.fixture(scope="module", params=ARCHS)
def model_case(request):
    """One arch's variables, batch and JAX results, computed once: the eval
    forward, and the train step's loss, gradients, train-mode output, BN
    stats and updated parameters."""
    arch = request.param
    rng = np.random.default_rng(ARCHS.index(arch))
    torch.manual_seed(0)
    jnet, tnet = _nets(arch)
    params, stats = _perturbed(tnet.state_dict(), rng)
    fields = _fields(rng)
    jb = _jbatch(fields)
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(v, np.float32)
                                       for k, v in STATS.items()})
    eval_out = np.asarray(jnet.apply({"params": params, "batch_stats": stats},
                                     jb, train=False))

    def loss_fn(p):
        reg_out, new_stats, _ = _forward(jnet, spec, p, stats, jb,
                                         train=True)
        return jloss(spec, reg_out, jb.y_reg, jb.y_reg_mask, True), \
            (new_stats, reg_out)

    (loss, (new_stats, reg_out)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = _jtx()
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"arch": arch, "params": params, "stats": stats,
            "fields": fields, "eval": eval_out, "loss": float(loss),
            "grads": np_(grads), "train_out": np.asarray(reg_out),
            "new_stats": np_(new_stats), "new_params": np_(new_params)}


def _port(case):
    _, net = _nets(case["arch"])
    net.load_state_dict(from_flax(case["params"], case["stats"]),
                        strict=True)
    return net


def test_eval_forward_matches_jax(model_case):
    net = _port(model_case).eval()
    with torch.no_grad():
        got = net(Batch(**model_case["fields"]).to("cpu"))
    assert got.shape == (4, 2) and got.dtype == torch.float32
    _close(got.numpy(), model_case["eval"])


def _nudged(fields):
    """The fields with every input feature moved up by one f32 ulp."""
    return dict(fields, x=np.nextafter(fields["x"], np.float32(np.inf)))


def _moved(a, b) -> float:
    """max|a - b| / max|a|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _train_forward(case, fields):
    net = _port(case).train()
    with torch.no_grad():
        out = net(Batch(**fields).to("cpu"),
                  generator=torch.Generator().manual_seed(0))
    return out.numpy(), {k: v.numpy() for k, v in net.state_dict().items()}


def test_train_forward_and_bn_stats_match_jax(model_case):
    """Training mode. Its output goes through BN over the batch's 4 rows
    in the head: a one-ulp change of the input features moves it by up to
    ~7e-5 of max|out| (PointNeXt-B, on the port alone), so the output and
    each stat are held to TOL or 4x what that change does to them,
    measured here, whichever is larger (as `test_train_step_matches_jax`
    holds the gradients)."""
    got, sd = _train_forward(model_case, model_case["fields"])
    moved_out, moved_sd = _train_forward(model_case,
                                         _nudged(model_case["fields"]))
    want = model_case["train_out"]
    tol = max(TOL, 4 * _moved(got, moved_out))
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=tol * np.abs(want).max())
    want_stats = from_flax({}, model_case["new_stats"])
    assert set(want_stats) == {k for k in sd if k.endswith((".mean", ".var"))}
    for key, w in want_stats.items():
        w = w.numpy()
        tol = max(TOL, 4 * _moved(sd[key], moved_sd[key]))
        np.testing.assert_allclose(sd[key], w, rtol=TOL,
                                   atol=tol * np.abs(w).max(), err_msg=key)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_step(case, fields):
    runner = train.build_runner(_port(case), STATS, seed=0)
    out = runner.train(Batch(**fields))
    return runner, float(out["loss"]), {
        k: p.grad.numpy().copy() for k, p in runner.net.named_parameters()}


def test_train_step_matches_jax(model_case):
    """One step of the recipe (clip 100, AdaBelief, CAWR), dropout 0. The
    loss and the gradients of these nets (BN over the batch's 4 rows in
    the head, BN over neighbourhoods) move by up to ~3e-4 of themselves
    when the input features move by one f32 ulp, on the port alone: the
    loss is held to rel 1e-5 and all gradients as one vector to rel-L2
    1e-4, or 4x what that one-ulp change does to them, measured here,
    whichever is larger; each gradient likewise, and each updated tensor
    to rtol 1e-4 with atol 1e-5 or 4x that change's max|delta| (AdaBelief's
    first step scales a gradient by its own magnitude, so a near-zero
    gradient's noise reaches its update whole); the widening of
    `chip_smoke.compare_train_steps` for KPConv."""
    fields = model_case["fields"]
    runner, loss, grads = _port_step(model_case, fields)
    nudged, moved_loss, moved = _port_step(model_case, _nudged(fields))
    np.testing.assert_allclose(
        loss, model_case["loss"],
        rtol=max(1e-5, 4 * abs(moved_loss - loss) / abs(loss)))
    want_g = {k: v.numpy() for k, v in from_flax(jax.tree.map(
        lambda g: np.clip(g, -100, 100), model_case["grads"]), None).items()}
    assert set(want_g) == set(grads)
    keys = sorted(grads)

    def flat(tree):
        return np.concatenate([tree[k].ravel() for k in keys])

    assert _rel(flat(grads), flat(want_g)) < max(
        1e-4, 4 * _rel(flat(moved), flat(grads)))
    for key in keys:
        tol = max(1e-4, 4 * _rel(moved[key], grads[key]))
        assert _rel(grads[key], want_g[key]) < tol, key
    sd, moved_sd = runner.net.state_dict(), nudged.net.state_dict()
    want = from_flax(model_case["new_params"], model_case["new_stats"])
    assert set(want) == set(sd)
    for key, w in want.items():
        atol = max(1e-5, 4 * float((moved_sd[key] - sd[key]).abs().max()))
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_rows_change_nothing(arch):
    """tests/test_pointnext.py's padding check on the port, every arch:
    other values in padding rows (features 77, far positions) give the
    same outputs in eval and training mode and the same running stats."""
    rng = np.random.default_rng(4)
    fields = _fields(rng)
    fields["pos"][~fields["mask"]] = 1e6
    other = dict(fields, x=np.where(fields["mask"][..., None], fields["x"],
                                    np.float32(77.0)))
    torch.manual_seed(0)
    _, net = _nets(arch)
    _, twin = _nets(arch)
    twin.load_state_dict(net.state_dict())
    for mode in (False, True):
        net.train(mode)
        twin.train(mode)
        with torch.no_grad():
            a = net(Batch(**fields).to("cpu"))
            b = twin(Batch(**other).to("cpu"))
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for key, t in net.state_dict().items():
        torch.testing.assert_close(t, twin.state_dict()[key], rtol=1e-5,
                                   atol=1e-7, msg=key)


# ---- names and the entry points --------------------------------------------

class _DS:
    num_reg_classes = 2


@pytest.mark.parametrize("model_name,arch", [
    ("PointNext", "pointnext_s"), ("PointNext", "pointnext_b"),
    ("PointNet", "pointnet")])
def test_flax_names_round_trip(model_name, arch):
    """The conf entry at full width: the port's names and shapes are the
    JAX init's (`jax.eval_shape`, nothing compiled), `to_flax` then
    `from_flax` is the identity, and `in_channels_of` reads 3 back."""
    option = dict(train.model_option(model_name, bf16=False), arch=arch)
    net, conv_type = build_model(option, 2, 3)
    assert conv_type == "PARTIAL_DENSE" and f32_only(option)
    shapes = jax.eval_shape(
        lambda: jpn.build_pointnext(option, _DS()).init(
            {"params": jax.random.PRNGKey(0)},
            _jbatch(_fields(np.random.default_rng(0), n=64)), train=False))
    want = {k: tuple(v.shape) for k, v in from_flax(
        *(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes[c])
          for c in ("params", "batch_stats"))).items()}
    sd = net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    back = from_flax(*to_flax(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k])
                                        for k in sd)
    assert in_channels_of(option, sd) == 3


def test_entry_points_name_both_conf_entries():
    """`train.model_option` gives the conf entries (radius =
    data.first_subsampling); f32 only; dense_dims refused."""
    for name, arch in (("PointNext", "pointnext_s"), ("PointNet", "pointnet")):
        option = train.model_option(name, bf16=False)
        conf = jload(CONF, "config", [
            "task=instance", "data=instance/NFI/reg", f"model_name={name}",
            f"models=instance/{name.lower()}"]).to_dict()["models"][name]
        assert option == conf and option["arch"] == arch
        assert train.MODELS[name][1]()["fixed_xy"]["num_points"] == 12000
        with pytest.raises(ValueError, match="f32 only"):
            train.model_option(name, bf16=True)
        with pytest.raises(ValueError, match="dense_dims"):
            train.model_option(name, bf16=False, dense_dims=(8, 8, 8))


# ---- the slice as a whole --------------------------------------------------

def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.array([[float(v) for v in r[1:]] for r in rows[1:]])


def _eval_preds(path):
    """(every column but the predictions, row by row; the predictions) of
    an eval stage's csv."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    keys = [k for k in rows[0] if k.startswith("pred_")]
    return ([{k: v for k, v in r.items() if k not in keys} for r in rows],
            np.array([[float(r[k]) for k in keys] for r in rows]))


def _agree(got, want, center, what):
    """got within SLICE_TOL of max|want - center|, plus one f32 ulp of
    max|want|: the CSVs hold f32 predictions, each rounded once more when
    it is de-standardized (x * scale + center), and a random net's spread
    around the center (~1 here) is far below their magnitude (~200)."""
    scale = float(np.abs(want - center).max())
    ulp = float(np.spacing(np.float32(np.abs(want).max())))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= SLICE_TOL * scale + ulp, \
        (what, err, scale, ulp)


def test_jax_checkpoint_served_by_both_clis(tmp_path):
    """A JAX-layout `.ckpt` of PointNeXt-S (random weights and BN stats,
    the conf entry with CUT) on three `.laz` plots."""
    files = tck._write_plots(str(tmp_path / "plots"))
    rc = jload(CONF, "config", [
        "task=instance", "data=instance/NFI/reg", "model_name=PointNext",
        "models=instance/pointnext", "data.transform_type=fixed_xy"]
    ).to_dict()
    rc["models"]["PointNext"].update(CUT)
    net, _ = build_model(rc["models"]["PointNext"], 2, 3,
                         generator=torch.Generator().manual_seed(0))
    params, stats = _perturbed(net.state_dict(), np.random.default_rng(0))
    ck = JCheckpoint(rc, dict(tck.PROPS))
    ck.models["latest"] = {"params": params, "batch_stats": stats}
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt)
    (ckpt / "PointNext.ckpt").write_bytes(ck.to_bytes())
    args = [f"checkpoint_dir={ckpt}", "model_name=PointNext",
            f"input={tmp_path}/plots/*.laz"]
    got = predict.main(args + [f"output={tmp_path}/port.csv", "device=cpu"])
    want = jax_predict.main(args + [f"output={tmp_path}/jax.csv"])
    (gh, gf, gp), (wh, wf, wp) = _read_csv(got), _read_csv(want)
    assert gh == wh and gf == wf == [os.path.basename(f) for f in files]
    assert np.ptp(wp[:, 0]) > 1e-3
    _agree(gp, wp, np.asarray(tck.PROPS["target_stats"]["center"]),
           "predict")


@pytest.mark.parametrize("model_name", ["PointNext", "PointNet"])
def test_root_grammar_train_eval_calibrate_predict(tmp_path, model_name):
    """The port's train (1 epoch on 12 synthetic plots, bs4), then its
    eval, calibrate_bn and predict on the `.ckpt`; the root eval.py reads
    the `.ckpt` to the port's test predictions."""
    data, run = str(tmp_path / "data"), str(tmp_path / "run")
    cut = [f"models.{model_name}.{k}={v}" for k, v in CUT.items()
           if model_name == "PointNext" or k == "num_points"]
    trainer = train.main([
        "task=instance", f"models=instance/{model_name.lower()}",
        f"model_name={model_name}", "data=instance/synthetic/reg",
        "data.transform_type=fixed_xy", "data.synthetic_plots=12",
        f"data.dataroot={data}", "training=nfi/pointnet",
        "training.epochs=1", "training.batch_size=4",
        "training.num_workers=1", "lr_scheduler=cosineawr",
        "update_lr_scheduler_on=on_num_batch", f"run_dir={run}", *cut,
        "device=cpu"])
    assert "bf16" not in (trainer.option.get("extra_options") or {})
    assert isinstance(trainer.net, tpn.PointNext if model_name == "PointNext"
                      else tpn.PointNetEncoderModel)
    assert trainer.collate.num_points == 12000
    ckpt = os.path.join(run, f"{model_name}.ckpt")
    assert os.path.exists(ckpt)
    common = [f"checkpoint_dir={run}", f"model_name={model_name}",
              "weight_name=latest", "pretty_print=False"]
    teval.main(common + [f"run_dir={tmp_path}/ev_t", "device=cpu"])
    jeval.main(common + [f"run_dir={tmp_path}/ev_j"])
    (got_rest, got), (want_rest, want) = (
        _eval_preds(f"{tmp_path}/{d}/SYNTH_test_preds.csv")
        for d in ("ev_t", "ev_j"))
    assert got_rest == want_rest and len(got) > 0
    _agree(got, want, np.asarray(trainer.spec.center), "eval")
    tcalibrate.main([f"checkpoint_dir={run}", f"model_name={model_name}",
                     f"run_dir={tmp_path}/cal", "epochs=1",
                     "pretty_print=False", "device=cpu"])
    assert os.path.exists(f"{tmp_path}/cal/{model_name}.ckpt")
    plots = tck._write_plots(str(tmp_path / "plots"), n=2)
    out = predict.main([f"checkpoint_dir={run}", f"model_name={model_name}",
                        f"input={tmp_path}/plots/*.laz",
                        f"output={tmp_path}/p.csv", "device=cpu"])
    header, names, preds = _read_csv(out)
    assert names == [os.path.basename(f) for f in plots]
    assert preds.shape == (2, 2) and np.isfinite(preds).all()
