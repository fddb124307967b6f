"""Rematerialization of the sparse-voxel nets (`models/minkowski.remat`,
the JAX package's `nn.remat` around every residual block and the dense
level 0's stem conv) on the CPU, at narrow widths:
  * a train forward keeps fewer bytes for the backward than the same
    blocks called directly (counted with `saved_tensors_hooks`), and runs
    one region a block (and the dense stem);
  * one step's BN running stats are the JAX step's (one momentum update,
    not two), and bit-equal to the direct step's;
  * with DropPath live the rematerialized step gives the direct step's
    loss, gradients, stats and generator state bit for bit (the recompute
    replays the forward's coins);
  * eval, calibrate (train-mode BN without gradients) and torch.export
    run no region;
  * SENet50's bottleneck blocks rematerialized on two gloo ranks match
    the JAX package's step over a 2-device mesh (tests/test_torch_train.py's
    tolerances).
The direct step is the same model with `minkowski.remat` monkeypatched to
call its function. About 40 s on one worker, most of it two JAX
compiles."""
import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcr_agb_tpu.models.minkowski import SparseResNet as JNet
from dpcr_agb_tpu.ops import layout as jlayout
from dpcr_agb_tpu.training.step import make_train_step
from dpcr_agb_tpu_torch import train
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models import minkowski
from dpcr_agb_tpu_torch.models.minkowski import SparseResNet
from dpcr_agb_tpu_torch.weights import from_flax
from tests import test_torch_bottleneck as bottleneck
from tests import test_torch_train as se

DENSE_L0 = dict(l0_mode="dense", stem_mode="zfold2d_firewall",
                pool_bwd="pallas")
# (port kwargs, fields maker, rematerialized regions of a train forward)
CASES = {
    "senet14": (se.NARROW, se._fields, 4),
    "senet50": ({**bottleneck.NARROW, "block": "se_bottleneck"},
                bottleneck._fields, 5),
    "senet14_dense_l0": ({**se.NARROW, **DENSE_L0}, se._fields, 5),
}


@pytest.fixture(autouse=True, scope="module")
def _single_device_jax_layout():
    """The JAX references in their single-device layout, whatever an
    earlier file in the same worker left set (tests/test_torch_train.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayout, "BATCH_LOCAL", False)
        mp.setattr(jlayout, "DATA_PARALLEL_DEGREE", 1)
        yield


def _net(key, **extra):
    kwargs, _, _ = CASES[key]
    torch.manual_seed(0)
    return SparseResNet(num_reg_targets=2, in_channels=3,
                        **{**kwargs, **extra})


def _batch(key, seed=0):
    _, fields, _ = CASES[key]
    return Batch(**fields(np.random.default_rng(seed), b=4)).to("cpu")


class _Counted:
    """`minkowski.remat` counting its calls; `direct` calls the function
    instead (the blocks as they run without remat)."""

    def __init__(self, monkeypatch, direct=False):
        self.calls = 0
        inner = minkowski.remat

        def remat(fn, *args, generator=None):
            self.calls += 1
            return fn(*args) if direct else inner(fn, *args,
                                                  generator=generator)
        monkeypatch.setattr(minkowski, "remat", remat)


def _saved_bytes(net, batch) -> int:
    """Bytes of the distinct tensors the train forward keeps for the
    backward (outside a region: a region keeps its inputs only)."""
    seen = {}

    def pack(t):
        seen[(t.data_ptr(), t.numel(), t.dtype)] = \
            t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = net(batch, generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    return sum(seen.values())


@pytest.mark.parametrize("key", sorted(CASES))
def test_remat_keeps_fewer_bytes_for_the_backward(key, monkeypatch):
    batch = _batch(key)
    net = _net(key).train()
    direct = copy.deepcopy(net)
    remat = _Counted(monkeypatch)
    kept = _saved_bytes(net, batch)
    assert remat.calls == CASES[key][2]
    monkeypatch.undo()
    _Counted(monkeypatch, direct=True)
    kept_direct = _saved_bytes(direct, batch)
    assert kept < 0.6 * kept_direct, (kept, kept_direct)


def _step(net, batch, seed=0):
    runner = train.build_runner(net, se.STATS, seed=seed)
    out = runner.train(batch)
    return {"loss": float(out["loss"]),
            "grads": {k: p.grad.clone() for k, p in net.named_parameters()},
            "state": {k: v.clone() for k, v in net.state_dict().items()},
            "generator": runner.generator.get_state()}


@pytest.mark.parametrize("key", sorted(CASES))
def test_drop_path_step_equals_the_direct_step(key, monkeypatch):
    """DropPath 0.3: the recompute draws the forward's coins again from a
    replay of the runner's generator, and leaves the generator where the
    forward left it; BN's running stats move once."""
    batch = _batch(key, seed=3)
    net = _net(key, drop_path=0.3)
    direct = copy.deepcopy(net)
    counted = _Counted(monkeypatch)
    got = _step(net, batch)
    assert counted.calls == CASES[key][2]
    monkeypatch.undo()
    _Counted(monkeypatch, direct=True)
    want = _step(direct, batch)
    assert got["loss"] == want["loss"]
    for k, g in want["grads"].items():
        assert torch.equal(got["grads"][k], g), k
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    assert torch.equal(got["generator"], want["generator"])
    fresh = train.build_runner(_net(key), se.STATS, seed=0).generator
    assert not torch.equal(got["generator"], fresh.get_state())


def test_one_remat_step_moves_bn_stats_once_as_jax_does(monkeypatch):
    """SENet14 from a perturbed state: the running stats after one
    rematerialized step are the JAX step's (rtol 1e-4, atol 1e-5), and
    the momentum applied twice would put them out of that."""
    rng = np.random.default_rng(0)
    fields = se._fields(rng)
    jnet = JNet(num_reg_targets=2, **se.NARROW)
    variables = se._np(jax.jit(lambda b: jnet.init(
        jax.random.PRNGKey(0), b, train=False))(se._jbatch(fields)))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    tx = se._jtx()
    _, s1, _, _ = make_train_step(jnet, se._jspec(), tx)(
        params, stats, tx.init(params), se._jbatch(fields), np.int32(0))
    want = from_flax({}, se._np(s1))
    before = from_flax({}, stats)
    counted = _Counted(monkeypatch)
    net = SparseResNet(num_reg_targets=2, in_channels=3, **se.NARROW)
    net.load_state_dict(from_flax(params, stats), strict=True)
    got = _step(net, Batch(**fields))["state"]
    assert counted.calls == 4
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # a second momentum update with the same moments would move each stat
    # by (1 - m) (s1 - s0) more: past the tolerance somewhere
    m = se.NARROW.get("bn_momentum", 0.1)
    assert any(bool(((1 - m) * (w - before[k]).abs()
                     > 1e-5 + 1e-4 * w.abs()).any())
               for k, w in want.items())


class _Exported(torch.nn.Module):
    def __init__(self, net, aux):
        super().__init__()
        self.net, self.aux = net, aux

    def forward(self, pos, x, mask, coords):
        b = pos.shape[0]
        return self.net(Batch(
            pos=pos, x=x, mask=mask, y_reg=torch.zeros(b, 2),
            y_reg_mask=torch.zeros(b, 2, dtype=torch.bool),
            area_idx=torch.zeros(b, dtype=torch.int32),
            label_idx=torch.zeros(b, dtype=torch.int64),
            is_double=torch.zeros(b, dtype=torch.bool), coords=coords,
            aux=self.aux))


@pytest.mark.parametrize("key", ["senet14", "senet14_dense_l0"])
def test_eval_calibrate_and_export_run_no_region(key, monkeypatch):
    counted = _Counted(monkeypatch)
    net = _net(key)
    batch = _batch(key)
    runner = train.build_runner(net, se.STATS, seed=0)
    runner.evaluate(batch)
    runner.evaluate(batch, enable_bn=True)
    runner.calibrate(batch)
    net.eval()
    with torch.no_grad():
        program = torch.export.export(
            _Exported(net, batch.aux),
            (batch.pos, batch.x, batch.mask, batch.coords))
    assert counted.calls == 0
    assert "checkpoint" not in str(program.graph)
    runner.train(batch)
    assert counted.calls == CASES[key][2]


def test_two_rank_remat_step_matches_the_jax_mesh_step(tmp_path):
    """Narrow SENet50 (bottleneck blocks, each rematerialized on each rank)
    one step on two gloo ranks against the JAX package's step over a
    2-device mesh on the global batch: loss, each gradient, parameters and
    BN stats at tests/test_torch_train.py's tolerances."""
    from tests import test_torch_parallel as par
    rng = np.random.default_rng(5)
    kwargs = CASES["senet50"][0]
    fields = bottleneck._fields(rng, b=4)
    jnet = JNet(num_reg_targets=2, **kwargs)
    variables = jax.jit(lambda b: jnet.init(
        jax.random.PRNGKey(0), b, train=False))(par._jbatch(fields))
    params, stats = par._perturbed(variables, rng)
    want = par._jax_mesh_step(jnet, params, stats, fields)
    case = {"kind": "step", "net": "senet", "kwargs": kwargs,
            "state": from_flax(params, stats), "stats": se.STATS,
            "fields": fields}
    inp = str(tmp_path / "cases.pt")
    torch.save({"senet50": case}, inp)
    par.run_ranks([sys.executable, "-c", par.WORKER, par.REPO, inp,
                   str(tmp_path)], par.WORLD)
    want_g = from_flax(want["grads"], None)
    total = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in want_g.values()))
    for r in range(par.WORLD):
        g = torch.load(str(tmp_path / f"rank{r}.pt"),
                       weights_only=False)["senet50"]
        assert g["remat_calls"] == CASES["senet50"][2]
        np.testing.assert_allclose(float(g["loss"]), want["loss"], rtol=1e-5)
        for k, b in want_g.items():
            a, b = g["grads"][k].numpy(), b.numpy()
            if np.linalg.norm(b) < 1e-6 * total:
                assert np.linalg.norm(a) < 1e-6 * total, k
            else:
                rel = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert rel < 1e-4, (k, rel)
        for k, v in from_flax(want["params"], want["stats"]).items():
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
