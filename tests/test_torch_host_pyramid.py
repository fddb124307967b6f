"""The port's host pyramid of KPConv against the JAX package's on the CPU.

- `native.grid_subsample` and `native.radius_neighbors` (the port's g++
  build of its copy of `native/pointops.cpp`) give the JAX library's bits
  on random clouds, duplicate points and equal-distance ties, points
  exactly at the radius, empty query and support sets, max_k above the
  support count, an extent wide enough to take the hash path, NaN rows and
  a binding n_max_out; the JAX side is asserted to be its native library,
  never its numpy/scikit-learn fallback.
- `ops.host_pyramid`: `kpconv_pyramid_host` key for key (reverse lists
  and edge transposes on and off, a deformable level, an empty sample, a
  cap that binds), `make_kpconv_post_collate` and the factory's
  `make_post_collate` on a collated batch, the prefix-mask error, the
  pyramid cache, `reverse_lists`, `_rev_cap` and `max_in_degree` (the
  overflow error included): bit-equal.
- The narrow KPCNN of `tests/test_torch_kpconv_model.py` on that host
  aux against `KPCNN(fused_kernel=True)` of the JAX package on the same
  aux: the eval forward at rtol/atol 2e-4, one train step at the
  tolerances of `tests/test_torch_kpconv_train.py`."""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpcr_agb_tpu import native as jnative
from dpcr_agb_tpu.data.batch import Batch as JBatch
from dpcr_agb_tpu.models import factory as jfactory
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec
from dpcr_agb_tpu.models.kpconv import KPCNN as JNet
from dpcr_agb_tpu.ops import host_pyramid as jhp
from dpcr_agb_tpu.training import optim as joptim
from dpcr_agb_tpu.training.step import make_train_step
from dpcr_agb_tpu_torch import native
from dpcr_agb_tpu_torch.data.batch import Batch
from dpcr_agb_tpu_torch.models.factory import make_post_collate
from dpcr_agb_tpu_torch.models.kpconv import KPCNN
from dpcr_agb_tpu_torch.ops import host_pyramid as hp
from dpcr_agb_tpu_torch.weights import from_flax
from tests.test_torch_kpconv_model import NARROW
from tests.test_torch_kpconv_model import _fields as model_fields
from tests.test_torch_kpconv_model import _variables
from tests.test_torch_kpconv_train import STATS, _check_step, _runner
from tests.test_torch_kpconv_train import _fields as train_fields


def _jax_lib():
    assert jnative.is_available(), "the JAX package's native library"
    return jnative.get_lib()


def _same_neighbors(q, s, radius, max_k):
    _jax_lib()
    want = jnative.radius_neighbors(q, s, radius, max_k)
    got = native.radius_neighbors(q, s, radius, max_k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def _same_subsample(p, dl, feats=None):
    _jax_lib()
    want = jnative.grid_subsample(p, dl, feats)
    got = native.grid_subsample(p, dl, feats)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    return got


# --- the native point ops --------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_random_clouds(seed):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(0, 1, (2000, 3)) * rng.uniform(0.5, 4, 3)
         ).astype(np.float32)
    q = rng.uniform(0, 2, (300, 3)).astype(np.float32)
    for r, k in ((0.05, 8), (0.12, 40), (0.3, 256)):
        nbr = _same_neighbors(p, p, r, k)
        assert (nbr[:, 0] < len(p)).all()          # each point finds itself
        _same_neighbors(q, p, r, k)
    f = rng.standard_normal((2000, 4)).astype(np.float32)
    for dl in (0.02, 0.1, 0.5):
        sub, fs = _same_subsample(p, dl, f)
        assert 0 < len(sub) <= len(p) and fs.shape == (len(sub), 4)
        _same_subsample(p, dl)


def test_duplicates_and_equal_distance_ties():
    """A lattice whose spacing divides the radius: every neighbour list has
    runs of equal distances (the library orders them by support index);
    each point repeated three times."""
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1)
    lattice = (g.reshape(-1, 3) * 0.25).astype(np.float32)
    p = np.concatenate([lattice, lattice, lattice[::-1]])
    for r, k in ((0.3, 12), (0.26, 40), (0.6, 64)):
        nbr = _same_neighbors(p, p, r, k)
        assert (nbr[:, :3] < len(p)).all()         # the three copies
    _same_subsample(p, 0.25)
    _same_subsample(p, 0.5, np.arange(len(p) * 2, dtype=np.float32
                                      ).reshape(-1, 2))


def test_points_exactly_at_the_radius_are_left_out():
    """Supports at exactly r along each axis: d == r^2 fails `d < r^2`."""
    r = 0.5
    s = np.array([[0, 0, 0], [r, 0, 0], [0, r, 0], [0, 0, -r],
                  [r * 0.999, 0, 0]], np.float32)
    q = np.zeros((1, 3), np.float32)
    nbr = _same_neighbors(q, s, r, 5)
    np.testing.assert_array_equal(nbr, [[0, 4, 5, 5, 5]])
    rng = np.random.default_rng(3)
    dirs = rng.standard_normal((500, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    shell = (dirs * r).astype(np.float32)   # |d|^2 rounds either side of r^2
    _same_neighbors(q, shell, r, 64)
    _same_neighbors(shell, shell, r, 32)


def test_empty_sets_and_max_k_above_the_support_count():
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    empty = np.zeros((0, 3), np.float32)
    assert _same_neighbors(empty, p, 0.5, 8).shape == (0, 8)
    got = _same_neighbors(p, empty, 0.5, 8)
    assert got.shape == (10, 8)                   # the library's zeros
    got = _same_neighbors(p, p, 10.0, 32)         # every point in range
    assert (got[:, :10] < 10).all() and (got[:, 10:] == 10).all()
    sub, f = _same_subsample(empty, 0.1, np.zeros((0, 2), np.float32))
    assert sub.shape == (0, 3) and f.shape == (0, 2)


def test_wide_extent_takes_the_hash_path():
    """Clusters 1e4 apart at radius 0.05: the flat grid would need more
    than 2^23 cells, so the library searches its hash of cells."""
    rng = np.random.default_rng(2)
    centers = rng.uniform(-1e4, 1e4, (20, 3))
    p = (centers[:, None, :] + rng.uniform(0, 0.2, (20, 50, 3))
         ).reshape(-1, 3).astype(np.float32)
    nbr = _same_neighbors(p, p, 0.05, 16)
    assert (nbr[:, 0] < len(p)).all()
    _same_neighbors(p[::7], p, 0.08, 40)
    _same_subsample(p, 0.05)


def test_nan_rows():
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    p[::17] = np.nan
    p[5, 1] = np.inf
    q = p[::3].copy()
    nbr = _same_neighbors(q, p, 0.15, 24)
    assert (nbr[~np.isfinite(q).all(1)] == len(p)).all()
    bad = ~np.isfinite(p).all(1)
    assert not np.isin(nbr, np.flatnonzero(bad)).any()
    _same_neighbors(p, p, 0.15, 24)


def test_n_max_out_binds_and_the_batched_form():
    """The C entry points directly: grid_subsample with a cap below the
    occupied cells keeps the first cells met; batch_grid_subsample over
    three concatenated clouds."""
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    f = rng.standard_normal((1000, 2)).astype(np.float32)
    jlib, lib = _jax_lib(), native.pointops_library()
    outs = []
    for h in (jlib, lib):
        op = np.zeros((37, 3), np.float32)
        of = np.zeros((37, 2), np.float32)
        n = h.grid_subsample(p, len(p), f.ctypes.data_as(ctypes.c_void_p), 2,
                             0.1, op, of.ctypes.data_as(ctypes.c_void_p), 37)
        outs.append((n, op, of))
    assert outs[0][0] == outs[1][0] == 37
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_array_equal(a, b)
    full, _ = native.grid_subsample(p, 0.1)
    assert len(full) > 37
    lengths = np.array([400, 0, 600], np.int64)
    res = []
    for h in (jlib, lib):
        op = np.zeros((1000, 3), np.float32)
        ol = np.zeros(3, np.int64)
        h.batch_grid_subsample(p, lengths, 3, 0.1, op, ol, 1000)
        res.append((op, ol))
    np.testing.assert_array_equal(res[0][1], res[1][1])
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert res[1][1][1] == 0


# --- the pyramid -------------------------------------------------------------

def _cloud(rng, n, n_valid, scale=1.0):
    pos = np.zeros((n, 3), np.float32)
    pos[:n_valid] = rng.uniform(0, scale, (n_valid, 3))
    mask = np.zeros(n, bool)
    mask[:n_valid] = True
    return pos, mask


def _same_pyramid(pos, mask, plan):
    want = jhp.kpconv_pyramid_host(pos, mask, plan)
    got = hp.kpconv_pyramid_host(pos, mask, plan)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


PLANS = {
    "plain": {},
    "reverse_dx": {"reverse_dx": True},
    "edge_transpose": {"edge_transpose": True},
    "both": {"reverse_dx": True, "edge_transpose": True},
    "rev_kr": {"reverse_dx": True, "rev_kr": 64},
}


@pytest.mark.parametrize("extra", list(PLANS))
def test_kpconv_pyramid_host_is_bit_equal(extra):
    rng = np.random.default_rng(6)
    _jax_lib()
    pos, mask = _cloud(rng, 512, 450)
    plan = {**hp.kpconv_pyramid_plan(0.04, 2.5, 3, 512, (1.0, 0.5, 0.2),
                                     (16, 24, 32)), **PLANS[extra]}
    assert plan == {**jhp.kpconv_pyramid_plan(
        0.04, 2.5, 3, 512, (1.0, 0.5, 0.2), (16, 24, 32)), **PLANS[extra]}
    got = _same_pyramid(pos, mask, plan)
    assert got["kp_pts0"].shape == (512, 3)
    assert (got["kp_pts0"][450:] == hp.SHADOW_POS).all()
    assert (got["kp_conv0"][450:] == 512).all()
    assert got["kp_pool0"].shape == (256, 16)


def test_kpconv_pyramid_deform_level_empty_sample_and_binding_caps():
    rng = np.random.default_rng(7)
    _jax_lib()
    pos, mask = _cloud(rng, 256, 256)
    deform = hp.kpconv_pyramid_plan(0.05, 2.5, 3, 256, (1.0, 0.6, 0.3),
                                    (12, 12, 12), [False, True, False], 2.0)
    _same_pyramid(pos, mask, deform)
    # an empty sample: every list is the shadow
    e_pos, e_mask = _cloud(rng, 128, 0)
    got = _same_pyramid(e_pos, e_mask, hp.kpconv_pyramid_plan(
        0.05, 2.5, 3, 128, (1.0, 0.5, 0.25), (8, 8, 8)))
    assert (got["kp_conv0"] == 128).all() and not got["kp_mask1"].any()
    # point caps and neighbour caps that bind (level 1 keeps 16 of its 27
    # cells, every list is full)
    tight = hp.kpconv_pyramid_plan(0.2, 2.5, 3, 256, (1.0, 0.01, 0.01),
                                   (4, 4, 4), None, 1.0)
    assert tight["caps"] == (256, 16, 16)
    got = _same_pyramid(pos, mask, tight)
    assert got["kp_mask1"].all() and (got["kp_conv0"] < 256).all()


def test_prefix_mask_required():
    pos = np.random.default_rng(8).uniform(0, 1, (64, 3)).astype(np.float32)
    mask = np.ones(64, bool)
    mask[10] = False
    plan = hp.kpconv_pyramid_plan(0.05, 2.5, 2, 64, (1.0, 0.5), (8, 8))
    with pytest.raises(ValueError, match="prefix-packed"):
        hp.kpconv_pyramid_host(pos, mask, plan)
    with pytest.raises(ValueError, match="prefix-packed"):
        jhp.kpconv_pyramid_host(pos, mask, plan)


@dataclasses.dataclass
class _B:
    pos: np.ndarray
    mask: np.ndarray
    aux: dict = None


def test_pyramid_cache_hits_on_identical_points(monkeypatch):
    """As tests/test_host_pyramid.py's: identical points reuse the cached
    pyramid, other points miss; a budget of 0 turns the cache off."""
    calls = []
    real = hp.kpconv_pyramid_host

    def counting(pos, mask, plan):
        calls.append(1)
        return real(pos, mask, plan)

    monkeypatch.setattr(hp, "kpconv_pyramid_host", counting)
    plan_fn = lambda v0: hp.kpconv_pyramid_plan(  # noqa: E731
        0.05, 2.5, 2, v0, (1.0, 0.5), (8, 8))
    pos = np.random.default_rng(9).uniform(0, 1, (2, 64, 3)).astype(
        np.float32)
    mask = np.ones((2, 64), bool)
    post = hp.make_kpconv_post_collate(plan_fn)
    b1 = post(_B(pos, mask))
    assert len(calls) == 2
    b2 = post(_B(pos, mask))
    assert len(calls) == 2
    post(_B(pos + 0.01, mask))
    assert len(calls) == 4
    for k in b1.aux:
        np.testing.assert_array_equal(b1.aux[k], b2.aux[k])
    monkeypatch.setenv("DPCR_PYRAMID_CACHE_MB", "0")
    off = hp.make_kpconv_post_collate(plan_fn)
    off(_B(pos, mask))
    off(_B(pos, mask))
    assert len(calls) == 8


@pytest.mark.parametrize("extra", ["plain", "both"])
def test_post_collate_is_bit_equal_on_a_collated_batch(extra):
    """Four samples of 300-600 points collated to 1024 rows: the reverse
    lists' per-sample widths padded to the batch's widest with the
    sentinel edge id, as in the JAX package."""
    rng = np.random.default_rng(10)
    _jax_lib()
    pos = np.zeros((4, 1024, 3), np.float32)
    mask = np.zeros((4, 1024), bool)
    for i, n in enumerate((300, 600, 450, 1024)):
        pos[i, :n], mask[i, :n] = _cloud(rng, n, n, scale=0.6)
    pos[1, :50] = pos[1, 0]                     # a density spike

    def plan_fn(v0):
        return {**hp.kpconv_pyramid_plan(0.03, 2.5, 3, v0, (1.0, 0.4, 0.2),
                                         (20, 30, 30)), **PLANS[extra]}
    got = hp.make_kpconv_post_collate(plan_fn, cache_bytes=0)(
        _B(pos, mask)).aux
    want = jhp.make_kpconv_post_collate(plan_fn, cache_bytes=0)(
        _B(pos, mask)).aux
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_factory_post_collate_equals_jax():
    """`make_post_collate` of the port's narrow KPCNN and of the JAX
    package's, on one collated batch of `tests/test_torch_kpconv_model.py`:
    the same plan (caps from the net's neighbour limits and the default
    point fractions) and the same arrays."""
    _jax_lib()
    f = model_fields(np.random.default_rng(0))
    limits = dict(neighborhood_limits=[7, 11])
    port = make_post_collate(KPCNN(**NARROW, **limits))
    jax_post = jfactory.make_post_collate(JNet(**NARROW, **limits))
    got = port(Batch(**f)).aux
    want = jax_post(JBatch(**f)).aux
    assert list(got) == list(want) == [
        "kp_pts0", "kp_mask0", "kp_conv0", "kp_pool0", "kp_pts1",
        "kp_mask1", "kp_conv1"]
    assert got["kp_conv0"].shape == (2, 64, 7)
    assert got["kp_conv1"].shape == (2, 48, 11)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_reverse_lists_rev_cap_and_in_degree_equal_jax():
    rng = np.random.default_rng(11)
    nq, k, ns = 60, 6, 40
    nbr = rng.integers(0, ns + 1, (nq, k)).astype(np.int32)
    assert hp.max_in_degree(nbr, ns) == jhp.max_in_degree(nbr, ns)
    for plan in ({}, {"rev_kr": 30}):
        assert hp._rev_cap(plan, k, nbr, ns) == jhp._rev_cap(plan, k, nbr,
                                                              ns)
    kr = hp._rev_cap({}, k, nbr, ns)
    np.testing.assert_array_equal(hp.reverse_lists(nbr, ns, kr),
                                  jhp.reverse_lists(nbr, ns, kr))
    for a, b in zip(hp._edge_transpose(nbr, ns),
                    jhp._edge_transpose(nbr, ns)):
        np.testing.assert_array_equal(a, b)
    spike = np.zeros((40, 4), np.int32)          # in-degree 160 at row 0
    assert hp._rev_cap({}, 4, spike, 5) == jhp._rev_cap({}, 4, spike, 5) \
        == 160
    np.testing.assert_array_equal(hp.reverse_lists(spike, 5, 160),
                                  jhp.reverse_lists(spike, 5, 160))
    with pytest.raises(ValueError, match="exceeds kr=8"):
        hp.reverse_lists(np.zeros((10, 4), np.int32), 5, 8)


# --- the narrow KPCNN on the host aux ---------------------------------------

def _with_aux(fields):
    """The fields with the JAX package's host pyramid of them in `aux`
    (the port's, bit-equal by the tests above)."""
    _jax_lib()
    post = jfactory.make_post_collate(JNet(fused_kernel=True, **NARROW))
    aux = post(JBatch(**fields)).aux
    return {**fields, "aux": {k: np.asarray(a) for k, a in aux.items()}}


def _jbatch(fields):
    return JBatch(**{k: ({n: jnp.asarray(a) for n, a in v.items()}
                         if isinstance(v, dict) else jnp.asarray(v))
                     for k, v in fields.items()})


class _Jitted:
    """`init` of a flax module under jit (the interpret-mode Pallas kernel
    is slow op by op)."""

    def __init__(self, net):
        self.init = jax.jit(net.init, static_argnames="train")


def test_eval_forward_on_the_host_aux_matches_jax():
    """rtol/atol 2e-4, as the device-pyramid forward of
    tests/test_torch_kpconv_model.py; the host lists differ from the
    device pyramid's at level 1 (another point order)."""
    rng = np.random.default_rng(0)
    fields = _with_aux(model_fields(rng))
    jnet = JNet(fused_kernel=True, **NARROW)
    jb = _jbatch(fields)
    variables = _variables(_Jitted(jnet), jb, rng)
    want = np.asarray(jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, jb))
    net = KPCNN(**NARROW)
    net.load_state_dict(from_flax(variables["params"],
                                  variables["batch_stats"]), strict=True)
    net.eval()
    with torch.no_grad():
        got = net(Batch(**fields).to("cpu")).numpy()
        device_route = net(Batch(**{**fields, "aux": None}).to("cpu"))
    assert got.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert not np.array_equal(got, device_route.numpy())


def test_train_step_on_the_host_aux_matches_jax():
    """One step of the paper's recipe on a batch with the host aux, from
    the same weights: `_check_step` of tests/test_torch_kpconv_train.py
    (loss rtol 1e-5, each gradient 1e-4 relative L2, updated parameters
    and BN stats rtol 1e-4)."""
    from dpcr_agb_tpu.models.base import compute_reg_loss as jloss
    from dpcr_agb_tpu.training.step import _forward
    rng = np.random.default_rng(0)
    fields = _with_aux(train_fields(rng))
    jnet = JNet(fused_kernel=True, **NARROW)
    v = jax.tree.map(np.asarray, _Jitted(jnet).init(
        jax.random.PRNGKey(0), _jbatch(fields), train=False))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(s, np.float32)
                                       for k, s in STATS.items()})
    tx = optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))

    def loss_fn(p, s, batch):
        reg_out, _, _ = _forward(jnet, spec, p, s, batch, train=True)
        return jloss(spec, reg_out, batch.y_reg, batch.y_reg_mask, True)

    _, grads = jax.jit(jax.value_and_grad(loss_fn))(params, stats,
                                                    _jbatch(fields))
    p2, s2, _, out = make_train_step(jnet, spec, tx)(
        params, stats, tx.init(params), _jbatch(fields), np.int32(0))
    run = {"batches": [fields], "losses": [float(out["loss"])],
           "grads": [jax.tree.map(np.asarray, grads)],
           "states": [(params, stats, None),
                      (jax.tree.map(np.asarray, p2),
                       jax.tree.map(np.asarray, s2), None)]}
    _check_step(_runner(params, stats), run, 0)
