"""Map mode of the port's sparse-voxel nets (`dense_dims=None`) against the
JAX package on the CPU.

Ops: `hypercube_offsets`, `lookup`, `kernel_map` and `downsample` equal
to the JAX functions as integers (probes clipped at the key range
included); `sparse_conv_apply` and `max_pool_apply` forward and VJP
within 1e-5 (f32; the pool's ties split alike), bf16 forward within 2e-2
of the largest value. Host pyramid: the numpy and the native route bit-
equal with `dpcr_agb_tpu/ops/host_pyramid.py` (first_stride 1 and 2,
caps that drop voxels, coords past the fast path). Models: a narrow
SENet14 (se_basic) and a narrow bottleneck net (planes 16,16,32,32, init
16, level caps that drop) with the same weights (`weights.from_flax`):
the eval forward (the port's maps from the host and from the device,
1e-4; also at first_stride 2) and one train step (`make_train_step`;
loss 1e-5, parameters and BN stats rtol 1e-4); the port's map mode
against its own dense mode where every BN maps 0 to 0 (2e-3 relative,
the JAX package's check); and the entry points with `dense_dims=null`:
two trainer epochs through the root grammar, then eval, calibrate_bn and
predict from the `.ckpt` (the root `predict.py` on the same checkpoint
gives the same CSV), and the `input=` form to `predict` from the `.pt`."""
import csv
import dataclasses
import functools
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

import predict as jpredict  # noqa: E402
from dpcr_agb_tpu.ops import layout as jlayout  # noqa: E402
from dpcr_agb_tpu.data.batch import Batch as JBatch  # noqa: E402
from dpcr_agb_tpu.models import minkowski as jmink  # noqa: E402
from dpcr_agb_tpu.models.base import InstanceSpec as JSpec  # noqa: E402
from dpcr_agb_tpu.ops import host_pyramid as jhp  # noqa: E402
from dpcr_agb_tpu.ops import voxel as jvox  # noqa: E402
from dpcr_agb_tpu.training import optim as joptim  # noqa: E402
from dpcr_agb_tpu.training.step import make_train_step  # noqa: E402
from dpcr_agb_tpu_torch import calibrate_bn as tcalibrate  # noqa: E402
from dpcr_agb_tpu_torch import eval as teval  # noqa: E402
from dpcr_agb_tpu_torch import predict, train  # noqa: E402
from dpcr_agb_tpu_torch.data.batch import Batch  # noqa: E402
from dpcr_agb_tpu_torch.data.synthetic import generate_plot  # noqa: E402
from dpcr_agb_tpu_torch.models import minkowski as tmink  # noqa: E402
from dpcr_agb_tpu_torch.models.factory import make_post_collate  # noqa: E402
from dpcr_agb_tpu_torch.nn.norm import MaskedBatchNorm  # noqa: E402
from dpcr_agb_tpu_torch.ops import host_pyramid as thp  # noqa: E402
from dpcr_agb_tpu_torch.ops import voxel as tvox  # noqa: E402
from dpcr_agb_tpu_torch.weights import from_flax  # noqa: E402


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


PAD = -(2 ** 20)
STATS = {"scale": [40.0, 80.0], "center": [100.0, 200.0],
         "weights": [0.5, 0.5]}
NARROW = dict(layers=(1, 1, 1, 1), planes=(16, 16, 32, 32), init_dim=16,
              activation="gelu", global_pool="sum", drop_path=0.0,
              dense_dims=None)
# (name, block, first_stride, level caps): the bottleneck net's caps drop
# voxels at level 1 and below
NETS = {"SENet14": ("se_basic", 1, None),
        "bottleneck": ("bottleneck", 1, (128, 40, 16, 8, 8)),
        "SENet14_s2": ("se_basic", 2, None)}


def _voxels(rng, n, v, dims=(12, 10, 9), lo=0):
    d, h, w = dims
    flat = rng.choice(d * h * w, size=n, replace=False)
    c = np.full((v, 3), PAD, np.int32)
    c[:n] = np.stack([flat // (h * w), flat // w % h, flat % w], 1) + lo
    m = np.zeros(v, bool)
    m[:n] = True
    return c, m


def _fields(rng, b=3, v=128):
    coords = np.full((b, v, 3), PAD, np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        coords[i], mask[i] = _voxels(rng, int(rng.integers(60, 120)), v)
    x = np.where(mask[..., None], rng.uniform(0, 1, (b, v, 3)), 0)
    y = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    y[2, 1] = np.nan
    return dict(pos=np.zeros((b, v, 3), np.float32), x=x.astype(np.float32),
                mask=mask, y_reg=y, y_reg_mask=~np.isnan(y),
                area_idx=np.zeros(b, np.int32),
                label_idx=np.arange(b, dtype=np.int64),
                is_double=np.zeros(b, bool), coords=coords)


def _jbatch(fields):
    return JBatch(**{k: jax.tree.map(jnp.asarray, f)
                     for k, f in fields.items()})


# ---- ops ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_hypercube_offsets_equal_jax(k):
    np.testing.assert_array_equal(tvox.hypercube_offsets(k),
                                  jvox.hypercube_offsets(k))


def _grids(rng, lo=0, dims=(12, 10, 9)):
    cs, ms = zip(*[_voxels(rng, n, 128, dims, lo) for n in (100, 37, 0)])
    coords, mask = np.stack(cs), np.stack(ms)
    jg = jax.vmap(jvox.build_grid)(jnp.asarray(coords), jnp.asarray(mask))
    tg = tvox.build_grid(torch.from_numpy(coords), torch.from_numpy(mask))
    return coords, mask, jg, tg


@pytest.mark.parametrize("lo", [0, 505])
@pytest.mark.parametrize("stride,ksize", [(1, 3), (2, 3), (2, 1), (1, 7),
                                          (2, 7)])
def test_kernel_map_lookup_downsample_equal_jax(lo, stride, ksize):
    """lo 505 puts probes past the key range (clipped, as the keys are)."""
    rng = np.random.default_rng(stride * 10 + ksize + lo)
    coords, mask, jg, tg = _grids(rng, lo)
    np.testing.assert_array_equal(tg.keys_sorted.numpy(),
                                  np.asarray(jg.keys_sorted))
    for cap in (128, 24):
        jd = jax.vmap(lambda g: jvox.downsample(g, None, stride, cap)[0])(jg)
        td, _ = tvox.downsample(tg, None, stride, cap)
        np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
        np.testing.assert_array_equal(
            np.where(td.mask.numpy()[..., None], td.coords.numpy(), 0),
            np.where(np.asarray(jd.mask)[..., None], np.asarray(jd.coords),
                     0))
        out_j = jg if stride == 1 else jd
        out_t = tg if stride == 1 else td
        offs = jvox.hypercube_offsets(ksize)
        want = jax.vmap(lambda gi, go: jvox.kernel_map(
            gi, go, jnp.asarray(offs), stride))(jg, out_j)
        got = tvox.kernel_map(tg, out_t, offs, stride)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    probe = coords[:, :20] + rng.integers(-2, 3, (3, 20, 3)).astype(np.int32)
    valid = rng.random((3, 20)) < 0.8
    want = jax.vmap(jvox.lookup)(jg, jnp.asarray(probe), jnp.asarray(valid))
    got = tvox.lookup(tg, torch.from_numpy(probe), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _conv_inputs(seed, k=27, cin=5, cout=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, 40, cin)).astype(np.float32)
    nbr = rng.integers(0, 41, (2, k, 33)).astype(np.int32)
    nbr[:, :, :4] = 40                       # all-shadow output rows
    w = rng.normal(size=(k, cin, cout)).astype(np.float32) * 0.3
    return feats, nbr, w


@pytest.mark.parametrize("k,cin,chunk", [(27, 5, None), (343, 3, None),
                                         (1, 7, None), (27, 64, 2)])
def test_sparse_conv_apply_and_vjp_equal_jax(k, cin, chunk):
    feats, nbr, w = _conv_inputs(k + cin, k, cin)
    ct = np.random.default_rng(1).normal(size=(2, 33, 6)).astype(np.float32)

    def jf(f, ww):
        return jax.vmap(lambda a, i: jvox.sparse_conv_apply(
            a, i, ww, offset_chunk=chunk))(f, jnp.asarray(nbr))
    want, vjp = jax.vjp(jf, jnp.asarray(feats), jnp.asarray(w))
    dfw, dww = vjp(jnp.asarray(ct))
    tf = torch.from_numpy(feats).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tvox.sparse_conv_apply(tf, torch.from_numpy(nbr), tw,
                                 offset_chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(dfw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dww), rtol=1e-5,
                               atol=1e-4)
    assert not got.detach()[:, :4].any()    # shadow rows only: zero


def test_sparse_conv_apply_bf16_accumulates_in_f32():
    """bf16 rows and weights, f32 sums: within 2e-2 of the largest value
    of the JAX function's output (preferred_element_type f32)."""
    feats, nbr, w = _conv_inputs(3, 343, 3)
    want = jax.vmap(lambda a, i: jvox.sparse_conv_apply(
        a, i, jnp.asarray(w).astype(jnp.bfloat16)))(
        jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(nbr))
    got = tvox.sparse_conv_apply(torch.from_numpy(feats).bfloat16(),
                                 torch.from_numpy(nbr), torch.from_numpy(w))
    assert got.dtype == torch.float32
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("ties", [False, True])
def test_max_pool_apply_and_vjp_equal_jax(ties):
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(2, 40, 4)).astype(np.float32)
    if ties:
        feats = np.round(feats)              # many equal maxima
    nbr = rng.integers(0, 41, (2, 27, 30)).astype(np.int32)
    nbr[:, :, :3] = 40                       # no real row
    out_mask = rng.random((2, 30)) < 0.8
    ct = rng.normal(size=(2, 30, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax.vmap(jvox.max_pool_apply)(
        f, jnp.asarray(nbr), jnp.asarray(out_mask)), jnp.asarray(feats))
    (dfw,) = vjp(jnp.asarray(ct))
    tf = torch.from_numpy(feats).requires_grad_()
    got = tvox.max_pool_apply(tf, torch.from_numpy(nbr),
                              torch.from_numpy(out_mask))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(dfw), rtol=1e-6,
                               atol=1e-6)



@pytest.mark.parametrize("mode", ["max", "sum", "mean"])
@pytest.mark.parametrize("cap", [128, 24])
def test_downsample_pooling_equals_jax(mode, cap):
    """downsample's pooled features against the JAX package's, with an
    empty sample, masked rows holding values and (cap 24) voxels dropped
    past v_out with their contributions; max zeroes the unoccupied
    outputs. max exact; sum and mean within f32 rounding (the port sums
    each voxel as a difference of f64 prefix sums)."""
    rng = np.random.default_rng({"max": 1, "sum": 2, "mean": 3}[mode] + cap)
    coords, mask, jg, tg = _grids(rng)
    feats = rng.normal(size=mask.shape + (5,)).astype(np.float32)
    jd, jf = jax.vmap(lambda g, f: jvox.downsample(g, f, 2, cap, mode))(
        jg, jnp.asarray(feats))
    td, tf = tvox.downsample(tg, torch.from_numpy(feats), 2, cap, mode)
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    assert tf.dtype == torch.float32 and tf.shape == jf.shape
    if mode == "max":
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert (tf.numpy()[~td.mask.numpy()] == 0).all()
    else:
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                                   atol=1e-6)
    # cap 24: the first sample's voxels fill every slot and some drop
    assert cap == 128 or td.mask.numpy()[0].all()

# ---- host pyramid ---------------------------------------------------------

@pytest.mark.parametrize("first_stride,caps,lo", [
    (1, None, 0), (2, None, 0), (1, (128, 40, 16, 8, 8), 0),
    (1, None, 480)])
@pytest.mark.parametrize("use_native", [True, False])
def test_host_pyramid_equals_jax(first_stride, caps, lo, use_native):
    """lo 480: stride * coords + offsets leave the key range, so the maps
    take lookup_np's clipped probes instead of the key-sum fast path."""
    rng = np.random.default_rng(first_stride + lo)
    cs, ms = zip(*[_voxels(rng, n, 128, (12, 10, 9), lo)
                   for n in (120, 50, 0)])
    coords, mask = np.stack(cs), np.stack(ms)
    fracs = tmink.DEFAULT_LEVEL_FRACS
    plan = thp.resnet_pyramid_plan(first_stride, (1, 2, 2, 2), 128, fracs,
                                   caps)
    assert plan == jhp.resnet_pyramid_plan(first_stride, (1, 2, 2, 2), 128,
                                           fracs, caps)
    want = jhp.collate_sparse_aux(coords, mask, plan)
    before = dict(thp.ROUTE_CALLS)
    got = thp.collate_sparse_aux(coords, mask, plan, use_native)
    route = "native" if use_native else "numpy"
    assert thp.ROUTE_CALLS[route] == before[route] + 3
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    grid = thp.HostGrid(coords[0], mask[0], use_native)
    jgrid = jhp.HostGrid(coords[0], mask[0])
    np.testing.assert_array_equal(grid.keys_sorted, jgrid.keys_sorted)
    np.testing.assert_array_equal(grid.order, jgrid.order)


@pytest.mark.parametrize("first_stride,caps", [(1, None), (2, None),
                                               (1, (64, 32, 16, 8, 8))])
def test_model_plan_is_the_jax_models_levels(first_stride, caps):
    """The levels and caps a map-mode forward reads are the JAX model's
    (its n_levels rule and _round8 of DEFAULT_LEVEL_FRACS, or
    level_caps)."""
    net = tmink.SparseResNet(num_reg_targets=2, in_channels=3,
                             block="se_basic", first_stride=first_stride,
                             level_caps=caps, **NARROW)
    plan = net.pyramid_plan(4096)
    n = 5 + (first_stride != 1)
    fracs = jmink.DEFAULT_LEVEL_FRACS
    want = list(caps) if caps else [jmink._round8(int(4096 * fracs[l]))
                                    for l in range(n)]
    assert tmink.DEFAULT_LEVEL_FRACS == fracs
    assert plan["n_levels"] == n and list(plan["caps"]) == want


# ---- models ---------------------------------------------------------------

def _tx():
    return optax.chain(optax.clip(100.0), joptim.adabelief(
        joptim.cosine_annealing_warm_restarts(5e-3, 10, 2),
        weight_decay=1e-2))


def _kw(name):
    block, first_stride, caps = NETS[name]
    return dict(num_reg_targets=2, block=block, first_stride=first_stride,
                level_caps=caps, **NARROW)


def _aux(name, fields):
    block, first_stride, caps = NETS[name]
    plan = jhp.resnet_pyramid_plan(first_stride, (1, 2, 2, 2),
                                   fields["coords"].shape[1],
                                   jmink.DEFAULT_LEVEL_FRACS, caps)
    return jhp.collate_sparse_aux(fields["coords"], fields["mask"], plan)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX map mode on the host maps (the same function as its device
    route, which tests/test_host_pyramid.py holds it to): perturbed init
    and the eval output."""
    rng = np.random.default_rng(3)
    fields = _fields(rng)
    jb = _jbatch({**fields, "aux": _aux(name, fields)})
    jnet = jmink.SparseResNet(**_kw(name))
    v = jax.tree.map(np.asarray, jax.jit(lambda b: jnet.init(
        jax.random.PRNGKey(0), b, train=False))(jb))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05)
                          .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    want = np.asarray(jax.jit(lambda vv, b: jnet.apply(vv, b, train=False))(
        {"params": params, "batch_stats": stats}, jb))
    return dict(fields=fields, params=params, stats=stats, want=want,
                jnet=jnet, jbatch=jb)


def _jax_step(name):
    """One `make_train_step` step of the JAX map mode from _jax_run's
    state: (loss, (params, batch_stats) after it)."""
    run = _jax_run(name)
    spec = JSpec(num_reg_targets=2, **{k: np.asarray(s, np.float32)
                                       for k, s in STATS.items()})
    tx = _tx()
    p, s, _, out = make_train_step(run["jnet"], spec, tx)(
        run["params"], run["stats"], tx.init(run["params"]), run["jbatch"],
        np.int32(0))
    return float(out["loss"]), (jax.tree.map(np.asarray, p),
                                jax.tree.map(np.asarray, s))


def _net(name, params, stats, **over):
    net = tmink.SparseResNet(in_channels=3, **{**_kw(name), **over})
    net.load_state_dict(from_flax(params, stats), strict=True)
    return net


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("maps", ["host", "device"])
def test_map_forward_equals_jax(name, maps):
    run = _jax_run(name)
    net = _net(name, run["params"], run["stats"]).eval()
    batch = Batch(**run["fields"])
    if maps == "host":
        batch = make_post_collate(net)(batch)
        assert "stem_map" in batch.aux
    with torch.no_grad():
        got = net(batch.to("cpu")).numpy()
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, run["want"], rtol=1e-4,
                               atol=1e-4 * np.abs(run["want"]).max())


@pytest.mark.parametrize("name", ["SENet14", "bottleneck"])
def test_map_train_step_equals_jax(name):
    """Port step from JAX's state on the host maps: loss 1e-5, updated
    parameters and BN running stats rtol 1e-4 (atol 1e-5)."""
    run = _jax_run(name)
    loss, after = _jax_step(name)
    runner = train.build_runner(_net(name, run["params"], run["stats"]),
                                STATS, seed=0)
    batch = make_post_collate(runner.net)(Batch(**run["fields"]))
    out = runner.train(batch)
    np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-5)
    want = from_flax(*after)
    sd = runner.net.state_dict()
    assert set(want) == set(sd)
    for key, w in want.items():
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", ["SENet14", "bottleneck"])
def test_map_mode_equals_dense_mode_where_bn_maps_zero_to_zero(name):
    """One state dict in both modes: the same outputs (2e-3 of the largest,
    the JAX package's check) when every BN's running mean and offset are 0
    (the dense path's empty cells then stay 0, as map mode's shadow is);
    with the offsets set, the two modes are other functions, in the JAX
    package too."""
    run = _jax_run(name)
    # the default caps: no level drops a voxel of this batch
    mapped = _net(name, run["params"], run["stats"], level_caps=None).eval()
    with torch.no_grad():
        for m in mapped.modules():
            if isinstance(m, MaskedBatchNorm):
                m.mean.zero_()
                m.bias.zero_()
    dense = tmink.SparseResNet(in_channels=3, **{
        **_kw(name), "dense_dims": (12, 10, 9), "level_caps": None}).eval()
    dense.load_state_dict(mapped.state_dict())
    fields = run["fields"]
    with torch.no_grad():
        got = mapped(make_post_collate(mapped)(Batch(**fields)).to("cpu"))
        want = dense(make_post_collate(dense)(Batch(**fields)).to("cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3 * want.abs().max().item())


def test_weights_carry_between_modes_and_from_jax():
    """The flax names of a JAX map-mode net are the port's, in either
    mode, and the dense JAX net's are the same tree."""
    run = _jax_run("SENet14")
    sd = from_flax(run["params"], run["stats"])
    for dims in (None, (12, 10, 9)):
        net = tmink.SparseResNet(in_channels=3, **{**_kw("SENet14"),
                                                   "dense_dims": dims})
        assert set(net.state_dict()) == set(sd)
    jd = jmink.SparseResNet(**{**_kw("SENet14"), "dense_dims": (12, 10, 9)})
    v = jax.eval_shape(lambda b: jd.init(jax.random.PRNGKey(0), b,
                                         train=False),
                       _jbatch(run["fields"]))
    assert jax.tree.structure(v["params"]) == \
        jax.tree.structure(run["params"])


# ---- entry points ---------------------------------------------------------

TINY = dict(block="se_basic", layers=(1, 1, 1, 1), strides=(1, 2, 2, 2),
            init_dim=16, planes=(16, 16, 32, 32))


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_map_mode_through_the_root_grammar(tmp_path):
    """Two epochs of two steps each (12 plots, batch 4), the maps built in
    the loader's threads; eval and calibrate_bn on the `.ckpt`; the port's
    predict and the root predict.py serve the `.ckpt` alike."""
    run, data = str(tmp_path / "run"), str(tmp_path / "data")
    caps = "[16384,4096,2048,1024,512]"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tmink._ARCH_EXTRAS, "SENetTiny", TINY)
        mp.setitem(jmink._ARCH_EXTRAS, "SENetTiny", TINY)
        trainer = train.main([
            "task=instance", "models=instance/minkowski_baseline",
            "model_name=SENet14", "data=instance/synthetic/reg",
            "data.transform_type=sparse_xy", "data.synthetic_plots=12",
            f"data.dataroot={data}", "training=nfi/minkowski",
            "training.epochs=2", "training.batch_size=4",
            "training.num_workers=2", "lr_scheduler=cosineawr",
            "update_lr_scheduler_on=on_num_batch", "visualization=eval",
            "models.SENet14.model_name=SENetTiny",
            "models.SENet14.extra_options.dense_dims=null",
            f"models.SENet14.extra_options.level_caps={caps}",
            f"run_dir={run}", "device=cpu"])
        assert trainer.net.dense_dims is None
        assert trainer.net.level_caps == [16384, 4096, 2048, 1024, 512]
        epochs = [h for h in trainer.history if h["stage"] == "train"]
        assert len(epochs) == 2 and all(h["batches"] == 2 for h in epochs)
        assert all(np.isfinite(h["tracked_losses"]).all() for h in epochs)
        results = teval.main([f"checkpoint_dir={run}", "model_name=SENet14",
                              "weight_name=latest", f"run_dir={tmp_path}/ev",
                              "pretty_print=False", "device=cpu"])
        assert np.isfinite(results["test"]["test_loss"])
        tcalibrate.main([f"checkpoint_dir={run}", "model_name=SENet14",
                         f"run_dir={tmp_path}/cal", "epochs=1",
                         "pretty_print=False", "device=cpu"])
        assert os.path.exists(f"{tmp_path}/cal/SENet14.ckpt")
        plots = str(tmp_path / "plots")
        _write_plots(plots)
        args = ["model_name=SENet14", "weight_name=latest",
                f"input={plots}/*.npz"]
        got = predict.main(args + [f"checkpoint_dir={run}",
                                   f"output={tmp_path}/t.csv", "device=cpu"])
        want = jpredict.main(args + [f"checkpoint_dir={run}",
                                     f"output={tmp_path}/j.csv"])
    g, w = _read(got), _read(want)
    assert g[0] == w[0] and [r[0] for r in g] == [r[0] for r in w]
    np.testing.assert_allclose(np.array([r[1:] for r in g[1:]], float),
                               np.array([r[1:] for r in w[1:]], float),
                               rtol=1e-4)


def _write_plots(root, n=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        pts, bm, v = generate_plot(rng, radius=6.0, density=3.0)
        np.savez(os.path.join(root, f"p{i}.npz"),
                 pos=pts + np.array([5e5, 6e6, 100.0], np.float32),
                 BMag_ha=bm, V_ha=v)


def test_input_form_trains_and_serves_map_mode(tmp_path):
    plots, ckpt = str(tmp_path / "plots"), str(tmp_path / "ck")
    _write_plots(plots)
    out = train.main([f"input={plots}/*.npz", f"checkpoint_dir={ckpt}",
                      "steps=2", "batch_size=2", "device=cpu",
                      "dense_dims=null", "level_caps=8192,4096,2048,512,256"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    saved = torch.load(out["checkpoint"], weights_only=True)
    assert saved["option"]["extra_options"] == {
        "dense_dims": None, "level_caps": [8192, 4096, 2048, 512, 256]}
    path = predict.main([f"checkpoint_dir={ckpt}", "model_name=SENet14",
                         f"input={plots}/*.npz", f"output={tmp_path}/p.csv",
                         "device=cpu"])
    rows = _read(path)[1:]
    assert len(rows) == 3 and np.isfinite(
        np.array([r[1:] for r in rows], float)).all()


def test_model_option_map_mode_and_refusals():
    opt = train.model_option("SENet50", bf16=True, dense_dims="null")
    assert opt["extra_options"] == {"bf16": True, "dense_dims": None}
    net, _ = train.build_model(opt, 2, 3)
    assert net.dense_dims is None and net.level_caps is None
    for name in ("KPConv", "MPointNet", "PointNext"):
        with pytest.raises(ValueError, match="sparse-voxel nets"):
            train.model_option(name, bf16=False, dense_dims="null")
        with pytest.raises(ValueError, match="sparse-voxel nets"):
            train.model_option(name, bf16=False, level_caps=["8"])


def test_map_batches_carry_every_level_and_map(tmp_path):
    _write_plots(str(tmp_path))
    opt = train.model_option("SENet14", bf16=False, dense_dims="null")
    net, conv_type = train.build_model(opt, 2, 3)
    files = sorted(str(p) for p in tmp_path.glob("*.npz"))
    stream = train.setup(files, "SENet14", dense_dims="null", batch_size=2,
                         device="cpu").stream
    batch = stream.next()
    v = batch.coords.shape[1]
    assert batch.aux["stem_map"].shape == (2, 343, v)
    assert batch.aux["pool_map"].shape[1] == 27
    assert {f"mask{l}" for l in range(5)} | {"s1_map1", "s1_map4",
                                             "down_k3_1", "down_k1_3"} \
        <= set(batch.aux)
    assert "zcells" not in batch.aux
    bare = dataclasses.replace(batch, aux=None)
    with torch.no_grad():
        net.eval()
        np.testing.assert_allclose(net(batch.to("cpu")).numpy(),
                                   net(bare.to("cpu")).numpy(), rtol=1e-5,
                                   atol=1e-6)
