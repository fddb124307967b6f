"""The port's YAML reader and config engine against PyYAML and the JAX
package's engine: every file under conf/ reads to the same tree as
`yaml.safe_load`, the root CLIs' commands compose to the same dict as
`dpcr_agb_tpu.config.load_config`, each override form acts the same, and
`pretty()` reads back through `safe_load`. Equality here is exact, with
key order and value types (int against float, bool against str)."""
import datetime
import math
import os
import pathlib

import pytest
import yaml

from dpcr_agb_tpu import config as jcfg
from dpcr_agb_tpu.config import engine as jengine
from dpcr_agb_tpu_torch import config as tcfg
from dpcr_agb_tpu_torch.config import engine as tengine
from dpcr_agb_tpu_torch.config import yaml as tyaml

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONF = str(ROOT / "conf")
FILES = sorted((ROOT / "conf").rglob("*.yaml"))


def same(a, b):
    """Equal trees with equal key order and equal types at every leaf."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_every_conf_file_is_counted():
    assert len(FILES) == 55


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "conf")))
def test_reader_equals_safe_load(path):
    text = path.read_text()
    want = yaml.safe_load(text)
    got = tyaml.safe_load(text)
    assert same(got, want)
    assert same(yaml.safe_load(tyaml.dump(got)), want)


SCALARS = ["1e-2", "1.0e-5", "0.", "-3.25", "+5", "1_000", "0b101", "0x1F",
           "017", "1:30", "1:30.5", "-.inf", ".NaN", "yes", "On", "OFF",
           "True", "false", "~", "null", "", "a b", "'x''y'", '"a\\tb"',
           "[1, 2]", "{a: 1, b: [x, 'y']}", "foo: bar", "[a, {b: c}]",
           "plots/*.las", "${now:%H}", "0.0125", "5e-3", "1.5E+3", "Null"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_resolution_equals_safe_load(text):
    assert same(tyaml.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", ["*undefined", "%YAML 1.1", "| block",
                                  "2001-12-14", "[1, 2", "!!str 5",
                                  "a: 1\n b: 2"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(tyaml.YAMLError):
        tyaml.safe_load(text)


def test_anchors_aliases_and_merge_keys():
    text = ("base: &b {x: 1, y: [1, 2]}\n"
            "other: &o\n  y: 3\n  z: 4\n"
            "m1:\n  <<: *b\n  x: 9\n"
            "m2:\n  <<: [*o, *b]\n"
            "lst: &l\n- a\n- b\n"
            "both: [*l, *l]\n"
            "nested:\n  - k: v\n    j: [1,\n        2]  # comment\n"
            "  - - deep\n    - er\n")
    assert same(tyaml.safe_load(text), yaml.safe_load(text))


README_TRAIN = [
    ("minkowski_baseline", "SENet14", "sparse_xy", "nfi/minkowski"),
    ("minkowski_baseline", "MPointNet", "sparse_xy", "nfi/minkowski"),
    ("minkowski_baseline", "ResNet50", "sparse", "nfi/minkowski"),
    ("kpconv", "KPConv", "xy", "nfi/kpconv"),
    ("simplestnet", "SimplestNet", "fixed_xy", "default"),
    ("pointnet", "PointNet", "fixed_xy", "nfi/pointnet"),
    ("pointnext", "PointNext", "xy_grid", "nfi/pointnet"),
]


def _train_overrides(models, name, tt, training, data="instance/NFI/reg"):
    return ["task=instance", f"models=instance/{models}",
            f"model_name={name}", f"data={data}",
            f"data.transform_type={tt}", f"training={training}",
            "lr_scheduler=cosineawr", "update_lr_scheduler_on=on_num_batch",
            "run_dir=outputs/fixed"]


@pytest.mark.parametrize("models,name,tt,training", README_TRAIN)
def test_train_composition_equals_jax(models, name, tt, training):
    ov = _train_overrides(models, name, tt, training)
    want = jcfg.load_config(CONF, "config", ov).to_dict()
    got = tcfg.load_config(CONF, "config", ov).to_dict()
    assert same(got, want)


@pytest.mark.parametrize("root,extra", [
    ("eval", ["data.transform_type=sparse_xy_eval",
              "checkpoint_dir=outputs/run", "weight_name=total_BMag_ha_rmse"]),
    ("eval", ["data.transform_type=xy_eval", "checkpoint_dir=outputs/run",
              "voting_runs=3", "enable_dropout=True"]),
    ("calibrate_bn", ["data.transform_type=sparse_xy",
                      "checkpoint_dir=outputs/run", "epochs=20",
                      "batch_size=64"]),
])
@pytest.mark.parametrize("data", ["instance/NFI/reg",
                                  "instance/synthetic/reg",
                                  "instance/NFI/noground/reg"])
def test_eval_and_calibrate_composition_equals_jax(root, extra, data,
                                                   monkeypatch):
    """One frozen clock for both composers: eval.yaml's run_dir reads
    ${now:...}, and two real calls can straddle a second."""
    class FrozenClock:
        class datetime(datetime.datetime):
            @classmethod
            def now(cls, tz=None):
                return datetime.datetime(2024, 5, 6, 7, 8, 9)

    monkeypatch.setattr(jengine, "datetime", FrozenClock)
    monkeypatch.setattr(tengine, "datetime", FrozenClock)
    ov = ["task=instance", "models=instance/minkowski_baseline",
          "model_name=SENet14", f"data={data}", *extra]
    want = jcfg.load_config(CONF, root, ov).to_dict()
    got = tcfg.load_config(CONF, root, ov).to_dict()
    assert same(got, want)
    if root == "eval":
        assert got["run_dir"] == "outputs/run/eval/2024-05-06_07-08-09"


OVERRIDE_CASES = [
    ["training.optim.base_lr=1e-3"],
    ["+training.optim.extra=5", "~training.wandb"],
    ["data.synthetic_plots=24", "data.xy_radius=12.5"],
    ["models.SENet14.extra_options={dense_dims: [40, 40, 48]}"],
    ["data.features=[classification]", "seed=7", "pretty_print=True"],
    ["new_top_level=hello", "++training.epochs=3"],
    ["training.optim.grad_clip=-1", "selection_stage=test"],
    ["data.areas.SYNTH.label_files=labels.csv", "debugging=early_break"],
    ["visualization=eval", "lr_scheduler=plateau"],
]


@pytest.mark.parametrize("extra", OVERRIDE_CASES)
def test_override_grammar_equals_jax(extra):
    ov = ["task=instance", "models=instance/minkowski_baseline",
          "model_name=SENet14", "data=instance/synthetic/reg",
          "data.transform_type=sparse_xy", "training=nfi/minkowski",
          "run_dir=outputs/fixed", *extra]
    want = jcfg.load_config(CONF, "config", ov).to_dict()
    got = tcfg.load_config(CONF, "config", ov).to_dict()
    assert same(got, want)
    assert jcfg.parse_overrides(extra) == tcfg.parse_overrides(extra)


def test_missing_values_raise_in_both():
    with pytest.raises(jcfg.MissingMandatoryValue):
        jcfg.load_config(CONF, "config", ["task=instance"])
    with pytest.raises(tcfg.MissingMandatoryValue, match="data"):
        tcfg.load_config(CONF, "config", ["task=instance"])
    cfg = tcfg.load_config(CONF, "config", _train_overrides(
        "minkowski_baseline", "SENet14", "sparse_xy", "nfi/minkowski"))
    cfg["data"]["transform_type"] = "???"
    with pytest.raises(tcfg.MissingMandatoryValue):
        cfg.data.transform_type
    assert cfg.select("data.transform_type", "d") == "d"
    assert cfg.get("no_such_key", 3) == 3


def test_interpolation_forms():
    tree = {"a": {"b": 2, "name": "x"}, "sel": "b", "c": "${a.${sel}}",
            "d": "v${a.b}w", "e": "${a}", "env": "${env:DPCR_NO_SUCH_VAR,dv}",
            "now": "${now:%Y}"}
    got = tcfg.Cfg(dict(tree)).to_dict()
    want = jcfg.Cfg(dict(tree)).to_dict()
    assert same(got, want)
    assert got["c"] == 2 and got["d"] == "v2w" and got["e"] == tree["a"]


def test_pretty_reads_back_through_safe_load():
    ov = _train_overrides("kpconv", "KPConv", "xy", "nfi/kpconv") + [
        "+extra.nan_value=.nan", "+extra.tiny=1.0e-30",
        "+extra.text='quote \" and # hash'"]
    cfg = tcfg.load_config(CONF, "config", ov)
    tree = cfg.to_dict(resolve=False)
    assert same(yaml.safe_load(cfg.pretty()), tree)
    assert same(tyaml.safe_load(cfg.pretty()), tree)
    assert os.linesep not in cfg.pretty() or os.linesep == "\n"
