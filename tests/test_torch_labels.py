"""The port's label layer against the JAX package's (pandas): GeoPackage
tables both ways, `process_label_files` and `ensure_split` on csv and gpkg
tables (NaN targets, aliases, unit factors, a class mapping, nans_allowed
False, targets_must_be_present), and `generate_nfi_like_dataset`. Tables
must agree exactly: the same columns in the same order, the same index
labels in the same row order, the same values (NaN where pandas has a
missing value) and the same column kinds (int64, float64, bool, str)."""
import os

import numpy as np
import pandas as pd
import pytest

from dpcr_agb_tpu.data import labels as jlabels
from dpcr_agb_tpu.data import synthetic as jsyn
from dpcr_agb_tpu.data.las_io import read_pt as jread_pt
from dpcr_agb_tpu.visualization import gpkg as jgpkg
from dpcr_agb_tpu_torch.data import labels as tlabels
from dpcr_agb_tpu_torch.data import synthetic as tsyn
from dpcr_agb_tpu_torch.data.las_io import read_pt as tread_pt
from dpcr_agb_tpu_torch.data.table import Table, isna
from dpcr_agb_tpu_torch.visualization import gpkg as tgpkg


def _kind(series: pd.Series) -> str:
    if pd.api.types.is_bool_dtype(series.dtype):
        return "b"
    if pd.api.types.is_integer_dtype(series.dtype):
        return "i"
    if pd.api.types.is_float_dtype(series.dtype):
        return "f"
    return "O"


def assert_same_table(table: Table, df: pd.DataFrame):
    assert table.columns == [str(c) for c in df.columns]
    np.testing.assert_array_equal(table.index, df.index.to_numpy())
    for name in df.columns:
        want = df[name]
        got = table[name]
        assert got.dtype.kind == _kind(want), (name, got.dtype, want.dtype)
        miss = want.isna().to_numpy()
        np.testing.assert_array_equal(isna(got), miss, err_msg=name)
        w = want.to_numpy(dtype=object)[~miss]
        g = got[~miss]
        assert [type(v) if not isinstance(v, np.generic) else type(v.item())
                for v in g.tolist()] == [
            type(v.item()) if isinstance(v, np.generic) else type(v)
            for v in w.tolist()], name
        assert g.tolist() == list(w), name


def _frame(rng, n=14, with_nan=True):
    df = pd.DataFrame({
        "plot_id": [f"p{i:03d}" for i in range(n)],
        "biomass": rng.uniform(10, 400, n),
        "vol_dm3": rng.uniform(1e4, 9e5, n),
        "count": rng.integers(0, 50, n),
        "species": rng.choice(["spruce", "pine", "birch"], n),
        "x": rng.uniform(5e5, 6e5, n),
        "y": rng.uniform(6e6, 6.1e6, n)})
    if with_nan:
        df.loc[[1, 5], "biomass"] = np.nan
        df.loc[[5, n - 2], "vol_dm3"] = np.nan
        df.loc[[3], "species"] = None
    return df


def test_gpkg_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    df = _frame(rng)
    df["flag"] = rng.random(len(df)) < 0.5
    jpath = str(tmp_path / "j.gpkg")
    jgpkg.write_gpkg(jpath, df, layer="nfi")
    assert tgpkg.list_layers(jpath) == jgpkg.list_layers(jpath) == ["nfi"]
    assert_same_table(tgpkg.read_gpkg(jpath), jgpkg.read_gpkg(jpath))
    # the port writes the same rows (its own read of them, without fid);
    # both packages read the same table back as from the JAX file
    read = tgpkg.read_gpkg(jpath)
    table = Table({c: read[c] for c in read.columns if c != "fid"})
    tpath = str(tmp_path / "t.gpkg")
    tgpkg.write_gpkg(tpath, table, layer="nfi")
    assert_same_table(tgpkg.read_gpkg(tpath), jgpkg.read_gpkg(tpath))
    pd.testing.assert_frame_equal(jgpkg.read_gpkg(tpath),
                                  jgpkg.read_gpkg(jpath))
    # append, as the prediction writer does
    tgpkg.write_gpkg(tpath, table, layer="nfi", append=True)
    assert len(jgpkg.read_gpkg(tpath)) == 2 * len(df)
    assert_same_table(tgpkg.read_gpkg(tpath), jgpkg.read_gpkg(tpath))


def test_csv_reader_infers_pandas_dtypes(tmp_path):
    path = tmp_path / "l.csv"
    path.write_text("a,b,c,d,e,f,g\n1,1.5,x,,True,,3\n2,,y,4,False,,"
                    "NA\n-3,2e-3,,5,True,,7\n")
    assert_same_table(Table.read_csv(str(path)), pd.read_csv(path))


AREAS = {
    "plain": {},
    "alias_factor": {"alias_targets": ["biomass", "vol_dm3"],
                     "target_metric_factor": {"V_ha": 0.001}},
    "nans_dropped": {"alias_targets": ["biomass", "vol_dm3"],
                     "nans_allowed": False},
    "must_first": {"alias_targets": ["biomass", "vol_dm3"],
                   "targets_must_be_present": [True, False],
                   "val_ratio": 0.2, "test_ratio": 0.15},
    "none_must": {"alias_targets": ["biomass", "vol_dm3"],
                  "targets_must_be_present": [False, False]},
    "no_val": {"alias_targets": ["biomass", "vol_dm3"], "val_ratio": 0.0},
    "all_train": {"alias_targets": ["biomass", "vol_dm3"], "val_ratio": 0.0,
                  "test_ratio": 0.0},
}
TARGETS = {"BMag_ha": {"task": "regression", "weight": 0.5},
           "V_ha": {"task": "regression", "weight": 0.5}}
CLS_TARGETS = {**TARGETS, "species": {
    "task": "classification",
    "class_mapping": {"spruce": 0, "pine": 1, "birch": 2}}}


@pytest.mark.parametrize("fmt", ["csv", "gpkg", "two_files"])
@pytest.mark.parametrize("case", sorted(AREAS))
def test_process_and_split_equal_jax(tmp_path, fmt, case):
    rng = np.random.default_rng(len(case))
    raw = tmp_path / "raw"
    raw.mkdir()
    frames = [_frame(rng, 14), _frame(rng, 9)]
    files = []
    for k, df in enumerate(frames[:2 if fmt == "two_files" else 1]):
        if fmt == "gpkg":
            files.append(f"l{k}.gpkg")
            jgpkg.write_gpkg(str(raw / files[-1]), df, layer="nfi")
        else:
            files.append(f"l{k}.csv")
            df.to_csv(raw / files[-1], index=False)
    targets = CLS_TARGETS if case == "plain" else TARGETS
    area = {"label_files": files if len(files) > 1 else files[0],
            **AREAS[case]}
    if case == "plain":
        area["alias_targets"] = ["biomass", "vol_dm3", "species"]
    jarea, tarea = dict(area), dict(area)
    want = jlabels.process_label_files(jarea, "A", targets, str(tmp_path))
    got = tlabels.process_label_files(tarea, "A", targets, str(tmp_path))
    assert_same_table(got, want)
    assert jarea == tarea
    want = jlabels.ensure_split(want, jarea, targets, "split")
    got = tlabels.ensure_split(got, tarea, targets, "split")
    assert_same_table(got, want)


def test_label_query_raises_naming_the_roadmap(tmp_path):
    """label_query filters the labels (more queries in
    tests/test_torch_label_query.py): the rows the JAX package's pandas
    query keeps, renumbered, and one that names a missing column raises."""
    (tmp_path / "raw").mkdir()
    _frame(np.random.default_rng(1)).to_csv(tmp_path / "raw" / "l.csv",
                                            index=False)
    area = {"label_files": "l.csv", "label_query": "BMag_ha > 150",
            "alias_targets": ["biomass", "vol_dm3"]}
    want = jlabels.process_label_files(dict(area), "A", TARGETS,
                                       str(tmp_path))
    got = tlabels.process_label_files(dict(area), "A", TARGETS,
                                      str(tmp_path))
    assert 0 < len(got) < 14
    assert_same_table(got, want)
    with pytest.raises(ValueError, match="not a column"):
        tlabels.process_label_files(
            {**area, "label_query": "nope > 5"}, "A", TARGETS,
            str(tmp_path))


@pytest.mark.parametrize("label_format", ["gpkg", "csv"])
def test_generated_dataset_equals_jax(tmp_path, label_format):
    jfile = jsyn.generate_nfi_like_dataset(str(tmp_path / "j"), n_plots=5,
                                           seed=3, label_format=label_format)
    tfile = tsyn.generate_nfi_like_dataset(str(tmp_path / "t"), n_plots=5,
                                           seed=3, label_format=label_format)
    assert os.path.basename(jfile) == os.path.basename(tfile)
    assert_same_table(tlabels.read_label_file(tfile),
                      jlabels.read_label_file(jfile))
    assert_same_table(tlabels.read_label_file(jfile),
                      jlabels.read_label_file(tfile))
    for i in range(5):
        name = f"raw/plots/plot_{i:04d}.las"
        with open(tmp_path / "j" / name, "rb") as a, \
                open(tmp_path / "t" / name, "rb") as b:
            assert a.read() == b.read()
        for read in (jread_pt, tread_pt):
            jp, jf, _ = read(str(tmp_path / "j" / name), ["classification"])
            tp, tf, _ = read(str(tmp_path / "t" / name), ["classification"])
            np.testing.assert_array_equal(jp, tp)
            np.testing.assert_array_equal(jf, tf)
