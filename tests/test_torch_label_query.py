"""`label_query` (`dpcr_agb_tpu_torch/data/query.py`) against
`pandas.DataFrame.query` on an NFI label table: the generated NFI-like
labels with the columns an inventory table carries beside them (species
with a missing value, a survey year, a stand age with NaN, a bool flag, a
name with a space). Each query keeps the rows pandas keeps, in the same
order; `process_label_files` with the query and `ensure_split` after it
give the JAX package's table and seed-42 splits; every node outside the
whitelist raises and names it. About 5 s on one worker."""
import numpy as np
import pandas as pd
import pytest

from dpcr_agb_tpu.data import labels as jlabels
from dpcr_agb_tpu.data import synthetic as jsyn
from dpcr_agb_tpu_torch.data import labels as tlabels
from dpcr_agb_tpu_torch.data.query import query_mask
from tests.test_torch_labels import assert_same_table

QUERIES = [
    "BMag_ha > 200",
    "BMag_ha > 200 & V_ha < 900",
    "BMag_ha > 200 and V_ha < 900",
    "BMag_ha < 150 | V_ha > 1000",
    "BMag_ha < 150 or V_ha > 1000 and species == 'pine'",
    "100 < BMag_ha <= 300",
    "not (BMag_ha > 250)",
    "~(BMag_ha > 250) & year > 2018",
    "species == 'spruce'",
    "species != 'pine'",
    "species in ['spruce', 'birch']",
    "species not in ['spruce']",
    "species == ['spruce', 'pine']",
    "year == [2019, 2021]",
    "year in (2018, 2019)",
    "year >= 2020",
    "stand_age > 40",
    "stand_age != 40",
    "stand_age == stand_age",
    "`tree count` > 10",
    "BMag_ha / V_ha > 0.47",
    "BMag_ha * 2 - V_ha > -25",
    "-BMag_ha < -300",
    "(BMag_ha + V_ha) / 2 > 500",
    "measured == True",
    "measured & (year < 2021)",
    "las_file == 'plot_0003' | las_file == 'plot_0007'",
    "x > 550000 & y < 6.05e6 & BMag_ha > 100",
    "BMag_ha > V_ha * 0.45",
]
UNSUPPORTED = [
    ("BMag_ha > @cut", "locals"),
    ("abs(BMag_ha) > 3", "Call"),
    ("BMag_ha.abs() > 3", "Call"),
    ("x.real > 3", "Attribute"),
    ("BMag_ha ** 2 > 4", "Pow"),
    ("BMag_ha % 2 == 0", "Mod"),
    ("BMag_ha if measured else V_ha", "IfExp"),
    ("[b for b in BMag_ha]", "ListComp"),
    ("BMag_ha > None", "Constant"),
]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = tmp_path_factory.mktemp("query")
    path = jsyn.generate_nfi_like_dataset(str(root), n_plots=60, seed=5,
                                          label_format="csv")
    df = pd.read_csv(path)
    rng = np.random.default_rng(5)
    n = len(df)
    df["species"] = rng.choice(["spruce", "pine", "birch"], n)
    df.loc[[4, 17], "species"] = None
    df["year"] = rng.integers(2017, 2023, n)
    df["stand_age"] = rng.integers(10, 120, n).astype(float)
    df.loc[[2, 9, 30], "stand_age"] = np.nan
    df.loc[[5], "stand_age"] = 40.0
    df["measured"] = rng.random(n) < 0.6
    df["tree count"] = rng.integers(0, 30, n)
    df.to_csv(path, index=False)
    return root, path


@pytest.mark.parametrize("query", QUERIES)
def test_query_selects_pandas_rows(table, query):
    _, path = table
    df = jlabels.read_label_file(path)
    t = tlabels.read_label_file(path)
    assert_same_table(t, df)
    want = df.query(query)
    got = t.select(query_mask(t, query))
    assert 0 < len(want) < len(df), query
    assert_same_table(got, want)


@pytest.mark.parametrize("query", [QUERIES[1], QUERIES[10], QUERIES[16]])
def test_label_files_and_splits_equal_jax(table, query, caplog):
    """The area's labels with the query, renumbered, then the seed-42
    split, through both packages; the warning counts the same rows."""
    root, _ = table
    caplog.set_level("WARNING")
    targets = {"BMag_ha": {"task": "regression", "weight": 0.5},
               "V_ha": {"task": "regression", "weight": 0.5}}
    area = {"label_files": "labels.csv", "label_query": query}
    want = jlabels.process_label_files(dict(area), "A", targets, str(root))
    got = tlabels.process_label_files(dict(area), "A", targets, str(root))
    assert_same_table(got, want)
    want = jlabels.ensure_split(want, dict(area), targets, "split")
    got = tlabels.ensure_split(got, dict(area), targets, "split")
    assert_same_table(got, want)
    assert set(got["split"]) == {"train", "val", "test"}
    said = [r.getMessage() for r in caplog.records
            if "samples filtered by" in r.getMessage()]
    assert len(said) == 2 and said[0] == said[1]


@pytest.mark.parametrize("query,node", UNSUPPORTED)
def test_unsupported_nodes_raise_naming_them(table, query, node):
    _, path = table
    t = tlabels.read_label_file(path)
    with pytest.raises(NotImplementedError, match=node):
        query_mask(t, query)
