"""``filter_df_with_spec``, the port against the JAX package:
``poor_man_gplvm_tpu_torch.utils.pandas_util`` (and the root
``pandas_util``) against ``poor_man_gplvm_tpu/utils/pandas_util.py``.

The specs are those of ``tests/test_analysis.py``,
``tests/test_compat_surface.py`` and
``tests/test_reference_parity_analysis.py``, with every operator, logic
form and option besides.  On a DataFrame the port returns what the JAX
function returns: the same rows (``assert_frame_equal``), the same mask
values and name, the same query string and environment; on a
``ResultTable`` of the same columns, the same rows (index kept) and mask
through ``to_dataframe()``/``to_series()``.  Held exactly.  The one
recorded difference: a string operator's JAX mask has pandas' nullable
``boolean`` dtype, the port's numpy ``bool``.  The query strings are
also run through ``DataFrame.query`` and must give the same rows.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from poor_man_gplvm_tpu.utils import pandas_util as jpu  # noqa: E402
from poor_man_gplvm_tpu_torch import pandas_util as root_shim  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import pandas_util as ppu  # noqa: E402
from poor_man_gplvm_tpu_torch.utils.table import ResultTable  # noqa: E402

ANALYSIS_DF = pd.DataFrame({
    "region": ["CA1", "CA1", "DG", "MEC"],
    "rate": [1.0, 5.0, 2.0, 8.0],
    "name": ["unit a", "unit b", "cell c", "cell d"],
})
ANALYSIS_SPECS = [
    ["rate", ">", 1.5],
    {"all": [["region", "in", ["CA1", "DG"]], ["rate", "<", 3]]},
    ["any", ["rate", ">", 7], ["region", "==", "DG"]],
    {"not": ["region", "==", "CA1"]},
    ["name", "startswith", "unit"],
    ["rate", "between", (1.5, 5.0)],
    [["rate", ">", 1.5], ["region", "==", "DG"]],
]
PARITY_DF = pd.DataFrame({
    "a": [1, 2, 3, 4, 5],
    "b": ["x", "y", "x", "z", "y"],
    "c": [0.1, 0.5, 0.9, 0.2, 0.7],
})
PARITY_SPECS = [
    ["a", ">", 2],
    {"all": [["a", ">=", 2], ["c", "<", 0.8]]},
    {"any": [["b", "==", "x"], {"not": ["a", "<", 4]}]},
    {"all": [["b", "in", ["x", "y"]], ["c", "between", (0.05, 0.75)]]},
]
#: missing values, a column name that needs backticks, every operator
WIDE_DF = pd.DataFrame({
    "region": ["CA1", None, "DG", "MEC", "ca3", "CA1"],
    "rate": [1.0, np.nan, 2.0, 8.0, 0.5, 5.0],
    "name": ["unit a", "unit b", None, "cell d", "Unit e", "x.y"],
    "n spikes": [10, 0, 3, 400, 7, 10],
    "good": [True, False, True, True, False, True],
}, index=[10, 11, 12, 13, 14, 15])
WIDE_SPECS = [
    ["rate", "!=", 2.0], ["rate", "<=", 2.0], ["n spikes", ">=", 10],
    ["region", "==", "CA1"], ["good", "==", True],
    ["region", "not in", ["CA1", "DG"]], ["rate", "in", [np.nan, 8.0]],
    ["n spikes", "in", 10], ["rate", "in", np.array([0.5, 5.0])],
    ["rate", "between", (1.0, 5.0), {"inclusive": "neither"}],
    ["rate", "between", (1.0, 5.0), {"inclusive": "left"}],
    ["rate", "between", (1.0, 5.0), {"inclusive": "right"}],
    ["region", "isna"], ["region", "isnull"], ["rate", "notna"],
    ["name", "notnull"],
    ["name", "contains", "UNIT", {"case": False}],
    ["name", "contains", ".", {"regex": False}],
    ["name", "contains", "x.y", {"regex": False, "case": False}],
    ["name", "contains", "u", {"na": True}],
    ["name", "regex", r"^(unit|cell) [a-c]$"],
    ["name", "endswith", "d"], ["rate", "startswith", "1"],
    ["ALL", ["rate", ">", 0.6], ["NOT", ["region", "isna"]]],
    ["any", ["name", "contains", "cell"], ["n spikes", "between", (5, 9)]],
    {"all": []}, {"any": []},
    {"not": {"any": [["good", "==", False], ["rate", ">", 6]]}},
]
CASES = ([(ANALYSIS_DF, s) for s in ANALYSIS_SPECS]
         + [(PARITY_DF, s) for s in PARITY_SPECS]
         + [(WIDE_DF, s) for s in WIDE_SPECS])


def _table(df):
    return ResultTable({c: df[c].to_numpy() for c in df.columns},
                       index=[df.index.to_numpy()])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_filter_matches_jax(case):
    df, spec = CASES[case]
    want = jpu.filter_df_with_spec(df, spec)
    for fn in (ppu.filter_df_with_spec, root_shim.filter_df_with_spec):
        got = fn(df, spec)
        assert got["query"] == want["query"]
        assert set(got["env"]) == set(want["env"])
        for k in want["env"]:
            assert repr(got["env"][k]) == repr(want["env"][k])
        pd.testing.assert_frame_equal(got["df"], want["df"])
        assert got["mask"].name == want["mask"].name
        assert got["mask"].index.equals(want["mask"].index)
        assert np.array_equal(got["mask"].to_numpy(),
                              want["mask"].to_numpy(dtype=bool))
    # the same columns as a ResultTable
    got = ppu.filter_df_with_spec(_table(df), spec)
    assert got["query"] == want["query"]
    pd.testing.assert_frame_equal(got["df"].to_dataframe(), want["df"],
                                  check_dtype=False)
    mask = got["mask"].to_series()
    assert mask.name == want["mask"].name
    assert np.array_equal(mask.index, want["mask"].index)
    assert np.array_equal(mask.to_numpy(), want["mask"].to_numpy(dtype=bool))
    # the query string gives the same rows (pandas has no .str on a
    # float column)
    q = want["query"]
    if q and "rate.str" not in q:
        assert df.query(q, local_dict=got["env"]).equals(want["df"])


def test_filter_without_the_query_and_on_a_plain_table():
    table = ResultTable({"a": np.arange(5), "b": np.array(list("xyzxy"))})
    got = ppu.filter_df_with_spec(table, ["b", "==", "x"],
                                  return_query=False)
    assert set(got) == {"df", "mask"}
    assert got["df"].index[0].tolist() == [0, 3]
    assert got["df"]["a"].tolist() == [0, 3]
    assert got["mask"].columns == ["b"]


@pytest.mark.parametrize("bad", [
    ["nope", ">", 1], ["a", "~", 1], [], ["a", "between", 3],
    ["a", "between", (1, 2), {"inclusive": "sometimes"}],
    ["a", "between", (1, 2), {"inclusive": True}], ["not", ["a", ">", 1],
                                                   ["a", "<", 3]], 5])
def test_filter_raises_as_jax(bad):
    with pytest.raises(Exception) as want:
        jpu.filter_df_with_spec(PARITY_DF, bad)
    for df in (PARITY_DF, _table(PARITY_DF)):
        with pytest.raises(type(want.value)):
            ppu.filter_df_with_spec(df, bad)
