"""DAG optimizer passes: filter pushdown, join reordering, IN rewrites
(reference: RelAlgOptimizer.cpp, FromTableReordering.cpp,
QueryRewrite.cpp)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def big(hdk):
    rng = np.random.default_rng(3)
    n = 5000
    return hdk.import_pydict({
        "k": rng.integers(0, 50, n),
        "v": rng.normal(size=n),
        "g": rng.integers(0, 8, n),
    }, name="opt_big")


@pytest.fixture(scope="module")
def small(hdk):
    return hdk.import_pydict({
        "k": list(range(50)),
        "w": [i * 0.5 for i in range(50)],
    }, name="opt_small")


def _df(t):
    return t.run().to_pandas()


def test_filter_pushes_below_project(hdk, big):
    q = big.proj(k2=big["k"] * 2, v=big["v"])
    f = q.filter(q["k2"] > 40)
    plan = hdk.explain(f)
    # Filter must sit below the Project after pushdown
    assert plan.index("Project") < plan.index("Filter")
    res = _df(f)
    pdf = pd.DataFrame({"k2": np.asarray(big.run().to_pandas()["k"]) * 2,
                        "v": big.run().to_pandas()["v"]})
    assert_frames_match(res, pdf[pdf.k2 > 40].reset_index(drop=True),
                        approx_cols=("v",))


def test_filter_not_pushed_past_window(hdk):
    rng = np.random.default_rng(5)
    w = hdk.import_pydict({"v": rng.normal(size=200)}, name="opt_win")
    q = w.proj(r=hdk.row_number().over().order_by(w["v"], w["rowid"]),
               v=w["v"])
    f = q.filter(q["r"] <= 10)
    plan = hdk.explain(f)
    assert plan.index("Filter") < plan.index("Project")
    assert len(_df(f)) == 10


def test_filter_splits_into_join_sides(hdk, big, small):
    j = big.join(small, "k", "k")
    f = j.filter((j["v"] > 0.0) & (j["w"] < 20.0))
    plan = hdk.explain(f)
    lines = plan.splitlines()
    # both conjuncts sank below the join: no Filter above it
    assert lines[0].startswith("Join")
    assert sum(1 for ln in lines if "Filter" in ln) == 2
    bdf = big.run().to_pandas()
    sdf = small.run().to_pandas()
    exp = bdf.merge(sdf.rename(columns={"k": "k_r"}),
                    left_on="k", right_on="k_r")
    exp = exp[(exp.v > 0.0) & (exp.w < 20.0)].reset_index(drop=True)
    assert_frames_match(_df(f), exp, approx_cols=("v", "w"))


def test_left_join_keeps_rhs_conjunct_above(hdk, big, small):
    j = big.join(small, "k", "k", how="left")
    f = j.filter((j["v"] > 0.0) & (j["w"] < 5.0))
    plan = hdk.explain(f)
    lines = plan.splitlines()
    # the w-conjunct (rhs side) must stay above the LEFT join
    assert lines[0].startswith("Filter")
    bdf = big.run().to_pandas()
    sdf = small.run().to_pandas()
    exp = bdf.merge(sdf.rename(columns={"k": "k_r"}),
                    left_on="k", right_on="k_r", how="left")
    exp = exp[(exp.v > 0.0) & (exp.w < 5.0)].reset_index(drop=True)
    assert_frames_match(_df(f), exp, approx_cols=("v", "w"))


def test_having_on_keys_hoists_below_aggregate(hdk, big):
    a = big.agg("g", "count", "sum(v)")
    f = a.filter(a["g"] >= 4)
    plan = hdk.explain(f)
    assert plan.index("Aggregate") < plan.index("Filter")
    bdf = big.run().to_pandas()
    exp = (bdf[bdf.g >= 4].groupby("g")
           .agg(count=("g", "size"), v_sum=("v", "sum")).reset_index())
    assert_frames_match(_df(f), exp, approx_cols=("v_sum",))


def test_having_on_aggregate_stays(hdk, big):
    a = big.agg("g", "count")
    f = a.filter(a["count"] > 600)
    plan = hdk.explain(f)
    assert plan.index("Filter") < plan.index("Aggregate")
    bdf = big.run().to_pandas()
    exp = bdf.groupby("g").agg(count=("g", "size")).reset_index()
    exp = exp[exp["count"] > 600].reset_index(drop=True)
    assert_frames_match(_df(f), exp)


def test_in_list_becomes_range(hdk, big):
    f = big.filter(big["k"].in_values([7, 8, 9, 10]))
    plan = hdk.explain(f)
    assert " in " not in plan and ">=" in plan and "<=" in plan
    bdf = big.run().to_pandas()
    exp = bdf[bdf.k.isin([7, 8, 9, 10])].reset_index(drop=True)
    assert_frames_match(_df(f), exp, approx_cols=("v",))


def test_non_contiguous_in_list_kept(hdk, big):
    f = big.filter(big["k"].in_values([7, 9, 30]))
    plan = hdk.explain(f)
    assert " in " in plan
    bdf = big.run().to_pandas()
    exp = bdf[bdf.k.isin([7, 9, 30])].reset_index(drop=True)
    assert_frames_match(_df(f), exp, approx_cols=("v",))


def test_join_inputs_reorder_by_cardinality(hdk, big, small):
    j = small.join(big, "k", "k")  # small probe, big build -> swap
    plan = hdk.explain(j)
    lines = plan.splitlines()
    assert lines[0].startswith("Project")
    assert "opt_big" in lines[2] and "opt_small" in lines[3]
    sdf = small.run().to_pandas()
    bdf = big.run().to_pandas()
    exp = sdf.merge(bdf.rename(columns={"k": "k_r"}),
                    left_on="k", right_on="k_r")
    assert_frames_match(_df(j), exp[list(_df(j).columns)],
                        approx_cols=("v", "w"))


def test_estimate_rows():
    from hdk_jax.exec import cost
    from hdk_jax.ir import node as nd

    class FakeTable:
        nrows = 1000
        def column_names(self):
            return []

    scan = nd.Scan.__new__(nd.Scan)
    nd.Node.__init__(scan, [])
    scan.table = FakeTable()
    scan._fields, scan._types = [], []
    assert cost.estimate_rows(scan) == 1000.0
    srt = nd.Sort(scan, [], limit=10)
    assert cost.estimate_rows(srt) == 10.0


def test_pushdown_preserves_residual_join(hdk, big, small):
    """Rhs-side pushdown must rebind residual ON refs onto the Filter
    wrapper (review finding: raw-index fallback read an lhs column)."""
    # residual via SQL (ON with an extra non-equi conjunct)
    res = hdk.sql(
        "SELECT COUNT(*) AS n FROM opt_big a JOIN opt_small b "
        "ON a.k = b.k AND a.v < b.w WHERE b.w > 10").to_pandas()
    bdf = big.run().to_pandas()
    sdf = small.run().to_pandas()
    m = bdf.merge(sdf.rename(columns={"k": "k2"}), left_on="k",
                  right_on="k2")
    want = int(((m.v < m.w) & (m.w > 10)).sum())
    assert int(res["n"].iloc[0]) == want and want > 0


@pytest.fixture(scope="module")
def chain_tables(hdk):
    rng = np.random.default_rng(9)
    n = 3000
    fact = hdk.import_pydict({
        "k": rng.integers(0, 40, n),
        "g": rng.integers(0, 8, n),
        "v": rng.normal(size=n),
    }, name="chain_fact")
    dima = hdk.import_pydict({
        "k": list(range(40)),
        "w": [i * 0.5 for i in range(40)],
        "x": [i % 5 for i in range(40)],
    }, name="chain_dima")
    dimb = hdk.import_pydict({
        "g": list(range(8)),
        "lbl": [float(i) for i in range(8)],
    }, name="chain_dimb")
    dimx = hdk.import_pydict({
        "x": list(range(5)),
        "y": [i * 10.0 for i in range(5)],
    }, name="chain_dimx")
    return fact, dima, dimb, dimx


def test_join_chain_reorders_by_cardinality(hdk, chain_tables):
    """Smaller build sides join first (FromTableReordering.cpp analog);
    output column order/names are preserved by the restoring Project."""
    fact, dima, dimb, _ = chain_tables
    j = fact.join(dima, "k", "k").join(dimb, "g", "g")
    plan = hdk.explain(j)
    lines = plan.splitlines()
    # innermost (deepest) join takes the 8-row dimb; dima joins above
    # (children print after their parent, so the deeper scan comes first)
    assert lines.index("      Scan(chain_dimb, rows=8)") < \
        lines.index("    Scan(chain_dima, rows=40)")
    fdf = fact.run().to_pandas()
    adf = dima.run().to_pandas().rename(columns={"k": "k_r"})
    bdf = dimb.run().to_pandas().rename(columns={"g": "g_r"})
    exp = fdf.merge(adf, left_on="k", right_on="k_r").merge(
        bdf, left_on="g", right_on="g_r")
    got = j.run().to_pandas()
    assert list(got.columns) == ["k", "g", "v", "k_r", "w", "x", "g_r",
                                 "lbl"]
    assert_frames_match(got, exp[list(got.columns)],
                        approx_cols=("v", "w", "lbl"))


def test_join_chain_snowflake_goes_bushy(hdk, chain_tables):
    """A join keyed on a column produced by an EARLIER build side is a
    snowflake arm: the bushy enumerator (optimizer._enumerate_bushy,
    reference: FromTableReordering.cpp generalized) plans dima⋈dimx
    FIRST — cost 40 rows — instead of running both joins over the
    fact table."""
    fact, dima, _, dimx = chain_tables
    j1 = fact.join(dima, "k", "k")
    j = j1.join(dimx, "x", "x")  # x comes from dima (5 < 40 rows)
    plan = hdk.explain(j)
    lines = plan.splitlines()
    # bushy shape: the dim⋈dim join nests under the fact join's rhs
    fact_join = next(i for i, l in enumerate(lines) if "Join" in l)
    inner_join = next(i for i, l in enumerate(lines)
                      if "Join" in l and i > fact_join)
    dima_i = next(i for i, l in enumerate(lines) if "chain_dima" in l)
    dimx_i = next(i for i, l in enumerate(lines) if "chain_dimx" in l)
    assert inner_join < dima_i < dimx_i  # dima/dimx under the inner join
    fdf = fact.run().to_pandas()
    adf = dima.run().to_pandas().rename(columns={"k": "k_r"})
    xdf = dimx.run().to_pandas().rename(columns={"x": "x_r"})
    exp = fdf.merge(adf, left_on="k", right_on="k_r").merge(
        xdf, left_on="x", right_on="x_r")
    got = j.run().to_pandas()
    assert_frames_match(got, exp[list(got.columns)],
                        approx_cols=("v", "w", "y"))


def test_join_chain_sql_three_way(hdk, chain_tables):
    got = hdk.sql(
        "SELECT b.lbl AS lbl, COUNT(*) AS c, SUM(a.w) AS s "
        "FROM chain_fact f JOIN chain_dima a ON f.k = a.k "
        "JOIN chain_dimb b ON f.g = b.g GROUP BY b.lbl ORDER BY lbl"
    ).to_pandas()
    fact, dima, dimb, _ = chain_tables
    fdf = fact.run().to_pandas()
    adf = dima.run().to_pandas()
    bdf = dimb.run().to_pandas()
    m = fdf.merge(adf, on="k").merge(bdf, on="g")
    exp = (m.groupby("lbl").agg(c=("lbl", "size"), s=("w", "sum"))
           .reset_index().sort_values("lbl").reset_index(drop=True))
    assert_frames_match(got, exp, approx_cols=("s",), ordered=True)
