"""SQL frontend tests, differential vs sqlite3.

Direct analog of the reference's SQLiteComparator
(Tests/ArrowSQLRunner/SQLiteComparator.h:45): every query runs on both
engines over identical data; results must match.
"""

import sqlite3

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def data(rng):
    n = 2000
    df = pd.DataFrame({
        "k": rng.integers(0, 8, n),
        "g": rng.integers(0, 1000, n),
        "v": np.round(rng.normal(50, 20, n), 6),
        "w": rng.integers(-50, 50, n),
        "s": rng.choice(["red", "green", "blue", "cyan"], n),
    })
    vn = df["v"].copy()
    vn[rng.random(n) < 0.1] = np.nan
    df["vn"] = vn
    return df


@pytest.fixture(scope="module")
def dim(rng):
    return pd.DataFrame({
        "k": np.arange(6),
        "label": ["a", "b", "c", "d", "e", "f"],
        "mult": [1, 2, 3, 4, 5, 6],
    })


@pytest.fixture(scope="module")
def env(hdk, data, dim):
    hdk.import_pandas(data, name="t")
    hdk.import_pandas(dim, name="dim")
    con = sqlite3.connect(":memory:")
    con.execute("PRAGMA case_sensitive_like=ON")
    data.to_sql("t", con, index=False)
    dim.to_sql("dim", con, index=False)
    return hdk, con


def check(env, sql, ordered=False, sqlite_sql=None):
    hdk, con = env
    got = hdk.sql(sql).to_pandas()
    exp = pd.read_sql_query(sqlite_sql or sql, con)
    exp.columns = list(got.columns)[: len(exp.columns)]
    assert_frames_match(got, exp, ordered=ordered)


def test_select_star(env):
    check(env, "SELECT * FROM t")


def test_projection_arith(env):
    check(env, "SELECT k, v * 2 + 1 AS x, w - k AS y FROM t")


def test_where(env):
    check(env, "SELECT k, v FROM t WHERE v > 50 AND k < 5")


def test_where_or_not(env):
    check(env, "SELECT w FROM t WHERE NOT (w > 0 OR k = 3)")


def test_in_between_like(env):
    check(env, "SELECT s, w FROM t WHERE s IN ('red', 'blue') "
               "AND w BETWEEN -10 AND 10")
    check(env, "SELECT s FROM t WHERE s LIKE 'gr%'")
    check(env, "SELECT s FROM t WHERE s NOT LIKE '%e%'")


def test_is_null(env):
    check(env, "SELECT k FROM t WHERE vn IS NULL")
    check(env, "SELECT k FROM t WHERE vn IS NOT NULL AND vn < 40")


def test_case(env):
    check(env, "SELECT k, CASE WHEN v > 60 THEN 'hi' WHEN v > 40 THEN 'mid' "
               "ELSE 'lo' END AS bucket FROM t")


def test_simple_case(env):
    check(env, "SELECT CASE k WHEN 0 THEN 'zero' WHEN 1 THEN 'one' "
               "ELSE 'many' END AS c FROM t")


def test_cast(env):
    check(env, "SELECT CAST(v AS int) AS vi, CAST(k AS double) AS kf FROM t")


def test_group_by(env):
    check(env, "SELECT k, COUNT(*) AS c, SUM(w) AS sw, AVG(v) AS av, "
               "MIN(v) AS mn, MAX(v) AS mx FROM t GROUP BY k")


def test_group_by_alias_and_position(env):
    check(env, "SELECT k AS grp, COUNT(*) AS c FROM t GROUP BY grp")
    check(env, "SELECT k, COUNT(*) AS c FROM t GROUP BY 1")


def test_group_by_expression(env):
    check(env, "SELECT w % 5 AS m, COUNT(*) AS c FROM t GROUP BY w % 5")


def test_group_by_null_skipping(env):
    check(env, "SELECT k, COUNT(vn) AS c, SUM(vn) AS s FROM t GROUP BY k")


def test_count_distinct(env):
    check(env, "SELECT k, COUNT(DISTINCT s) AS nd FROM t GROUP BY k")


def test_global_agg(env):
    check(env, "SELECT COUNT(*) AS c, SUM(v) AS s, AVG(w) AS a FROM t")


def test_agg_arithmetic(env):
    check(env, "SELECT k, SUM(v) / COUNT(*) AS manual_avg FROM t GROUP BY k")


def test_having(env):
    check(env, "SELECT g, COUNT(*) AS c FROM t GROUP BY g HAVING COUNT(*) > 2")


def test_order_by_limit(env):
    check(env, "SELECT k, COUNT(*) AS c FROM t GROUP BY k "
               "ORDER BY c DESC, k LIMIT 5", ordered=True)


def test_order_by_position_offset(env):
    check(env, "SELECT k, w FROM t ORDER BY 2 DESC, 1 LIMIT 10 OFFSET 3",
          ordered=True)


def test_order_by_expression(env):
    check(env, "SELECT k, w FROM t ORDER BY w % 7, k, w LIMIT 20",
          ordered=True)


def test_distinct(env):
    check(env, "SELECT DISTINCT k, s FROM t")


def test_inner_join(env):
    check(env, "SELECT t.k, t.v, dim.label FROM t "
               "JOIN dim ON t.k = dim.k WHERE t.v > 60")


def test_left_join(env):
    check(env, "SELECT t.k, dim.label FROM t LEFT JOIN dim ON t.k = dim.k")


def test_join_aliases(env):
    check(env, "SELECT a.k, b.mult FROM t a JOIN dim b ON a.k = b.k "
               "WHERE a.w > 25")


def test_implicit_join(env):
    check(env, "SELECT t.k, dim.label FROM t, dim "
               "WHERE t.k = dim.k AND t.v > 70")


def test_join_group(env):
    check(env, "SELECT dim.label, COUNT(*) AS c, SUM(t.v) AS s FROM t "
               "JOIN dim ON t.k = dim.k GROUP BY dim.label")


def test_subquery_from(env):
    check(env, "SELECT q.k, q.c FROM (SELECT k, COUNT(*) AS c FROM t "
               "GROUP BY k) q WHERE q.c > 200")


def test_nested_subquery_agg(env):
    check(env, "SELECT AVG(c) AS ac FROM "
               "(SELECT g, COUNT(*) AS c FROM t GROUP BY g)")


def test_union_all(env):
    check(env, "SELECT k FROM t WHERE k < 2 UNION ALL "
               "SELECT k FROM t WHERE k > 6")


def test_union_all_order(env):
    check(env, "SELECT k, w FROM t WHERE k = 0 UNION ALL "
               "SELECT k, w FROM t WHERE k = 7 ORDER BY w LIMIT 9",
          ordered=True)


def test_with_cte(env):
    check(env, "WITH big AS (SELECT k, v FROM t WHERE v > 55) "
               "SELECT k, COUNT(*) AS c FROM big GROUP BY k")


def test_coalesce_nullif(env):
    check(env, "SELECT COALESCE(vn, 0.0) AS cv FROM t")
    check(env, "SELECT NULLIF(k, 3) AS nk FROM t")


def test_scalar_functions(env):
    check(env, "SELECT ABS(w) AS aw, ROUND(v) AS rv FROM t")


def test_semi_anti_join(env, data, dim):
    hdk, _ = env
    got = hdk.sql("SELECT k FROM t SEMI JOIN dim ON t.k = dim.k").to_pandas()
    exp = data[data["k"].isin(dim["k"])][["k"]]
    assert_frames_match(got, exp)
    got = hdk.sql("SELECT k FROM t ANTI JOIN dim ON t.k = dim.k").to_pandas()
    exp = data[~data["k"].isin(dim["k"])][["k"]]
    assert_frames_match(got, exp)


def test_date_functions(hdk):
    ht = hdk.import_pydict(
        {"d": np.asarray(["2021-03-14T10:30:00", "1999-12-31T23:59:59",
                          "2020-02-29T00:00:00"], dtype="datetime64[s]")},
        name="sql_dates")
    got = hdk.sql(
        "SELECT EXTRACT(year FROM d) AS y, EXTRACT(month FROM d) AS m, "
        "EXTRACT(dow FROM d) AS dw, DATE_TRUNC('month', d) AS tm "
        "FROM sql_dates").to_pandas()
    assert list(got["y"]) == [2021, 1999, 2020]
    assert list(got["m"]) == [3, 12, 2]
    assert list(got["dw"]) == [0, 5, 6]
    assert str(got["tm"][0])[:10] == "2021-03-01"


def test_timestamp_literal(hdk):
    got = hdk.sql("SELECT COUNT(*) AS c FROM sql_dates "
                  "WHERE d >= TIMESTAMP '2020-01-01 00:00:00'").to_pandas()
    assert got["c"][0] == 2


def test_sql_errors(env):
    hdk, _ = env
    from hdk_jax.sql.lexer import SqlError

    with pytest.raises(SqlError):
        hdk.sql("SELECT nope FROM t")
    with pytest.raises(SqlError):
        hdk.sql("SELECT v FROM t GROUP BY k")
    with pytest.raises(SqlError):
        hdk.sql("SELECT FROM t")
    with pytest.raises((SqlError, KeyError)):
        hdk.sql("SELECT * FROM no_such_table")


def test_in_subquery(env):
    check(env, "SELECT k, v FROM t WHERE k IN (SELECT k FROM dim WHERE mult > 2)")
    check(env, "SELECT k FROM t WHERE k NOT IN (SELECT k FROM dim) AND w > 10")


def test_scalar_subquery(env):
    check(env, "SELECT COUNT(*) AS c FROM t WHERE v > (SELECT AVG(v) FROM t)")


def test_exists_subquery(env):
    check(env, "SELECT k FROM t WHERE EXISTS (SELECT k FROM dim WHERE mult > 100)")
    check(env, "SELECT COUNT(*) AS c FROM t WHERE NOT EXISTS "
               "(SELECT k FROM dim WHERE mult > 100)")


# ---------------------------------------------------------------------------
# set operations: EXCEPT / INTERSECT / UNION DISTINCT (VERDICT r1 #10)
# ---------------------------------------------------------------------------

def test_union_distinct(env):
    check(env, "SELECT k FROM t WHERE k < 4 UNION SELECT k FROM t WHERE k > 2")


def test_intersect(env):
    check(env, "SELECT k, s FROM t WHERE v > 40 INTERSECT "
               "SELECT k, s FROM t WHERE w > 0")


def test_except(env):
    check(env, "SELECT k FROM t EXCEPT SELECT k FROM dim WHERE mult > 3")


def test_except_intersect_precedence(env):
    # SQL standard: INTERSECT binds tighter than EXCEPT, so this is
    # a EXCEPT (b INTERSECT c).  (sqlite3 is non-standard left-assoc
    # here, so the oracle is computed manually.)
    hdk, _ = env
    got = hdk.sql("SELECT k FROM t EXCEPT SELECT k FROM t WHERE k > 2 "
                  "INTERSECT SELECT k FROM t WHERE k < 5").to_pandas()
    all_k = set(range(8))
    inner = {k for k in all_k if k > 2} & {k for k in all_k if k < 5}
    exp = sorted(all_k - inner)
    assert sorted(got["k"].tolist()) == exp


def test_intersect_with_nulls(env):
    # SQL set ops treat NULLs as equal
    check(env, "SELECT vn FROM t WHERE vn IS NULL OR vn > 70 INTERSECT "
               "SELECT vn FROM t WHERE vn IS NULL OR vn > 75")


def test_union_then_order(env):
    check(env, "SELECT k FROM t WHERE k = 1 UNION "
               "SELECT k FROM t WHERE k IN (2, 3) ORDER BY k", ordered=True)


# ---------------------------------------------------------------------------
# GROUPING SETS / ROLLUP / CUBE (VERDICT r1 #10)
# ---------------------------------------------------------------------------

def _rollup_oracle(df, sets, agg_col="v"):
    frames = []
    for gs in sets:
        if gs:
            g = df.groupby(list(gs), dropna=False).agg(
                c=(agg_col, "size"), s=(agg_col, "sum")).reset_index()
        else:
            g = pd.DataFrame({"c": [len(df)], "s": [df[agg_col].sum()]})
        for col in {"k", "w"} - set(gs):
            g[col] = np.nan
        frames.append(g)
    out = pd.concat(frames, ignore_index=True)
    return out[["k", "w", "c", "s"]]


def test_rollup(env, data):
    hdk, _ = env
    got = hdk.sql("SELECT k, w, COUNT(*) AS c, SUM(v) AS s FROM t "
                  "GROUP BY ROLLUP(k, w)").to_pandas()
    exp = _rollup_oracle(data, [("k", "w"), ("k",), ()])
    assert_frames_match(got, exp)


def test_cube(env, data):
    hdk, _ = env
    got = hdk.sql("SELECT k, w, COUNT(*) AS c, SUM(v) AS s FROM t "
                  "GROUP BY CUBE(k, w)").to_pandas()
    exp = _rollup_oracle(data, [("k", "w"), ("k",), ("w",), ()])
    assert_frames_match(got, exp)


def test_grouping_sets(env, data):
    hdk, _ = env
    got = hdk.sql("SELECT k, w, COUNT(*) AS c, SUM(v) AS s FROM t "
                  "GROUP BY GROUPING SETS ((k), (w))").to_pandas()
    exp = _rollup_oracle(data, [("k",), ("w",)])
    assert_frames_match(got, exp)


def test_grouping_sets_with_having(env, data):
    hdk, _ = env
    got = hdk.sql("SELECT k, COUNT(*) AS c FROM t "
                  "GROUP BY GROUPING SETS ((k), ()) HAVING COUNT(*) > 100"
                  ).to_pandas()
    exp_k = data.groupby("k").size()
    exp_rows = [(float(k), int(c)) for k, c in exp_k.items() if c > 100]
    if len(data) > 100:
        exp_rows.append((np.nan, len(data)))
    exp = pd.DataFrame(exp_rows, columns=["k", "c"])
    assert_frames_match(got, exp)


def test_select_without_from(hdk):
    out = hdk.sql("SELECT 1 + 1 AS a, ABS(-2.5) AS c, "
                  "CAST(3.7 AS INT) AS i").to_pandas()
    assert out["a"].tolist() == [2]
    assert out["c"].tolist() == [2.5]
    assert out["i"].tolist() == [3]


def test_sample_ratio(env, data):
    # reference: IR/Expr.h:571 SampleRatioExpr; RuntimeFunctions.cpp:1472
    hdk, _ = env
    got = hdk.sql(
        "SELECT COUNT(*) AS c, SUM(w) AS s FROM t "
        "WHERE SAMPLE_RATIO(0.4)").to_pandas()
    pos = np.arange(len(data), dtype=np.int64)
    keep = (pos * 2654435761) % 4294967296 < int(4294967296 * 0.4)
    assert got["c"].tolist() == [int(keep.sum())]
    assert got["s"].tolist() == [int(data["w"][keep].sum())]
    # deterministic: proportion 1.0 keeps everything
    allr = hdk.sql("SELECT COUNT(*) AS c FROM t WHERE SAMPLE_RATIO(1.0)"
                   ).to_pandas()
    assert allr["c"].tolist() == [len(data)]


def test_sample_ratio_in_projection(env, data):
    hdk, _ = env
    got = hdk.sql("SELECT SAMPLE_RATIO(0.25) AS f FROM t").to_pandas()
    pos = np.arange(len(data), dtype=np.int64)
    keep = (pos * 2654435761) % 4294967296 < int(4294967296 * 0.25)
    assert got["f"].astype(bool).tolist() == keep.tolist()


def test_string_literal_compare(hdk, rng):
    """Dict-encoded column vs raw string literal: the literal is re-typed
    into the column's dictionary and compared in code space (reference:
    transient literal encoding, StringDictionaryProxy)."""
    seg = np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE"])
    col = seg[rng.integers(0, 3, 60)]
    hdk.import_pydict({"c": col, "k": np.arange(60)}, name="strlit_t")
    eq = hdk.sql("SELECT k FROM strlit_t WHERE c = 'BUILDING'").to_pandas()
    assert eq["k"].tolist() == [i for i in range(60) if col[i] == "BUILDING"]
    ne = hdk.sql("SELECT k FROM strlit_t WHERE c <> 'BUILDING'").to_pandas()
    assert len(eq) + len(ne) == 60
    # literal absent from the dictionary: equals no row, <> matches all
    absent = hdk.sql("SELECT k FROM strlit_t WHERE c = 'NOPE'").to_pandas()
    assert len(absent) == 0
    # reflected literal-on-the-left form
    refl = hdk.sql("SELECT k FROM strlit_t WHERE 'BUILDING' = c").to_pandas()
    assert refl["k"].tolist() == eq["k"].tolist()


def test_comma_join_three_tables_deferred_conjunct(hdk, rng):
    """TPC-H Q3 shape: a WHERE equi conjunct that references a table not
    yet merged into the comma-join chain must defer to the later join
    step instead of failing resolution."""
    n_c, n_o, n_l = 20, 50, 200
    cust = {"ck": np.arange(n_c), "seg": rng.integers(0, 3, n_c)}
    orders = {"ok": np.arange(n_o), "ock": rng.integers(0, n_c, n_o)}
    items = {"lok": rng.integers(0, n_o, n_l),
             "price": rng.integers(1, 100, n_l).astype(np.float32)}
    hdk.import_pydict(cust, name="c3t")
    hdk.import_pydict(orders, name="o3t")
    hdk.import_pydict(items, name="l3t")
    got = hdk.sql(
        "SELECT SUM(price) AS s, COUNT(*) AS n FROM c3t, o3t, l3t "
        "WHERE ck = ock AND lok = ok AND seg = 1").to_pandas()
    import pandas as pd
    df = (pd.DataFrame(cust).merge(pd.DataFrame(orders),
                                   left_on="ck", right_on="ock")
          .merge(pd.DataFrame(items), left_on="ok", right_on="lok"))
    df = df[df["seg"] == 1]
    assert got["n"].iloc[0] == len(df)
    assert np.isclose(got["s"].iloc[0], df["price"].sum(), rtol=1e-4)
