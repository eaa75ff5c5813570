"""Reference-derived differential suite.

Query shapes mined from the reference's ArrowBasedExecuteTest.cpp
(216 TEST blocks — multi-term arithmetic predicates, expression
aggregates, constant projections, 3VL filters, string predicates,
FROM-subqueries, self-joins, HAVING, set ops).  Oracle: sqlite3 on the
same data (the SQLiteComparator role, Tests/ArrowSQLRunner).  These are
NOT copies — each shape is re-expressed over a synthetic schema that
mirrors the reference test table's column mix (ints x/y/z/t, floats
f/d, nullables fn/dn, dict string str, bool b).
"""

import sqlite3

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def env(rng):
    n = 3000
    df = pd.DataFrame({
        "x": rng.integers(5, 10, n),
        "y": rng.integers(40, 45, n),
        "z": rng.integers(100, 105, n),
        "t": rng.integers(1000, 1010, n),
        "f": np.round(rng.normal(1.2, 0.4, n), 6),
        "d": np.round(rng.normal(2.5, 1.0, n), 6),
        "fn": np.where(rng.random(n) < 0.2, np.nan,
                       np.round(rng.normal(-0.5, 1.0, n), 6)),
        "w": rng.integers(-50, 50, n),
        "s": rng.choice(["foo", "bar", "baz", "quux"], n),
        "b": rng.integers(0, 2, n),
    })
    hdk = hdk_jax.HDK()
    hdk.import_pandas(df, name="rt")
    inner = pd.DataFrame({
        "x": rng.integers(5, 10, 40),
        "s": rng.choice(["foo", "bar", "hidden"], 40),
        "v": rng.integers(0, 100, 40),
    })
    hdk.import_pandas(inner, name="rt_inner")
    con = sqlite3.connect(":memory:")
    df.to_sql("rt", con, index=False)
    inner.to_sql("rt_inner", con, index=False)
    return hdk, con


def check(env, sql, ordered=False):
    hdk, con = env
    got = hdk.sql(sql).to_pandas()
    exp = pd.read_sql_query(sql, con)
    exp.columns = list(got.columns)[: len(exp.columns)]
    approx = tuple(c for c in got.columns
                   if got[c].dtype.kind in "fc")
    assert_frames_match(got, exp, ordered=ordered, approx_cols=approx)


QUERIES = [
    # aggregates over expressions (ExecuteTest: SUM(x + y) family)
    "SELECT SUM(x + y) AS s FROM rt",
    "SELECT SUM(x + y + z) AS s FROM rt",
    "SELECT SUM(x + y + z + t) AS s FROM rt",
    "SELECT SUM(2 * x) AS s FROM rt WHERE x = 7",
    "SELECT SUM(2 * x + z) AS s FROM rt WHERE x = 7",
    "SELECT SUM(x * y + 15) AS s FROM rt WHERE x + y + 1 = 50",
    "SELECT MIN(x) AS a, MAX(x) AS b, MIN(z) AS c, MAX(t) AS d FROM rt",
    "SELECT COUNT(fn) AS a, COUNT(*) AS b FROM rt",
    "SELECT SUM(f + d) AS s FROM rt WHERE x + y + 1 = 50",
    # multi-term arithmetic predicates
    "SELECT COUNT(*) AS c FROM rt WHERE x > 6 AND x < 8",
    "SELECT COUNT(*) AS c FROM rt WHERE x > 6 AND x < 8 AND z > 100 AND z < 102",
    "SELECT COUNT(*) AS c FROM rt WHERE x > 6 AND x < 8 OR (z > 100 AND z < 103)",
    "SELECT COUNT(*) AS c FROM rt WHERE x <> 7",
    "SELECT COUNT(*) AS c FROM rt WHERE x + y = 49",
    "SELECT COUNT(*) AS c FROM rt WHERE x - y = -35",
    "SELECT COUNT(*) AS c FROM rt WHERE x - y + z = 66",
    "SELECT COUNT(*) AS c FROM rt WHERE y - x = 35",
    # constant projections (ExecuteTest: SELECT 'Total', COUNT(*))
    "SELECT 'Total' AS lbl, COUNT(*) AS c FROM rt WHERE x <> 7",
    # 3VL / IS NULL
    "SELECT COUNT(*) AS c FROM rt WHERE fn IS NOT NULL",
    "SELECT COUNT(*) AS c FROM rt WHERE fn IS NULL OR x = 7",
    "SELECT SUM(fn) AS s FROM rt WHERE fn < 0",
    # string predicates
    "SELECT COUNT(*) AS c FROM rt WHERE s = 'foo'",
    "SELECT COUNT(*) AS c FROM rt WHERE s <> 'foo' AND x > 6",
    "SELECT COUNT(*) AS c FROM rt WHERE s LIKE 'ba%'",
    "SELECT COUNT(*) AS c FROM rt WHERE s IN ('foo', 'baz')",
    "SELECT s, COUNT(*) AS c FROM rt GROUP BY s ORDER BY s",
    # group by + order/limit/having
    "SELECT x, COUNT(*) AS c FROM rt GROUP BY x ORDER BY x DESC",
    "SELECT x, y, COUNT(*) AS c FROM rt GROUP BY x, y ORDER BY x, y",
    "SELECT x, SUM(w) AS s FROM rt GROUP BY x HAVING SUM(w) > 0 ORDER BY x",
    "SELECT z, AVG(f) AS a FROM rt GROUP BY z ORDER BY a LIMIT 3",
    "SELECT x + y AS k, COUNT(*) AS c FROM rt GROUP BY k ORDER BY k",
    # CASE
    ("SELECT CASE WHEN x = 7 THEN 'seven' WHEN x = 8 THEN 'eight' "
     "ELSE 'other' END AS lbl, COUNT(*) AS c FROM rt GROUP BY lbl "
     "ORDER BY lbl"),
    ("SELECT SUM(CASE WHEN x BETWEEN 6 AND 7 THEN w ELSE 0 END) AS s "
     "FROM rt"),
    # BETWEEN / IN range rewrite
    "SELECT COUNT(*) AS c FROM rt WHERE w BETWEEN -10 AND 10",
    "SELECT COUNT(*) AS c FROM rt WHERE x IN (5, 6, 7)",
    # DISTINCT
    "SELECT COUNT(DISTINCT x) AS c FROM rt",
    "SELECT COUNT(DISTINCT s) AS c, COUNT(DISTINCT z) AS d FROM rt",
    # FROM-subquery (ExecuteTest: SELECT R.x ... FROM (SELECT ...) R)
    ("SELECT r.x AS x, COUNT(*) AS c FROM "
     "(SELECT x, z FROM rt WHERE x >= 7 AND z < 103) r "
     "GROUP BY r.x ORDER BY r.x"),
    # self/inner joins incl. string + int composite condition
    ("SELECT COUNT(*) AS c FROM rt JOIN rt_inner "
     "ON rt.s = rt_inner.s AND rt.x = rt_inner.x"),
    ("SELECT rt_inner.v AS v, COUNT(*) AS c FROM rt JOIN rt_inner "
     "ON rt.x = rt_inner.x GROUP BY rt_inner.v ORDER BY v LIMIT 5"),
    # set ops
    ("SELECT x FROM rt WHERE x = 5 UNION ALL SELECT x FROM rt WHERE x = 9"),
    ("SELECT DISTINCT x FROM rt WHERE x > 7 UNION "
     "SELECT DISTINCT x FROM rt WHERE x < 6"),
    # sort with nulls + limit (ORDER BY k ASC NULLS FIRST family)
    "SELECT fn FROM rt ORDER BY fn NULLS LAST LIMIT 10",
    # arithmetic edge: division / floor
    "SELECT COUNT(*) AS c FROM rt WHERE y / x = 6",
    "SELECT SUM(w) AS s, SUM(-w) AS ns FROM rt",
]


@pytest.mark.parametrize("sql", QUERIES, ids=[q[:48] for q in QUERIES])
def test_ref_shape(env, sql):
    check(env, sql)
