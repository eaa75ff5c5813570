"""Regression tests for the round-1 advisor findings (ADVICE.md r1):
streaming top-n dead-row leak, DISTINCT aggregates, silent group-cap
overflow, identity-keyed cache staleness, NOT IN null semantics."""

import gc
import sqlite3

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


# ---------------------------------------------------------------------------
# ADVICE high: streaming top-n must not leak filtered-out rows
# ---------------------------------------------------------------------------

def test_topn_filtered_rows_do_not_displace_live_nulls(hdk):
    # live NULL-key rows sort last (nulls-last default) but must still
    # beat dead (filtered-out) rows for slots inside the LIMIT window
    n = 400
    flag = np.zeros(n, np.int64)
    flag[:10] = 1  # only the first 10 rows survive the filter
    v = np.full(n, np.nan)
    v[:3] = [5.0, 1.0, 3.0]  # 3 live non-null, 7 live NULL
    df = pd.DataFrame({"flag": flag, "v": v})
    ht = hdk.import_pandas(df, name="topn_leak")
    res = (ht.filter(ht["flag"] == 1)
           .sort("v", limit=5).run().to_pandas())
    assert len(res) == 5
    assert list(res["flag"]) == [1] * 5, "filtered-out rows leaked into LIMIT"
    np.testing.assert_allclose(res["v"][:3], [1.0, 3.0, 5.0])
    assert res["v"][3:].isna().all()


def test_topn_filtered_rows_nonnull_sortcol(hdk):
    n = 300
    df = pd.DataFrame({
        "flag": (np.arange(n) % 3 == 0).astype(np.int64),
        "v": np.arange(n, dtype=np.int64)[::-1],
    })
    ht = hdk.import_pandas(df, name="topn_leak2")
    res = (ht.filter(ht["flag"] == 1).sort(("v", "desc"), limit=7)
           .run().to_pandas())
    exp = (df[df.flag == 1].sort_values("v", ascending=False)
           .head(7).reset_index(drop=True))
    assert list(res["v"]) == list(exp["v"])


# ---------------------------------------------------------------------------
# ADVICE medium: DISTINCT in aggregates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_data(rng):
    n = 1000
    df = pd.DataFrame({
        "k": rng.integers(0, 7, n),
        "x": rng.integers(0, 12, n).astype(np.int64),
        "f": np.round(rng.normal(size=n), 1),
    })
    df.loc[rng.random(n) < 0.1, "f"] = np.nan
    return df


@pytest.fixture(scope="module")
def dist_env(hdk, dist_data):
    hdk.import_pandas(dist_data, name="dst")
    con = sqlite3.connect(":memory:")
    dist_data.to_sql("dst", con, index=False)
    return hdk, con


def check_sql(env, sql, ordered=False):
    hdk, con = env
    res = hdk.sql(sql).to_pandas()
    exp = pd.read_sql_query(sql, con)
    assert_frames_match(res, exp, ordered=ordered)


def test_sum_distinct(dist_env):
    check_sql(dist_env, "SELECT k, SUM(DISTINCT x) AS s FROM dst GROUP BY k")


def test_avg_distinct(dist_env):
    check_sql(dist_env, "SELECT k, AVG(DISTINCT x) AS a FROM dst GROUP BY k")


def test_sum_distinct_nullable_float(dist_env):
    check_sql(dist_env, "SELECT k, SUM(DISTINCT f) AS s FROM dst GROUP BY k")


def test_sum_distinct_nogroup(dist_env):
    check_sql(dist_env, "SELECT SUM(DISTINCT x) AS s, AVG(DISTINCT x) AS a "
                        "FROM dst")


def test_min_max_distinct_noop(dist_env):
    check_sql(dist_env, "SELECT k, MIN(DISTINCT x) AS lo, "
                        "MAX(DISTINCT x) AS hi FROM dst GROUP BY k")


def test_distinct_unsupported_raises(dist_env):
    hdk, _ = dist_env
    from hdk_jax.sql.lexer import SqlError
    with pytest.raises(SqlError, match="DISTINCT"):
        hdk.sql("SELECT STDDEV(DISTINCT x) FROM dst")


# ---------------------------------------------------------------------------
# ADVICE medium: group-cap overflow must widen-and-retry, never clamp
# ---------------------------------------------------------------------------

def test_group_cap_overflow_retries(rng):
    # cap the baseline buffer below the true NDV; results must still be
    # exact (the engine re-runs with the widened cap)
    session = hdk_jax.HDK(**{"exec.group_by.default_max_groups": 16})
    n = 3000
    # huge key range forces the baseline (sort) layout, whose buffer is
    # capped by default_max_groups — NDV 500 >> 16 provokes the overflow
    df = pd.DataFrame({"k": (rng.integers(0, 500, n) * 2**33 + 7).astype(np.int64),
                       "v": rng.normal(size=n)})
    ht = session.import_pandas(df, name="ovf")
    res = ht.agg("k", "count", "sum(v)").run().to_pandas()
    exp = (df.groupby("k").agg(count=("v", "size"), v_sum=("v", "sum"))
           .reset_index())
    exp.columns = ["k", "count", "v_sum"]
    assert_frames_match(res, exp)


def test_group_cap_overflow_no_retry_raises(rng):
    session = hdk_jax.HDK(**{"exec.group_by.default_max_groups": 16,
                             "exec.allow_retry": False})
    n = 1000
    df = pd.DataFrame(
        {"k": np.arange(n, dtype=np.int64) * 7919 % 100003 * 2**33})
    ht = session.import_pandas(df, name="ovf2")
    from hdk_jax.exec.scalar import ExecError
    with pytest.raises(ExecError, match="exceeds buffer cap"):
        ht.agg("k", "count").run().to_pandas()


# ---------------------------------------------------------------------------
# ADVICE medium: identity-keyed caches validate object identity
# ---------------------------------------------------------------------------

def test_identity_cache_rejects_reused_ids():
    from hdk_jax.exec.executor import _IdentityKeyedCache
    import jax.numpy as jnp

    cache = _IdentityKeyedCache(8)
    a = jnp.arange(4)
    cache.put("sig", [a], "value-for-a")
    assert cache.get("sig", [a]) == "value-for-a"
    # simulate CPython id reuse: a dies, a new buffer lands on its id
    b = jnp.arange(8)
    ent = cache._d.pop(("sig", (id(a),)))
    cache._d[("sig", (id(b),))] = ent  # stale weakref to a
    del a
    gc.collect()
    assert cache.get("sig", [b]) is None, "stale entry must miss"


def test_identity_cache_none_members():
    from hdk_jax.exec.executor import _IdentityKeyedCache
    import jax.numpy as jnp

    cache = _IdentityKeyedCache(8)
    a = jnp.arange(4)
    cache.put("s", [a, None], 42)
    assert cache.get("s", [a, None]) == 42


# ---------------------------------------------------------------------------
# ADVICE low: NOT IN (subquery) three-valued null semantics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def notin_env(hdk):
    df = pd.DataFrame({"a": [1, 2, 3, 4, None], "tag": list("vwxyz")})
    sub = pd.DataFrame({"b": [2.0, None]})
    sub_nonull = pd.DataFrame({"b": [2.0, 4.0]})
    hdk.import_pandas(df, name="ni_t")
    hdk.import_pandas(sub, name="ni_s")
    hdk.import_pandas(sub_nonull, name="ni_sn")
    con = sqlite3.connect(":memory:")
    df.to_sql("ni_t", con, index=False)
    sub.to_sql("ni_s", con, index=False)
    sub_nonull.to_sql("ni_sn", con, index=False)
    return hdk, con


def test_not_in_null_in_subquery(notin_env):
    # NULL in the subquery -> every NOT IN comparison is FALSE/UNKNOWN
    check_sql(notin_env, "SELECT tag FROM ni_t "
                         "WHERE a NOT IN (SELECT b FROM ni_s)")


def test_not_in_null_probe(notin_env):
    # NULL probe value is UNKNOWN -> filtered even with clean subquery
    check_sql(notin_env, "SELECT tag FROM ni_t "
                         "WHERE a NOT IN (SELECT b FROM ni_sn)")


def test_in_unaffected(notin_env):
    check_sql(notin_env, "SELECT tag FROM ni_t "
                         "WHERE a IN (SELECT b FROM ni_s)")


# ---------------------------------------------------------------------------
# ADVICE r4 low: a static superset range that fails the perfect-join
# density guard must fall back to the device min/max probe (a heavily
# filtered build side may still admit a compact dense table) instead of
# permanently caching a rejection for that buffer identity.
# ---------------------------------------------------------------------------

def test_filtered_build_static_range_falls_back_to_probe(rng):
    sess = hdk_jax.HDK()
    n_b = 4000
    # build table whose STATIC key range is huge (one outlier at 50M)
    # but whose filtered subset is dense [0, 200)
    bk = np.arange(n_b, dtype=np.int64)
    bk[-1] = 50_000_000  # widens base-table stats far past the guard
    build = pd.DataFrame({"k": bk, "w": rng.normal(size=n_b)})
    probe = pd.DataFrame({"k": rng.integers(0, 200, 5000),
                          "v": rng.normal(size=5000)})
    tb = sess.import_pandas(build, name="adv_sb")
    tp = sess.import_pandas(probe, name="adv_sp")
    # filter keeps only keys < 200: the device probe sees a tiny range
    fb = tb.filter(tb["k"] < 200)
    res = tp.join(fb, "k", "k").run().to_pandas()
    exp = probe.merge(build[build["k"] < 200], on="k", how="inner")
    exp.insert(2, "k_r", exp["k"])
    assert_frames_match(res, exp[["k", "v", "k_r", "w"]])
    # the perfect route must have been taken (probe range is dense):
    assert getattr(sess._executor, "_join_route", None) in (
        "perfect", "spread"), sess._executor._join_route


# ---------------------------------------------------------------------------
# make_mesh never degrades silently: asking for more devices than are
# visible is an error, not a truncated or CPU-backed mesh
# ---------------------------------------------------------------------------

def test_make_mesh_truncation_warns():
    import jax

    from hdk_jax.parallel import mesh as pm

    with pytest.raises(RuntimeError, match="make_mesh"):
        pm.make_mesh(10_000)  # far beyond any real/virtual devices
    assert pm.make_mesh(2).devices.size == 2
    assert pm.make_mesh().devices.size == len(jax.devices())
