"""Plan-keyed join build-artifact recycling (reference:
HashtableRecycler by plan-DAG hash + table generations,
DataRecycler/HashtableRecycler.h:32, QueryPlanDagCache.h:61): a build
side derived from an intermediate result gets fresh device buffers
every execution, so the identity cache misses warm runs; the plan
layer recycles the dense table + value tables and the executor skips
the build subtree entirely."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture()
def sess():
    s = hdk_jax.HDK()
    s.config.exec.eager_agg_min_rows = 500
    s.config.exec.eager_agg_min_ratio = 1.0
    return s


@pytest.fixture()
def q3ish(sess, rng):
    n_c, n_o, n_l = 300, 3000, 12000
    cust = pd.DataFrame({
        "ck": np.arange(n_c, dtype=np.int64),
        "seg": rng.integers(0, 5, n_c).astype(np.int64),
    })
    orders = pd.DataFrame({
        "ok": np.arange(n_o, dtype=np.int64),
        "ck": rng.integers(0, n_c, n_o),
        "pri": rng.integers(0, 3, n_o).astype(np.int64),
    })
    li = pd.DataFrame({
        "ok": rng.integers(0, n_o, n_l),
        "price": rng.gamma(3.0, 100.0, n_l),
    })
    sess.import_pandas(cust, name="rc_c")
    sess.import_pandas(orders, name="rc_o")
    sess.import_pandas(li, name="rc_l")
    return cust, orders, li


Q = ("SELECT l.ok, SUM(l.price) AS rev, o.pri "
     "FROM rc_l l, rc_o o, rc_c c "
     "WHERE l.ok = o.ok AND o.ck = c.ck AND c.seg = 2 "
     "GROUP BY l.ok, o.pri ORDER BY rev DESC LIMIT 5")


def oracle(cust, orders, li):
    m = (li.merge(orders, on="ok")
         .merge(cust[cust["seg"] == 2], on="ck"))
    g = (m.groupby(["ok", "pri"])["price"].sum().reset_index(name="rev")
         .sort_values("rev", ascending=False).head(5))
    return g[["ok", "rev", "pri"]].reset_index(drop=True)


def test_second_run_skips_build_subtree(sess, q3ish):
    cust, orders, li = q3ish
    r1 = sess.sql(Q).to_pandas()
    assert not sess._executor._join_skip_rhs, "no skip on the cold run"
    r2 = sess.sql(Q).to_pandas()
    # the orders-x-customer build subtree of the partials join was
    # skipped and its artifacts recycled
    assert sess._executor._join_skip_rhs, (
        "warm run did not recycle the intermediate build side")
    assert sess._executor._join_route == "perfect(recycled)"
    exp = oracle(cust, orders, li)
    assert_frames_match(r1, exp, ordered=True)
    assert_frames_match(r2, exp, ordered=True)


def test_append_invalidates_recycled_artifacts(sess, q3ish, rng):
    cust, orders, li = q3ish
    sess.sql(Q).to_pandas()
    sess.sql(Q).to_pandas()
    assert sess._executor._join_skip_rhs
    # append customers so seg=2 gains members: generation bump must
    # invalidate the recycled build artifacts
    extra = pd.DataFrame({
        "ck": np.arange(300, 340, dtype=np.int64),
        "seg": np.full(40, 2, dtype=np.int64),
    })
    sess.append_pydict("rc_c", {c: extra[c].to_numpy() for c in extra})
    extra_orders = pd.DataFrame({
        "ok": np.arange(3000, 3100, dtype=np.int64),
        "ck": rng.integers(300, 340, 100).astype(np.int64),
        "pri": np.zeros(100, dtype=np.int64),
    })
    sess.append_pydict("rc_o", {c: extra_orders[c].to_numpy() for c in extra_orders})
    extra_li = pd.DataFrame({
        "ok": rng.integers(3000, 3100, 400).astype(np.int64),
        "price": 1e7 + rng.uniform(0, 1e6, 400),  # unique: no LIMIT ties
    })
    sess.append_pydict("rc_l", {c: extra_li[c].to_numpy() for c in extra_li})
    r3 = sess.sql(Q).to_pandas()
    assert not sess._executor._join_skip_rhs, (
        "stale recycled artifacts used after append")
    exp = oracle(pd.concat([cust, extra], ignore_index=True),
                 pd.concat([orders, extra_orders], ignore_index=True),
                 pd.concat([li, extra_li], ignore_index=True))
    assert_frames_match(r3, exp, ordered=True)


def test_disabled_cache_never_skips(q3ish, rng):
    s2 = hdk_jax.HDK(**{"cache.enable_hashtable_cache": False})
    s2.config.exec.eager_agg_min_rows = 500
    s2.config.exec.eager_agg_min_ratio = 1.0
    cust, orders, li = q3ish
    s2.import_pandas(cust, name="rd_c")
    s2.import_pandas(orders, name="rd_o")
    s2.import_pandas(li, name="rd_l")
    q = Q.replace("rc_", "rd_")
    r1 = s2.sql(q).to_pandas()
    r2 = s2.sql(q).to_pandas()
    assert not s2._executor._join_skip_rhs
    assert_frames_match(r1, oracle(cust, orders, li), ordered=True)
    assert_frames_match(r2, oracle(cust, orders, li), ordered=True)


def test_recycled_route_matches_fresh_session(sess, q3ish):
    cust, orders, li = q3ish
    for _ in range(4):
        res = sess.sql(Q).to_pandas()
        assert_frames_match(res, oracle(cust, orders, li), ordered=True)
