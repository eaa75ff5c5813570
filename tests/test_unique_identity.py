"""Uniqueness certificates + the group-by identity pass, and masked
(uncompacted) perfect-join outputs.

The eager-aggregation plan shape (pre-agg below the join, re-group
above it) is the main producer/consumer pair: the pre-agg certifies its
key columns unique, the perfect join propagates the certificate across
its 1:1 probe mapping, and the re-group collapses to an identity pass
(reference analog: Calcite AggregateRemoveRule over unique keys).
Differential coverage: every query here is checked against pandas.
"""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from hdk_jax.exec.agg_exec import AggExecMixin


@pytest.fixture()
def hdk():
    return hdk_jax.HDK()


def _track_identity(monkeypatch):
    """Counts BOTH identity-pass entry points: the standalone table
    (_agg_identity_table) and the fused identity+sort tail program
    that replaced it for small-LIMIT sorts (round 5)."""
    fired = []
    orig = AggExecMixin._agg_identity_table
    orig_fused = AggExecMixin._exec_fused_identity_sort

    def patched(self, node, source, chain, src_node):
        r = orig(self, node, source, chain, src_node)
        fired.append(r is not None)
        return r

    def patched_fused(self, sort_node, node, source, chain, src_node):
        r = orig_fused(self, sort_node, node, source, chain, src_node)
        fired.append(r is not None)
        return r

    monkeypatch.setattr(AggExecMixin, "_agg_identity_table", patched)
    monkeypatch.setattr(AggExecMixin, "_exec_fused_identity_sort",
                        patched_fused)
    return fired


def _q3_tables(hdk, n_ord=24_000, n_li=96_000, seed=7):
    rng = np.random.default_rng(seed)
    orders = {
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_val": rng.integers(0, 50, n_ord),
        "o_flag": rng.integers(0, 3, n_ord).astype(np.int8),
    }
    li = {
        "l_orderkey": rng.integers(0, n_ord, n_li),
        "l_price": rng.gamma(3.0, 100.0, n_li).astype(np.float32),
        "l_keep": rng.integers(0, 2, n_li).astype(np.int8),
    }
    hdk.import_pydict(orders, name="uorders")
    hdk.import_pydict(li, name="uli")
    return pd.DataFrame(orders), pd.DataFrame(li)


def _oracle_regroup(o, l):
    m = l[l.l_keep == 1].merge(o, left_on="l_orderkey",
                               right_on="o_orderkey")
    m["rev"] = m.l_price.astype(np.float64)
    return (m.groupby(["l_orderkey", "o_flag"], as_index=False)
            .agg(rev=("rev", "sum"), cnt=("rev", "size")))


def test_eager_regroup_identity_fires_and_matches(hdk, monkeypatch):
    fired = _track_identity(monkeypatch)
    hdk.config.exec.eager_agg_min_rows = 1000
    hdk.config.exec.eager_agg_min_ratio = 0.1
    o, l = _q3_tables(hdk)
    df = hdk.sql(
        "SELECT l_orderkey, o_flag, SUM(l_price) AS rev, COUNT(*) AS cnt "
        "FROM uli, uorders WHERE l_orderkey = o_orderkey AND l_keep = 1 "
        "GROUP BY l_orderkey, o_flag ORDER BY rev DESC LIMIT 20"
    ).to_pandas()
    assert any(fired), "identity pass never fired on the re-group"
    g = _oracle_regroup(o, l).sort_values("rev", ascending=False).head(20)
    assert list(df.l_orderkey) == list(g.l_orderkey)
    np.testing.assert_allclose(df.rev.values, g.rev.values, rtol=1e-6)
    np.testing.assert_array_equal(df.cnt.values, g.cnt.values)


def test_identity_agg_kinds_match_oracle(hdk, monkeypatch):
    """MIN/MAX/AVG/COUNT(col) over certified-unique keys: the identity
    closed forms must match a real group-by (pandas oracle)."""
    fired = _track_identity(monkeypatch)
    hdk.config.exec.eager_agg_min_rows = 1000
    hdk.config.exec.eager_agg_min_ratio = 0.1
    o, l = _q3_tables(hdk, n_ord=6_000, n_li=48_000, seed=11)
    df = hdk.sql(
        "SELECT l_orderkey, SUM(l_price) AS s, MIN(o_val) AS mn, "
        "MAX(o_val) AS mx, AVG(l_price) AS av, COUNT(o_val) AS c "
        "FROM uli, uorders WHERE l_orderkey = o_orderkey "
        "GROUP BY l_orderkey ORDER BY l_orderkey LIMIT 50"
    ).to_pandas()
    m = l.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    g = (m.groupby("l_orderkey", as_index=False)
         .agg(s=("l_price", lambda x: x.astype(np.float64).sum()),
              mn=("o_val", "min"), mx=("o_val", "max"),
              av=("l_price", lambda x: x.astype(np.float64).mean()),
              c=("o_val", "size"))
         .sort_values("l_orderkey").head(50))
    assert list(df.l_orderkey) == list(g.l_orderkey)
    np.testing.assert_allclose(df.s.values, g.s.values, rtol=1e-6)
    np.testing.assert_array_equal(df.mn.values, g.mn.values)
    np.testing.assert_array_equal(df.mx.values, g.mx.values)
    np.testing.assert_allclose(df.av.values, g.av.values, rtol=1e-6)
    np.testing.assert_array_equal(df.c.values, g.c.values)


def test_identity_respects_null_aggregates(hdk, monkeypatch):
    """SUM over a NULL operand row must stay NULL through the identity
    pass, and COUNT(col) must drop it."""
    _track_identity(monkeypatch)
    ok = np.arange(500, dtype=np.int64)
    hdk.import_pydict({"k": ok, "grp": ok % 7}, name="ubase")
    hdk.import_pydict(
        {"k": ok, "v": [float(i) if i % 3 else None for i in ok]},
        name="uvals")
    # group-by k (certifies k unique), join, re-group by k
    df = hdk.sql(
        "SELECT a.k AS k, SUM(v) AS sv, COUNT(v) AS cv FROM "
        "(SELECT k, COUNT(*) AS c FROM ubase GROUP BY k) a, uvals "
        "WHERE a.k = uvals.k GROUP BY a.k ORDER BY a.k"
    ).to_pandas()
    assert len(df) == 500
    for i in (0, 3, 6):
        assert pd.isna(df.sv[i]), f"SUM of NULL row {i} must be NULL"
        assert df.cv[i] == 0
    for i in (1, 2, 4):
        assert df.sv[i] == float(i)
        assert df.cv[i] == 1


def test_no_identity_without_certificate(hdk, monkeypatch):
    """A plain group-by over a base table must never take the identity
    pass (no certificate), and duplicate keys must still group."""
    fired = _track_identity(monkeypatch)
    rng = np.random.default_rng(3)
    k = rng.integers(0, 100, 10_000)
    v = rng.integers(0, 10, 10_000)
    hdk.import_pydict({"k": k, "v": v}, name="udup")
    df = hdk.sql("SELECT k, SUM(v) AS s FROM udup GROUP BY k "
                 "ORDER BY k").to_pandas()
    assert not any(fired)
    g = pd.DataFrame({"k": k, "v": v}).groupby("k", as_index=False).v.sum()
    np.testing.assert_array_equal(df.s.values, g.v.values)


def test_masked_join_output_matches_compacted(hdk):
    """Perfect INNER join with a partial match set: the masked
    (uncompacted) output route must agree with the compaction route
    (forced via the frac knob) and with pandas."""
    rng = np.random.default_rng(5)
    n_probe, n_build = 200_000, 4_000
    probe = {"k": rng.integers(0, n_build * 2, n_probe),  # ~50% match
             "x": rng.integers(0, 1000, n_probe)}
    build = {"k": np.arange(n_build * 2, dtype=np.int64)[::2],  # evens
             "w": rng.integers(0, 9, n_build)}
    hdk.import_pydict(probe, name="uprobe")
    hdk.import_pydict(build, name="ubuild")
    sql = ("SELECT w, SUM(x) AS s, COUNT(*) AS c FROM uprobe, ubuild "
           "WHERE uprobe.k = ubuild.k GROUP BY w ORDER BY w")
    df_masked = hdk.sql(sql).to_pandas()
    hdk.config.exec.join.masked_output_min_match_frac = 2.0  # force compact
    df_comp = hdk.sql(sql).to_pandas()
    pd.testing.assert_frame_equal(df_masked, df_comp)
    m = pd.DataFrame(probe).merge(pd.DataFrame(build), on="k")
    g = (m.groupby("w", as_index=False)
         .agg(s=("x", "sum"), c=("x", "size")))
    np.testing.assert_array_equal(df_masked.s.values, g.s.values)
    np.testing.assert_array_equal(df_masked.c.values, g.c.values)
