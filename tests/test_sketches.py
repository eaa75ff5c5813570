"""Mergeable sketches: HLL (APPROX_COUNT_DISTINCT) and t-digest
(APPROX_QUANTILE) — error bounds vs exact, grouped + global + distributed
(VERDICT r1 #6; reference: HyperLogLog.h:90, Shared/approx_quantile.h)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


def test_hll_kernel_error_bound(rng):
    """Raw sketch: estimate within the 1.04/sqrt(m) envelope at p=11."""
    import jax.numpy as jnp
    from hdk_jax.ops import sketches as sk

    for true_nd in (100, 5_000, 60_000):
        vals = rng.integers(0, true_nd, 200_000)
        # every value of range present
        vals[:true_nd] = np.arange(true_nd)
        gid = jnp.zeros(vals.shape[0], jnp.int32)
        regs = sk.hll_registers(jnp.asarray(vals), None, gid, 1, 11)
        est = int(sk.hll_estimate(regs)[0])
        assert abs(est - true_nd) <= max(0.08 * true_nd, 3), (true_nd, est)


def test_hll_merge_equals_union(rng):
    """Register max of two sketches == sketch of the union (hll_unify)."""
    import jax.numpy as jnp
    from hdk_jax.ops import sketches as sk

    a = rng.integers(0, 10_000, 50_000)
    b = rng.integers(5_000, 15_000, 50_000)
    gid = lambda x: jnp.zeros(x.shape[0], jnp.int32)
    ra = sk.hll_registers(jnp.asarray(a), None, gid(a), 1, 10)
    rb = sk.hll_registers(jnp.asarray(b), None, gid(b), 1, 10)
    u = np.concatenate([a, b])
    ru = sk.hll_registers(jnp.asarray(u), None, gid(u), 1, 10)
    assert (np.maximum(np.asarray(ra), np.asarray(rb))
            == np.asarray(ru)).all()


def test_tdigest_quantile_error(rng):
    import jax.numpy as jnp
    from hdk_jax.ops import sketches as sk

    vals = rng.normal(size=100_000)
    gid = jnp.zeros(vals.shape[0], jnp.int32)
    means, weights = sk.tdigest_build(jnp.asarray(vals), None, gid, 1, 300)
    sv = np.sort(vals)
    for q in (0.01, 0.25, 0.5, 0.75, 0.99):
        est = float(sk.tdigest_quantile(means, weights, q)[0])
        # rank error: position of the estimate in the sorted data
        rank = np.searchsorted(sv, est) / len(sv)
        assert abs(rank - q) < 0.01, (q, rank, est)


def test_tdigest_merge_preserves_accuracy(rng):
    import jax.numpy as jnp
    from hdk_jax.ops import sketches as sk

    vals = rng.normal(size=80_000)
    halves = np.split(vals, 8)
    parts = [sk.tdigest_build(jnp.asarray(h), None,
                              jnp.zeros(h.shape[0], jnp.int32), 1, 100)
             for h in halves]
    gm = jnp.concatenate([p[0] for p in parts], axis=1)
    gw = jnp.concatenate([p[1] for p in parts], axis=1)
    mm, mw = sk.tdigest_merge_gathered(gm, gw, 100)
    sv = np.sort(vals)
    for q in (0.1, 0.5, 0.9):
        est = float(sk.tdigest_quantile(mm, mw, q)[0])
        rank = np.searchsorted(sv, est) / len(sv)
        assert abs(rank - q) < 0.02, (q, rank)


@pytest.fixture(scope="module")
def data(rng):
    n = 40_000
    df = pd.DataFrame({
        "g": rng.integers(0, 12, n).astype(np.int64),
        "v": rng.integers(0, 3_000, n).astype(np.int64),
        "x": rng.normal(10.0, 3.0, n),
    })
    df.loc[rng.random(n) < 0.05, "x"] = np.nan
    return df


@pytest.fixture(scope="module")
def ht(hdk, data):
    return hdk.import_pandas(data, name="sk_t")


def test_engine_approx_count_distinct_grouped(ht, data):
    res = ht.agg("g", ht["v"].approx_count_distinct().name("nd")
                 ).run().to_pandas()
    exp = data.groupby("g")["v"].nunique().reset_index(name="nd")
    merged = res.merge(exp, on="g", suffixes=("", "_e"))
    assert len(merged) == len(exp)
    np.testing.assert_allclose(merged["nd"].to_numpy(float),
                               merged["nd_e"].to_numpy(float),
                               rtol=0.08, atol=2)


def test_engine_approx_quantile_grouped(ht, data):
    res = ht.agg("g", ht["x"].approx_quantile(0.5).name("med")
                 ).run().to_pandas()
    exp = data.groupby("g")["x"].median().reset_index(name="med")
    merged = res.merge(exp, on="g", suffixes=("", "_e"))
    np.testing.assert_allclose(merged["med"].to_numpy(float),
                               merged["med_e"].to_numpy(float), atol=0.15)


def test_engine_approx_global(ht, data):
    res = ht.agg([], ht["v"].approx_count_distinct().name("nd"),
                 ht["x"].approx_quantile(0.9).name("p90")).run().to_pandas()
    nd_exact = data["v"].nunique()
    p90_exact = data["x"].quantile(0.9)
    assert abs(res["nd"][0] - nd_exact) <= max(0.05 * nd_exact, 3)
    assert abs(res["p90"][0] - p90_exact) < 0.1


def test_engine_approx_quantile_all_null(hdk):
    df = pd.DataFrame({"g": [1, 1, 2], "x": [np.nan, np.nan, 5.0]})
    ht = hdk.import_pandas(df, name="sk_null")
    res = ht.agg("g", ht["x"].approx_quantile(0.5).name("m")
                 ).run().to_pandas().sort_values("g").reset_index(drop=True)
    assert pd.isna(res["m"][0])
    assert res["m"][1] == 5.0


def test_sql_approx_aggs(hdk, data):
    res = hdk.sql("SELECT g, APPROX_COUNT_DISTINCT(v) AS nd, "
                  "APPROX_QUANTILE(x, 0.25) AS q1 FROM sk_t "
                  "GROUP BY g").to_pandas()
    exp_nd = data.groupby("g")["v"].nunique()
    exp_q1 = data.groupby("g")["x"].quantile(0.25)
    merged = res.set_index("g").join(exp_nd.rename("nd_e")).join(
        exp_q1.rename("q1_e"))
    np.testing.assert_allclose(merged["nd"].to_numpy(float),
                               merged["nd_e"].to_numpy(float),
                               rtol=0.08, atol=2)
    np.testing.assert_allclose(merged["q1"].to_numpy(float),
                               merged["q1_e"].to_numpy(float), atol=0.15)


# ---------------------------------------------------------------------------
# distributed: sketches make APPROX_* two-phase distributable
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_session():
    return hdk_jax.HDK(**{"dist.enable": True})


def test_dist_approx_matches_local(dist_session, data, ht):
    """Dist HLL must EQUAL local HLL (register max is associative) and
    t-digest must stay within the error envelope."""
    dht = dist_session.import_pandas(data, name="sk_d")
    local = ht.agg("g", ht["v"].approx_count_distinct().name("nd")
                   ).run().to_pandas()
    dist = dht.agg("g", dht["v"].approx_count_distinct().name("nd")
                   ).run().to_pandas()
    assert_frames_match(dist, local)

    exp = data.groupby("g")["x"].median().reset_index(name="med")
    dq = dht.agg("g", dht["x"].approx_quantile(0.5).name("med")
                 ).run().to_pandas()
    merged = dq.merge(exp, on="g", suffixes=("", "_e"))
    assert len(merged) == len(exp)
    np.testing.assert_allclose(merged["med"].to_numpy(float),
                               merged["med_e"].to_numpy(float), atol=0.2)


def test_dist_approx_skewed_heavy_hitter(dist_session, rng):
    """Zipf-skewed key: one key owns ~90% of rows.  Sketch partials are
    fixed-width per (shard, key), so the shuffle cannot overload the
    owner shard (north-star skew requirement, SURVEY §7.3)."""
    n = 60_000
    g = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 200, n))
    df = pd.DataFrame({
        "g": g.astype(np.int64),
        "v": rng.integers(0, 5_000, n).astype(np.int64),
    })
    ht = dist_session.import_pandas(df, name="sk_skew")
    res = ht.agg("g", ht["v"].approx_count_distinct().name("nd")
                 ).run().to_pandas()
    exp = df.groupby("g")["v"].nunique().reset_index(name="nd")
    merged = res.merge(exp, on="g", suffixes=("", "_e"))
    assert len(merged) == len(exp)
    np.testing.assert_allclose(merged["nd"].to_numpy(float),
                               merged["nd_e"].to_numpy(float),
                               rtol=0.1, atol=2)


def test_streaming_approx_count_distinct(hdk, rng):
    from hdk_jax.streaming import StreamingAggregation

    schema = {"k": "int64", "v": "int64"}
    sa = StreamingAggregation(hdk, schema, ["k"],
                              ["count", "approx_count_distinct(v)", "sum(v)"])
    all_k, all_v = [], []
    for _ in range(4):
        k = rng.integers(0, 5, 3_000)
        v = rng.integers(0, 800, 3_000)
        all_k.append(k)
        all_v.append(v)
        sa.push({"k": k, "v": v})
    res = sa.finish().to_pandas()
    df = pd.DataFrame({"k": np.concatenate(all_k),
                       "v": np.concatenate(all_v)})
    exp = df.groupby("k").agg(
        count=("v", "size"), nd=("v", "nunique"),
        v_sum=("v", "sum")).reset_index()
    merged = res.merge(exp, on="k", suffixes=("", "_e"))
    assert (merged["count"] == merged["count_e"]).all()
    assert (merged["v_sum"] == merged["v_sum_e"]).all()
    np.testing.assert_allclose(
        merged["v_approx_count_distinct"].to_numpy(float),
        merged["nd"].to_numpy(float), rtol=0.08, atol=2)
