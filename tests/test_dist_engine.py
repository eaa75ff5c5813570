"""Distributed engine mode: full queries over a sharded session
(dist.enable=True — scans shard rows over all devices; GSPMD inserts
the collectives).  SURVEY.md §2.8's 'new vs reference' capability."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
import jax

from harness import assert_frames_match

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices")


@pytest.fixture(scope="module")
def pair(rng):
    """(distributed session, single-device session) over identical data."""
    n = 4001  # deliberately not divisible by 8: exercises pad+mask
    df = pd.DataFrame({
        "k": rng.integers(0, 6, n),
        "big": rng.integers(0, 10**8, n),
        "v": rng.normal(size=n) * 10,
        "s": rng.choice(["a", "b", "c"], n),
    })
    dist = hdk_jax.HDK(**{"dist.enable": True})
    solo = hdk_jax.HDK()
    dist.import_pandas(df, name="t")
    solo.import_pandas(df, name="t")
    return dist, solo, df


def _both(pair, build):
    dist, solo, _ = pair
    a = build(dist.scan("t"), dist).to_pandas()
    b = build(solo.scan("t"), solo).to_pandas()
    return a, b


def test_sharded_perfect_groupby(pair):
    a, b = _both(pair, lambda t, s: t.agg("k", "count", "sum(v)",
                                          "min(v)", "max(v)").run())
    assert_frames_match(a, b)


def test_sharded_filter_agg(pair):
    a, b = _both(pair, lambda t, s: t.filter(t["v"] > 0)
                 .agg("k", "count", "avg(v)").run())
    assert_frames_match(a, b)


def test_sharded_high_ndv_groupby(pair):
    a, b = _both(pair, lambda t, s: t.agg("big", "count").run())
    assert_frames_match(a, b)


def test_sharded_global_agg(pair):
    a, b = _both(pair, lambda t, s: t.agg([], "count", "sum(v)",
                                          "stddev(v)").run())
    assert_frames_match(a, b, approx_cols=("v_stddev",))


def test_sharded_sort_limit(pair):
    a, b = _both(pair, lambda t, s: t.sort(("v", "desc"), limit=25).run())
    assert_frames_match(a, b, ordered=True, approx_cols=("v",))


def test_sharded_projection(pair):
    a, b = _both(pair, lambda t, s: t.proj(x=t["v"] * 2 + 1).run())
    assert_frames_match(a, b)


def test_sharded_string_groupby(pair):
    a, b = _both(pair, lambda t, s: t.agg("s", "count").run())
    assert_frames_match(a, b)


def test_sharded_join(pair):
    dist, solo, df = pair
    dim = pd.DataFrame({"k": np.arange(6), "w": np.arange(6) * 10})
    dist.import_pandas(dim, name="dim")
    solo.import_pandas(dim, name="dim")
    a = (dist.scan("t").join(dist.scan("dim"), "k", "k")
         .agg([], "count", "sum(w)").run().to_pandas())
    b = (solo.scan("t").join(solo.scan("dim"), "k", "k")
         .agg([], "count", "sum(w)").run().to_pandas())
    assert_frames_match(a, b)


def test_sharded_sql(pair):
    dist, solo, _ = pair
    q = ("SELECT k, COUNT(*) AS c, AVG(v) AS av FROM t "
         "WHERE v > -5 GROUP BY k ORDER BY k")
    assert_frames_match(dist.sql(q).to_pandas(), solo.sql(q).to_pandas(),
                        ordered=True)


def test_sharded_skewed_high_ndv(pair, rng):
    """Engine-level: heavy-hitter keys in a sharded session go through
    the two-phase shuffle and still aggregate correctly."""
    dist, solo, _ = pair
    n = 8 * 600
    df2 = pd.DataFrame({
        "k": np.where(rng.random(n) < 0.9, 123456789,
                      rng.integers(0, 10**9, n)),
        "v": rng.integers(0, 100, n),
    })
    dist.import_pandas(df2, name="skew")
    solo.import_pandas(df2, name="skew")
    a = dist.scan("skew").agg("k", "count", "sum(v)", "min(v)").run().to_pandas()
    b = solo.scan("skew").agg("k", "count", "sum(v)", "min(v)").run().to_pandas()
    assert_frames_match(a, b)


def test_sharded_filtered_high_ndv(pair, rng):
    def q(session):
        t = session.scan("t")
        return t.filter(t["v"] > 0).agg("big", "count").run().to_pandas()

    dist, solo, _ = pair
    assert_frames_match(q(dist), q(solo))


def test_merge_cap_overflow_widens_and_retries(rng):
    """Receiver group-cap overflow in the two-phase merge is a detected
    signal feeding the widen-and-retry ladder — results must be exact,
    never silently merged tail groups (ADVICE r1 / VERDICT r1 #2)."""
    # group_cap = max(64, min(default_max_groups//ndev, rows/ndev*2)) = 64;
    # ~1000 distinct keys over 8 shards => ~125 keys/owner-shard > 64
    sess = hdk_jax.HDK(**{"dist.enable": True,
                          "exec.group_by.default_max_groups": 256})
    solo = hdk_jax.HDK()
    n = 8 * 500
    df = pd.DataFrame({
        "k": (rng.integers(0, 1000, n) * 2**33 + 5).astype(np.int64),
        "v": rng.integers(0, 100, n),
    })
    sess.import_pandas(df, name="mo")
    solo.import_pandas(df, name="mo")
    a = sess.scan("mo").agg("k", "count", "sum(v)").run().to_pandas()
    b = solo.scan("mo").agg("k", "count", "sum(v)").run().to_pandas()
    assert_frames_match(a, b)


# ---------------------------------------------------------------------------
# distributed joins (VERDICT r1 #1): replicated-build + partitioned
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def join_pair(rng):
    n = 8 * 400 + 3  # not divisible: exercises pad path
    fact = pd.DataFrame({
        "k": rng.integers(0, 300, n).astype(np.int64),
        "v": rng.normal(size=n).round(3),
        "tag": rng.integers(0, 5, n).astype(np.int64),
    })
    dim = pd.DataFrame({
        "k": np.arange(0, 250, dtype=np.int64),  # keys 250..299 unmatched
        "w": (np.arange(250) * 3 + 1).astype(np.int64),
    })
    # duplicate build keys: OneToMany expansion
    dim_dup = pd.concat([dim, dim.head(40)], ignore_index=True)
    dist = hdk_jax.HDK(**{"dist.enable": True})
    solo = hdk_jax.HDK()
    for s in (dist, solo):
        s.import_pandas(fact, name="f")
        s.import_pandas(dim, name="d")
        s.import_pandas(dim_dup, name="dd")
    return dist, solo


def _join_both(join_pair, build, **cfg):
    dist, solo = join_pair
    return (build(dist).to_pandas(), build(solo).to_pandas())


@pytest.mark.parametrize("dim_name", ["d", "dd"])
def test_dist_inner_join_broadcast(join_pair, dim_name):
    def q(s):
        return (s.scan("f").join(s.scan(dim_name), "k", "k")
                .agg("tag", "count", "sum(w)", "sum(v)").run())
    a, b = _join_both(join_pair, q)
    assert_frames_match(a, b)


def test_dist_inner_join_rows(join_pair):
    def q(s):
        f = s.scan("f")
        return f.filter(f["tag"] == 2).join(s.scan("d"), "k", "k").run()
    a, b = _join_both(join_pair, q)
    assert_frames_match(a, b)


def test_dist_left_join(join_pair):
    def q(s):
        return (s.scan("f").join(s.scan("d"), "k", "k", how="left")
                .agg("tag", "count", "sum(w)", "count(w)").run())
    a, b = _join_both(join_pair, q)
    assert_frames_match(a, b)


def test_dist_semi_anti_join(join_pair):
    dist, solo = join_pair
    for how in ("semi", "anti"):
        def q(s):
            return (s.scan("f").join(s.scan("d"), "k", "k", how=how)
                    .agg("tag", "count", "sum(v)").run())
        a, b = q(dist).to_pandas(), q(solo).to_pandas()
        assert_frames_match(a, b)


def test_dist_join_partitioned(rng):
    """Build side above the broadcast threshold -> shuffle-both-sides."""
    dist = hdk_jax.HDK(**{"dist.enable": True,
                          "dist.broadcast_join_threshold": 64})
    solo = hdk_jax.HDK()
    n, m = 8 * 300, 8 * 200
    fact = pd.DataFrame({"k": rng.integers(0, 1000, n).astype(np.int64),
                         "v": rng.integers(0, 50, n).astype(np.int64)})
    dim = pd.DataFrame({"k": rng.permutation(1200)[:m % 1200 + 500].astype(np.int64)})
    dim["w"] = dim["k"] * 2 + 1
    for s in (dist, solo):
        s.import_pandas(fact, name="pf")
        s.import_pandas(dim, name="pd_")
    for how in ("inner", "left", "semi", "anti"):
        a = (dist.scan("pf").join(dist.scan("pd_"), "k", "k", how=how)
             .agg([], "count", "sum(v)").run().to_pandas())
        b = (solo.scan("pf").join(solo.scan("pd_"), "k", "k", how=how)
             .agg([], "count", "sum(v)").run().to_pandas())
        assert_frames_match(a, b)


def test_dist_join_then_sort(join_pair):
    def q(s):
        return (s.scan("f").join(s.scan("d"), "k", "k")
                .sort(("w", "desc"), "k", limit=20).run())
    a, b = _join_both(join_pair, q)
    assert_frames_match(a, b, ordered=False)


# ---------------------------------------------------------------------------
# distributed routing: sorts via dist_sort, holistic aggs via raw shuffle
# ---------------------------------------------------------------------------

def test_dist_full_sort_multikey(pair):
    a, b = _both(pair, lambda t, s: t.sort(("k", "desc"), "v").run())
    assert_frames_match(a, b, ordered=True, approx_cols=("v",))


def test_dist_full_sort_nullable(pair, rng):
    dist, solo, _ = pair
    n = 8 * 350
    df = pd.DataFrame({"x": rng.normal(size=n), "y": rng.integers(0, 9, n)})
    df.loc[rng.random(n) < 0.07, "x"] = np.nan
    dist.import_pandas(df, name="srt_n")
    solo.import_pandas(df, name="srt_n")
    a = dist.scan("srt_n").sort("x", ("y", "desc")).run().to_pandas()
    b = solo.scan("srt_n").sort("x", ("y", "desc")).run().to_pandas()
    assert_frames_match(a, b, ordered=True)


def test_dist_sort_with_filter_and_offset(pair):
    def q(t, s):
        return t.filter(t["v"] > 0).sort("v", limit=None, offset=13).run()
    a, b = _both(pair, q)
    assert_frames_match(a, b, ordered=True, approx_cols=("v",))


def test_dist_holistic_aggs(pair, rng):
    dist, solo, _ = pair
    n = 8 * 600
    df = pd.DataFrame({
        "k": (rng.integers(0, 900, n) * 2**33 + 3).astype(np.int64),
        "v": rng.integers(0, 40, n).astype(np.int64),
        "f": rng.normal(size=n),
    })
    dist.import_pandas(df, name="hol")
    solo.import_pandas(df, name="hol")
    def q(s):
        t = s.scan("hol")
        return t.agg("k", "count", "count_distinct(v)",
                     "quantile(f, 0.5)").run().to_pandas()
    assert_frames_match(q(dist), q(solo))


def test_dist_sum_distinct(pair, rng):
    dist, solo, _ = pair
    q = "SELECT k, SUM(DISTINCT v) AS s FROM t GROUP BY k ORDER BY k"
    assert_frames_match(dist.sql(q).to_pandas(), solo.sql(q).to_pandas(),
                        ordered=True)


# ---------------------------------------------------------------------------
# heavy-hitter / DISTINCT-class skew-proof distribution (VERDICT r1 #5)
# ---------------------------------------------------------------------------

def _skewed_frame(rng, n, hot_share=0.8):
    """One key owns ``hot_share`` of all rows (Zipf-style heavy hitter)."""
    return pd.DataFrame({
        "k": np.where(rng.random(n) < hot_share, 7,
                      rng.integers(100, 160, n)).astype(np.int64),
        "v": rng.integers(0, 500, n).astype(np.int64),
        "x": rng.normal(size=n),
    })


def test_dist_count_distinct_skewed_small_caps(rng):
    """Zipf-skewed COUNT DISTINCT on the 8-device mesh with small group
    caps: the pair-split route spreads the hot key by (key, value) hash,
    so results are exact where a key-hash shuffle would overflow."""
    dist = hdk_jax.HDK(**{"dist.enable": True,
                          "exec.group_by.default_max_groups": 512})
    solo = hdk_jax.HDK()
    n = 8 * 700
    df = _skewed_frame(rng, n)
    dist.import_pandas(df, name="zipf")
    solo.import_pandas(df, name="zipf")

    def q(s):
        t = s.scan("zipf")
        return t.agg("k", "count", t["v"].count(distinct=True).name("nd"),
                     "sum(x)", "max(v)").run().to_pandas()

    a, b = q(dist), q(solo)
    assert dist._executor._dist_agg_route == "distinct_split"
    assert_frames_match(a, b)


def test_dist_distinct_split_uniform_keys(rng):
    """The pair-split route must be exact on unskewed data too (forced
    via heavy_hitter_threshold=0)."""
    dist = hdk_jax.HDK(**{"dist.enable": True,
                          "dist.heavy_hitter_threshold": 0.0})
    solo = hdk_jax.HDK()
    n = 8 * 500
    df = pd.DataFrame({
        "k": rng.integers(0, 200, n).astype(np.int64),
        "v": rng.integers(0, 50, n).astype(np.int64),
    })
    # null keys and null values exercise the 3VL corners
    df.loc[df.index[:40], "v"] = pd.NA
    df["v"] = df["v"].astype("Int64")
    dist.import_pandas(df, name="u")
    solo.import_pandas(df, name="u")
    q = ("SELECT k, COUNT(DISTINCT v) AS nd, SUM(DISTINCT v) AS sd, "
         "AVG(v) AS a FROM u GROUP BY k ORDER BY k")
    a = dist.sql(q).to_pandas()
    assert dist._executor._dist_agg_route == "distinct_split"
    assert_frames_match(a, solo.sql(q).to_pandas(), ordered=True)


def test_dist_distinct_raw_route_below_threshold(rng):
    """With the hot-key probe under threshold the cheaper raw shuffle
    runs (one all_to_all) and stays exact."""
    dist = hdk_jax.HDK(**{"dist.enable": True,
                          "dist.heavy_hitter_threshold": 1e9})
    solo = hdk_jax.HDK()
    n = 8 * 400
    df = pd.DataFrame({
        "k": rng.integers(0, 64, n).astype(np.int64),
        "v": rng.integers(0, 30, n).astype(np.int64),
    })
    dist.import_pandas(df, name="r")
    solo.import_pandas(df, name="r")

    def q(s):
        t = s.scan("r")
        return t.agg("k", t["v"].count(distinct=True).name("nd")
                     ).run().to_pandas()

    a, b = q(dist), q(solo)
    assert dist._executor._dist_agg_route == "shuffled"
    assert_frames_match(a, b)


def test_dist_multi_operand_distinct_falls_back(rng):
    """COUNT(DISTINCT a) + COUNT(DISTINCT b) (different operands) is not
    pair-splittable; the raw shuffle handles it exactly."""
    dist = hdk_jax.HDK(**{"dist.enable": True})
    solo = hdk_jax.HDK()
    n = 8 * 300
    df = pd.DataFrame({
        "k": rng.integers(0, 40, n).astype(np.int64),
        "a": rng.integers(0, 25, n).astype(np.int64),
        "b": rng.integers(0, 90, n).astype(np.int64),
    })
    dist.import_pandas(df, name="m2")
    solo.import_pandas(df, name="m2")

    def q(s):
        t = s.scan("m2")
        return t.agg("k", t["a"].count(distinct=True).name("nda"),
                     t["b"].count(distinct=True).name("ndb")
                     ).run().to_pandas()

    a, b = q(dist), q(solo)
    assert dist._executor._dist_agg_route == "shuffled"
    assert_frames_match(a, b)


def test_dist_window_rank_sum(pair):
    """Window functions in a dist session route through the explicit
    shuffle plan (parallel/dist_window.py): rows shuffle to their
    partition-owner shard, the local window engine runs there, results
    route back by global position — no GSPMD fallback for the sort."""
    dist, solo, df = pair
    sql = ("SELECT k, big, "
           "RANK() OVER (PARTITION BY k ORDER BY big) AS r, "
           "SUM(v) OVER (PARTITION BY k) AS s FROM t")
    a = dist.sql(sql).to_pandas()
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b)


def test_dist_window_row_number_after_filter(pair):
    """Filter-dead rows must not occupy window positions post-shuffle."""
    dist, solo, df = pair
    sql = ("SELECT k, big, "
           "ROW_NUMBER() OVER (PARTITION BY k ORDER BY big) AS rn "
           "FROM t WHERE v > 0")
    a = dist.sql(sql).to_pandas()
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b)


def test_dist_window_lag_lead(pair):
    dist, solo, df = pair
    sql = ("SELECT big, "
           "LAG(big, 1) OVER (PARTITION BY k ORDER BY big) AS lg, "
           "LEAD(big, 1) OVER (PARTITION BY k ORDER BY big) AS ld FROM t")
    a = dist.sql(sql).to_pandas()
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b)


def test_dist_window_global_falls_back(pair):
    """No partition keys: a single shard would own all rows — the GSPMD
    fallback must still give correct results."""
    dist, solo, df = pair
    sql = "SELECT big, RANK() OVER (ORDER BY big) AS r FROM t"
    a = dist.sql(sql).to_pandas()
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b)


def test_dist_fragment_pruning(rng):
    """Dist sessions keep min/max fragment skipping (VERDICT-r2 #6):
    a selective range filter prunes on the host and shards only the
    surviving fragments."""
    n = 12_000
    df = pd.DataFrame({
        "dt": np.arange(n, dtype=np.int64),  # monotone: perfect stats
        "v": rng.normal(size=n),
    })
    dist = hdk_jax.HDK(**{"dist.enable": True,
                          "storage.fragment_size": 1000})
    t = dist.import_pandas(df, name="pr_t")
    res = (t.filter((t["dt"] >= 3000) & (t["dt"] < 4000))
           .agg([], "count", "sum(v)").run().to_pandas())
    stats = dist._executor._frag_prune_stats
    assert stats is not None and stats["selected"] < stats["total"]
    exp = df[(df.dt >= 3000) & (df.dt < 4000)]
    assert res["count"].iloc[0] == len(exp)
    assert np.isclose(res["v_sum"].iloc[0], exp["v"].sum())


def test_dist_fragment_streaming(rng):
    """Over-budget dist scans stream fragment chunks (sharded per
    chunk) instead of materializing the whole table."""
    n = 20_000
    df = pd.DataFrame({
        "g": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.normal(size=n),
    })
    dist = hdk_jax.HDK(**{"dist.enable": True,
                          "storage.fragment_size": 1000,
                          "exec.scan_stream_bytes": 32_000})
    t = dist.import_pandas(df, name="fsd_t")
    res = t.agg("g", "count", "sum(v)").run().to_pandas()
    ch = dist._executor._frag_stream_chunks
    assert ch and ch > 1
    exp = df.groupby("g").agg(count=("g", "size"),
                              v_sum=("v", "sum")).reset_index()
    assert_frames_match(res, exp, approx_cols=("v_sum",))


def test_dist_window_feeding_aggregate(pair):
    """Window DEEP in the plan (VERDICT r3 missing #4): a window Project
    fused inside an Aggregate's chain routes through the explicit
    shuffle-to-partition-owner plan, not GSPMD — route asserted."""
    dist, solo, df = pair
    sql = ("SELECT k, MAX(rn) AS mx, SUM(cs) AS sc FROM ("
           "SELECT k, ROW_NUMBER() OVER (PARTITION BY k ORDER BY big) AS rn, "
           "SUM(v) OVER (PARTITION BY k) AS cs FROM t) sub GROUP BY k")
    a = dist.sql(sql).to_pandas()
    assert dist._executor._dist_window_route == "dist_window"
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b, approx_cols=("sc",))


def test_dist_window_feeding_sort(pair):
    """Window project under an ORDER BY + LIMIT consumer takes the dist
    window route inside the sort's fused chain."""
    dist, solo, df = pair
    sql = ("SELECT big, RANK() OVER (PARTITION BY k ORDER BY big) AS r "
           "FROM t WHERE v > 0 ORDER BY r DESC, big LIMIT 40")
    a = dist.sql(sql).to_pandas()
    assert dist._executor._dist_window_route == "dist_window"
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b, ordered=True)


def test_dist_window_feeding_join(pair):
    """Window output joined against an aggregate of the same table —
    the join input chain hoists the window through the dist route."""
    dist, solo, df = pair
    sql = ("SELECT w.k, COUNT(*) AS c FROM "
           "(SELECT k, big, ROW_NUMBER() OVER (PARTITION BY k ORDER BY big)"
           " AS rn FROM t) w JOIN "
           "(SELECT k, COUNT(*) AS n FROM t GROUP BY k) g ON w.k = g.k "
           "WHERE w.rn <= g.n / 2 GROUP BY w.k")
    a = dist.sql(sql).to_pandas()
    b = solo.sql(sql).to_pandas()
    assert_frames_match(a, b)
