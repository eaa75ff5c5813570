"""Measured-feedback route tuning (exec/feedback.py, the P3 autotune
seam): near the one-hot/sort tier boundary the executor explores both
group-by routes with synced timing, then repeats the measured winner."""

import numpy as np
import pytest

import hdk_jax
from hdk_jax.exec.feedback import RouteFeedback


def test_choose_explores_then_exploits():
    fb = RouteFeedback()
    r1, m1 = fb.choose("sig", ["a", "b"])
    assert (r1, m1) == ("a", True)
    fb.record("sig", "a", 0.5)
    r2, m2 = fb.choose("sig", ["a", "b"])
    assert (r2, m2) == ("b", True)
    fb.record("sig", "b", 0.1)
    r3, m3 = fb.choose("sig", ["a", "b"])
    assert (r3, m3) == ("b", False)
    # ewma shifts the winner back if it degrades
    for _ in range(20):
        fb.record("sig", "b", 2.0)
    assert fb.choose("sig", ["a", "b"])[0] == "a"


def test_groupby_routes_explored_and_settled(rng):
    """A perfect-layout group-by in the tunable window runs 'perfect'
    then 'sort' on the first two repetitions (measured), then settles."""
    hdk = hdk_jax.HDK()
    n = 1 << 17
    t = hdk.import_pydict({
        "k": rng.integers(0, 1000, n),   # entries ~1000: in (512, 4096]
        "v": rng.integers(0, 50, n),
    }, name="fb_t")
    fb = hdk._executor._feedback
    import pandas as pd

    exp = (pd.DataFrame({"k": np.asarray(t.run().to_pandas()["k"]),
                         "v": np.asarray(t.run().to_pandas()["v"])})
           .groupby("k").agg(count=("k", "size"), v_sum=("v", "sum"))
           .reset_index())
    results = []
    for _ in range(3):
        got = (t.agg("k", "count", "sum(v)").run().to_pandas()
               .sort_values("k").reset_index(drop=True))
        results.append(got)
    sigs = {g for (g, _r) in fb._t.keys()}
    assert len(sigs) == 1
    measured = fb.measured(next(iter(sigs)))
    assert set(measured) == {"perfect", "sort"}  # both explored
    for got in results:  # every route produced identical exact results
        assert got["count"].tolist() == exp["count"].tolist()
        assert got["v_sum"].tolist() == exp["v_sum"].tolist()


def test_feedback_disabled(rng):
    hdk = hdk_jax.HDK(**{"exec.enable_route_feedback": False})
    n = 1 << 17
    t = hdk.import_pydict({"k": rng.integers(0, 1000, n)}, name="fb_off")
    for _ in range(2):
        t.agg("k", "count").run()
    assert hdk._executor._feedback._t == {}


def test_join_route_feedback_explores_and_settles(rng):
    """VERDICT r3 #8: the join route (spread vs value-table vs
    sorted-hash) is under the same explore-once-then-exploit measured
    contract as the group-by boundary.  First three repetitions of the
    plan signature explore one candidate each (timed warm, outputs
    forced); the fourth runs the measured winner."""
    import hdk_jax

    h = hdk_jax.HDK()
    h.config.exec.join.spread_join_min_rows = 50
    n = 70_000
    lhs = {"k": rng.integers(0, 64, n).astype(np.int64),
           "v": rng.normal(size=n).astype(np.float32)}
    rhs = {"k": np.arange(64, dtype=np.int64),
           "w": rng.normal(size=64).astype(np.float32)}
    tl = h.import_pydict(lhs, name="fbj_l")
    tr = h.import_pydict(rhs, name="fbj_r")
    exp_cnt = n
    exp_sum = float(rhs["w"][lhs["k"]].sum())

    routes = []
    for _ in range(4):
        res = tl.join(tr, "k", "k").agg([], "count", "sum(w)"
                                        ).run().to_pandas()
        assert res["count"].iloc[0] == exp_cnt
        assert np.isclose(res["w_sum"].iloc[0], exp_sum, rtol=1e-4)
        routes.append(h._executor._join_route)
    # exploration covered all three candidates ("perfect" is the
    # value-table route's label; "spread" refines it)
    assert set(routes[:3]) == {"spread", "perfect", "hash"}, routes
    fb = h._executor._feedback
    sigs = {s for (s, r) in fb._t if s.endswith("|tunejoin")}
    assert len(sigs) == 1
    measured = fb.measured(next(iter(sigs)))
    assert set(measured) == {"spread", "value", "hash"}
    assert all(v > 0 for v in measured.values())
    # steady state: the fourth run picked the measured winner
    winner = min(measured, key=measured.get)
    expect_label = {"spread": "spread", "value": "perfect",
                    "hash": "hash"}[winner]
    assert routes[3] == expect_label, (routes, measured)


def test_join_route_feedback_inadmissible_poisoned(rng):
    """A candidate whose admission fails (duplicate build keys kill
    both perfect-table routes) is recorded as +inf once and never
    re-explored — repetitions settle on the hash route."""
    import hdk_jax

    h = hdk_jax.HDK()
    n = 70_000
    lhs = {"k": rng.integers(0, 64, n).astype(np.int64)}
    rhs = {"k": np.concatenate([np.arange(64), np.arange(64)]),
           "w": np.ones(128, np.float32)}
    tl = h.import_pydict(lhs, name="fbj2_l")
    tr = h.import_pydict(rhs, name="fbj2_r")
    for _ in range(3):
        res = tl.join(tr, "k", "k").agg([], "count").run().to_pandas()
        assert res["count"].iloc[0] == 2 * n  # each key matches twice
    assert h._executor._join_route == "hash"
    fb = h._executor._feedback
    sig = next(s for (s, r) in fb._t if s.endswith("|tunejoin"))
    m = fb.measured(sig)
    assert m["spread"] == float("inf") and m["value"] == float("inf")
    assert np.isfinite(m["hash"])
