"""Eager aggregation (push group-by below INNER join): plan shape +
pandas-differential correctness, including R-side duplicate join keys
(the correctness-critical case: the join replicates partial rows and
the combine aggregate must restore the original multiplicities).

Reference semantics target: aggregates over joins in
omniscidb/Tests/ArrowBasedExecuteTest.cpp (GROUP BY over JOIN blocks);
the rewrite itself is the plan inversion documented at
optimizer.push_aggregation_below_join.
"""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    h = hdk_jax.HDK()
    # fire on tiny test tables
    h.config.exec.eager_agg_min_rows = 64
    h.config.exec.eager_agg_min_ratio = 1.0
    return h


@pytest.fixture(scope="module")
def data(hdk):
    rng = np.random.default_rng(71)
    n_l, n_r = 4000, 64
    lhs = {
        "fk": rng.integers(0, n_r, n_l),
        "val": rng.normal(size=n_l),
        "qty": rng.integers(1, 10, n_l),
        "extra": rng.integers(0, 5, n_l),
    }
    rhs = {
        "pk": rng.permutation(n_r),
        "cat": rng.integers(0, 4, n_r).astype(np.int8),
        "w": rng.normal(size=n_r),
    }
    hdk.import_pydict(lhs, name="ea_l")
    hdk.import_pydict(rhs, name="ea_r")
    # duplicate-key build side: every pk appears twice with different cat
    dup = {
        "pk": np.concatenate([rhs["pk"], rhs["pk"]]),
        "cat": np.concatenate([rhs["cat"], rhs["cat"] + 10]).astype(np.int8),
    }
    hdk.import_pydict(dup, name="ea_rdup")
    return (pd.DataFrame(lhs), pd.DataFrame(rhs), pd.DataFrame(dup))


def _plan_has_agg_below_join(plan: str) -> bool:
    ji = plan.index("Join[inner]")
    return "Aggregate" in plan[ji:]


def test_rewrite_fires_and_matches_pandas(hdk, data):
    ldf, rdf, _ = data
    l = hdk.scan("ea_l")
    r = hdk.scan("ea_r")
    q = l.join(r, "fk", "pk").agg(["fk", "cat"], "count", "sum(val)",
                                  "min(qty)", "max(qty)")
    plan = hdk.explain(q)
    assert _plan_has_agg_below_join(plan), plan
    res = q.run().to_pandas().sort_values(["fk", "cat"]).reset_index(
        drop=True)
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby(["fk", "cat"], as_index=False).agg(
        count=("val", "size"), sum_val=("val", "sum"),
        min_qty=("qty", "min"), max_qty=("qty", "max"))
    exp = exp.sort_values(["fk", "cat"]).reset_index(drop=True)
    res.columns = list(exp.columns)
    assert_frames_match(res, exp, approx_cols=("sum_val",))


def test_duplicate_build_keys_multiplicity(hdk, data):
    """Partial sums replicate once per duplicate build row; the combine
    SUM must count each replica exactly once per matching group."""
    ldf, _, ddf = data
    l = hdk.scan("ea_l")
    d = hdk.scan("ea_rdup")
    q = l.join(d, "fk", "pk").agg(["cat"], "count", "sum(val)")
    plan = hdk.explain(q)
    assert _plan_has_agg_below_join(plan), plan
    res = q.run().to_pandas().sort_values("cat").reset_index(drop=True)
    m = ldf.merge(ddf, left_on="fk", right_on="pk")
    exp = m.groupby("cat", as_index=False).agg(
        count=("val", "size"), sum_val=("val", "sum"))
    exp = exp.sort_values("cat").reset_index(drop=True)
    res.columns = list(exp.columns)
    assert_frames_match(res, exp, approx_cols=("sum_val",))


def test_group_by_rhs_key_only(hdk, data):
    """No L-side group key at all: pre-agg at join-key granularity,
    final agg purely on build-side columns."""
    ldf, rdf, _ = data
    l = hdk.scan("ea_l")
    r = hdk.scan("ea_r")
    q = l.join(r, "fk", "pk").agg(["cat"], "sum(qty)", "max(val)")
    assert _plan_has_agg_below_join(hdk.explain(q))
    res = q.run().to_pandas().sort_values("cat").reset_index(drop=True)
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby("cat", as_index=False).agg(
        sum_qty=("qty", "sum"), max_val=("val", "max"))
    exp = exp.sort_values("cat").reset_index(drop=True)
    res.columns = list(exp.columns)
    assert_frames_match(res, exp, approx_cols=("max_val",))


def test_extra_lhs_group_key(hdk, data):
    """An L-side group key beyond the join key widens the pre-agg
    granularity but stays correct."""
    ldf, rdf, _ = data
    l = hdk.scan("ea_l")
    r = hdk.scan("ea_r")
    q = l.join(r, "fk", "pk").agg(["extra", "cat"], "count", "sum(val)")
    assert _plan_has_agg_below_join(hdk.explain(q))
    res = q.run().to_pandas().sort_values(["extra", "cat"]).reset_index(
        drop=True)
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby(["extra", "cat"], as_index=False).agg(
        count=("val", "size"), sum_val=("val", "sum"))
    exp = exp.sort_values(["extra", "cat"]).reset_index(drop=True)
    res.columns = list(exp.columns)
    assert_frames_match(res, exp, approx_cols=("sum_val",))


def test_no_rewrite_for_agg_over_rhs_column(hdk, data):
    """SUM over a build-side column is not decomposable through the
    pre-aggregate: the plan must stay agg-above-join."""
    l = hdk.scan("ea_l")
    r = hdk.scan("ea_r")
    q = l.join(r, "fk", "pk").agg(["fk"], "sum(w)")
    plan = hdk.explain(q)
    ji = plan.index("Join[inner]")
    assert "Aggregate" not in plan[ji:], plan
    # correctness unchanged
    ldf, rdf, _ = data
    res = q.run().to_pandas().sort_values("fk").reset_index(drop=True)
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby("fk", as_index=False).agg(sum_w=("w", "sum"))
    res.columns = list(exp.columns)
    assert_frames_match(res, exp.sort_values("fk").reset_index(drop=True),
                        approx_cols=("sum_w",))


def test_no_rewrite_for_distinct(hdk, data):
    l = hdk.scan("ea_l")
    r = hdk.scan("ea_r")
    j = l.join(r, "fk", "pk")
    q = j.agg(["cat"], j["qty"].count(distinct=True).name("nd"))
    plan = hdk.explain(q)
    ji = plan.index("Join[inner]")
    assert "Aggregate" not in plan[ji:], plan


def test_disabled_by_config(data):
    h2 = hdk_jax.HDK()
    h2.config.exec.enable_eager_aggregation = False
    h2.config.exec.eager_agg_min_rows = 64
    ldf = data[0]
    h2.import_pydict({k: np.asarray(v) for k, v in ldf.items()},
                     name="ea_l2")
    h2.import_pydict({"pk": np.arange(64), "cat": np.arange(64) % 4},
                     name="ea_r2")
    l = h2.scan("ea_l2")
    r = h2.scan("ea_r2")
    q = l.join(r, "fk", "pk").agg(["cat"], "count")
    plan = h2.explain(q)
    ji = plan.index("Join[inner]")
    assert "Aggregate" not in plan[ji:], plan


def test_sql_q3_shape_with_nulls(hdk):
    """Q3-shaped SQL over data with NULL join keys and NULL agg values:
    NULL keys never join; NULL operands don't contribute to SUM."""
    rng = np.random.default_rng(99)
    n_l, n_r = 2000, 50
    fk = rng.integers(0, n_r, n_l).astype(np.float64)
    fk[rng.random(n_l) < 0.1] = np.nan
    val = rng.normal(size=n_l)
    val[rng.random(n_l) < 0.1] = np.nan
    hdk.import_pandas(pd.DataFrame({"fk": fk, "val": val}), name="ea_ln")
    hdk.import_pydict({"pk": np.arange(n_r, dtype=np.float64),
                       "cat": np.arange(n_r) % 3}, name="ea_rn")
    res = hdk.sql(
        "SELECT cat, COUNT(*) AS c, SUM(val) AS s FROM ea_ln, ea_rn "
        "WHERE fk = pk GROUP BY cat ORDER BY cat").to_pandas()
    ldf = pd.DataFrame({"fk": fk, "val": val})
    rdf = pd.DataFrame({"pk": np.arange(n_r, dtype=np.float64),
                        "cat": np.arange(n_r) % 3})
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby("cat", as_index=False).agg(c=("fk", "size"),
                                               s=("val", "sum"))
    assert_frames_match(res, exp.sort_values("cat").reset_index(drop=True),
                        approx_cols=("s",))


def test_avg_decomposition(hdk, data):
    """AVG decomposes into SUM/COUNT partials + a restoring division;
    must match row-level AVG including NULL operands and duplicate
    build keys."""
    ldf, _, ddf = data
    l = hdk.scan("ea_l")
    d = hdk.scan("ea_rdup")
    q = l.join(d, "fk", "pk").agg(["cat"], "avg(val)", "count",
                                  "avg(qty)")
    assert _plan_has_agg_below_join(hdk.explain(q))
    res = q.run().to_pandas().sort_values("cat").reset_index(drop=True)
    m = ldf.merge(ddf, left_on="fk", right_on="pk")
    exp = m.groupby("cat", as_index=False).agg(
        avg_val=("val", "mean"), count=("val", "size"),
        avg_qty=("qty", "mean"))
    exp = exp.sort_values("cat").reset_index(drop=True)
    res.columns = list(exp.columns)
    assert_frames_match(res, exp, approx_cols=("avg_val", "avg_qty"))


def test_avg_with_nulls(hdk):
    rng = np.random.default_rng(123)
    n_l, n_r = 3000, 40
    val = rng.normal(size=n_l)
    val[rng.random(n_l) < 0.15] = np.nan
    ldf = pd.DataFrame({"fk": rng.integers(0, n_r, n_l), "val": val})
    hdk.import_pandas(ldf, name="ea_lavg")
    rdf = pd.DataFrame({"pk": np.arange(n_r), "cat": np.arange(n_r) % 5})
    hdk.import_pydict({"pk": rdf.pk.to_numpy(), "cat": rdf.cat.to_numpy()},
                      name="ea_ravg")
    res = hdk.sql(
        "SELECT cat, AVG(val) AS a FROM ea_lavg, ea_ravg "
        "WHERE fk = pk GROUP BY cat ORDER BY cat").to_pandas()
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby("cat", as_index=False).agg(a=("val", "mean"))
    assert_frames_match(res, exp.sort_values("cat").reset_index(drop=True),
                        approx_cols=("a",))


def test_eager_agg_in_dist_session():
    """The rewritten plan (pre-agg below join) must execute correctly
    over a sharded session: the pre-aggregate routes through the dist
    aggregation paths and the join through the dist join router."""
    import jax
    if len(jax.devices()) < 2:
        import pytest as _pt
        _pt.skip("needs multiple (virtual) devices")
    rng = np.random.default_rng(7)
    n_l, n_r = 4003, 64  # not divisible by 8: exercises pad+mask
    ldf = pd.DataFrame({"fk": rng.integers(0, n_r, n_l),
                        "val": rng.normal(size=n_l)})
    rdf = pd.DataFrame({"pk": np.arange(n_r), "cat": np.arange(n_r) % 4})
    h = hdk_jax.HDK(**{"dist.enable": True})
    h.config.exec.eager_agg_min_rows = 64
    h.config.exec.eager_agg_min_ratio = 1.0
    h.import_pandas(ldf, name="ea_dl")
    h.import_pandas(rdf, name="ea_dr")
    l, r = h.scan("ea_dl"), h.scan("ea_dr")
    q = l.join(r, "fk", "pk").agg(["cat"], "count", "sum(val)", "avg(val)")
    assert _plan_has_agg_below_join(h.explain(q))
    res = q.run().to_pandas().sort_values("cat").reset_index(drop=True)
    m = ldf.merge(rdf, left_on="fk", right_on="pk")
    exp = m.groupby("cat", as_index=False).agg(
        count=("val", "size"), sum_val=("val", "sum"),
        avg_val=("val", "mean"))
    res.columns = list(exp.columns)
    assert_frames_match(res, exp, approx_cols=("sum_val", "avg_val"))


# ---------------------------------------------------------------------------
# plan-level measured feedback (VERDICT r4 #7): the rewrite explores
# both plan variants once, then runs the measured winner — a mis-fired
# rewrite self-disables for that plan shape.
# ---------------------------------------------------------------------------

def test_plan_choice_feedback_state_machine():
    from hdk_jax.exec.feedback import PlanChoiceFeedback, RouteFeedback

    fb = PlanChoiceFeedback(RouteFeedback(enabled=True))
    sig = "plan-x"
    # explore sequence: rewrite cold -> rewrite timed -> original cold
    # -> original timed -> winner
    assert fb.choose(sig, ["rewrite", "original"]) == ("rewrite", "cold")
    assert fb.choose(sig, ["rewrite", "original"]) == ("rewrite", "timed")
    fb.record(sig, "rewrite", 2.0)
    assert fb.choose(sig, ["rewrite", "original"]) == ("original", "cold")
    assert fb.choose(sig, ["rewrite", "original"]) == ("original", "timed")
    fb.record(sig, "original", 0.5)
    assert fb.choose(sig, ["rewrite", "original"]) == ("original", None)
    # and the faster rewrite wins elsewhere
    sig2 = "plan-y"
    for _ in range(2):
        fb.choose(sig2, ["rewrite", "original"])
    fb.record(sig2, "rewrite", 0.1)
    for _ in range(2):
        fb.choose(sig2, ["rewrite", "original"])
    fb.record(sig2, "original", 0.9)
    assert fb.choose(sig2, ["rewrite", "original"]) == ("rewrite", None)


def test_rewrite_self_disables_when_measured_slower(data):
    sess = hdk_jax.HDK()
    sess.config.exec.eager_agg_min_rows = 64
    sess.config.exec.eager_agg_min_ratio = 1.0
    lhs, rhs, _ = data
    sess.import_pandas(lhs, name="pf_l")
    sess.import_pandas(rhs, name="pf_r")
    q = ("SELECT cat, SUM(val) AS s FROM pf_l JOIN pf_r "
         "ON pf_l.fk = pf_r.pk GROUP BY cat")

    executed_plans = []
    ex = sess._executor
    real_execute = type(ex).execute

    def spy(dag):
        from hdk_jax.exec.explain import explain_dag

        executed_plans.append(explain_dag(dag.root))
        return real_execute(ex, dag)

    ex.execute = spy
    # 4 exploration runs: rewrite cold/timed, original cold/timed
    for _ in range(4):
        sess.sql(q).to_pandas()
    assert len(executed_plans) == 4
    assert "Aggregate" in executed_plans[0]
    assert executed_plans[0] == executed_plans[1]  # rewrite twice
    assert executed_plans[2] == executed_plans[3]  # original twice
    assert executed_plans[0] != executed_plans[2]
    # force the decision: make the rewrite measure slower
    sig = [s for (s, v) in ex._plan_feedback._fb._t if v == "rewrite"][0]
    ex._plan_feedback._fb._t[(sig, "rewrite")] = 9.9
    ex._plan_feedback._fb._t[(sig, "original")] = 0.1
    res = sess.sql(q).to_pandas()
    # winner (original, agg above join) runs from now on
    assert executed_plans[-1] == executed_plans[2]
    exp = (lhs.merge(rhs, left_on="fk", right_on="pk")
           .groupby("cat")["val"].sum().reset_index(name="s"))
    assert_frames_match(res, exp)
    # and the reverse preference picks the rewrite
    ex._plan_feedback._fb._t[(sig, "rewrite")] = 0.1
    ex._plan_feedback._fb._t[(sig, "original")] = 9.9
    sess.sql(q).to_pandas()
    assert executed_plans[-1] == executed_plans[0]
