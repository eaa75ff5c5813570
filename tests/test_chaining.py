"""Multi-step plans, result chaining, union, optimizer
(reference: ResultSetRegistry chaining hdk.py:2518; ExecutionSequenceTest)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def ht(hdk):
    return hdk.import_pydict({
        "g": [1, 1, 2, 2, 3, 3, 3],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0],
    }, name="chain_t")


def test_result_scan_chain(ht):
    res1 = ht.agg("g", "sum(v)").run()
    node = res1.scan
    res2 = node.filter(node["v_sum"] > 4).sort("g").run().to_pandas()
    exp = pd.DataFrame({"g": [2, 3], "v_sum": [7.0, 18.0]})
    assert_frames_match(res2, exp, ordered=True)


def test_deep_pipeline_single_run(ht):
    # multi-node DAG executed in one run (topo-ordered steps)
    n = ht.filter(ht["v"] > 1.5).proj("g", w=ht["v"] * 2).agg("g", "sum(w)")
    out = n.sort("g").run().to_pandas()
    exp = pd.DataFrame({"g": [1, 2, 3], "w_sum": [4.0, 14.0, 36.0]})
    assert_frames_match(out, exp, ordered=True)


def test_union_all(hdk):
    t1 = hdk.import_pydict({"a": [1, 2], "b": [1.0, 2.0]}, name="u1")
    t2 = hdk.import_pydict({"a": [3], "b": [3.0]}, name="u2")
    out = t1.union_all(t2).sort("a").run().to_pandas()
    assert list(out["a"]) == [1, 2, 3]


def test_union_type_promotion(hdk):
    t1 = hdk.import_pydict({"a": np.asarray([1, 2], np.int32)}, name="up1")
    t2 = hdk.import_pydict({"a": [3.5]}, name="up2")
    out = t1.union_all(t2).run().to_pandas()
    assert sorted(out["a"]) == [1.0, 2.0, 3.5]


def test_self_join_via_two_scans(hdk, ht):
    other = hdk.scan("chain_t")
    res = ht.join(other, "g", "g").agg([], "count").run().to_pandas()
    # each group g contributes n_g^2 pairs: 4 + 4 + 9
    assert res["count"][0] == 17


def test_shared_subtree_executes_once(ht):
    base = ht.filter(ht["v"] > 2)
    a = base.agg("g", "count")
    res = a.run().to_pandas()
    assert res["count"].sum() == 5


def test_optimizer_identity_projection_removed(ht):
    from hdk_jax.exec.optimizer import eliminate_identity_projections
    from hdk_jax.ir import node as nd

    proj = ht.proj()  # identity
    dag = nd.QueryDag(nd.Filter(proj.node, (proj["v"] > 0).expr))
    out = eliminate_identity_projections(dag)
    assert isinstance(out.root, nd.Filter)
    assert isinstance(out.root.inputs[0], nd.Scan)


def test_optimizer_filter_fold(ht):
    from hdk_jax.exec.optimizer import fold_filters
    from hdk_jax.ir import node as nd

    f1 = nd.Filter(ht.node, (ht["v"] > 1).expr)
    import hdk_jax.builder as b

    cond2 = b._rebase((ht["v"] < 6).expr, ht.node, f1)
    f2 = nd.Filter(f1, cond2)
    out = fold_filters(nd.QueryDag(f2))
    assert isinstance(out.root, nd.Filter)
    assert isinstance(out.root.inputs[0], nd.Scan)


def test_folded_filter_still_correct(ht):
    out = ht.filter(ht["v"] > 1).filter(ht["v"] > 1.5, ht["v"] < 6).run()
    assert out.row_count == 4


def test_head(ht):
    res = ht.run()
    h = res.head(3)
    assert h.num_rows == 3


def test_timer_report(hdk, ht):
    hdk_jax.enable_debug_timer(True)
    try:
        ht.agg("g", "count").run()
        rep = hdk_jax.timer_report()
    finally:
        hdk_jax.enable_debug_timer(False)
    assert rep is None or "ms" in rep
