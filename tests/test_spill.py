"""Result spill-to-host under the device-memory budget (reference:
DataMgr 3-level buffer hierarchy, omniscidb/DataMgr/DataMgr.h — here
HBM-resident results offload to host numpy on LRU eviction and reload
transparently)."""

import numpy as np
import pytest

import hdk_jax
from hdk_jax.storage.memory import device_cache_manager


@pytest.fixture()
def hdk():
    return hdk_jax.HDK()


def test_explicit_offload_roundtrip(hdk):
    ht = hdk.import_pydict({"k": [1, 2, 1, 3], "v": [1., 2., 3., 4.]},
                           name="sp_t")
    res = ht.agg("k", "count", "sum(v)").run()
    first = res.to_pandas()
    res.offload()
    assert res._table is None and res._host_spill is not None
    again = res.to_pandas()
    assert first.equals(again)
    # chaining off a spilled result restores and queries it
    res.offload()
    s = res.scan
    out = s.filter(s["count"] > 1).run().to_pandas()
    assert out["k"].tolist() == [1]


def test_budget_evicts_lru_results(hdk):
    mgr = device_cache_manager()
    old_budget = mgr.budget
    rng = np.random.default_rng(2)
    ht = hdk.import_pydict({
        "k": rng.integers(0, 50_000, 200_000),
        "v": rng.normal(size=200_000),
    }, name="sp_big")
    try:
        results = []
        before = mgr.evictions
        mgr.set_budget(1 << 20)  # 1 MiB: a few results must spill
        for i in range(6):
            r = ht.proj(a=ht["k"] + i, b=ht["v"] * 2).run()
            r.block()
            results.append(r)
        assert mgr.evictions > before
        assert any(r._table is None for r in results[:3])
        # spilled results still read back correctly
        got = results[0].to_pandas()
        assert got["a"].tolist()[:3] == (np.asarray(
            ht.run().to_pandas()["k"][:3]) + 0).tolist()
    finally:
        mgr.set_budget(old_budget)


def test_spilled_schema_visible(hdk):
    ht = hdk.import_pydict({"x": [1, 2]}, name="sp_s")
    res = ht.proj(y=ht["x"] * 10).run()
    res.offload()
    assert [n for n, _ in res.schema] == ["y"]
    assert res.row_count == 2
