"""Infra: explain, watchdog, config, code cache
(reference: EXPLAIN Execute.h:459; DynamicWatchdog; Config tree)."""

import pytest

import hdk_jax
from hdk_jax.config import build_config


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def ht(hdk):
    return hdk.import_pydict({"k": [1, 2, 1, 3], "v": [1., 2., 3., 4.]},
                             name="infra_t")


def test_explain_builder(hdk, ht):
    plan = hdk.explain(ht.filter(ht["v"] > 1).agg("k", "sum(v)").sort("k"))
    assert "Sort" in plan and "Aggregate" in plan and "Filter" in plan
    assert "Scan(infra_t" in plan


def test_explain_sql(hdk, ht):
    plan = hdk.explain("SELECT k, COUNT(*) FROM infra_t GROUP BY k")
    assert "Aggregate" in plan and "Scan" in plan


def test_just_explain_option(hdk, ht):
    out = ht.agg("k", "count").run(just_explain=True)
    assert isinstance(out, str) and "Aggregate" in out


def test_watchdog_row_budget():
    session = hdk_jax.HDK(**{"exec.watchdog.enable": True,
                             "exec.watchdog.max_rows_per_step": 2})
    ht = session.import_pydict({"a": [1, 2, 3, 4, 5]}, name="wd_t")
    with pytest.raises(Exception, match="watchdog"):
        ht.agg("a", "count").run()


def test_config_tree():
    cfg = build_config(fragment_size=123, hll_precision=12,
                       **{"exec.watchdog.enable": True})
    assert cfg.storage.fragment_size == 123
    assert cfg.exec.group_by.hll_precision == 12
    assert cfg.exec.watchdog.enable is True
    with pytest.raises(ValueError):
        build_config(bogus_option=1)


def test_code_cache_hits(hdk, ht):
    ex = hdk._executor
    before = ex.code_cache.hits
    ht.agg("k", "count").run()
    ht.agg("k", "count").run()  # same plan: cached step callable
    assert ex.code_cache.hits > before


def test_timer_tree(hdk, ht):
    hdk_jax.enable_debug_timer(True)
    try:
        ht.agg("k", "count").run()
        rep = hdk_jax.timer_report()
        assert rep and "ms" in rep
    finally:
        hdk_jax.enable_debug_timer(False)


def test_device_cache_budget_eviction():
    import numpy as np
    from hdk_jax.storage.memory import device_cache_manager

    session = hdk_jax.HDK(device_cache_budget_bytes=4 * 8 * 1000)  # 4 cols
    mgr = device_cache_manager()
    before = mgr.evictions
    data = {f"c{i}": np.arange(1000, dtype=np.int64) for i in range(8)}
    ht = session.import_pydict(data, name="mem_t")
    for i in range(8):  # touch every column -> must exceed the budget
        ht.agg([], f"sum(c{i})").run()
    assert mgr.evictions > before
    assert mgr.resident_bytes <= 4 * 8 * 1000
    # correctness survives eviction: evicted columns re-transfer
    out = ht.agg([], "sum(c0)", "sum(c7)").run().to_pandas()
    assert out["c0_sum"][0] == out["c7_sum"][0] == 499500
    from hdk_jax.storage.memory import default_budget

    device_cache_manager().set_budget(default_budget())


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self._stats = platform, stats
        self.device_kind = f"fake {platform}"

    def memory_stats(self):
        return self._stats


def test_default_budget_fraction_of_device_limit():
    from hdk_jax.storage import memory

    dev = _FakeDevice("gpu", {"bytes_limit": 60 << 30,
                              "bytes_in_use": 1 << 20})
    assert memory.default_budget(dev) == int(
        (60 << 30) * memory.BUDGET_FRACTION)


def test_default_budget_fixed_on_cpu():
    import jax

    from hdk_jax.storage import memory

    assert memory.default_budget(_FakeDevice("cpu", None)) == \
        memory.HOST_BUDGET
    assert memory.default_budget() == memory.HOST_BUDGET  # tests run on CPU
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_default_budget_refuses_accelerator_without_stats(stats):
    from hdk_jax.storage import memory

    with pytest.raises(RuntimeError, match="no memory limit"):
        memory.default_budget(_FakeDevice("gpu", stats))


def test_compile_cache_dir_follows_environment():
    import os

    from hdk_jax import _compile_cache_dir

    assert _compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        hdk_jax.__file__)))
    assert _compile_cache_dir({}) == os.path.join(root, ".jax_cache")


def test_compile_cache_dir_applied_at_import():
    import os

    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        assert jax.config.jax_compilation_cache_dir == \
            os.environ["JAX_COMPILATION_CACHE_DIR"]
    else:
        assert jax.config.jax_compilation_cache_dir == \
            hdk_jax._compile_cache_dir({})


def test_explain_analyze(rng):
    """EXPLAIN ANALYZE executes the query with every step forced and
    annotates plan lines with [ms, rows] (the EXPLAIN + DebugTimer
    DurationTree combination)."""
    import re

    import hdk_jax

    hdk = hdk_jax.HDK()
    t = hdk.import_pydict({"k": rng.integers(0, 5, 2000),
                           "v": rng.integers(0, 50, 2000)}, name="ea_t")
    q = t.filter(t["v"] > 10).agg("k", "count", "sum(v)").sort("k")
    plain = hdk.explain(q)
    assert "ms," not in plain  # no annotations without analyze
    analyzed = hdk.explain(q, analyze=True)
    stamps = re.findall(r"\[(\d+\.\d) ms, (\d+) rows\]", analyzed)
    assert stamps, analyzed
    # the terminal step reports the (possibly fused) output rows
    assert any(int(rows) <= 6 for _ms, rows in stamps), analyzed
    assert not hdk._executor._analyze  # flag resets even on success
