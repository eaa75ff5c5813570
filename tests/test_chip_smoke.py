"""chip_smoke.py's phases at a tiny scale on CPU: each phase's
generator, query and numpy reference run through the engine, and the
numpy reference is itself checked against sqlite3 on the same data.
The full-size run needs a GPU (``gpu`` marker)."""

import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import hdk_jax  # noqa: E402

SCALE = 2e-5  # 2,000 taxi rows, 1,200 lineitem rows, 2,000 probe rows

# test case -> (chip_smoke dataset, its queries)
CASES = {
    "tpch_q1": ("tpch_q1_q6", ["tpch_q1"]),
    "tpch_q6": ("tpch_q1_q6", ["tpch_q6"]),
    "tpch_q3": ("tpch_q3", ["tpch_q3"]),
    "taxi_q1": ("taxi", ["taxi_q1"]),
    "taxi_q2": ("taxi", ["taxi_q2"]),
    "taxi_q3": ("taxi", ["taxi_q3"]),
    "taxi_q4": ("taxi", ["taxi_q4"]),
    "join": ("join", ["join"]),
    "high_ndv": ("high_ndv", ["high_ndv", "high_ndv_top100"]),
}


def _sqlite_columns(sql, tables):
    conn = sqlite3.connect(":memory:")
    try:
        for name, cols in tables.items():
            names = list(cols)
            conn.execute(f"CREATE TABLE {name} ({', '.join(names)})")
            rows = zip(*[np.asarray(cols[n]).tolist() for n in names])
            conn.executemany(
                f"INSERT INTO {name} VALUES "
                f"({', '.join('?' * len(names))})", rows)
        rows = conn.execute(sql).fetchall()
    finally:
        conn.close()
    return [np.asarray(c) for c in zip(*rows)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_matches_reference_and_sqlite(case):
    dataset, names = CASES[case]
    session = hdk_jax.HDK()
    queries = {q.name: q for q in chip_smoke.DATASETS[dataset](session,
                                                               SCALE)}
    for name in names:
        q = queries[name]
        q.check(chip_smoke.result_columns(q.run()))
        sql, tables = q.sqlite
        q.check(_sqlite_columns(sql, tables))


def test_q3_without_pyarrow(monkeypatch):
    """The main path (pydict ingest with a dictionary-encoded string
    column, SQL, numpy readback) needs no pyarrow: Q3 still matches."""
    from hdk_jax.storage import importers

    monkeypatch.setattr(importers, "pa", None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)  # import fails
    session = hdk_jax.HDK()
    (q,) = chip_smoke.DATASETS["tpch_q3"](session, SCALE)
    q.check(chip_smoke.result_columns(q.run()))


def test_arrow_readback_without_pyarrow_is_a_clear_error(monkeypatch):
    from hdk_jax.exec import materialize

    session = hdk_jax.HDK()
    res = session.import_pydict({"k": [1, 2, 1]}, name="no_arrow").agg(
        "k", "count").run()
    monkeypatch.setattr(materialize, "pa", None)
    with pytest.raises(ImportError, match="to_numpy"):
        res.to_arrow()
    assert sorted(res.to_numpy()["count"].tolist()) == [1, 2]


def test_mismatch_is_an_error():
    want = [np.asarray([1, 2]), np.asarray([1.0, 2.0])]
    assert chip_smoke.compare(want, want, ["exact", "f64"]) == 0.0
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare([np.asarray([1, 3]), want[1]], want,
                           ["exact", "f64"])
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare([want[0], np.asarray([1.0, 2.001])], want,
                           ["exact", "f32"])


def test_refuses_to_run_without_gpu(monkeypatch, capsys):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"platform": "gpu"' in out.stdout.splitlines()[-1]
