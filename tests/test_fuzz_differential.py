"""Seeded randomized differential fuzzing: builder-API queries composed
from random filters / group keys / aggregate mixes over random data,
checked against pandas (the reference's differential-oracle strategy,
generalized: ArrowBasedExecuteTest enumerates fixed shapes; this
samples the same space randomly but DETERMINISTICALLY — seeded, so
failures reproduce)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


N = 4000
COLS = ["a", "b", "c", "f", "g"]


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(1234)
    df = pd.DataFrame({
        "a": rng.integers(0, 12, N),
        "b": rng.integers(-30, 30, N),
        "c": rng.integers(0, 5, N),
        "f": np.round(rng.normal(0, 10, N), 4),
        "g": rng.integers(0, 3, N),
    })
    hdk = hdk_jax.HDK()
    t = hdk.import_pandas(df, name="fz")
    return hdk, t, df


def _rand_filter(rng, t, df):
    """(engine_predicate, pandas_mask) with 1-3 random conjuncts."""
    pred = None
    mask = pd.Series(True, index=df.index)
    for _ in range(int(rng.integers(1, 4))):
        col = COLS[int(rng.integers(0, len(COLS)))]
        op = int(rng.integers(0, 4))
        thr = float(np.round(rng.uniform(df[col].min(), df[col].max()), 2))
        if op == 0:
            c, m = t[col] > thr, df[col] > thr
        elif op == 1:
            c, m = t[col] <= thr, df[col] <= thr
        elif op == 2:
            iv = int(thr)
            c, m = t[col] == iv, df[col] == iv
        else:
            c, m = t[col] != int(thr), df[col] != int(thr)
        if pred is None or rng.random() < 0.7:
            pred = c if pred is None else (pred & c)
            mask = mask & m
        else:
            pred = pred | c
            mask = mask | m
    return pred, mask


AGGS = [
    ("count", lambda g, c: g.size()),
    ("sum", lambda g, c: g[c].sum()),
    ("min", lambda g, c: g[c].min()),
    ("max", lambda g, c: g[c].max()),
    ("avg", lambda g, c: g[c].mean()),
]


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_grouped_query(env, seed):
    hdk, t, df = env
    rng = np.random.default_rng(9000 + seed)
    pred, mask = _rand_filter(rng, t, df)
    sub = df[mask]
    keys = list(rng.choice(["a", "c", "g"],
                           size=int(rng.integers(1, 3)), replace=False))
    n_aggs = int(rng.integers(1, 4))
    agg_strs, pandas_aggs = [], []
    for _ in range(n_aggs):
        name, pfn = AGGS[int(rng.integers(0, len(AGGS)))]
        col = ["b", "f"][int(rng.integers(0, 2))]
        agg_strs.append("count" if name == "count" else f"{name}({col})")
        pandas_aggs.append((name, col, pfn))
    got = (t.filter(pred).agg(keys, *agg_strs)
           .run().to_pandas().sort_values(keys).reset_index(drop=True))
    if len(sub) == 0:
        assert len(got) == 0
        return
    grouped = sub.groupby(keys)
    exp = pd.DataFrame(index=grouped.size().index)
    for i, (name, col, pfn) in enumerate(pandas_aggs):
        exp[f"agg{i}"] = pfn(grouped, col)  # positional: engine keeps
        # duplicate aggregates with suffixed names, same order
    exp = exp.reset_index().sort_values(keys).reset_index(drop=True)
    exp.columns = list(got.columns)
    approx = tuple(c for c in got.columns if got[c].dtype.kind == "f")
    assert_frames_match(got, exp, approx_cols=approx)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_filter_project_sort(env, seed):
    hdk, t, df = env
    rng = np.random.default_rng(7000 + seed)
    pred, mask = _rand_filter(rng, t, df)
    key = ["a", "b", "f"][int(rng.integers(0, 3))]
    lim = int(rng.integers(1, 50))
    got = (t.filter(pred).proj(k=t[key], s=t["b"] + t["c"])
           .sort("k", limit=lim).run().to_pandas())
    sub = df[mask]
    exp = (pd.DataFrame({"k": sub[key], "s": sub["b"] + sub["c"]})
           .sort_values("k", kind="stable").head(lim).reset_index(drop=True))
    assert len(got) == len(exp)
    # sort is on k only: compare k exactly, s as multisets per k
    assert np.allclose(got["k"].to_numpy(np.float64),
                       exp["k"].to_numpy(np.float64))
    assert sorted(got["s"].tolist()) == sorted(exp["s"].tolist())
