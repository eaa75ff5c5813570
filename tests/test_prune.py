"""Fragment skipping (exec/prune.py): min/max-stat pruning of scan
fragments (reference: Execute.h:540 skipFragmentPair) with bucket-padded
gathers.  Differential oracle: pandas on the full frame."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from hdk_jax.exec import prune

from harness import assert_frames_match


@pytest.fixture()
def sess():
    # small fragments so a 1200-row table has 12 fragments
    return hdk_jax.HDK(**{"storage.fragment_size": 100})


@pytest.fixture()
def frame(rng):
    n = 1200
    return pd.DataFrame({
        "d": np.arange(n) // 10,          # ordered: prunes well
        "v": rng.normal(size=n),
        "k": rng.integers(0, 5, n),
        "u": rng.integers(0, 10**6, n),   # unordered: every frag overlaps
    })


def _stats(sess):
    return sess._executor._frag_prune_stats


def test_range_filter_prunes(sess, frame):
    ht = sess.import_pandas(frame, name="t")
    res = ht.filter((ht["d"] >= 40) & (ht["d"] < 50)).agg(
        "k", "count", "sum(v)").run().to_pandas()
    exp = (frame[(frame.d >= 40) & (frame.d < 50)]
           .groupby("k").agg(count=("v", "size"), v_sum=("v", "sum"))
           .reset_index())
    exp.columns = ["k", "count", "v_sum"]
    assert_frames_match(res, exp)
    st = _stats(sess)
    assert st is not None and st["selected"] < st["total"]
    # rows 400..499 live in fragments 4 (400-499): exactly 1 of 12
    assert st["selected"] == 1 and st["total"] == 12


def test_eq_filter_prunes_projection(sess, frame):
    ht = sess.import_pandas(frame, name="t2")
    res = ht.filter(ht["d"] == 77).proj("d", "v").run().to_pandas()
    exp = frame[frame.d == 77][["d", "v"]].reset_index(drop=True)
    assert_frames_match(res, exp)
    assert _stats(sess)["selected"] == 1


def test_unprunable_column_still_correct(sess, frame):
    ht = sess.import_pandas(frame, name="t3")
    sess._executor._frag_prune_stats = None
    res = ht.filter(ht["u"] < 500000).agg("k", "count").run().to_pandas()
    exp = (frame[frame.u < 500000].groupby("k").size()
           .reset_index(name="count"))
    assert_frames_match(res, exp)


def test_empty_selection(sess, frame):
    ht = sess.import_pandas(frame, name="t4")
    res = ht.filter(ht["d"] > 10**6).agg("k", "count").run().to_pandas()
    assert len(res) == 0


def test_isnull_pruning(sess, rng):
    n = 600
    df = pd.DataFrame({"a": rng.normal(size=n), "g": rng.integers(0, 3, n)})
    df.loc[df.index[:50], "a"] = np.nan  # nulls only in fragment 0
    ht = sess.import_pandas(df, name="t5")
    res = ht.filter(ht["a"].is_null()).agg("g", "count").run().to_pandas()
    exp = (df[df.a.isna()].groupby("g").size().reset_index(name="count"))
    assert_frames_match(res, exp)
    st = _stats(sess)
    assert st["selected"] == 1 and st["total"] == 6


def test_in_list_pruning(sess, frame):
    ht = sess.import_pandas(frame, name="t6")
    res = sess.sql("SELECT k, COUNT(*) AS c FROM t6 "
                   "WHERE d IN (13, 14) GROUP BY k").to_pandas()
    exp = (frame[frame.d.isin([13, 14])].groupby("k").size()
           .reset_index(name="c"))
    assert_frames_match(res, exp)
    assert _stats(sess)["selected"] == 1


def test_sql_between_dates(sess, rng):
    n = 1000
    dates = pd.to_datetime("2015-01-01") + pd.to_timedelta(
        np.arange(n) // 2, unit="D")
    df = pd.DataFrame({"dt": dates, "x": rng.normal(size=n)})
    ht = sess.import_pandas(df, name="t7")
    res = sess.sql(
        "SELECT COUNT(*) AS c, SUM(x) AS s FROM t7 "
        "WHERE dt >= DATE '2015-09-01' AND dt < DATE '2015-10-01'"
    ).to_pandas()
    sel = df[(df.dt >= "2015-09-01") & (df.dt < "2015-10-01")]
    assert int(res["c"][0]) == len(sel)
    np.testing.assert_allclose(float(res["s"][0]), sel.x.sum(), rtol=1e-9)
    st = _stats(sess)
    assert st is not None and st["selected"] < st["total"]


def test_prune_disabled_flag(frame):
    sess = hdk_jax.HDK(**{"storage.fragment_size": 100,
                          "exec.enable_fragment_skipping": False})
    ht = sess.import_pandas(frame, name="t8")
    res = ht.filter(ht["d"] == 5).agg("k", "count").run().to_pandas()
    exp = frame[frame.d == 5].groupby("k").size().reset_index(name="count")
    assert_frames_match(res, exp)
    assert sess._executor._frag_prune_stats is None


def test_bucket_shapes_shared():
    assert prune.pad_bucket(100) == 104
    assert prune.pad_bucket(1) == 64
    assert prune.pad_bucket(1024) == 1024
    assert prune.pad_bucket(1025) == 1152
