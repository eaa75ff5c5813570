"""Window function tests vs pandas
(reference: WindowContext semantics, SURVEY.md A.6; pyhdk API
hdk.py:2791-2922 row_number/rank/... + over/order_by)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def data(rng):
    n = 500
    return pd.DataFrame({
        "g": rng.integers(0, 7, n),
        "o": rng.integers(0, 40, n),  # ordering column with ties
        "v": np.round(rng.normal(10, 5, n), 4),
    })


@pytest.fixture(scope="module")
def ht(hdk, data):
    return hdk.import_pandas(data, name="win_t")


def _sorted_out(df, res_cols):
    return df


def test_row_number(hdk, ht, data):
    res = ht.proj("g", "o", rn=hdk.row_number().over(ht["g"]).order_by(ht["o"])
                  ).run().to_pandas()
    # verify within our own output (sorting by g, o, rn must give rn 1..n)
    chk = res.sort_values(["g", "rn"])
    for g, grp in chk.groupby("g"):
        assert list(grp["rn"]) == list(range(1, len(grp) + 1))
        assert (np.diff(grp["o"]) >= 0).all()


def test_rank_dense_rank_sql(hdk, ht, data):
    res = hdk.sql(
        "SELECT g, o, RANK() OVER (PARTITION BY g ORDER BY o) AS r, "
        "DENSE_RANK() OVER (PARTITION BY g ORDER BY o) AS dr "
        "FROM win_t").to_pandas()
    exp_r = data.groupby("g")["o"].rank(method="min").astype(int)
    exp_dr = data.groupby("g")["o"].rank(method="dense").astype(int)
    np.testing.assert_array_equal(res["r"], exp_r)
    np.testing.assert_array_equal(res["dr"], exp_dr)


def test_percent_rank_cume_dist(hdk, ht, data):
    res = hdk.sql(
        "SELECT PERCENT_RANK() OVER (PARTITION BY g ORDER BY o) AS pr, "
        "CUME_DIST() OVER (PARTITION BY g ORDER BY o) AS cd FROM win_t"
    ).to_pandas()
    cnt = data.groupby("g")["o"].transform("size")
    rk = data.groupby("g")["o"].rank(method="min")
    exp_pr = ((rk - 1) / (cnt - 1).clip(lower=1)).where(cnt > 1, 0.0)
    exp_cd = data.groupby("g")["o"].rank(method="max") / cnt
    np.testing.assert_allclose(res["pr"], exp_pr, atol=1e-12)
    np.testing.assert_allclose(res["cd"], exp_cd, atol=1e-12)


def test_ntile(hdk, ht, data):
    res = hdk.sql("SELECT g, NTILE(4) OVER (PARTITION BY g ORDER BY o) AS nt "
                  "FROM win_t").to_pandas()
    assert res["nt"].between(1, 4).all()
    # tiles are near-equal sized per partition
    for g, grp in res.groupby("g"):
        sizes = grp["nt"].value_counts()
        assert sizes.max() - sizes.min() <= 1


def test_lag_lead(hdk, ht, data):
    res = ht.proj("g", "o", "v",
                  lg=ht["v"].lag(1).over(ht["g"]).order_by(ht["o"], ht["rowid"]),
                  ld=ht["v"].lead(1).over(ht["g"]).order_by(ht["o"], ht["rowid"]),
                  ).run().to_pandas()
    df = data.reset_index().rename(columns={"index": "rowid"})
    df = df.sort_values(["g", "o", "rowid"], kind="stable")
    exp_lg = df.groupby("g")["v"].shift(1)
    exp_ld = df.groupby("g")["v"].shift(-1)
    got = res.iloc[df.index]
    np.testing.assert_allclose(got["lg"].to_numpy(), exp_lg.to_numpy(),
                               equal_nan=True)
    np.testing.assert_allclose(got["ld"].to_numpy(), exp_ld.to_numpy(),
                               equal_nan=True)


def test_windowed_sum_whole_partition(hdk, ht, data):
    res = hdk.sql("SELECT g, SUM(v) OVER (PARTITION BY g) AS s, "
                  "COUNT(*) OVER (PARTITION BY g) AS c FROM win_t").to_pandas()
    exp_s = data.groupby("g")["v"].transform("sum")
    exp_c = data.groupby("g")["v"].transform("size")
    np.testing.assert_allclose(res["s"], exp_s, rtol=1e-9)
    np.testing.assert_array_equal(res["c"], exp_c)


def test_windowed_cumulative_sum(hdk, ht, data):
    res = ht.proj("g", "o", "v",
                  cs=ht["v"].sum().over(ht["g"]).order_by(ht["o"], ht["rowid"])
                  ).run().to_pandas()
    df = data.reset_index().rename(columns={"index": "rowid"})
    df = df.sort_values(["g", "o", "rowid"], kind="stable")
    exp = df.groupby("g")["v"].cumsum()
    got = res.iloc[df.index]
    np.testing.assert_allclose(got["cs"].to_numpy(), exp.to_numpy(), rtol=1e-9)


def test_first_last_value(hdk, ht, data):
    res = hdk.sql(
        "SELECT g, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY o) AS fv, "
        "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY o) AS lv FROM win_t"
    ).to_pandas()
    df = data.sort_values(["g", "o"], kind="stable")
    exp_fv = df.groupby("g")["v"].transform("first")
    exp_lv = df.groupby("g")["v"].transform("last")
    got = res.iloc[df.index]
    np.testing.assert_allclose(got["fv"].to_numpy(), exp_fv.to_numpy())
    np.testing.assert_allclose(got["lv"].to_numpy(), exp_lv.to_numpy())


def test_window_after_filter(hdk, ht, data):
    # window must see only filter-surviving rows (lazy row_mask)
    flt = ht.filter(ht["v"] > 10)
    res = flt.proj("g", rn=hdk.row_number().over(flt["g"]).order_by(flt["o"])
                   ).run().to_pandas()
    sub = data[data["v"] > 10]
    exp_counts = sub.groupby("g").size()
    got_counts = res.groupby("g")["rn"].max()
    for g in exp_counts.index:
        assert got_counts[g] == exp_counts[g]


def test_global_window_no_partition(hdk, ht, data):
    res = ht.proj(rn=hdk.row_number().over().order_by(ht["o"], ht["rowid"])
                  ).run().to_pandas()
    assert sorted(res["rn"]) == list(range(1, len(data) + 1))


# ---------------------------------------------------------------------------
# explicit frames (reference: WindowContext.h:67-140) + NTH_VALUE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_env(rng):
    import sqlite3
    n = 400
    df = pd.DataFrame({
        "g": rng.integers(0, 6, n),
        "o": rng.integers(0, 60, n),
        "v": np.round(rng.normal(5, 3, n), 4),
    })
    vn = df["v"].copy()
    vn[rng.random(n) < 0.1] = np.nan
    df["vn"] = vn
    sess = hdk_jax.HDK()
    sess.import_pandas(df, name="fw")
    con = sqlite3.connect(":memory:")
    df.to_sql("fw", con, index=False)
    return sess, con


def _fcheck(frame_env, sql):
    sess, con = frame_env
    got = sess.sql(sql).to_pandas()
    exp = pd.read_sql_query(sql, con)
    exp.columns = list(got.columns)[: len(exp.columns)]
    assert_frames_match(got, exp)


def test_rows_frame_sum(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, v, SUM(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS s FROM fw")


def test_rows_frame_moving_avg(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, AVG(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS m FROM fw")


def test_rows_frame_min_max(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, MIN(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS lo, "
            "MAX(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS hi FROM fw")


def test_rows_frame_count_nulls(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, COUNT(vn) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS c FROM fw")


def test_rows_frame_following_only(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, SUM(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 1 FOLLOWING AND 3 FOLLOWING) AS s FROM fw")


def test_rows_unbounded_following(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, SUM(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS s FROM fw")


def test_range_frame_offsets(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, COUNT(*) OVER (PARTITION BY g ORDER BY o "
            "RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS c, "
            "SUM(v) OVER (PARTITION BY g ORDER BY o "
            "RANGE BETWEEN 10 PRECEDING AND CURRENT ROW) AS s FROM fw")


def test_range_frame_desc(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, SUM(v) OVER (PARTITION BY g ORDER BY o DESC "
            "RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS s FROM fw")


def test_nth_value(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, NTH_VALUE(v, 2) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) "
            "AS nv FROM fw")


def test_first_last_with_frame(frame_env):
    _fcheck(frame_env,
            "SELECT g, o, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS f, "
            "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY o, v "
            "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS l FROM fw")


def test_frame_on_rank_rejected(frame_env):
    sess, _ = frame_env
    with pytest.raises(Exception, match="frame"):
        sess.sql("SELECT RANK() OVER (PARTITION BY g ORDER BY o "
                 "ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM fw"
                 ).to_pandas()


def test_builder_frame_api(frame_env, rng):
    sess, _ = frame_env
    ht = sess.scan("fw")
    res = ht.proj("g", "o", "v",
                  s=ht["v"].sum().over(ht["g"]).order_by(ht["o"], ht["v"])
                  .frame("rows", ("preceding", 2), "current_row")
                  ).run().to_pandas()
    exp = (res.sort_values(["g", "o", "v"]).groupby("g")["v"]
           .rolling(3, min_periods=1).sum().reset_index(level=0, drop=True))
    got = res.sort_values(["g", "o", "v"])["s"]
    np.testing.assert_allclose(got.to_numpy(), exp.to_numpy(), rtol=1e-9)
