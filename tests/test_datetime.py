"""Datetime semantics vs pandas (reference: ExtractFromTime.cpp,
DateTruncate.cpp, DateAdd.cpp tables; Tests date/time suites)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


@pytest.fixture(scope="module")
def ts_data(rng):
    # timestamps across years incl. pre-epoch, leap years, DST-free UTC
    base = pd.Timestamp("1965-01-01")
    offsets = rng.integers(0, 3650 * 4, 500)  # days over ~40 years
    secs = rng.integers(0, 86400, 500)
    ts = base + pd.to_timedelta(offsets, unit="D") + pd.to_timedelta(secs, unit="s")
    return pd.DataFrame({"ts": ts})


@pytest.fixture(scope="module")
def ht(hdk, ts_data):
    return hdk.import_pandas(ts_data, name="dt_t")


@pytest.mark.parametrize("field,pdattr", [
    ("year", lambda s: s.dt.year),
    ("quarter", lambda s: s.dt.quarter),
    ("month", lambda s: s.dt.month),
    ("day", lambda s: s.dt.day),
    ("hour", lambda s: s.dt.hour),
    ("minute", lambda s: s.dt.minute),
    ("second", lambda s: s.dt.second),
    ("doy", lambda s: s.dt.dayofyear),
    ("isodow", lambda s: s.dt.dayofweek + 1),
    ("dow", lambda s: (s.dt.dayofweek + 1) % 7),
    ("week", lambda s: s.dt.isocalendar().week.astype("int64")),
])
def test_extract(ht, ts_data, field, pdattr):
    res = ht.proj(x=ht["ts"].extract(field)).run().to_pandas()
    exp = pdattr(ts_data["ts"])
    np.testing.assert_array_equal(res["x"].to_numpy(), exp.to_numpy(),
                                  err_msg=field)


@pytest.mark.parametrize("field,freq", [
    ("year", "YS"), ("quarter", "QS"), ("month", "MS"),
    ("day", "D"), ("hour", "h"), ("minute", "min"),
])
def test_date_trunc(ht, ts_data, field, freq):
    res = ht.proj(x=ht["ts"].trunc(field)).run().to_pandas()
    if freq in ("YS", "QS", "MS"):
        exp = ts_data["ts"].dt.to_period(freq[0] if freq != "QS" else "Q").dt.start_time
    else:
        exp = ts_data["ts"].dt.floor(freq)
    np.testing.assert_array_equal(
        res["x"].to_numpy().astype("datetime64[us]"),
        exp.to_numpy().astype("datetime64[us]"), err_msg=field)


def test_trunc_week_is_monday(ht, ts_data):
    res = ht.proj(x=ht["ts"].trunc("week")).run().to_pandas()
    got = pd.to_datetime(res["x"])
    assert (got.dt.dayofweek == 0).all()
    assert ((ts_data["ts"].dt.normalize() - got).dt.days < 7).all()


@pytest.mark.parametrize("field,n", [
    ("day", 40), ("month", 5), ("year", 2), ("hour", -30), ("month", -13),
])
def test_date_add(ht, ts_data, field, n):
    res = ht.proj(x=ht["ts"].add_interval(n, field)).run().to_pandas()
    exp = ts_data["ts"] + pd.DateOffset(**{field + "s": n})
    np.testing.assert_array_equal(
        res["x"].to_numpy().astype("datetime64[us]"),
        exp.to_numpy().astype("datetime64[us]"), err_msg=f"{field}{n}")


def test_date_add_month_clamps(hdk):
    ht = hdk.import_pydict(
        {"d": np.asarray(["2020-01-31", "2020-02-29"], dtype="datetime64[s]")},
        name="clamp_t")
    res = ht.proj(x=ht["d"].add_interval(1, "month"),
                  y=ht["d"].add_interval(12, "month")).run().to_pandas()
    assert str(res["x"][0])[:10] == "2020-02-29"
    assert str(res["x"][1])[:10] == "2020-03-29"
    assert str(res["y"][1])[:10] == "2021-02-28"  # leap day + 1y clamps


def test_date_diff(hdk):
    ht = hdk.import_pydict({
        "a": np.asarray(["2020-01-31", "2020-03-01", "1969-06-01"],
                        dtype="datetime64[s]"),
        "b": np.asarray(["2020-03-01", "2020-01-31", "1972-06-01"],
                        dtype="datetime64[s]"),
    }, name="diff_t")
    res = ht.proj(d=ht["a"].diff("day", ht["b"]),
                  m=ht["a"].diff("month", ht["b"]),
                  y=ht["a"].diff("year", ht["b"])).run().to_pandas()
    assert list(res["d"]) == [30, -30, 1096]
    assert list(res["m"]) == [1, -1, 36]
    assert list(res["y"]) == [0, 0, 3]


def test_date32_column(hdk):
    dates = np.asarray(["2021-03-14", "1999-12-31", "1970-01-01"],
                       dtype="datetime64[D]")
    ht = hdk.import_pydict({"d": dates}, name="d32_t")
    res = ht.proj(y=ht["d"].extract("year"), m=ht["d"].extract("month"),
                  dom=ht["d"].extract("day")).run().to_pandas()
    assert list(res["y"]) == [2021, 1999, 1970]
    assert list(res["m"]) == [3, 12, 1]
    assert list(res["dom"]) == [14, 31, 1]


def test_timestamp_literal_compare(hdk, ht, ts_data):
    lit = hdk.timestamp("2000-01-01T00:00:00", unit="us")
    res = ht.filter(ht["ts"] >= lit).run()
    exp = (ts_data["ts"] >= pd.Timestamp("2000-01-01")).sum()
    assert res.row_count == exp


def test_extract_on_groupby_key(ht, ts_data):
    # the taxi Q3 pattern: GROUP BY extract(year from ts)
    res = ht.agg(ht["ts"].extract("year").name("y"), "count").run().to_pandas()
    exp = ts_data["ts"].dt.year.value_counts().sort_index()
    assert list(res.sort_values("y")["count"]) == list(exp.values)


# ---------------------------------------------------------------------------
# INTERVAL literals (VERDICT r1 missing #10): timestamp/date +/- INTERVAL
# ---------------------------------------------------------------------------

def test_interval_literal_arithmetic(hdk, rng):
    import sqlite3
    n = 300
    base = pd.to_datetime("2019-03-05 10:00:00")
    df = pd.DataFrame({
        "ts": base + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
        "v": rng.integers(0, 50, n),
    })
    ht = hdk.import_pandas(df, name="iv_t")
    con = sqlite3.connect(":memory:")
    df.to_sql("iv_t", con, index=False)

    got = hdk.sql("SELECT ts + INTERVAL '3' DAY AS a, "
                  "ts - INTERVAL '90' MINUTE AS b FROM iv_t").to_pandas()
    exp_a = df.ts + pd.Timedelta(days=3)
    exp_b = df.ts - pd.Timedelta(minutes=90)
    assert (pd.to_datetime(got["a"]).reset_index(drop=True) == exp_a).all()
    assert (pd.to_datetime(got["b"]).reset_index(drop=True) == exp_b).all()


def test_interval_month_calendar(hdk):
    df = pd.DataFrame({"d": pd.to_datetime(
        ["2020-01-31", "2020-02-29", "2019-12-15"])})
    ht = hdk.import_pandas(df, name="iv_m")
    got = hdk.sql("SELECT d + INTERVAL '1' MONTH AS m, "
                  "d + INTERVAL '1' YEAR AS y FROM iv_m").to_pandas()
    # calendar clamping: Jan 31 + 1 month = Feb 29 (leap 2020)
    assert str(pd.to_datetime(got["m"][0]).date()) == "2020-02-29"
    assert str(pd.to_datetime(got["m"][1]).date()) == "2020-03-29"
    assert str(pd.to_datetime(got["y"][0]).date()) == "2021-01-31"


def test_interval_in_filter(hdk, rng):
    n = 200
    dates = pd.to_datetime("2018-01-01") + pd.to_timedelta(
        rng.integers(0, 400, n), unit="D")
    df = pd.DataFrame({"d": dates})
    hdk.import_pandas(df, name="iv_f")
    got = hdk.sql("SELECT COUNT(*) AS c FROM iv_f "
                  "WHERE d < DATE '2018-01-10' + INTERVAL '20' DAY"
                  ).to_pandas()
    exp = int((dates < pd.Timestamp("2018-01-30")).sum())
    assert int(got["c"][0]) == exp


def test_extract_year_bounded_fast_path_boundaries(hdk):
    """Stats-bounded YEAR fast path (compare-adds against Jan-1 epoch
    boundaries; exec/scalar.py _extract_year_bounded): exact at year
    boundaries, leap days, and whole-second edges — differential
    against pandas over a deliberately boundary-heavy sample."""
    import calendar

    edges = []
    for y in range(2011, 2021):
        j1 = calendar.timegm((y, 1, 1, 0, 0, 0))
        edges += [j1 - 1, j1, j1 + 1]                  # new-year seconds
        edges.append(calendar.timegm((y, 12, 31, 23, 59, 59)))
        if y % 4 == 0:
            edges.append(calendar.timegm((y, 2, 29, 12, 0, 0)))
    rng = np.random.default_rng(5)
    span = (calendar.timegm((2021, 1, 1, 0, 0, 0))
            - calendar.timegm((2011, 1, 1, 0, 0, 0)))
    fill = calendar.timegm((2011, 1, 1, 0, 0, 0)) + rng.integers(
        0, span, 5000)
    secs = np.concatenate([np.array(edges, np.int64), fill])
    from hdk_jax import types as tt

    ht = hdk.import_pydict(
        {"ts": secs}, name="ybf_t",
        schema={"ts": tt.timestamp(tt.TimeUnit.SECOND, False)})
    got = ht.proj(y=ht["ts"].extract("year")).run().to_pandas()["y"]
    exp = pd.to_datetime(pd.Series(secs), unit="s").dt.year
    np.testing.assert_array_equal(got.to_numpy(), exp.to_numpy())


def test_extract_year_wide_span_falls_back(hdk):
    """>64-year spans use the civil-calendar kernel — same answers."""
    rng = np.random.default_rng(6)
    secs = rng.integers(-2_000_000_000, 4_000_000_000, 4000)  # ~1906-2096
    from hdk_jax import types as tt

    ht = hdk.import_pydict(
        {"ts": secs}, name="ybw_t",
        schema={"ts": tt.timestamp(tt.TimeUnit.SECOND, False)})
    got = ht.proj(y=ht["ts"].extract("year")).run().to_pandas()["y"]
    exp = pd.to_datetime(pd.Series(secs), unit="s").dt.year
    np.testing.assert_array_equal(got.to_numpy(), exp.to_numpy())
