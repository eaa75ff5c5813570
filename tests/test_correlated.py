"""Correlated subqueries, decorrelated to SEMI/ANTI/LEFT joins
(reference shapes: CorrelatedSubqueryTest.cpp).  Oracle: sqlite3."""

import sqlite3

import numpy as np
import pandas as pd
import pytest

import hdk_jax

from harness import assert_frames_match


@pytest.fixture(scope="module")
def env(rng):
    n = 800
    df = pd.DataFrame({
        "k": rng.integers(0, 12, n),
        "v": rng.integers(0, 100, n),
        "x": np.round(rng.normal(10, 5, n), 6),
    })
    dn = pd.DataFrame({
        "k": rng.integers(0, 15, 300),
        "w": rng.integers(0, 100, 300),
    })
    wn = dn["w"].astype("float64").copy()
    wn[rng.random(300) < 0.15] = np.nan
    dn["wn"] = wn
    hdk = hdk_jax.HDK()
    hdk.import_pandas(df, name="a")
    hdk.import_pandas(dn, name="b")
    con = sqlite3.connect(":memory:")
    df.to_sql("a", con, index=False)
    dn.to_sql("b", con, index=False)
    return hdk, con


def check(env, sql, ordered=False):
    hdk, con = env
    got = hdk.sql(sql).to_pandas()
    exp = pd.read_sql_query(sql, con)
    exp.columns = list(got.columns)[: len(exp.columns)]
    assert_frames_match(got, exp, ordered=ordered)


def test_correlated_exists(env):
    check(env, "SELECT k, v FROM a WHERE EXISTS "
               "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > 90)")


def test_correlated_not_exists(env):
    check(env, "SELECT k, COUNT(*) AS c FROM a WHERE NOT EXISTS "
               "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > 95) GROUP BY k")


def test_correlated_in(env):
    check(env, "SELECT k, v FROM a WHERE v IN "
               "(SELECT w FROM b WHERE b.k = a.k)")


def test_correlated_not_in(env):
    check(env, "SELECT k, v FROM a WHERE v NOT IN "
               "(SELECT w FROM b WHERE b.k = a.k)")


def test_correlated_not_in_nullable(env):
    # per-group 3VL: groups whose value set contains NULL yield no rows
    check(env, "SELECT k, v FROM a WHERE v NOT IN "
               "(SELECT wn FROM b WHERE b.k = a.k)")


def test_correlated_scalar_agg(env):
    check(env, "SELECT k, v FROM a WHERE v > "
               "(SELECT AVG(w) FROM b WHERE b.k = a.k)")


def test_correlated_scalar_max_flipped_eq(env):
    check(env, "SELECT k, v FROM a WHERE "
               "(SELECT MAX(w) FROM b WHERE a.k = b.k) < v + 10")


def test_correlated_scalar_count_empty_is_zero(env):
    # COUNT over an empty correlated set is 0 (LEFT-join NULL -> 0):
    # rows of a with k not present in b must satisfy "= 0"
    check(env, "SELECT k, COUNT(*) AS c FROM a WHERE "
               "(SELECT COUNT(*) FROM b WHERE b.k = a.k AND b.w > 50) = 0 "
               "GROUP BY k")


def test_correlated_scalar_in_arithmetic(env):
    check(env, "SELECT k FROM a WHERE "
               "x + (SELECT AVG(w) FROM b WHERE b.k = a.k) > 60")


def test_correlated_with_extra_inner_filter(env):
    check(env, "SELECT k, v FROM a WHERE EXISTS "
               "(SELECT 1 FROM b WHERE b.k = a.k AND b.w < 20)")


def test_correlated_non_equality_raises(env):
    hdk, _ = env
    with pytest.raises(Exception):
        hdk.sql("SELECT k FROM a WHERE EXISTS "
                "(SELECT 1 FROM b WHERE b.w < a.v)").to_pandas()


def test_two_correlated_predicates(env):
    check(env, "SELECT k, v FROM a WHERE v > "
               "(SELECT AVG(w) FROM b WHERE b.k = a.k) AND EXISTS "
               "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > 80)")


def test_uncorrelated_still_works(env):
    check(env, "SELECT k, v FROM a WHERE v IN (SELECT w FROM b)")
    check(env, "SELECT k FROM a WHERE v > (SELECT AVG(w) FROM b)")
