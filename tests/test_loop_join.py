"""Loop (cartesian) joins: CROSS JOIN, comma-FROM products, non-equi ON
(reference: IRCodegen.cpp:513 loop-join fallback).  Oracle: sqlite3."""

import sqlite3

import numpy as np
import pandas as pd
import pytest

import hdk_jax

from harness import assert_frames_match


@pytest.fixture(scope="module")
def env(rng):
    a = pd.DataFrame({"x": rng.integers(0, 20, 60),
                      "u": rng.normal(size=60).round(6)})
    b = pd.DataFrame({"y": rng.integers(0, 20, 35),
                      "w": rng.integers(0, 9, 35)})
    hdk = hdk_jax.HDK()
    hdk.import_pandas(a, name="a")
    hdk.import_pandas(b, name="b")
    con = sqlite3.connect(":memory:")
    a.to_sql("a", con, index=False)
    b.to_sql("b", con, index=False)
    return hdk, con


def check(env, sql, ordered=False):
    hdk, con = env
    got = hdk.sql(sql).to_pandas()
    exp = pd.read_sql_query(sql, con)
    exp.columns = list(got.columns)[: len(exp.columns)]
    assert_frames_match(got, exp, ordered=ordered)


def test_explicit_cross_join(env):
    check(env, "SELECT x, y FROM a CROSS JOIN b WHERE x = 3 AND w = 1")


def test_comma_from_product(env):
    check(env, "SELECT COUNT(*) AS c FROM a, b")


def test_comma_from_filtered(env):
    check(env, "SELECT x, y, w FROM a, b WHERE x + 1 = y AND u > 0")


def test_non_equi_on(env):
    check(env, "SELECT x, y FROM a JOIN b ON x < y WHERE w = 2")


def test_inner_cap_enforced(env, rng):
    hdk, _ = env
    big = pd.DataFrame({"z": np.arange(9000)})
    hdk.import_pandas(big, name="big")
    with pytest.raises(Exception, match="loop_join_inner_table_max"):
        hdk.sql("SELECT COUNT(*) AS c FROM a, big").to_pandas()


def test_loop_join_disabled():
    sess = hdk_jax.HDK(**{"exec.join.enable_loop_join": False})
    sess.import_pydict({"x": [1, 2]}, name="p")
    sess.import_pydict({"y": [3]}, name="q")
    with pytest.raises(Exception, match="enable_loop_join"):
        sess.sql("SELECT * FROM p, q").to_pandas()


def test_builder_non_equi_left_raises(env):
    hdk, _ = env
    with pytest.raises(Exception, match="equality"):
        hdk.sql("SELECT x FROM a LEFT JOIN b ON x < y").to_pandas()
