"""External-executor escape hatch: queries the native engine rejects
re-run through in-memory SQLite over the session's tables (reference:
ExternalExecutor.h:50, enable_interop fallback RelAlgExecutor.cpp:443).
"""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture()
def sess():
    return hdk_jax.HDK(**{"exec.enable_interop": True})


def test_unsupported_sql_falls_back_to_sqlite(sess):
    df = pd.DataFrame({"k": [1, 2, 3, 4], "v": [10.0, 20.0, 30.0, 40.0]})
    sess.import_pandas(df, name="io_t")
    # recursive CTE: unsupported by the native parser, valid SQLite
    res = sess.sql(
        "WITH RECURSIVE cnt(x) AS (SELECT 1 UNION ALL SELECT x+1 "
        "FROM cnt WHERE x < 3) "
        "SELECT t.k, t.v FROM io_t t JOIN cnt ON t.k = cnt.x "
        "ORDER BY t.k").to_pandas()
    exp = df[df["k"] <= 3].reset_index(drop=True)
    assert_frames_match(res, exp, ordered=True)


def test_interop_decodes_strings(sess):
    sess.import_pydict({"s": ["aa", "bb", "aa", None],
                        "v": [1, 2, 3, 4]}, name="io_s")
    res = sess.sql(
        "WITH RECURSIVE one(x) AS (SELECT 1) "
        "SELECT s, SUM(v) AS sv FROM io_s GROUP BY s ORDER BY s"
    ).to_pandas()
    exp = pd.DataFrame({"s": [None, "aa", "bb"], "sv": [4, 4, 2]})
    assert sorted([x for x in res["s"] if isinstance(x, str)]) == [
        "aa", "bb"]
    assert int(res.loc[res["s"] == "aa", "sv"].iloc[0]) == 4


def test_interop_off_by_default():
    sess = hdk_jax.HDK()
    sess.import_pydict({"k": [1]}, name="io_off")
    from hdk_jax.sql.lexer import SqlError

    with pytest.raises(SqlError):
        sess.sql("WITH RECURSIVE cnt(x) AS (SELECT 1) "
                 "SELECT * FROM cnt")


def test_interop_engine_error_surfaces_for_bad_sql(sess):
    from hdk_jax.sql.lexer import SqlError

    sess.import_pydict({"k": [1]}, name="io_bad")
    with pytest.raises(SqlError):
        sess.sql("SELECT nonexistent_col FROM io_bad")


def test_native_path_unaffected(sess):
    df = pd.DataFrame({"k": [1, 2, 2], "v": [1.0, 2.0, 3.0]})
    sess.import_pandas(df, name="io_n")
    res = sess.sql("SELECT k, SUM(v) AS s FROM io_n GROUP BY k "
                   "ORDER BY k").to_pandas()
    exp = df.groupby("k")["v"].sum().reset_index(name="s")
    assert_frames_match(res, exp, ordered=True)
