"""Array columns: list ingest, CARDINALITY, subscript, UNNEST
(reference: IR/Type.h FixedLen/VarLenArray, IR/Expr.h ArrayExpr/
Cardinality, Calcite UNNEST)."""

import numpy as np
import pandas as pd
import pytest

import hdk_jax
from harness import assert_frames_match


@pytest.fixture()
def hdk():
    return hdk_jax.HDK()


@pytest.fixture()
def ht(hdk):
    return hdk.import_pydict({
        "id": [1, 2, 3, 4],
        "xs": [[1, 2, 3], [4], None, [5, 6]],
    }, name="arr_t")


def test_array_ingest_roundtrip(ht):
    out = ht.run().to_pandas()
    assert [list(x) for x in out["xs"]] == [[1, 2, 3], [4], [], [5, 6]]


def test_cardinality(hdk, ht):
    out = ht.proj(id=ht["id"], n=ht["xs"].cardinality()).run().to_pandas()
    assert out["n"].tolist() == [3, 1, 0, 2]
    res = hdk.sql("SELECT CARDINALITY(xs) AS n FROM arr_t").to_pandas()
    assert res["n"].tolist() == [3, 1, 0, 2]


def test_subscript(ht):
    out = ht.proj(a0=ht["xs"].at(0), a2=ht["xs"].at(2)).run().to_pandas()
    assert out["a0"].tolist()[:2] == [1, 4]
    assert pd.isna(out["a0"].iloc[2])
    assert out["a2"].iloc[0] == 3
    assert pd.isna(out["a2"].iloc[1])


def test_unnest(ht):
    out = ht.unnest("xs").run().to_pandas()
    assert out["id"].tolist() == [1, 1, 1, 2, 4, 4]
    assert out["xs"].tolist() == [1, 2, 3, 4, 5, 6]


def test_unnest_then_aggregate(hdk, ht):
    out = (ht.unnest("xs").agg("id", "count", "sum(xs)").run().to_pandas())
    exp = pd.DataFrame({"id": [1, 2, 4], "count": [3, 1, 2],
                        "xs_sum": [6, 4, 11]})
    assert_frames_match(out, exp)


def test_topk_result_chain_unnest(hdk):
    rng = np.random.default_rng(5)
    t2 = hdk.import_pydict({
        "g": rng.integers(0, 3, 100),
        "v": rng.integers(0, 1000, 100),
    }, name="arr_src")
    res = t2.agg("g", t2["v"].top_k(3).name("t")).run()
    sc = res.scan
    out = sc.unnest("t").run().to_pandas()
    assert len(out) == 9


def test_sql_unnest(hdk, ht):
    res = hdk.sql(
        "SELECT id, e FROM arr_t, UNNEST(xs) AS e ORDER BY id, e").to_pandas()
    assert res["id"].tolist() == [1, 1, 1, 2, 4, 4]
    assert res["e"].tolist() == [1, 2, 3, 4, 5, 6]
    agg = hdk.sql(
        "SELECT id, COUNT(*) AS n, SUM(e) AS s FROM arr_t, "
        "UNNEST(arr_t.xs) AS e GROUP BY id ORDER BY id").to_pandas()
    assert agg["n"].tolist() == [3, 1, 2]
    assert agg["s"].tolist() == [6, 4, 11]


def test_arrow_and_parquet_list_ingest(hdk, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    tbl = pa.table({
        "id": [1, 2, 3],
        "xs": pa.array([[1.5, 2.5], None, [3.0]],
                       type=pa.list_(pa.float64())),
    })
    ht = hdk.import_arrow(tbl, name="arr_pa")
    out = ht.run().to_pandas()
    assert [list(x) for x in out["xs"]] == [[1.5, 2.5], [], [3.0]]
    res = hdk.sql("SELECT id, CARDINALITY(xs) AS n FROM arr_pa "
                  "ORDER BY id").to_pandas()
    assert res["n"].tolist() == [2, 0, 1]

    path = str(tmp_path / "a.parquet")
    pq.write_table(tbl, path)
    hp = hdk.import_parquet(path, name="arr_pq")
    out2 = hp.unnest("xs").run().to_pandas()
    assert out2["xs"].tolist() == [1.5, 2.5, 3.0]


def test_null_elements_and_append(hdk):
    ht = hdk.import_pydict({"id": [1, 2], "xs": [[1, None, 3], None]},
                           name="arr_n")
    out = ht.proj(n=ht["xs"].cardinality()).run().to_pandas()
    assert out["n"].tolist() == [2, 0]
    hdk.append_pydict("arr_n", {"id": [3], "xs": [[7, 8]]})
    out2 = hdk.scan("arr_n").unnest("xs").run().to_pandas()
    assert out2["xs"].tolist() == [1, 3, 7, 8]


def test_union_of_arrays_and_empty(hdk):
    a = hdk.import_pydict({"xs": [[1, 2, 3]]}, name="arr_u1")
    b = hdk.import_pydict({"xs": [[9]]}, name="arr_u2")
    out = a.union_all(b).run().to_pandas()
    assert [list(x) for x in out["xs"]] == [[1, 2, 3], [9]]
    res = hdk.sql("SELECT xs FROM arr_u1 WHERE 1 = 0").to_pandas()
    assert len(res) == 0


def test_mixed_scalars_rejected(hdk):
    with pytest.raises(TypeError):
        hdk.import_pydict({"xs": [5, [1, 2]]}, name="arr_bad")


def test_sql_unnest_scope_and_alias(hdk):
    hdk.import_pydict({"id": [1], "xs": [[4, 5]]}, name="arr_s1")
    hdk.import_pydict({"k": [1, 2]}, name="arr_s2")
    # unnest binds AFTER the comma-join merge: t2's columns resolve
    res = hdk.sql(
        "SELECT k, e FROM arr_s1, arr_s2, UNNEST(arr_s1.xs) AS e "
        "WHERE id = 1 ORDER BY k, e").to_pandas()
    assert res["k"].tolist() == [1, 1, 2, 2]
    assert res["e"].tolist() == [4, 5, 4, 5]
    # with an alias the source array column survives
    res2 = hdk.sql(
        "SELECT id, xs, e FROM arr_s1, UNNEST(xs) AS e ORDER BY e")\
        .to_pandas()
    assert [list(x) for x in res2["xs"]] == [[4, 5], [4, 5]]
    assert res2["e"].tolist() == [4, 5]
    # UNNEST cannot be the base FROM item
    from hdk_jax.sql.lexer import SqlError
    with pytest.raises(SqlError):
        hdk.sql("SELECT * FROM UNNEST(xs)")
