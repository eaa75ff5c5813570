"""Storage/import tests (reference: Tests/ArrowStorageTest.cpp)."""

import numpy as np
import pyarrow as pa
import pytest

import hdk_jax
from hdk_jax import types as t


@pytest.fixture(scope="module")
def hdk():
    return hdk_jax.HDK()


def test_import_pydict_types(hdk):
    ht = hdk.import_pydict(
        {"i": [1, 2, 3], "f": [1.5, 2.5, None], "s": ["a", "b", None],
         "b": np.asarray([True, False, True])})
    schema = dict(ht.schema)
    assert schema["i"].is_integer()
    assert schema["f"].is_fp() and schema["f"].nullable
    assert schema["s"].is_dict_encoded_string()
    assert schema["b"].is_boolean()


def test_import_arrow_roundtrip(hdk):
    at = pa.table({
        "x": pa.array([1, None, 3], type=pa.int32()),
        "y": pa.array(["p", "q", "p"]),
        "ts": pa.array([1000, 2000, None], type=pa.timestamp("ms")),
    })
    ht = hdk.import_arrow(at, name="arrow_rt")
    out = ht.proj("x", "y", "ts").run().to_arrow()
    assert out.column("x").to_pylist() == [1, None, 3]
    assert out.column("y").to_pylist() == ["p", "q", "p"]
    assert out.column("ts").to_pylist()[0] is not None
    assert out.column("ts").null_count == 1


def test_fragment_stats(hdk):
    ht = hdk.import_pydict({"v": list(range(100))}, name="stats_t")
    table = hdk._schema.get("stats_t")
    lo, hi, has_nulls = table.column_range("v")
    assert (lo, hi, has_nulls) == (0, 99, False)


def test_fragments_split():
    session = hdk_jax.HDK(fragment_size=10)
    ht = session.import_pydict({"v": list(range(25))}, name="frag_t")
    table = session._schema.get("frag_t")
    assert table.fragments == [(0, 10), (10, 20), (20, 25)]
    # stats per fragment
    st = table.stats("v", (10, 20))
    assert (st.min_val, st.max_val) == (10, 19)


def test_append(hdk):
    ht = hdk.import_pydict({"a": [1, 2], "s": ["x", "y"]}, name="app_t")
    hdk.append_pydict("app_t", {"a": [3], "s": ["x"]})
    out = hdk.scan("app_t").run().to_pandas()
    assert list(out["a"]) == [1, 2, 3]
    assert list(out["s"]) == ["x", "y", "x"]


def test_drop_table(hdk):
    hdk.import_pydict({"a": [1]}, name="dropme")
    hdk.drop_table("dropme")
    with pytest.raises(KeyError):
        hdk.scan("dropme")


def test_create_empty_table(hdk):
    ht = hdk.create_table("empty_t", {"a": "int64", "s": "text"})
    out = ht.run()
    assert out.row_count == 0


def test_rowid(hdk):
    ht = hdk.import_pydict({"a": [5, 6, 7]}, name="rowid_t")
    out = ht.proj("rowid", "a").run().to_pandas()
    assert list(out["rowid"]) == [0, 1, 2]


def test_string_dictionary_dedup(hdk):
    from hdk_jax.storage.dictionary import StringDictionary

    d = StringDictionary(1)
    codes = d.bulk_get_or_add(["a", "b", "a", None, "c"])
    assert codes[0] == codes[2]
    assert len(d) == 3
    assert d.get_string(codes[1]) == "b"
    assert d.decode(codes).tolist() == ["a", "b", "a", None, "c"]


def test_dictionary_translation(hdk):
    from hdk_jax.storage.dictionary import NULL_CODE, StringDictionary

    d1 = StringDictionary(1)
    d2 = StringDictionary(2)
    d1.bulk_get_or_add(["a", "b", "c"])
    d2.bulk_get_or_add(["c", "a"])
    tmap = d1.translate_to(d2)
    assert tmap[0] == d2.get_code("a")
    assert tmap[1] == NULL_CODE
    assert tmap[2] == d2.get_code("c")


def test_csv_parquet_import(hdk, tmp_path):
    import pyarrow.parquet as pq

    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,x\n2,y\n")
    ht = hdk.import_csv(str(csv), name="csv_t")
    out = ht.run().to_pandas()
    assert list(out["a"]) == [1, 2]

    at = pa.table({"v": [1.0, 2.0]})
    pq.write_table(at, tmp_path / "t.parquet")
    ht2 = hdk.import_parquet(str(tmp_path / "t.parquet"), name="pq_t")
    assert ht2.run().row_count == 2


def test_import_json(tmp_path, rng):
    """Line-delimited JSON ingest (reference: ArrowStorage importJson)."""
    import json as _json

    import hdk_jax

    p = tmp_path / "t.json"
    rows = [{"a": int(i), "b": float(i) / 2, "s": f"v{i % 3}"}
            for i in range(50)]
    p.write_text("\n".join(_json.dumps(r) for r in rows))
    hdk = hdk_jax.HDK()
    t = hdk.import_json(str(p), name="jt")
    got = t.agg("s", "count", "sum(a)").sort("s").run().to_pandas()
    import pandas as pd

    df = pd.DataFrame(rows)
    exp = (df.groupby("s").agg(count=("s", "size"), a_sum=("a", "sum"))
           .reset_index())
    assert got["count"].tolist() == exp["count"].tolist()
    assert got["a_sum"].tolist() == exp["a_sum"].tolist()
