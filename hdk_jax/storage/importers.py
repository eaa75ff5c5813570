"""Data import: pydict / pandas / Arrow / CSV / Parquet -> Table.

Reference entry points: pyhdk ``import_pydict`` (hdk.py:2416),
``import_arrow`` (:2361), ``import_csv`` (:2229), ``import_parquet``
(:2313); engine side ArrowStorage::importArrowTable (ArrowStorage.cpp:666)
with arrow-type coercion (ArrowStorageUtils.cpp) and text dict-encoding.

Coercions (everything must land in a fixed-width device dtype):
  * text        -> StringDictionary int32 codes (DictionaryType)
  * arrow dictionary arrays -> re-encoded into the table's dictionary
  * timestamps  -> int64 in the arrow unit
  * date32/64   -> int32 days / int64 seconds
  * decimal128  -> scaled int64 (DecimalType), precision <= 18
  * bool        -> np.bool_ (validity mask carries nulls)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from .dictionary import DictionaryRegistry, StringDictionary
from .table import Column, ColumnInfo, Table

try:  # pyarrow is present in the target environment; keep a soft gate
    import pyarrow as pa
    import pyarrow.compute as pc
except ImportError:  # pragma: no cover
    pa = None
    pc = None


def _encode_strings(
    values: Sequence[Optional[str]], dictionary: StringDictionary
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    # fast path: hand the raw values to Arrow's C++ converter (NaN/None
    # become nulls) and encode via the dedup route — the per-row Python
    # isinstance/str() loop below costs more than the whole C++ encode
    if pa is not None:
        try:
            arr = pa.array(values, type=pa.string(), from_pandas=True)
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            arr = None
        if arr is not None:
            return _encode_arrow_strings(arr, dictionary)
    codes = dictionary.bulk_get_or_add(
        [None if v is None or (isinstance(v, float) and np.isnan(v)) else str(v) for v in values]
    )
    from .dictionary import NULL_CODE

    validity = codes != NULL_CODE
    return codes, (None if bool(validity.all()) else validity)


def _from_numpy(
    name: str,
    arr: np.ndarray,
    dicts: DictionaryRegistry,
    declared: Optional[t.Type],
    validity: Optional[np.ndarray] = None,
) -> Tuple[t.Type, np.ndarray, Optional[np.ndarray]]:
    arr = np.asarray(arr)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        if declared is not None and declared.is_dict_encoded_string():
            d = dicts.get(declared.dict_id)  # type: ignore[attr-defined]
        else:
            d = dicts.create()
        codes, validity = _encode_strings(arr.tolist(), d)
        return t.dict_text(d.dict_id, nullable=validity is not None), codes, validity
    if np.issubdtype(arr.dtype, np.floating):
        nan_mask = np.isnan(arr)
        if nan_mask.any() and validity is None:
            validity = ~nan_mask
    if np.issubdtype(arr.dtype, np.datetime64):
        typ = t.from_numpy_dtype(arr.dtype)
        phys = arr.astype(typ.physical_dtype())
        nat = np.isnat(arr)
        if nat.any():
            validity = ~nat if validity is None else (validity & ~nat)
        return typ.with_nullable(validity is not None), phys, validity
    if declared is not None:
        phys = arr.astype(declared.physical_dtype(), copy=False)
        return declared, phys, validity
    typ = t.from_numpy_dtype(arr.dtype, nullable=validity is not None)
    return typ, arr, validity


def _from_lists(values, declared: Optional[t.Type], name: str = "?"):
    """List-of-lists column -> fixed-width (rows, width) array data with
    an element-validity mask (reference: FixedLenArray/VarLenArray —
    varlen pads to the max width; NULL rows and NULL elements carry
    mask False; NULL rows read back as empty)."""
    lists = []
    for v in values:
        if v is None:
            lists.append(None)
            continue
        if not isinstance(v, (list, tuple, np.ndarray)):
            raise TypeError(
                f"column {name!r} mixes scalars and lists: {v!r}")
        a = np.asarray(v)
        if a.dtype == object:  # NULL elements inside the list
            em = np.asarray([x is not None for x in v])
            a = np.asarray([0 if x is None else x for x in v])
            lists.append((a, em))
        else:
            lists.append((a, None))
    live = [a for e in lists if e is not None for a in [e[0]] if a.size]
    width = max((e[0].shape[0] for e in lists if e is not None), default=1)
    width = max(width, 1)
    if declared is not None and declared.is_array():
        elem_t = declared.elem_type  # type: ignore[attr-defined]
        dt = elem_t.physical_dtype()
    else:
        dt = np.result_type(*[a.dtype for a in live]) if live else np.int64
        if dt == object:
            raise TypeError(
                f"column {name!r}: array elements must be numeric")
        elem_t = t.from_numpy_dtype(np.dtype(dt))
    data = np.zeros((len(lists), width), dt)
    mask = np.zeros((len(lists), width), np.bool_)
    for i, e in enumerate(lists):
        if e is None:
            continue
        a, em = e
        if a.size == 0:
            continue
        data[i, :a.shape[0]] = a.astype(dt)
        mask[i, :a.shape[0]] = True if em is None else em
    return t.array(elem_t, nullable=True), data, mask


def columns_from_pydict(
    data: Dict[str, Sequence],
    dicts: DictionaryRegistry,
    schema: Optional[Dict[str, t.Type]] = None,
) -> List[Tuple[str, t.Type, np.ndarray, Optional[np.ndarray]]]:
    out = []
    for name, values in data.items():
        declared = (schema or {}).get(name)
        if isinstance(values, np.ndarray) and values.dtype != object:
            typ, phys, validity = _from_numpy(name, values, dicts,
                                              declared, None)
            out.append((name, typ, phys, validity))
            continue
        if not isinstance(values, np.ndarray):
            values = list(values)
        # single C-pass type inference + null handling via Arrow: the
        # previous per-value Python scans (list-ness, None-ness, fill)
        # cost ~4x the whole native encode at 4M rows.  _arrow_column
        # honors the declared schema the same way _from_numpy does.
        aarr = None
        if pa is not None and len(values):
            try:
                aarr = pa.array(values, from_pandas=True)
            except (pa.ArrowInvalid, pa.ArrowTypeError,
                    pa.ArrowNotImplementedError):
                aarr = None
        if aarr is not None and not pa.types.is_null(aarr.type):
            typ, phys, validity = _arrow_column(
                name, pa.chunked_array([aarr]), dicts, declared)
            out.append((name, typ, phys, validity))
            continue
        # legacy Python path: empty/None-only columns, mixed values
        # Arrow rejects (kept for its precise error messages)
        if ((declared is not None and declared.is_array())
                or any(isinstance(v, (list, tuple, np.ndarray))
                       for v in values)):
            typ, arr2d, emask = _from_lists(list(values), declared, name)
            out.append((name, typ, arr2d, emask))
            continue
        if isinstance(values, np.ndarray):
            arr = values
            validity = None
        else:
            has_none = any(v is None for v in values)
            if has_none and values and any(
                isinstance(v, (int, float, np.integer, np.floating))
                for v in values if v is not None
            ):
                validity = np.asarray([v is not None for v in values])
                fill = 0
                arr = np.asarray([fill if v is None else v for v in values])
            else:
                arr = np.asarray(values, dtype=object if has_none else None)
                validity = None
        typ, phys, validity = _from_numpy(name, arr, dicts, declared, validity)
        out.append((name, typ, phys, validity))
    return out


# ---------------------------------------------------------------------------
# Arrow
# ---------------------------------------------------------------------------

def _arrow_validity(arr: "pa.ChunkedArray") -> Optional[np.ndarray]:
    if arr.null_count == 0:
        return None
    return np.asarray(pc.is_valid(arr).combine_chunks())


def _arrow_column(
    name: str,
    arr: "pa.ChunkedArray",
    dicts: DictionaryRegistry,
    declared: Optional[t.Type],
) -> Tuple[t.Type, np.ndarray, Optional[np.ndarray]]:
    at = arr.type
    validity = _arrow_validity(arr)
    nullable = validity is not None

    def fixed(np_dtype, typ: t.Type):
        filled = arr.combine_chunks()
        if validity is not None:
            filled = pc.fill_null(
                filled, False if pa.types.is_boolean(at) else 0)
        data = np.asarray(filled, dtype=np_dtype)
        if declared is not None and not declared.is_array():
            # honor the declared schema like the pydict path does
            # (reference: ArrowStorage type coercion on import,
            # ArrowStorageUtils.cpp) — e.g. int64 epoch seconds
            # declared as a TIMESTAMP column
            data = data.astype(declared.physical_dtype(), copy=False)
            return declared.with_nullable(
                declared.nullable or nullable), data, validity
        return typ.with_nullable(nullable), data, validity

    if pa.types.is_list(at) or pa.types.is_large_list(at):
        # list columns -> fixed-width array storage (reference:
        # FixedLen/VarLenArray ingest, ArrowStorageUtils).  Vectorized
        # from the offsets/values buffers; falls back to the Python
        # path only when elements are nullable or non-numeric
        comb = arr.combine_chunks()
        if isinstance(comb, pa.ChunkedArray):
            comb = (comb.chunk(0) if comb.num_chunks == 1
                    else pa.concat_arrays([comb.chunk(i)
                                           for i in range(comb.num_chunks)]))
        vals = comb.values
        numeric = (pa.types.is_integer(vals.type)
                   or pa.types.is_floating(vals.type))
        if numeric and vals.null_count == 0:
            offsets = np.asarray(comb.offsets, dtype=np.int64)
            counts = offsets[1:] - offsets[:-1]
            rows = len(counts)
            if validity is not None:
                counts = np.where(validity, counts, 0)
            width = max(int(counts.max()) if rows else 1, 1)
            flat = np.asarray(vals)
            if declared is not None and declared.is_array():
                elem_t = declared.elem_type
                dt = elem_t.physical_dtype()
            else:
                dt = flat.dtype
                elem_t = t.from_numpy_dtype(np.dtype(dt))
            data = np.zeros((rows, width), dt)
            mask = np.arange(width)[None, :] < counts[:, None]
            # flat values fill the masked slots in row-major order
            starts = np.repeat(offsets[:-1], counts)
            within = np.arange(counts.sum()) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
            data[mask] = flat[(starts + within)].astype(dt)
            return t.array(elem_t, nullable=True), data, mask
        return _from_lists(comb.to_pylist(), declared, name)
    if pa.types.is_boolean(at):
        return fixed(np.bool_, t.boolean())
    if pa.types.is_integer(at):
        width = at.bit_width // 8
        if pa.types.is_unsigned_integer(at):
            width = min(width * 2, 8)
        return fixed(np.dtype(f"int{width * 8}"), t.IntegerType(True, width))
    if pa.types.is_floating(at):
        width = 8 if at.bit_width == 64 else 4
        filled = arr.combine_chunks()
        data = np.asarray(filled, dtype=np.dtype(f"float{width * 8}"))
        return t.FloatingPointType(nullable, width), data, validity
    if pa.types.is_decimal(at):
        if at.precision > 18:
            raise TypeError(f"decimal precision {at.precision} > 18 unsupported")
        ints = pc.multiply(pc.cast(arr, pa.float64()), 10.0 ** at.scale)
        data = np.asarray(pc.round(ints).cast(pa.int64()).combine_chunks())
        if validity is not None:
            data = np.where(validity, data, 0)
        return t.decimal64(at.precision, at.scale, nullable), data, validity
    if pa.types.is_date32(at):
        return fixed(np.int32, t.date32())
    if pa.types.is_date64(at):
        ms = np.asarray(pc.fill_null(arr.cast(pa.int64()), 0).combine_chunks())
        return t.date64().with_nullable(nullable), ms // 1000, validity
    if pa.types.is_timestamp(at):
        unit = {"s": t.TimeUnit.SECOND, "ms": t.TimeUnit.MILLI,
                "us": t.TimeUnit.MICRO, "ns": t.TimeUnit.NANO}[at.unit]
        return fixed(np.int64, t.timestamp(unit))
    if pa.types.is_time32(at) or pa.types.is_time64(at):
        unit = {"s": t.TimeUnit.SECOND, "ms": t.TimeUnit.MILLI,
                "us": t.TimeUnit.MICRO, "ns": t.TimeUnit.NANO}[at.unit]
        return fixed(np.int64, t.time64(unit))
    if pa.types.is_dictionary(at) or pa.types.is_string(at) or pa.types.is_large_string(at):
        if declared is not None and declared.is_dict_encoded_string():
            d = dicts.get(declared.dict_id)  # type: ignore[attr-defined]
        else:
            d = dicts.create()
        codes, validity = _encode_arrow_strings(arr, d)
        return t.dict_text(d.dict_id, nullable=validity is not None), codes, validity
    raise TypeError(f"unsupported arrow type for column {name!r}: {at}")


def _encode_arrow_strings(arr: "pa.ChunkedArray", d
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Bulk encode via Arrow's C++ dictionary_encode: only the *unique*
    strings round-trip through Python (reference hot path:
    StringDictionary::getOrAddBulk, parallel in C++ there — here Arrow's
    native kernel does the heavy dedup)."""
    from .dictionary import NULL_CODE

    comb = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    if isinstance(comb, pa.ChunkedArray):  # zero-chunk edge
        comb = pa.concat_arrays([c for c in comb.chunks]) if comb.num_chunks \
            else pa.array([], type=comb.type)
    if pa.types.is_dictionary(comb.type):
        denc = comb
    else:
        denc = comb.dictionary_encode()
    uniq = denc.dictionary.to_pylist()
    mapping = d.bulk_get_or_add(uniq)
    idx = denc.indices
    if idx.null_count:
        valid = np.asarray(pc.is_valid(idx))
        idx_np = np.asarray(idx.fill_null(0), dtype=np.int64)
        codes = mapping[idx_np].astype(np.int32)
        codes[~valid] = NULL_CODE
        return codes, valid
    if len(uniq) == 0:
        return np.zeros(0, np.int32), None
    codes = mapping[np.asarray(idx, dtype=np.int64)].astype(np.int32)
    return codes, None


def columns_from_arrow(
    table: "pa.Table",
    dicts: DictionaryRegistry,
    schema: Optional[Dict[str, t.Type]] = None,
    pipeline=None,
) -> List[Tuple[str, t.Type, np.ndarray, Optional[np.ndarray]]]:
    """``pipeline``: per-column callback fired as soon as that column's
    host decode finishes — the ingest/compute-overlap seam (the session
    hands each column to the transfer worker while the next column
    decodes; reference: ColumnFetcher.h:42-90)."""
    out = []
    for name in table.column_names:
        declared = (schema or {}).get(name)
        typ, data, validity = _arrow_column(name, table.column(name), dicts, declared)
        out.append((name, typ, data, validity))
        if pipeline is not None:
            pipeline(out[-1])
    return out


def columns_from_pandas(df, dicts: DictionaryRegistry, schema=None):
    if pa is None:  # pragma: no cover
        raise RuntimeError("pyarrow required for pandas import")
    return columns_from_arrow(pa.Table.from_pandas(df, preserve_index=False), dicts, schema)


def build_table(
    table_id: int,
    name: str,
    cols: List[Tuple[str, t.Type, np.ndarray, Optional[np.ndarray]]],
    fragment_size: int,
    process_local: bool = False,
) -> Table:
    columns = [
        Column(ColumnInfo(table_id, i, cname, typ), data, validity)
        for i, (cname, typ, data, validity) in enumerate(cols)
    ]
    return Table(table_id, name, columns, fragment_size,
                 process_local=process_local)
