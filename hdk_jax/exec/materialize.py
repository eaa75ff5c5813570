"""Result materialization: ExecTable -> Arrow / pandas / storage Table.

Reference: ResultSet/ArrowResultSetConverter.{h,cpp} (ResultSet ->
arrow::Table with dictionary columns and validity) plus
ResultSetRegistry's ColumnarResults re-materialization for chaining.
Here step results are already columnar device arrays, so conversion is a
device->host copy plus logical-type reconstruction.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import types as t
from ..storage.dictionary import NULL_CODE, DictionaryRegistry
from ..storage.table import Column, ColumnInfo, Table
from .executor import ExecTable
from .masked import MaskedCol

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


def _to_np(arr) -> np.ndarray:
    """Device->host; multi-controller global arrays (shards spread over
    other processes' hosts) allgather first so every process returns the
    FULL result (reference analog: collectAllDeviceResults)."""
    if hasattr(arr, "is_fully_addressable") and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils as mh

        return np.asarray(mh.process_allgather(arr, tiled=True))
    return np.asarray(arr)


def _host(col: MaskedCol):
    data = _to_np(col.data)
    mask = _to_np(col.mask) if col.mask is not None else None
    return data, mask


def _arrow_array(typ: t.Type, data: np.ndarray, mask: Optional[np.ndarray],
                 dicts: DictionaryRegistry):
    arrow_mask = None if mask is None else ~mask  # arrow wants null flags
    if typ.is_dict_encoded_string():
        d = dicts.get(typ.dict_id)  # type: ignore[attr-defined]
        safe = np.where(data == NULL_CODE, 0, data) if mask is None else np.where(mask, data, 0)
        dictionary = pa.array(d.all_strings() or [""], type=pa.string())
        null_mask = (data == NULL_CODE) if mask is None else ~mask
        indices = pa.array(np.clip(safe, 0, max(len(d) - 1, 0)).astype(np.int32),
                           mask=null_mask)
        return pa.DictionaryArray.from_arrays(indices, dictionary)
    if typ.is_decimal():
        from decimal import Decimal

        scale = typ.scale  # type: ignore[attr-defined]
        scaled = [
            None if (mask is not None and not mask[i])
            else Decimal(int(v)).scaleb(-scale)
            for i, v in enumerate(data)
        ]
        return pa.array(scaled, type=pa.decimal128(typ.precision, scale))  # type: ignore[attr-defined]
    if typ.is_date():
        if typ.unit == t.TimeUnit.DAY:  # type: ignore[attr-defined]
            return pa.array(data.astype(np.int32), type=pa.date32(), mask=arrow_mask)
        return pa.array(data.astype(np.int64) * 1000, type=pa.date64(), mask=arrow_mask)
    if typ.is_timestamp():
        return pa.array(data.astype(np.int64),
                        type=pa.timestamp(typ.unit.value), mask=arrow_mask)  # type: ignore[attr-defined]
    if typ.is_time():
        unit = typ.unit  # type: ignore[attr-defined]
        if unit in (t.TimeUnit.SECOND, t.TimeUnit.MILLI):
            scale = 1000 if unit == t.TimeUnit.SECOND else 1
            return pa.array((data.astype(np.int64) * scale).astype(np.int32),
                            type=pa.time32("ms"), mask=arrow_mask)
        return pa.array(data.astype(np.int64), type=pa.time64(unit.value),
                        mask=arrow_mask)
    if typ.is_array():
        elem = typ.elem_type  # type: ignore[attr-defined]
        counts = (mask.sum(axis=1) if mask is not None
                  else np.full(len(data), data.shape[1]))
        offsets = np.zeros(len(data) + 1, np.int32)
        np.cumsum(counts, out=offsets[1:])
        flat = data[mask] if mask is not None else data.reshape(-1)
        ev = pa.array(flat)
        return pa.ListArray.from_arrays(pa.array(offsets, pa.int32()), ev)
    if typ.is_interval():
        return pa.array(data.astype(np.int64), type=pa.int64(), mask=arrow_mask)
    return pa.array(data, mask=arrow_mask)


def to_arrow(table: ExecTable, dicts: DictionaryRegistry) -> "pa.Table":
    if pa is None:
        raise ImportError("to_arrow()/to_pandas() need pyarrow, which is "
                          "not installed; to_numpy() needs only numpy")
    arrays = []
    for typ, col in zip(table.types, table.columns):
        data, mask = _host(col)
        arrays.append(_arrow_array(typ, data, mask, dicts))
    return pa.table(arrays, names=table.fields)


def to_pandas(table: ExecTable, dicts: DictionaryRegistry):
    return to_arrow(table, dicts).to_pandas()


def to_numpy(table: ExecTable, dicts: DictionaryRegistry) -> dict:
    """Physical values per column (timestamps as integers in their
    unit, dictionary strings decoded to str objects); NULLs masked."""
    out = {}
    for name, typ, col in zip(table.fields, table.types, table.columns):
        data, mask = _host(col)
        if typ.is_dict_encoded_string():
            d = dicts.get(typ.dict_id)  # type: ignore[attr-defined]
            valid = (data != NULL_CODE) if mask is None else mask
            strings = np.asarray(d.all_strings() or [""], dtype=object)
            data = strings[np.where(valid, data, 0)]
            mask = None if valid.all() else valid
        out[name] = data if mask is None else np.ma.masked_array(data, ~mask)
    return out


def to_storage_table(table: ExecTable, table_id: int, name: str,
                     fragment_size: int) -> Table:
    """Register a result as a queryable temp table (reference:
    ResultSetRegistry::put, ResultSetRegistry.h:38)."""
    cols = []
    for i, (fname, typ, col) in enumerate(
            zip(table.fields, table.types, table.columns)):
        data, mask = _host(col)
        # 2D array columns stay fixed-width device-shaped (rows x width)
        # with their element mask — scans re-upload them directly
        cols.append(Column(ColumnInfo(table_id, i, fname, typ), data, mask))
    if not cols:
        cols = [Column(ColumnInfo(table_id, 0, "dummy", t.int64(False)),
                       np.zeros(table.nrows, np.int64))]
    return Table(table_id, name, cols, fragment_size)
