"""Columnar in-memory tables: the analog of ArrowStorage.

Reference: omniscidb/ArrowStorage/ArrowStorage.h:29-135 — tables are
per-column chunked arrays split into row fragments with per-fragment
min/max/null stats (``computeStats`` ArrowStorage.h:221) used for
fragment skipping (Execute.h:540 skipFragmentPair).

Design:
  * Host tier: columns are contiguous numpy arrays + optional validity
    masks (Arrow-style), staged for zero-copy handoff to jax.
  * Device tier: on first use a column is transferred to the default
    device (or sharded over a mesh axis for multi-device runs) and cached;
    this replaces the reference's CPU->GPU BufferMgr chunk pinning
    (DataMgr/BufferMgr).
  * Fragments are logical row ranges kept for (a) stats-based pruning and
    (b) the row-shard axis when distributing over a mesh.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from .dictionary import NULL_CODE, StringDictionary

ROWID_NAME = "rowid"  # hidden virtual column (reference: ArrowStorage rowid)


@dataclass(frozen=True)
class ColumnInfo:
    """reference: SchemaMgr/ColumnInfo.h."""

    table_id: int
    col_idx: int
    name: str
    type: t.Type
    is_rowid: bool = False


@dataclass(frozen=True)
class FragmentStats:
    """Per-fragment per-column stats (reference: ChunkMetadata min/max/nulls,
    ArrowStorage::computeStats ArrowStorage.h:221)."""

    row_start: int
    row_end: int
    min_val: Optional[float]
    max_val: Optional[float]
    null_count: int


class Column:
    """One column: host numpy data (+validity) with a cached device copy."""

    def __init__(
        self,
        info: ColumnInfo,
        data: np.ndarray,
        validity: Optional[np.ndarray] = None,
    ) -> None:
        # ndim == 2: fixed-width array column (rows x width) with a
        # same-shape element-validity mask (reference: FixedLenArray;
        # varlen lists pad to the max width at ingest)
        assert data.ndim in (1, 2)
        if validity is not None:
            assert validity.dtype == np.bool_ and validity.shape == data.shape
            if bool(validity.all()):
                validity = None
        self.info = info
        self.data = data
        self.validity = validity  # True = valid (Arrow convention)
        self._device: Optional[Tuple[object, object]] = None
        self._lock = threading.Lock()

    @property
    def type(self) -> t.Type:
        return self.info.type

    def __len__(self) -> int:
        return len(self.data)

    def has_nulls(self) -> bool:
        return self.validity is not None

    def device_arrays(self):
        """(data, mask_or_None) as jax arrays, cached with LRU-budget
        accounting (reference chunk fetch path: DataMgr::getBuffer ->
        ArrowStorage::fetchBuffer, ArrowStorage.h:65; budget/eviction:
        BufferMgr slabs)."""
        from .memory import device_cache_manager

        got = self._device
        if got is None:
            with self._lock:
                got = self._device
                if got is None:
                    import jax.numpy as jnp

                    data = jnp.asarray(self.data)
                    mask = jnp.asarray(self.validity) if self.validity is not None else None
                    got = self._device = (data, mask)
        nbytes = self.data.nbytes + (
            self.validity.nbytes if self.validity is not None else 0)
        # note_use may evict THIS column when the budget is smaller than
        # one column — return the local handle, not self._device
        device_cache_manager().note_use(self, nbytes)
        return got

    def prefetch_device(self) -> None:
        """Issue this column's device transfer on the shared ingest
        worker, so the NEXT column's host decode overlaps this one's
        transfer (ingest/compute overlap — the reference overlaps
        per-fragment fetch with kernel execution, ColumnFetcher.h:42-90
        + the TBB kernel pool, Execute.cpp:2753).  Errors surface on
        the query path's own device_arrays call, never here."""
        def work():
            try:
                self.device_arrays()
            except Exception:  # defer to the foreground call
                self.drop_device_cache()

        _ingest_pool().submit(work)

    def drop_device_cache(self, _from_manager: bool = False) -> None:
        self._device = None
        self._device_pruned = None  # fragment-pruned gather cache
        if not _from_manager:
            from .memory import device_cache_manager

            device_cache_manager().note_drop(self)

    def fragment_stats(self, row_start: int, row_end: int) -> FragmentStats:
        if self.data.ndim > 1:  # array columns carry no range stats
            return FragmentStats(row_start, row_end, None, None, 0)
        sl = self.data[row_start:row_end]
        if self.validity is not None:
            v = self.validity[row_start:row_end]
            nulls = int((~v).sum())
            sl = sl[v]
        else:
            nulls = 0
        if (sl.size == 0 or sl.dtype == object or sl.dtype == np.bool_
                or sl.ndim > 1):
            return FragmentStats(row_start, row_end, None, None, nulls)
        return FragmentStats(row_start, row_end, sl.min().item(), sl.max().item(), nulls)


_INGEST_POOL = None
_INGEST_POOL_LOCK = threading.Lock()


def _ingest_pool():
    """Process-wide single-worker transfer pipeline: ONE worker keeps
    transfers ordered and bounds contention with the decode thread."""
    global _INGEST_POOL
    with _INGEST_POOL_LOCK:
        if _INGEST_POOL is None:
            import concurrent.futures

            _INGEST_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hdk-ingest")
        return _INGEST_POOL


class Table:
    """An in-memory columnar table split into row fragments."""

    def __init__(
        self,
        table_id: int,
        name: str,
        columns: Sequence[Column],
        fragment_size: int,
        process_local: bool = False,
    ) -> None:
        assert columns, "table must have at least one column"
        nrows = len(columns[0])
        for c in columns:
            assert len(c) == nrows, "ragged columns"
        self.table_id = table_id
        self.name = name
        self.columns: List[Column] = list(columns)
        self._by_name: Dict[str, Column] = {c.info.name: c for c in columns}
        self.nrows = nrows
        # multi-controller ingest: host data holds only THIS process's
        # rows; scans assemble the global sharded array (SURVEY §2.8
        # per-host shard feeding).  nrows stays the LOCAL count.
        self.process_local = process_local
        self.fragment_size = max(1, fragment_size)
        self._stats: Dict[Tuple[int, int], FragmentStats] = {}
        self._stats_lock = threading.Lock()
        # data generation: bumped on every append so plan-keyed derived
        # artifacts (join hash tables / value tables recycled by
        # exec/codecache.data_plan_sig) invalidate when content changes
        # (reference: table generations in the DataRecycler keys)
        self.generation = 0

    # -- schema -------------------------------------------------------------
    def column_names(self, include_rowid: bool = False) -> List[str]:
        return [
            c.info.name
            for c in self.columns
            if include_rowid or not c.info.is_rowid
        ]

    def column(self, name: str) -> Column:
        col = self._by_name.get(name)
        if col is None:
            if name == ROWID_NAME:
                return self._make_rowid()
            raise KeyError(f"no column {name!r} in table {self.name!r}")
        return col

    def column_info(self, name: str) -> ColumnInfo:
        return self.column(name).info

    def _make_rowid(self) -> Column:
        info = ColumnInfo(self.table_id, len(self.columns), ROWID_NAME,
                          t.int64(nullable=False), is_rowid=True)
        col = Column(info, np.arange(self.nrows, dtype=np.int64))
        self._by_name[ROWID_NAME] = col
        self.columns.append(col)
        return col

    def prefetch_stats_async(self) -> None:
        """Warm per-fragment min/max stats on the ingest worker — the
        perfect-layout choice then needs no first-query host pass."""
        def work():
            for c in self.columns:
                for frag in self.fragments:
                    try:
                        self.stats(c.info.name, frag)
                    except Exception:
                        return

        _ingest_pool().submit(work)

    # -- fragments ----------------------------------------------------------
    @property
    def fragments(self) -> List[Tuple[int, int]]:
        out = []
        start = 0
        while start < self.nrows:
            out.append((start, min(start + self.fragment_size, self.nrows)))
            start += self.fragment_size
        return out or [(0, 0)]

    def stats(self, name: str, frag: Tuple[int, int]) -> FragmentStats:
        key = (self.column(name).info.col_idx, frag[0])
        with self._stats_lock:
            st = self._stats.get(key)
            if st is None:
                st = self.column(name).fragment_stats(*frag)
                self._stats[key] = st
        return st

    def column_range(self, name: str) -> Tuple[Optional[float], Optional[float], bool]:
        """Whole-table (min, max, has_nulls) from fragment stats — drives
        perfect-hash layout choice (reference: ColumnarResults /
        getExpressionRange over chunk metadata)."""
        lo: Optional[float] = None
        hi: Optional[float] = None
        has_nulls = False
        for frag in self.fragments:
            st = self.stats(name, frag)
            has_nulls |= st.null_count > 0
            if st.min_val is not None:
                lo = st.min_val if lo is None else min(lo, st.min_val)
                hi = st.max_val if hi is None else max(hi, st.max_val)
        return lo, hi, has_nulls

    # -- append (reference: ArrowStorage::appendArrowTable :851) ------------
    def append(self, columns: Sequence[Column]) -> None:
        assert len(columns) == len([c for c in self.columns if not c.info.is_rowid])
        self._by_name.pop(ROWID_NAME, None)
        self.columns = [c for c in self.columns if not c.info.is_rowid]
        new_cols: List[Column] = []
        for old, new in zip(self.columns, columns):
            assert old.type.physical_dtype() == new.data.dtype, (
                f"append dtype mismatch on {old.info.name}"
            )
            od, nd_ = old.data, new.data
            ov, nv = old.validity, new.validity
            if od.ndim == 2 or nd_.ndim == 2:
                # array columns: widths pad to the max; padded slots get
                # mask False (masks are mandatory for arrays here)
                width = max(od.shape[1], nd_.shape[1])

                def wpad(d, v):
                    if v is None:
                        v = np.ones(d.shape, np.bool_)
                    k = d.shape[1]
                    if k < width:
                        z = ((d.shape[0], width - k))
                        d = np.concatenate(
                            [d, np.zeros(z, d.dtype)], axis=1)
                        v = np.concatenate(
                            [v, np.zeros(z, np.bool_)], axis=1)
                    return d, v

                od, ov = wpad(od, ov)
                nd_, nv = wpad(nd_, nv)
            data = np.concatenate([od, nd_])
            if ov is None and nv is None:
                validity = None
            else:
                va = ov if ov is not None else np.ones(od.shape, np.bool_)
                vb = nv if nv is not None else np.ones(nd_.shape, np.bool_)
                validity = np.concatenate([va, vb])
            new_cols.append(Column(old.info, data, validity))
        self.columns = new_cols
        self._by_name = {c.info.name: c for c in new_cols}
        self.nrows = len(new_cols[0]) if new_cols else 0
        self._stats.clear()
        self.generation += 1
