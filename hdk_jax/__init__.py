"""hdk_jax — a vectorized query-execution engine in JAX.

A from-scratch rebuild of intel/HDK's capabilities: columnar tables
live as device arrays, relational operators are JAX-traced XLA
programs, and multi-device scaling uses jax.sharding meshes +
collectives instead of the reference's threads/GPUs (see SURVEY.md).

Primary API mirrors pyhdk (python/pyhdk/hdk.py):

    import hdk_jax
    hdk = hdk_jax.init()
    ht = hdk.import_pydict({"a": [1, 2, 1], "b": [10., 20., 30.]}, name="t")
    res = ht.agg("a", "sum(b)").run()
    res.to_arrow()
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import jax

# The engine needs 64-bit integer/double columns (aggregate accumulators,
# epoch timestamps, decimal int64).
jax.config.update("jax_enable_x64", True)

import os as _os


def _compile_cache_dir(environ=_os.environ) -> Optional[str]:
    """Where this package keeps JAX's persistent compilation cache (the
    disk tier of the reference's code cache): None when
    JAX_COMPILATION_CACHE_DIR is set, since JAX then reads it itself;
    otherwise a fixed ``.jax_cache`` beside the package, so processes
    of one checkout share compiled programs."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_cache_dir = _compile_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)

import numpy as np  # noqa: E402

from . import types  # noqa: E402
from .builder import QueryExpr, QueryNode, if_then_else  # noqa: E402
from .config import Config, build_config  # noqa: E402
from .ir import expr as _ir_expr  # noqa: E402
from .ir import node as _ir_node  # noqa: E402
from .exec.executor import ExecTable, Executor  # noqa: E402
from .exec import materialize as _mat  # noqa: E402
from .storage.dictionary import DictionaryRegistry  # noqa: E402
from .storage import importers as _imp  # noqa: E402
from .storage.schema import (  # noqa: E402
    DATA_SCHEMA_ID,
    RESULT_SCHEMA_ID,
    SchemaRegistry,
)
from .utils.timer import enable_debug_timer, timer_report  # noqa: E402

__version__ = "0.1.0"


class _ResultSpillHandle:
    """DeviceCacheManager entry for a QueryResult's device buffers.
    LRU eviction offloads the result to host memory — the CPU tier of
    the reference's 3-level DataMgr hierarchy (DataMgr/DataMgr.h)."""

    def __init__(self, result: "QueryResult") -> None:
        import weakref

        from .storage.memory import device_cache_manager

        self._ref = weakref.ref(result)
        weakref.finalize(result, device_cache_manager().note_drop, self)

    def drop_device_cache(self, _from_manager: bool = False) -> None:
        r = self._ref()
        if r is not None:
            r.offload()


class QueryResult:
    """Executed query result; also a queryable temp table
    (reference: ExecutionResult + ResultSetTableToken, hdk.py:2518
    ``res.scan`` chaining)."""

    def __init__(self, session: "HDK", table: ExecTable) -> None:
        self._session = session
        self._table = table  # may carry a lazy row_mask; compacted on use
        self._registered = None
        self._host_spill = None  # host copy while offloaded (DataMgr tier)
        self._spill_handle = _ResultSpillHandle(self)
        self._note_resident()

    # -- spill-to-host (reference: DataMgr 3-level hierarchy — GPU /
    # CPU / disk buffer pools, omniscidb/DataMgr/DataMgr.h.  Here the
    # device tier is HBM under the DeviceCacheManager budget; results
    # evicted by LRU offload to host numpy and transparently reload) --
    def _nbytes(self) -> int:
        total = 0
        for c in self._table.columns:
            if c is None:
                continue
            total += c.data.size * c.data.dtype.itemsize
            if c.mask is not None:
                total += c.mask.size
        return total

    def _note_resident(self) -> None:
        from .storage.memory import device_cache_manager

        if type(self._table.columns) is not list:
            # lazy column containers (join outputs, pruned scans): sizing
            # them would force their gathers — leave untracked until the
            # result materializes through normal use
            return
        device_cache_manager().note_use(self._spill_handle, self._nbytes())

    def offload(self) -> "QueryResult":
        """Move this result's buffers to host memory (spill tier);
        device copies are dropped and restored on next use."""
        if self._table is not None:
            import jax as _jax

            t = self._table
            self._host_spill = (
                list(t.fields), list(t.types), t.nrows,
                [(None if c is None else
                  (_jax.device_get(c.data),
                   None if c.mask is None else _jax.device_get(c.mask)))
                 for c in t.columns],
                None if t.row_mask is None else _jax.device_get(t.row_mask))
            self._table = None
        return self

    def _ensure_device(self) -> ExecTable:
        t = self._table
        if t is None:
            import jax.numpy as jnp
            from .exec.masked import MaskedCol

            fields, types, nrows, cols_h, rm_h = self._host_spill
            cols = [None if c is None else
                    MaskedCol(jnp.asarray(c[0]),
                              None if c[1] is None else jnp.asarray(c[1]))
                    for c in cols_h]
            t = ExecTable(fields, types, cols, nrows,
                          None if rm_h is None else jnp.asarray(rm_h))
            self._table = t
            self._host_spill = None
            # note_use may re-evict immediately under a tiny budget —
            # callers hold the local handle, so this read still works
            self._note_resident()
        return t

    def _dense(self) -> ExecTable:
        t = self._ensure_device()
        if t.row_mask is not None:
            self._table = t = t.compact()
        return t

    @property
    def row_count(self) -> int:
        return self._ensure_device().live_count()

    def block(self) -> "QueryResult":
        """Wait for all device computation behind this result (jax
        dispatch is async; benchmarks must block before stopping
        timers)."""
        t = self._ensure_device()
        for c in t.columns:
            c.data.block_until_ready()
            if c.mask is not None:
                c.mask.block_until_ready()
        if t.row_mask is not None:
            t.row_mask.block_until_ready()
        return self

    @property
    def schema(self):
        t = self._table
        if t is None:
            return list(zip(self._host_spill[0], self._host_spill[1]))
        return list(zip(t.fields, t.types))

    def to_arrow(self):
        """reference: ResultSetTableToken::toArrow (_sql.pyx:80-83)."""
        return _mat.to_arrow(self._dense(), self._session._dicts)

    def to_pandas(self):
        return _mat.to_pandas(self._dense(), self._session._dicts)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """{column: host array} through numpy alone (no pyarrow or
        pandas); a column with NULLs is a numpy masked array."""
        return _mat.to_numpy(self._dense(), self._session._dicts)

    def head(self, n: int = 10):
        import pyarrow as pa

        return self.to_arrow().slice(0, n)

    def tail(self, n: int = 10):
        """Last n rows (reference: ResultSetTableToken.h:44-45 tail)."""
        arr = self.to_arrow()
        return arr.slice(max(0, arr.num_rows - n), n)

    @property
    def scan(self) -> QueryNode:
        """Chain this result as an input (reference: hdk.py:2518)."""
        if self._registered is None:
            s = self._session
            tid = s._schema.next_table_id(RESULT_SCHEMA_ID)
            tname = f"__result_{tid & 0xFFFFFF}"
            table = _mat.to_storage_table(
                self._dense(), tid, tname, s._config.storage.fragment_size)
            s._schema.register(table)
            self._registered = table
        return self._session.scan(self._registered.name)

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(f"{n}: {ty}" for n, ty in self.schema)
        return f"QueryResult({self.row_count} rows; {cols})"


class HDK:
    """Session facade wiring Config -> storage -> executor -> builder
    (reference: HDK.__init__ hdk.py:2113-2128)."""

    def __init__(self, **config_kwargs) -> None:
        self._config = (config_kwargs.pop("config")
                        if "config" in config_kwargs
                        else build_config(**config_kwargs))
        self._schema = SchemaRegistry()
        self._dicts = DictionaryRegistry()
        from .utils import logger as _logger

        _logger.configure(self._config.debug.log_severity,
                          log_to_file=self._config.debug.log_to_file,
                          log_dir=self._config.debug.log_dir)
        from .storage.memory import default_budget, device_cache_manager

        device_cache_manager().set_budget(
            self._config.storage.device_cache_budget_bytes
            or default_budget())
        from .udf import UdfRegistry

        self._udfs = UdfRegistry()
        self._executor = Executor(self._schema, self._dicts, self._config,
                                  udfs=self._udfs)
        self._tmp_counter = 0
        self._lock = threading.Lock()

    # -- UDFs ---------------------------------------------------------------
    def register_udf(self, name: str, fn, arg_types, ret_type,
                     null_propagation: bool = True):
        """Register a jax-traceable scalar UDF callable from SQL and the
        builder (reference: UdfCompiler.h:30; here the function traces
        into the fused XLA program — see udf.py)."""
        return self._udfs.register(name, fn, arg_types, ret_type,
                                   null_propagation=null_propagation)

    def call(self, name: str, *args) -> "QueryExpr":
        """Builder-side call of a registered UDF or scalar builtin.
        Python literals become typed constants."""
        from . import types as _t
        from .builder import QueryExpr
        from .ir.expr import Constant, Expr, FunctionCall

        def as_expr(a):
            if isinstance(a, QueryExpr):
                return a.expr
            if isinstance(a, Expr):
                return a
            if isinstance(a, bool):
                return Constant(_t.boolean(False), a)
            if isinstance(a, int):
                return Constant(_t.int64(False), a)
            if isinstance(a, float):
                return Constant(_t.fp64(False), a)
            raise TypeError(f"cannot pass {type(a).__name__} to call(); "
                            "wrap strings/dates with hdk.cst()")

        exprs = [as_expr(a) for a in args]
        udf = self._udfs.get(name)
        if udf is not None:
            nullable = any(e.type.nullable for e in exprs)
            out_t = udf.ret_type.with_nullable(
                udf.ret_type.nullable or (udf.null_propagation and nullable))
            return QueryExpr(FunctionCall(out_t, name.lower(), exprs))
        # builtin: reuse the SQL binder's result typing (lower/upper keep
        # their dict-encoded type, sign -> int32, default fp64, ...)
        from .sql.binder import Binder

        out_t = Binder(self)._fn_type(name.lower(), exprs)
        return QueryExpr(FunctionCall(out_t, name.lower(), exprs))

    @property
    def config(self) -> Config:
        return self._config

    # -- ingest ------------------------------------------------------------
    def _table_name(self, name: Optional[str]) -> str:
        if name:
            return name
        with self._lock:
            self._tmp_counter += 1
            return f"table_{self._tmp_counter}"

    def _register(self, name, cols, process_local: bool = False) -> QueryNode:
        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        table = _imp.build_table(tid, name, cols,
                                 self._config.storage.fragment_size,
                                 process_local=process_local)
        self._schema.register(table)
        return self.scan(name)

    def import_pydict(self, data: Dict[str, Sequence], name: Optional[str] = None,
                      schema: Optional[Dict[str, types.Type]] = None,
                      process_local: bool = False) -> QueryNode:
        """reference: hdk.py:2416 import_pydict.

        ``process_local=True`` (multi-controller, multi-host): ``data`` holds
        only THIS process's rows; scans assemble the global row-sharded
        table across all hosts (requires a dist session; every process
        must import the same table name with its own shard).  Dict-
        encoded string columns are globally unified at ingest: every
        process's private dictionary allgathers into one canonical code
        space and local codes are rewritten (reference:
        StringDictionaryTranslationMgr, Execute.h:305-315)."""
        name = self._table_name(name)
        pre_dicts = set(self._dicts._dicts.keys()) if process_local else set()
        cols = _imp.columns_from_pydict(data, self._dicts, schema)
        if process_local:
            cols = self._unify_process_local_dicts(cols, pre_dicts)
        return self._register(name, cols, process_local=process_local)

    def _unify_process_local_dicts(self, cols, pre_dicts):
        """Rewrite freshly dict-encoded process-local columns into the
        cross-process canonical code space (parallel/mesh.py)."""
        import jax as _jax

        from .parallel.mesh import unify_process_dictionary
        from .storage.dictionary import NULL_CODE

        if _jax.process_count() == 1:
            return cols
        out = []
        for (cname, typ, phys, validity) in cols:
            if typ.is_dict_encoded_string():
                did = typ.dict_id  # type: ignore[attr-defined]
                if did in pre_dicts:
                    raise ValueError(
                        f"process_local column {cname!r} declares a shared "
                        "dictionary; cross-process unification would "
                        "rewrite codes of previously ingested tables — "
                        "import it with a fresh dictionary instead")
                trans = unify_process_dictionary(self._dicts.get(did))
                codes = np.asarray(phys)
                phys = np.where(codes >= 0, trans[np.maximum(codes, 0)],
                                NULL_CODE).astype(np.int32)
            out.append((cname, typ, phys, validity))
        return out

    def import_arrow(self, at, name: Optional[str] = None,
                     schema=None) -> QueryNode:
        """reference: hdk.py:2361 import_arrow.

        With ``storage.prefetch_device`` (default on), each column's
        device transfer is issued on the ingest worker the moment its
        host decode completes, overlapping the next column's decode —
        and fragment stats warm in the background, so the first query
        pays neither (SURVEY §2.7 P3 ingest/compute overlap)."""
        name = self._table_name(name)
        if not self._config.storage.prefetch_device:
            cols = _imp.columns_from_arrow(at, self._dicts, schema)
            return self._register(name, cols)
        from .storage.table import Column, ColumnInfo

        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        built = []

        def pipeline(tup):
            cname, typ, data, validity = tup
            col = Column(ColumnInfo(tid, len(built), cname, typ),
                         data, validity)
            built.append(col)
            col.prefetch_device()

        _imp.columns_from_arrow(at, self._dicts, schema, pipeline=pipeline)
        from .storage.table import Table as _Table

        table = _Table(tid, name, built,
                       self._config.storage.fragment_size)
        table.prefetch_stats_async()
        self._schema.register(table)
        return self.scan(name)

    def import_pandas(self, df, name: Optional[str] = None) -> QueryNode:
        return self.import_arrow(
            __import__("pyarrow").Table.from_pandas(df, preserve_index=False),
            name)

    def import_csv(self, path, name: Optional[str] = None, **read_options) -> QueryNode:
        """reference: hdk.py:2229 import_csv (Arrow multithreaded reader)."""
        import pyarrow.csv as pacsv

        paths = path if isinstance(path, (list, tuple)) else [path]
        tables = [pacsv.read_csv(p, **read_options) for p in paths]
        import pyarrow as pa

        at = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        return self.import_arrow(at, name)

    def import_parquet(self, path, name: Optional[str] = None) -> QueryNode:
        """reference: hdk.py:2313 import_parquet."""
        import pyarrow.parquet as pq

        return self.import_arrow(pq.read_table(path), name)

    def import_json(self, path, name: Optional[str] = None,
                    **read_options) -> QueryNode:
        """Line-delimited JSON files via the Arrow reader (reference:
        ArrowStorage importJson*, ArrowStorage.h:29-135)."""
        import pyarrow as pa
        import pyarrow.json as pajson

        paths = path if isinstance(path, (list, tuple)) else [path]
        tables = [pajson.read_json(p, **read_options) for p in paths]
        at = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        return self.import_arrow(at, name)

    def create_table(self, name: str, schema: Dict[str, object]) -> QueryNode:
        """Empty table from {col: type-string-or-Type}
        (reference: hdk.py:2130 create_table)."""
        resolved = {
            k: (types.parse_type(v) if isinstance(v, str) else v)
            for k, v in schema.items()
        }
        data = {k: np.zeros(0, v.physical_dtype()) for k, v in resolved.items()}
        # text columns need a dictionary even when empty
        for k, v in list(resolved.items()):
            if v.is_string():
                d = self._dicts.create()
                resolved[k] = types.dict_text(d.dict_id)
                data[k] = np.zeros(0, np.int32)
        cols = [(k, v, data[k], None) for k, v in resolved.items()]
        return self._register(name, cols)

    def clear_device_mem(self) -> None:
        """Drop cached device copies of all table columns
        (reference: hdk.py:2521 clear_gpu_mem)."""
        for tname in self._schema.table_names():
            table = self._schema.get(tname)
            for col in table.columns:
                col.drop_device_cache()
                if hasattr(col, "_device_sharded"):
                    col._device_sharded = None

    def refragmented_view(self, name: str, new_name: str,
                          fragment_size: int) -> QueryNode:
        """View of a table with a different fragment size
        (reference: hdk.py:2527 refragmented_view)."""
        from .storage.table import Table

        src = self._schema.get(name)
        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        cols = [c for c in src.columns if not c.info.is_rowid]
        view = Table(tid, new_name, cols, fragment_size)
        self._schema.register(view)
        return self.scan(new_name)

    def drop_table(self, name: str) -> None:
        """reference: hdk.py:2169."""
        self._schema.drop(name)

    def append_pydict(self, name: str, data: Dict[str, Sequence]) -> None:
        """reference: import append logic hdk.py:2292-2305."""
        table = self._schema.get(name)
        schema = {c.info.name: c.type for c in table.columns if not c.info.is_rowid}
        cols = _imp.columns_from_pydict(data, self._dicts, schema)
        from .storage.table import Column, ColumnInfo

        ordered = []
        by_name = dict((n, (ty, d, v)) for n, ty, d, v in cols)
        for c in table.columns:
            if c.info.is_rowid:
                continue
            ty, d, v = by_name[c.info.name]
            ordered.append(Column(c.info, d, v))
        table.append(ordered)

    # -- query construction -------------------------------------------------
    def scan(self, name: str) -> QueryNode:
        """reference: hdk.py:2556 scan."""
        return QueryNode(_ir_node.Scan(self._schema.get(name)), self)

    def table_names(self):
        return self._schema.table_names()

    def cst(self, value, type_str: Optional[str] = None) -> QueryExpr:
        """Literal (reference: hdk.py:2652 cst)."""
        if type_str is not None:
            typ = types.parse_type(type_str)
            return QueryExpr(_ir_expr.Constant(typ, value))
        from .builder import _to_expr

        return QueryExpr(_to_expr(value))

    def date(self, value: str) -> QueryExpr:
        """reference: hdk.py:2700 date literal."""
        days = np.datetime64(value, "D").astype(np.int64)
        return QueryExpr(_ir_expr.Constant(types.date32(False), int(days)))

    def timestamp(self, value: str, unit: str = "us") -> QueryExpr:
        """reference: hdk.py:2769 timestamp literal."""
        tu = types.TimeUnit(unit)
        v = np.datetime64(value).astype(f"datetime64[{unit}]").astype(np.int64)
        return QueryExpr(_ir_expr.Constant(types.timestamp(tu, False), int(v)))

    def time(self, value: str) -> QueryExpr:
        """reference: hdk.py:2735 time literal."""
        h, m, s = (list(map(int, value.split(":"))) + [0, 0])[:3]
        return QueryExpr(_ir_expr.Constant(
            types.time64(types.TimeUnit.SECOND, False), h * 3600 + m * 60 + s))

    if_then_else = staticmethod(if_then_else)

    # -- window function constructors (reference: hdk.py:2791-2922) ---------
    def _window(self, kind: "_ir_expr.WindowKind", typ, arg1=None,
                name: str = "") -> QueryExpr:
        wf = _ir_expr.WindowFunction(typ, kind, [], [], [], (), arg1)
        return QueryExpr(wf, name or kind.value)

    def row_number(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.ROW_NUMBER, types.int64(False))

    def rank(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.RANK, types.int64(False))

    def dense_rank(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.DENSE_RANK, types.int64(False))

    def percent_rank(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.PERCENT_RANK, types.fp64(False))

    def cume_dist(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.CUME_DIST, types.fp64(False))

    def ntile(self, tile_count: int) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.NTILE, types.int64(False),
                            arg1=tile_count)

    # -- streaming (reference: Execute.h:212-226 streaming API) -------------
    def create_stream(self, schema: Dict[str, object], keys, aggs):
        """Incremental GROUP BY over arriving batches
        (reference: prepareStreamingExecution/runOnBatch/finish,
        Execute.cpp:1800-1889)."""
        from .streaming import StreamingAggregation

        return StreamingAggregation(self, schema, list(keys), list(aggs))

    # -- SQL ----------------------------------------------------------------
    def sql(self, query: str, **options) -> "QueryResult":
        """Execute a SQL query (reference: hdk.py:2456 HDK.sql; parser/
        binder replace the embedded Calcite JVM, SURVEY.md §2.1).
        ``EXPLAIN SELECT ...`` returns the plan text (reference:
        executeExplain, Execute.h:459)."""
        from .sql.binder import Binder

        stripped = query.lstrip()
        if stripped[:8].lower() == "explain ":
            options = dict(options, just_explain=True)
            query = stripped[8:]
        from .exec.scalar import ExecError
        from .sql.lexer import SqlError

        try:
            node = Binder(self).bind(query)
            return self._run(node, **options)
        except (SqlError, ExecError) as err:
            if not self._config.exec.enable_interop:
                raise
            return self._sql_interop(query, err)

    def _sql_interop(self, query: str, err: Exception) -> "QueryResult":
        """External-executor escape hatch (reference:
        ExternalExecutor.h:50, gated by exec.enable_interop with the
        fallback seam at RelAlgExecutor.cpp:443-449): a query the
        native engine rejects (unsupported dialect/op) re-runs through
        in-memory SQLite over the session's tables — the same engine
        the reference delegates to.  Tables referenced by name are
        exported through the engine's own scan path (dictionary columns
        decode to strings); the SQLite result imports back as a normal
        result table.  Types round-trip with SQLite's affinity rules —
        an escape hatch, not a performance path."""
        import re
        import sqlite3

        import pandas as pd

        names = [n for n in self._schema.table_names()
                 if re.search(rf"\b{re.escape(n)}\b", query, re.I)]
        if not names:
            raise err
        conn = sqlite3.connect(":memory:")
        try:
            for n in names:
                df = self.scan(n).run().to_pandas()
                df.to_sql(n, conn, index=False)
            out = pd.read_sql_query(query, conn)
        except Exception:
            raise err  # surface the ENGINE's error, not SQLite's
        finally:
            conn.close()
        import jax.numpy as jnp

        from .exec.masked import MaskedCol
        from .utils.logger import get_channel

        cols = []
        fields = []
        typs = []
        for cname, typ, data, validity in _imp.columns_from_pandas(
                out, self._dicts):
            fields.append(cname)
            typs.append(typ)
            cols.append(MaskedCol(
                jnp.asarray(data),
                jnp.asarray(validity) if validity is not None else None))
        table = ExecTable(fields, typs, cols, len(out))
        get_channel("sql").info(
            "interop fallback ran %d-table query through SQLite "
            "(engine said: %s)", len(names), str(err)[:120])
        return QueryResult(self, table)

    # -- execution ----------------------------------------------------------
    def explain(self, node_or_sql, analyze: bool = False) -> str:
        """Plan text (reference: EXPLAIN / just_explain,
        RelAlgExecutor.cpp:239-267).  ``analyze=True`` EXECUTES the
        query with every step forced + timed (honest sync per step) and
        annotates each plan line with [ms, rows] — the EXPLAIN ANALYZE
        role, combining the reference's EXPLAIN with its DebugTimer
        DurationTree."""
        from .exec.explain import explain_dag
        from .exec.optimizer import optimize_dag

        if isinstance(node_or_sql, str):
            from .sql.binder import Binder

            node = Binder(self).bind(node_or_sql)
        elif isinstance(node_or_sql, QueryNode):
            node = node_or_sql.node
        else:
            node = node_or_sql
        dag = optimize_dag(_ir_node.QueryDag(node), self._config)
        annotations = None
        if analyze:
            ex = self._executor
            ex._analyze = True
            ex._step_times = {}
            samp0 = ex._ndv_sample_seconds
            builds0 = ex.code_cache.misses
            try:
                ex.execute(dag)
            finally:
                ex._analyze = False
            annotations = {
                nid: f"{ms:.1f} ms, {rows} rows"
                for nid, (ms, rows) in ex._step_times.items()
            }
            out = explain_dag(dag.root, annotations)
            samp = ex._ndv_sample_seconds - samp0
            if samp > 0:
                # estimator host pulls are the one round-trip class the
                # engine otherwise avoids — surface their share
                out += (f"\n-- sampling estimators (NDV/skew): "
                        f"{samp * 1000:.1f} ms of host readback\n")
            # builds-per-query: each CodeCache miss wraps one jax.jit,
            # i.e. one device compile per shape — the cold-latency
            # driver (VERDICT r4 next #8; reference analog: multifrag
            # kernel consolidation, QueryFragmentDescriptor.h:64-83)
            builds = ex.code_cache.misses - builds0
            out += f"\n-- jit builds this run: {builds}\n"
            return out
        return explain_dag(dag.root, annotations)

    def _run(self, node, **options) -> QueryResult:
        """Execute with per-query options (reference: QueryOptions,
        hdk.py:2017-2110 — device_type/watchdog/just_explain; options
        that are meaningless on a single-target engine are accepted
        and ignored for compatibility)."""
        from .exec.optimizer import optimize_dag

        known = {"just_explain", "device_type", "enable_watchdog",
                 "watchdog_time_limit_ms", "enable_lazy_fetch",
                 "enable_columnar_output", "enable_dynamic_watchdog",
                 "forced_gpu_proportion"}
        unknown = set(options) - known
        if unknown:
            raise TypeError(f"unknown query options: {sorted(unknown)}")
        dag = _ir_node.QueryDag(node)
        dag = optimize_dag(dag, self._config)
        if options.get("just_explain"):
            from .exec.explain import explain_dag

            return explain_dag(dag.root)  # type: ignore[return-value]
        dag, plan_fb = self._choose_plan_variant(node, dag)
        wd = self._config.exec.watchdog
        saved = (wd.enable, wd.time_limit_ms)
        if "enable_watchdog" in options:
            wd.enable = bool(options["enable_watchdog"])
        if "watchdog_time_limit_ms" in options:
            wd.time_limit_ms = int(options["watchdog_time_limit_ms"])
            wd.enable = True
        try:
            if plan_fb is not None:
                import time as _time

                sig, variant = plan_fb
                t0 = _time.perf_counter()
                table = self._executor.execute(dag)
                self._executor._force_table(table)
                self._executor._plan_feedback.record(
                    sig, variant, _time.perf_counter() - t0)
            else:
                table = self._executor.execute(dag)
        finally:
            wd.enable, wd.time_limit_ms = saved
        return QueryResult(self, table)

    def _choose_plan_variant(self, node, rewritten):
        """Plan-level measured feedback for the eager-aggregation
        rewrite (VERDICT r4 #7; reference seam: cost-model-driven
        policy, CostModel/CostModel.h:45): when the rewrite changed the
        plan, the first repetitions of this plan shape run each variant
        once cold (compiles) and once timed (warm), then the session
        sticks with the measured winner — a mis-fired rewrite
        self-disables.  Returns (dag, None) or (dag, (sig, variant))
        when this execution should be timed and recorded."""
        ecfg = self._config.exec
        if (not ecfg.enable_eager_aggregation
                or not ecfg.enable_route_feedback):
            return rewritten, None
        from .exec import optimizer as _opt
        from .exec.explain import explain_dag

        # quick structural gate before paying a second optimizer pass
        has_agg_join = any(
            isinstance(n, _ir_node.Aggregate)
            for n in rewritten.topo_order()
        ) and any(isinstance(n, _ir_node.Join)
                  for n in rewritten.topo_order())
        if not has_agg_join:
            return rewritten, None
        import copy as _copy

        cfg_off = _copy.deepcopy(self._config)
        cfg_off.exec.enable_eager_aggregation = False
        alt = _opt.optimize_dag(_ir_node.QueryDag(node), cfg_off)
        rew_txt = explain_dag(rewritten.root)
        alt_txt = explain_dag(alt.root)
        if rew_txt == alt_txt:
            return rewritten, None  # rewrite didn't fire
        sig = "eagerplan|" + alt_txt
        variant, mode = self._executor._plan_feedback.choose(
            sig, ["rewrite", "original"])
        chosen = rewritten if variant == "rewrite" else alt
        if mode == "timed":
            return chosen, (sig, variant)
        return chosen, None


_global: Optional[HDK] = None
_global_lock = threading.Lock()


def init(**kwargs) -> HDK:
    """Global session (reference: pyhdk.init singleton, hdk.py:2956-2963 —
    repeat calls return the existing instance, kwargs ignored)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = HDK(**kwargs)
        return _global
