"""DAG optimizer passes.

Reference: QueryEngine/RelAlgOptimizer.cpp (1682 LoC) — mark-noops,
eliminate-identical-copies, fold-filters, eliminate-dead-columns,
coalesce — plus QueryRewrite.cpp (expression rewrites) and
FromTableReordering.cpp (cardinality-ordered joins).  Documented in
docs/source/execution/optimizer.rst.

Implemented passes (each a pure rewrite producing a new DAG):
  * eliminate_identity_projections — drop no-op Projects
    (RelAlgOptimizer.cpp mark-noops / eliminate-copies);
  * fold_filters — merge adjacent Filters into one AND condition
    (RelAlgOptimizer.cpp fold-filters);
  * push_down_filters — move filter conjuncts below Project / Join /
    Sort / Union / Aggregate-keys (RelAlgOptimizer.cpp
    pushDownFilterPredicates; hoisted filters shrink join probes and
    enable fragment skipping at the scan);
  * reorder_join_inputs — put the estimated-bigger side on the probe
    (lhs) of INNER hash joins (FromTableReordering.cpp, fed by
    exec/cost.py estimates);
  * rewrite_in_values — contiguous integer IN lists become range
    predicates (QueryRewrite.cpp style rewrite; ranges feed fragment
    skipping, an isin list cannot);
  * constant folding happens implicitly at trace time (XLA), so the
    reference's fold pass is unnecessary here.

Dead columns are pruned at execution (executor._used_columns + lazy
scan/join columns), not as a plan rewrite.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import types as t
from ..config import Config
from ..ir import expr as ir
from ..ir import node as nd


def _remap_expr(e: ir.Expr, mapping: Dict[int, nd.Node]) -> ir.Expr:
    if isinstance(e, ir.ColumnRef):
        new_node = mapping.get(e.node.id)
        if new_node is not None and new_node is not e.node:
            return ir.ColumnRef(e.type, new_node, e.index)
        return e
    ops = [_remap_expr(o, mapping) for o in e.operands()]
    return e.rebuild(*ops) if ops else e


def _rebuild_node(node: nd.Node, new_inputs, mapping) -> nd.Node:
    """Clone a node with rewritten inputs/exprs."""
    if isinstance(node, nd.Scan):
        return node
    if isinstance(node, nd.Project):
        return nd.Project(new_inputs[0],
                          [_remap_expr(e, mapping) for e in node.exprs],
                          node.fields)
    if isinstance(node, nd.Filter):
        return nd.Filter(new_inputs[0], _remap_expr(node.condition, mapping))
    if isinstance(node, nd.Aggregate):
        return nd.Aggregate(new_inputs[0],
                            [_remap_expr(e, mapping) for e in node.keys],
                            [_remap_expr(a, mapping) for a in node.aggs],
                            node.fields)
    if isinstance(node, nd.Join):
        pairs = [(_remap_expr(l, mapping), _remap_expr(r, mapping))
                 for l, r in node.key_pairs]
        residual = (_remap_expr(node.residual, mapping)
                    if node.residual is not None else None)
        return nd.Join(new_inputs[0], new_inputs[1], pairs, node.join_type,
                       residual)
    if isinstance(node, nd.Sort):
        return nd.Sort(new_inputs[0], node.sort_fields, node.limit, node.offset)
    if isinstance(node, nd.Unnest):
        return nd.Unnest(new_inputs[0], node.field_index)
    if isinstance(node, nd.LogicalUnion):
        return nd.LogicalUnion(new_inputs, node.all)
    if isinstance(node, nd.LogicalValues):
        return node
    raise TypeError(f"unknown node {node!r}")


def _transform(dag: nd.QueryDag, visit) -> nd.QueryDag:
    """Bottom-up rewrite.  ``visit(node)`` may return a replacement node
    (must be schema-compatible)."""
    mapping: Dict[int, nd.Node] = {}
    for node in dag.topo_order():
        new_inputs = [mapping[i.id] for i in node.inputs]
        changed = any(ni is not oi for ni, oi in zip(new_inputs, node.inputs))
        cur = _rebuild_node(node, new_inputs, mapping) if changed else node
        replacement = visit(cur)
        mapping[node.id] = replacement if replacement is not None else cur
    return nd.QueryDag(mapping[dag.root.id])


def eliminate_identity_projections(dag: nd.QueryDag) -> nd.QueryDag:
    def visit(node: nd.Node):
        if isinstance(node, nd.Project) and node.is_identity():
            inp = node.inputs[0]
            if node.fields == inp.fields:
                return inp
        return None

    return _transform(dag, visit)


def fold_filters(dag: nd.QueryDag) -> nd.QueryDag:
    def visit(node: nd.Node):
        if isinstance(node, nd.Filter) and isinstance(node.inputs[0], nd.Filter):
            inner = node.inputs[0]
            cond = ir.BinOp(
                t.boolean(node.condition.type.nullable
                          or inner.condition.type.nullable),
                ir.BinOpKind.AND, inner.condition, node.condition)
            # the merged filter reads columns through the removed one;
            # remap refs onto the inner filter's input
            remapped = _remap_expr(cond, {inner.id: inner.inputs[0]})
            return nd.Filter(inner.inputs[0], remapped)
        return None

    return _transform(dag, visit)


# ---------------------------------------------------------------------------
# filter pushdown
# ---------------------------------------------------------------------------

def _split_conjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.BinOp) and e.kind == ir.BinOpKind.AND:
        return _split_conjuncts(e.lhs) + _split_conjuncts(e.rhs)
    return [e]


def _and_all(conjuncts: List[ir.Expr]) -> ir.Expr:
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = ir.BinOp(t.boolean(out.type.nullable or c.type.nullable),
                       ir.BinOpKind.AND, out, c)
    return out


def _refs_only_node(e: ir.Expr, node: nd.Node) -> bool:
    """True when every ColumnRef in ``e`` points at ``node`` directly
    (refs through filter aliases stay put — conservative)."""
    if isinstance(e, ir.ColumnRef):
        return e.node is node
    return all(_refs_only_node(o, node) for o in e.operands())


def _ref_indices(e: ir.Expr, out: set) -> None:
    if isinstance(e, ir.ColumnRef):
        out.add(e.index)
    for o in e.operands():
        _ref_indices(o, out)


def _contains_window(e: ir.Expr) -> bool:
    if isinstance(e, ir.WindowFunction):
        return True
    return any(_contains_window(o) for o in e.operands())


def _subst_refs(e: ir.Expr, node: nd.Node, repl) -> ir.Expr:
    """Replace ColumnRef(node, i) by repl(i)."""
    if isinstance(e, ir.ColumnRef) and e.node is node:
        return repl(e.index)
    ops = [_subst_refs(o, node, repl) for o in e.operands()]
    return e.rebuild(*ops) if ops else e


def _push_once(f: nd.Filter) -> Optional[nd.Node]:
    """One pushdown step for a Filter, or None."""
    inp = f.inputs[0]
    if not _refs_only_node(f.condition, inp):
        return None

    if isinstance(inp, nd.Project):
        # Filter(Project(X)) -> Project(Filter(X)) with the condition's
        # refs substituted by the projected exprs.  Never past window
        # functions: they see all rows by definition.
        if any(_contains_window(e) for e in inp.exprs):
            return None
        cond = _subst_refs(f.condition, inp, lambda i: inp.exprs[i])
        return nd.Project(nd.Filter(inp.inputs[0], cond), inp.exprs,
                          inp.fields)

    if isinstance(inp, nd.Sort):
        # commutes only without a limit/offset window
        if inp.limit is not None or inp.offset:
            return None
        cond = _subst_refs(f.condition, inp,
                           lambda i: inp.inputs[0].ref(i))
        return nd.Sort(nd.Filter(inp.inputs[0], cond), inp.sort_fields,
                       inp.limit, inp.offset)

    if isinstance(inp, nd.Aggregate):
        # key-referencing conjuncts commute with GROUP BY (the
        # reference's HAVING-to-WHERE hoist); agg-referencing ones stay
        nkeys = len(inp.keys)
        push, keep = [], []
        for c in _split_conjuncts(f.condition):
            idx: set = set()
            _ref_indices(c, idx)
            (push if idx and max(idx) < nkeys else keep).append(c)
        if not push:
            return None
        cond = _subst_refs(_and_all(push), inp, lambda i: inp.keys[i])
        agg = nd.Aggregate(nd.Filter(inp.inputs[0], cond), inp.keys,
                           inp.aggs, inp.fields)
        return nd.Filter(agg, _subst_refs(
            _and_all(keep), inp, lambda i: agg.ref(i))) if keep else agg

    if isinstance(inp, nd.Join):
        lhs, rhs = inp.inputs
        n_l = lhs.size()
        rhs_ok = inp.join_type == nd.JoinType.INNER
        l_push, r_push, keep = [], [], []
        for c in _split_conjuncts(f.condition):
            idx: set = set()
            _ref_indices(c, idx)
            if idx and max(idx) < n_l:
                l_push.append(c)
            elif rhs_ok and idx and min(idx) >= n_l:
                r_push.append(c)
            else:
                keep.append(c)
        if not l_push and not r_push:
            return None
        new_l, new_r = lhs, rhs
        if l_push:
            cond = _subst_refs(_and_all(l_push), inp, lambda i: lhs.ref(i))
            new_l = nd.Filter(lhs, cond)
        if r_push:
            cond = _subst_refs(_and_all(r_push), inp,
                               lambda i: rhs.ref(i - n_l))
            new_r = nd.Filter(rhs, cond)

        def remap_side(e):
            # refs to the join's output rebind positionally; refs to the
            # ORIGINAL children (key pairs and residuals are expressed
            # against lhs/rhs directly) must move onto the new Filter
            # wrappers — the executor rebinds them by node identity
            def repl(i):
                return (new_l.ref(i) if i < n_l else new_r.ref(i - n_l))
            e = _subst_refs(e, inp, repl)
            if new_l is not lhs:
                e = _subst_refs(e, lhs, lambda i: new_l.ref(i))
            if new_r is not rhs:
                e = _subst_refs(e, rhs, lambda i: new_r.ref(i))
            return e

        pairs = [(remap_side(l), remap_side(r)) for l, r in inp.key_pairs]
        residual = (remap_side(inp.residual)
                    if inp.residual is not None else None)
        join = nd.Join(new_l, new_r, pairs, inp.join_type, residual)
        if keep:
            return nd.Filter(join, _subst_refs(
                _and_all(keep), inp, lambda i: join.ref(i)))
        return join

    if isinstance(inp, nd.LogicalUnion):
        # replicate into every branch when branch schemas match the
        # union's (common-type promotion would retype the condition)
        idx: set = set()
        _ref_indices(f.condition, idx)
        for b in inp.inputs:
            if any(b.output_types[i] != inp.output_types[i] for i in idx):
                return None
        branches = [
            nd.Filter(b, _subst_refs(f.condition, inp,
                                     lambda i, b=b: b.ref(i)))
            for b in inp.inputs
        ]
        return nd.LogicalUnion(branches, inp.all)

    return None


def push_down_filters(dag: nd.QueryDag) -> nd.QueryDag:
    """Iterate single pushdown steps to a fixpoint (a filter hoisted
    below a Project may then sink below the Join underneath it)."""
    for _ in range(16):
        changed = [False]

        def visit(node: nd.Node):
            if isinstance(node, nd.Filter):
                repl = _push_once(node)
                if repl is not None:
                    changed[0] = True
                    return repl
            return None

        dag = _transform(dag, visit)
        if not changed[0]:
            break
        dag = fold_filters(dag)
    return dag


# ---------------------------------------------------------------------------
# join input reordering (cardinality-based)
# ---------------------------------------------------------------------------

def reorder_join_inputs(dag: nd.QueryDag) -> nd.QueryDag:
    """Swap INNER join inputs when the build side (rhs) is estimated
    bigger than the probe (reference: FromTableReordering.cpp); a
    Project on top restores the original column order."""
    from . import cost

    def visit(node: nd.Node):
        if not isinstance(node, nd.Join) or not cost.should_swap_join(node):
            return None
        lhs, rhs = node.inputs
        n_l = lhs.size()
        pairs = [(r, l) for l, r in node.key_pairs]
        swapped = nd.Join(rhs, lhs, pairs, node.join_type, node.residual,
                          suffix="_l")
        # swapped output = rhs ++ lhs; restore lhs ++ rhs order
        n_r = rhs.size()
        exprs = [swapped.ref(n_r + i) for i in range(n_l)] + [
            swapped.ref(i) for i in range(n_r)]
        if node.residual is not None:
            def repl(i):
                return (swapped.ref(n_r + i) if i < n_l
                        else swapped.ref(i - n_l))
            swapped.residual = _subst_refs(node.residual, node, repl)
        return nd.Project(swapped, exprs, node.fields)

    return _transform(dag, visit)


# ---------------------------------------------------------------------------
# join CHAIN reordering (left-deep, cardinality-ordered)
# ---------------------------------------------------------------------------

def _is_chain_join(n: nd.Node) -> bool:
    return (isinstance(n, nd.Join) and n.join_type == nd.JoinType.INNER
            and bool(n.key_pairs))


def _collect_chain(head: nd.Join):
    """Walk lhs through consecutive INNER keyed joins.  Returns
    (base, joins) with joins innermost-first."""
    joins: List[nd.Join] = []
    cur: nd.Node = head
    while _is_chain_join(cur):
        joins.append(cur)  # type: ignore[arg-type]
        cur = cur.inputs[0]
    joins.reverse()
    return cur, joins


def _reorder_one_chain(base: nd.Node, joins: List[nd.Join],
                       head: nd.Join) -> Optional[nd.Node]:
    """Reorder the build sides of a left-deep INNER join chain by
    ascending estimated cardinality, respecting key/residual column
    dependencies (reference: FromTableReordering.cpp orders the from-
    list by cardinality before nesting the join loops).  Returns a
    rebuilt chain + restoring Project, or None when the greedy order is
    already the written order."""
    from . import cost

    n = len(joins)
    sources: List[nd.Node] = [base] + [j.inputs[1] for j in joins]
    sizes = [s.size() for s in sources]
    cum = [0]
    for s in sizes:
        cum.append(cum[-1] + s)

    def src_of(p: int) -> int:
        for s in range(len(sources)):
            if p < cum[s + 1]:
                return s
        raise IndexError(p)

    # dependency sets: which sources each join's LEFT-side refs touch
    deps: List[set] = []
    for k, j in enumerate(joins):
        old_lhs = base if k == 0 else joins[k - 1]
        need: set = set()
        ok = True
        for l, _ in j.key_pairs:
            for ref in _collect_refs(l):
                if ref.node is not old_lhs:
                    ok = False
                need.add(src_of(ref.index))
        for _, r in j.key_pairs:
            for ref in _collect_refs(r):
                if ref.node is not j.inputs[1]:
                    ok = False
        if j.residual is not None:
            for ref in _collect_refs(j.residual):
                if ref.node is old_lhs:
                    need.add(src_of(ref.index))
                elif ref.node is not j.inputs[1]:
                    ok = False
        if not ok:
            return None
        deps.append(need)

    rows = [cost.estimate_rows(s) for s in sources]
    placed = {0}
    order: List[int] = []
    remaining = list(range(1, n + 1))
    while remaining:
        avail = [i for i in remaining if deps[i - 1] <= placed]
        pick = min(avail, key=lambda i: (rows[i], i))
        order.append(pick)
        placed.add(pick)
        remaining.remove(pick)
    if order == list(range(1, n + 1)):
        return None

    # rebuild in the new order
    cur: nd.Node = base
    offsets = {0: 0}
    width = sizes[0]
    for i in order:
        j = joins[i - 1]
        old_lhs = base if i == 1 else joins[i - 2]
        rhs = j.inputs[1]

        def remap(e: ir.Expr, cur=cur, old_lhs=old_lhs) -> ir.Expr:
            if isinstance(e, ir.ColumnRef):
                if e.node is old_lhs:
                    s = src_of(e.index)
                    return ir.ColumnRef(e.type, cur,
                                        offsets[s] + (e.index - cum[s]))
                return e  # rhs ref: node + index unchanged
            ops = [remap(o, cur, old_lhs) for o in e.operands()]
            return e.rebuild(*ops) if ops else e

        pairs = [(remap(l), r) for l, r in j.key_pairs]
        residual = remap(j.residual) if j.residual is not None else None
        cur = nd.Join(cur, rhs, pairs, nd.JoinType.INNER, residual,
                      suffix=f"_c{i}")
        offsets[i] = width
        width += sizes[i]

    # restore the head's column order and names
    exprs = []
    for q in range(head.size()):
        s = src_of(q)
        exprs.append(cur.ref(offsets[s] + (q - cum[s])))
    return nd.Project(cur, exprs, head.fields)


def _collect_refs(e: ir.Expr) -> List[ir.ColumnRef]:
    out: List[ir.ColumnRef] = []

    def walk(x: ir.Expr) -> None:
        if isinstance(x, ir.ColumnRef):
            out.append(x)
            return
        for o in x.operands():
            walk(o)

    walk(e)
    return out


def _enumerate_bushy(base: nd.Node, joins: List[nd.Join],
                     head: nd.Join) -> Optional[nd.Node]:
    """Bushy join enumeration: exact DP over the relations of a
    left-deep INNER chain (reference: FromTableReordering.cpp orders the
    from-list; this goes further and considers bushy shapes, so a
    snowflake's dim⋈dim can be planned before touching the fact table).

    Plan space: subsets of relations, merged only along equi predicates
    (no cartesian bushes).  Cardinality model matches exec/cost.py's
    FK assumption — an equi merge yields max(|A|, |B|) rows — and the
    objective is the sum of intermediate result sizes.  Equi conjuncts
    whose left side ends up split across both subtrees apply as residual
    filters at that merge (INNER joins commute with filters, so applying
    a predicate at the first merge containing its columns is exact).

    Returns a rebuilt tree + column-restoring Project, or None when the
    best plan is the written left-deep order (or the chain's shape is
    out of scope)."""
    from . import cost

    n = len(joins)
    sources: List[nd.Node] = [base] + [j.inputs[1] for j in joins]
    m = len(sources)
    if m > 6:
        return None  # 2^m DP: cap the search (greedy handles long chains)
    sizes = [s.size() for s in sources]
    cum = [0]
    for s in sizes:
        cum.append(cum[-1] + s)

    def src_of(p: int) -> int:
        for s in range(len(sources)):
            if p < cum[s + 1]:
                return s
        raise IndexError(p)

    # ---- normalize predicates: (sources, kind, payload) ---------------
    # equi: (lsrcs, rsrc, l_expr, r_expr, owner_join) with l over the
    # flattened chain space and r over the rhs source's local space
    equi = []
    resid = []  # (srcs, expr, owner_join)
    for k, j in enumerate(joins):
        old_lhs = base if k == 0 else joins[k - 1]
        rhs = j.inputs[1]
        for l, r in j.key_pairs:
            lsrcs = set()
            for ref in _collect_refs(l):
                if ref.node is not old_lhs:
                    return None
                lsrcs.add(src_of(ref.index))
            for ref in _collect_refs(r):
                if ref.node is not rhs:
                    return None
            if not lsrcs:
                return None  # constant key: out of scope
            equi.append((frozenset(lsrcs), k + 1, l, r, k))
        if j.residual is not None:
            srcs = set()
            for ref in _collect_refs(j.residual):
                if ref.node is old_lhs:
                    srcs.add(src_of(ref.index))
                elif ref.node is rhs:
                    srcs.add(k + 1)
                else:
                    return None
            resid.append((frozenset(srcs), j.residual, k))

    rows = [max(cost.estimate_rows(s), 1.0) for s in sources]

    def bits(subset: int):
        return [i for i in range(m) if subset >> i & 1]

    def key_formable(a_set: int, b_set: int) -> bool:
        for lsrcs, rsrc, _l, _r, _k in equi:
            la = all(a_set >> s & 1 for s in lsrcs)
            lb = all(b_set >> s & 1 for s in lsrcs)
            if (la and b_set >> rsrc & 1) or (lb and a_set >> rsrc & 1):
                return True
        return False

    full = (1 << m) - 1
    best: Dict[int, Tuple[float, object]] = {}
    subset_rows: Dict[int, float] = {}
    for i in range(m):
        best[1 << i] = (0.0, i)
        subset_rows[1 << i] = rows[i]
    for subset in range(1, full + 1):
        if subset.bit_count() < 2:
            continue
        subset_rows[subset] = max(rows[i] for i in bits(subset))
        lowest = subset & -subset
        a = (subset - 1) & subset
        while a > 0:
            b = subset ^ a
            if (a & lowest) and a in best and b in best \
                    and key_formable(a, b):
                c = best[a][0] + best[b][0] + subset_rows[subset]
                if subset not in best or c < best[subset][0] - 1e-9:
                    best[subset] = (c, (best[a][1], best[b][1]))
            a = (a - 1) & subset
    if full not in best:
        return None

    plan = best[full][1]
    expected: object = 0  # written order: (((0,1),2),...)
    for i in range(1, m):
        expected = (expected, i)
    if plan == expected:
        return None

    applied: set = set()

    def remap_into(e: ir.Expr, owner: int, node: nd.Node,
                   layout: List[int], offs: Dict[int, int]) -> ir.Expr:
        """Rewrite a pred expr's refs into ``node``'s column space.
        Refs to the owner join's old_lhs use the flattened chain space;
        refs to a source node use local indices."""
        old_lhs = base if owner == 0 else joins[owner - 1]

        def go(x: ir.Expr) -> ir.Expr:
            if isinstance(x, ir.ColumnRef):
                if x.node is old_lhs:
                    s = src_of(x.index)
                    return ir.ColumnRef(x.type, node,
                                        offs[s] + (x.index - cum[s]))
                # a source-local ref (the owner's rhs)
                for s, srcn in enumerate(sources):
                    if x.node is srcn:
                        return ir.ColumnRef(x.type, node, offs[s] + x.index)
                raise KeyError(x)
            ops = [go(o) for o in x.operands()]
            return x.rebuild(*ops) if ops else x

        return go(e)

    def build(p) -> Tuple[nd.Node, List[int]]:
        if isinstance(p, int):
            return sources[p], [p]
        (pa, pb) = p
        na, la = build(pa)
        nb, lb = build(pb)
        a_set = sum(1 << s for s in la)
        b_set = sum(1 << s for s in lb)
        offs_a = {}
        w = 0
        for s in la:
            offs_a[s] = w
            w += sizes[s]
        offs_b = {}
        w2 = 0
        for s in lb:
            offs_b[s] = w2
            w2 += sizes[s]
        pairs = []
        residuals = []
        for pi, (lsrcs, rsrc, l, r, k) in enumerate(equi):
            if ("e", pi) in applied:
                continue
            srcs = set(lsrcs) | {rsrc}
            if not all((a_set | b_set) >> s & 1 for s in srcs):
                continue
            in_a = any(a_set >> s & 1 for s in srcs)
            in_b = any(b_set >> s & 1 for s in srcs)
            if not (in_a and in_b):
                continue
            la_all = all(a_set >> s & 1 for s in lsrcs)
            lb_all = all(b_set >> s & 1 for s in lsrcs)
            if la_all and b_set >> rsrc & 1:
                pairs.append((remap_into(l, k, na, la, offs_a),
                              remap_into(r, k, nb, lb, offs_b)))
            elif lb_all and a_set >> rsrc & 1:
                pairs.append((remap_into(r, k, na, la, offs_a),
                              remap_into(l, k, nb, lb, offs_b)))
            else:
                # left side split across subtrees: equality as residual
                bt = t.boolean(l.type.nullable or r.type.nullable)
                residuals.append(("split", pi, bt))
            applied.add(("e", pi))
        for ri, (srcs, e, k) in enumerate(resid):
            if ("r", ri) in applied:
                continue
            if not all((a_set | b_set) >> s & 1 for s in srcs):
                continue
            if not (any(a_set >> s & 1 for s in srcs)
                    and any(b_set >> s & 1 for s in srcs)):
                continue
            residuals.append(("orig", ri, None))
            applied.add(("r", ri))
        if not pairs:
            raise _BushyBail()
        # residual exprs reference the join INPUTS (executor resolves
        # refs to inputs[0]/inputs[1] on candidate pairs)
        res_e: Optional[ir.Expr] = None
        for tag, idx, bt in residuals:
            if tag == "split":
                lsrcs, rsrc, l, r, k = equi[idx]
                # both sides land in pair space via input-node refs
                le = remap_two_sided(l, k, na, la, offs_a, nb, lb, offs_b)
                re_ = remap_two_sided(r, k, na, la, offs_a, nb, lb, offs_b)
                cond = ir.BinOp(bt, ir.BinOpKind.EQ, le, re_)
            else:
                srcs, e, k = resid[idx]
                cond = remap_two_sided(e, k, na, la, offs_a, nb, lb, offs_b)
            res_e = cond if res_e is None else ir.BinOp(
                t.boolean(res_e.type.nullable or cond.type.nullable),
                ir.BinOpKind.AND, res_e, cond)
        node = nd.Join(na, nb, pairs, nd.JoinType.INNER, res_e,
                       suffix="_b")
        return node, la + lb

    def remap_two_sided(e: ir.Expr, owner: int, na, la, offs_a,
                        nb, lb, offs_b) -> ir.Expr:
        old_lhs = base if owner == 0 else joins[owner - 1]

        def go(x: ir.Expr) -> ir.Expr:
            if isinstance(x, ir.ColumnRef):
                if x.node is old_lhs:
                    s = src_of(x.index)
                    c = x.index - cum[s]
                else:
                    s = next(i for i, srcn in enumerate(sources)
                             if x.node is srcn)
                    c = x.index
                if s in offs_a:
                    return ir.ColumnRef(x.type, na, offs_a[s] + c)
                return ir.ColumnRef(x.type, nb, offs_b[s] + c)
            ops = [go(o) for o in x.operands()]
            return x.rebuild(*ops) if ops else x

        return go(e)

    class _BushyBail(Exception):
        pass

    try:
        top, layout = build(plan)
    except _BushyBail:
        return None
    offs = {}
    w = 0
    for s in layout:
        offs[s] = w
        w += sizes[s]
    exprs = []
    for q in range(head.size()):
        s = src_of(q)
        exprs.append(top.ref(offs[s] + (q - cum[s])))
    return nd.Project(top, exprs, head.fields)


def reorder_join_chains(dag: nd.QueryDag) -> nd.QueryDag:
    """Apply _reorder_one_chain to every maximal chain.  Chains whose
    intermediate joins are shared by other consumers are left alone
    (rewriting would duplicate work for the other consumer)."""
    consumers: Dict[int, int] = {}
    for node in dag.topo_order():
        for i in node.inputs:
            consumers[i.id] = consumers.get(i.id, 0) + 1

    def visit(node: nd.Node):
        if not _is_chain_join(node):
            return None
        base, joins = _collect_chain(node)  # type: ignore[arg-type]
        if len(joins) < 2:
            return None
        # fire only at the head: a chain join consumed by another chain
        # join (as lhs) is an interior link
        for j in joins[:-1]:
            if consumers.get(j.id, 0) > 1:
                return None
        # exact bushy DP for small chains (snowflakes: dim⋈dim first);
        # the greedy left-deep reorder covers longer chains
        out = _enumerate_bushy(base, joins, node)  # type: ignore[arg-type]
        if out is not None:
            return out
        return _reorder_one_chain(base, joins, node)  # type: ignore[arg-type]

    # custom traversal: rebuild bottom-up but SKIP interior chain joins
    # (the head rebuild consumes them); _transform's generic rebuild is
    # reused for everything else
    mapping: Dict[int, nd.Node] = {}
    interior: set = set()
    for node in dag.topo_order():
        if _is_chain_join(node) and _is_chain_join(node.inputs[0]) \
                and consumers.get(node.inputs[0].id, 0) == 1:
            interior.add(node.inputs[0].id)
    for node in dag.topo_order():
        new_inputs = [mapping[i.id] for i in node.inputs]
        changed = any(ni is not oi for ni, oi in zip(new_inputs, node.inputs))
        cur = _rebuild_node(node, new_inputs, mapping) if changed else node
        if node.id not in interior:
            repl = visit(cur)
            if repl is not None:
                cur = repl
        mapping[node.id] = cur
    return nd.QueryDag(mapping[dag.root.id])


# ---------------------------------------------------------------------------
# IN-list rewrites
# ---------------------------------------------------------------------------

def rewrite_in_values(dag: nd.QueryDag) -> nd.QueryDag:
    """``x IN (3,4,5,6)`` -> ``x BETWEEN 3 AND 6`` for contiguous
    integer lists (QueryRewrite.cpp style): two compares instead of an
    isin, and range predicates drive fragment skipping."""
    def rewrite_expr(e: ir.Expr) -> ir.Expr:
        ops = [rewrite_expr(o) for o in e.operands()]
        e2 = e.rebuild(*ops) if ops else e
        if (isinstance(e2, ir.InValues) and len(e2.values) >= 2
                and e2.operand.type.is_integer()
                and all(isinstance(v, int) for v in e2.values)):
            vs = sorted(set(e2.values))
            if vs[-1] - vs[0] == len(vs) - 1:
                bt = t.boolean(e2.operand.type.nullable)
                ct = e2.operand.type.with_nullable(False)
                return ir.BinOp(
                    bt, ir.BinOpKind.AND,
                    ir.BinOp(bt, ir.BinOpKind.GE, e2.operand,
                             ir.Constant(ct, vs[0])),
                    ir.BinOp(bt, ir.BinOpKind.LE, e2.operand,
                             ir.Constant(ct, vs[-1])))
        return e2

    def visit(node: nd.Node):
        if isinstance(node, nd.Filter):
            cond = rewrite_expr(node.condition)
            if cond is not node.condition:
                return nd.Filter(node.inputs[0], cond)
        return None

    return _transform(dag, visit)


# ---------------------------------------------------------------------------
# eager aggregation (group-by pushdown below a join)
# ---------------------------------------------------------------------------

# kinds that decompose into partial-agg + combine through a duplicating
# join: the INNER join replicates each partial row once per matching
# build row, and SUM/COUNT re-add (MIN/MAX re-take) those replicas with
# exactly the multiplicity the original row-level aggregate saw
_EAGER_COMBINE = {
    ir.AggKind.COUNT: ir.AggKind.SUM,
    ir.AggKind.SUM: ir.AggKind.SUM,
    ir.AggKind.MIN: ir.AggKind.MIN,
    ir.AggKind.MAX: ir.AggKind.MAX,
}


def _subst_project(e: ir.Expr, p: nd.Project) -> ir.Expr:
    if isinstance(e, ir.ColumnRef) and e.node is p:
        return p.exprs[e.index]
    ops = [_subst_project(o, p) for o in e.operands()]
    return e.rebuild(*ops) if ops else e


def _rebase_to(e: ir.Expr, old_node: nd.Node, new_node: nd.Node,
               shift: int = 0) -> ir.Expr:
    if isinstance(e, ir.ColumnRef) and e.node is old_node:
        return ir.ColumnRef(e.type, new_node, e.index + shift)
    ops = [_rebase_to(o, old_node, new_node, shift) for o in e.operands()]
    return e.rebuild(*ops) if ops else e


def push_aggregation_below_join(dag: nd.QueryDag,
                                config: Config) -> nd.QueryDag:
    """Eager aggregation (Yan & Larson's eager group-by, VLDB'95): for

        Aggregate(keys=K, aggs=A, Project* (Join[inner](L, R)))

    where every agg in A is decomposable (COUNT/SUM/MIN/MAX, non-
    distinct) and references only L, rewrite to

        Aggregate(K', combine(A), Join[inner](Aggregate(L, JK∪K_L, A'), R))

    — the pre-aggregate runs on L at join-key granularity, the join
    replicates partial rows per matching R row, and the outer combine
    (SUM of partial COUNT/SUM, MIN/MAX of partial MIN/MAX) restores the
    original multiplicities exactly, so the rewrite is correct for ANY
    R-side duplication.  Cost-gated: fires when the probe side is large
    (exec.eager_agg_min_rows) and dominates the build side
    (eager_agg_min_ratio) — then the probe-side random-gather join
    traffic (the dominant cost of filtered FK joins, e.g. TPC-H Q3's
    60M-row lineitem probe) collapses to a bounded-key dense reduction.

    Reference analog: the reference keeps aggregates above joins and
    makes the join fast with perfect hash tables
    (PerfectJoinHashTable.h:54); here the probe is a device-memory
    random gather per probe row while a dense bounded-key reduction
    streams, so this plan inverts the order (gated by cost and by
    measured feedback, exec/feedback.py).
    """
    cfg = config.exec
    if not cfg.enable_eager_aggregation:
        return dag
    from .codecache import expr_sig
    from .cost import estimate_rows

    consumers: Dict[int, int] = {}
    for node in dag.topo_order():
        for i in node.inputs:
            consumers[i.id] = consumers.get(i.id, 0) + 1

    def visit(old: nd.Node, cur: nd.Node) -> Optional[nd.Node]:
        if not isinstance(cur, nd.Aggregate) or not cur.keys:
            return None
        if any(a.distinct or (a.kind not in _EAGER_COMBINE
                              and a.kind != ir.AggKind.AVG)
               for a in cur.aggs):
            return None
        # descend through exclusively-consumed Projects to an INNER join
        chain: List[nd.Project] = []
        o, c = old.inputs[0], cur.inputs[0]
        while (isinstance(c, nd.Project)
               and consumers.get(o.id, 0) == 1):
            chain.append(c)
            o, c = o.inputs[0], c.inputs[0]
        if (not isinstance(c, nd.Join)
                or c.join_type != nd.JoinType.INNER
                or c.residual is not None or not c.key_pairs
                or consumers.get(o.id, 0) != 1):
            return None
        join: nd.Join = c
        lhs_node, rhs_node = join.inputs
        nl = len(lhs_node.fields)

        # compose aggregate exprs through the Project chain down to the
        # join's output columns
        def compose(e: ir.Expr) -> ir.Expr:
            for p in chain:
                e = _subst_project(e, p)
            return e

        keys = [compose(k) for k in cur.keys]
        aggs = [a.rebuild(*(compose(op) for op in a.operands()))
                for a in cur.aggs]
        if any(_contains_window(e) for e in keys + list(aggs)):
            return None

        def side_of(e: ir.Expr) -> str:
            refs = _collect_refs(e)
            if not refs:
                return "C"  # constant key: passes through either side
            if any(r.node is not join for r in refs):
                return "X"
            sides = {"L" if r.index < nl else "R" for r in refs}
            return sides.pop() if len(sides) == 1 else "X"

        key_sides = [side_of(k) for k in keys]
        if any(s == "X" for s in key_sides):
            return None
        for a in aggs:
            if any(side_of(op) != "L" for op in a.operands()):
                return None  # agg over R (or mixed): not decomposable here

        # cost gate: the pre-aggregate pays one pass over L; it wins
        # when L dominates (probe-side traffic is the join's cost)
        est_l = estimate_rows(lhs_node)
        if (est_l < cfg.eager_agg_min_rows
                or est_l < cfg.eager_agg_min_ratio
                * max(estimate_rows(rhs_node), 1.0)):
            return None

        def rebase_l(e: ir.Expr) -> ir.Expr:
            return _rebase_to(e, join, lhs_node)

        # pre-aggregate keys: the join keys (required granularity: the
        # join must still see every distinct key value) plus any extra
        # L-side group keys (finer granularity, still correct)
        sig_ids = {lhs_node.id: "L"}
        pre_keys: List[ir.Expr] = [lk for lk, _ in join.key_pairs]
        pre_sigs = [expr_sig(k, sig_ids) for k in pre_keys]
        key_slot: Dict[int, int] = {}  # original key idx -> pre_keys idx
        for i, (k, s) in enumerate(zip(keys, key_sides)):
            if s != "L":
                continue
            rk = rebase_l(k)
            ks = expr_sig(rk, sig_ids)
            if ks in pre_sigs:
                key_slot[i] = pre_sigs.index(ks)
            else:
                key_slot[i] = len(pre_keys)
                pre_keys.append(rk)
                pre_sigs.append(ks)
        # AVG decomposes as SUM/COUNT partials + a restoring division
        # above the combine aggregate (reference: the same split the
        # reference's shared-mem AVG reduction does, TargetExprBuilder
        # AVG = agg_sum/agg_count pair)
        pre_aggs: List[ir.AggExpr] = []
        agg_plan: List[tuple] = []  # per orig agg: ("d", slot)|("avg", s, c)
        for a in aggs:
            if a.kind == ir.AggKind.AVG:
                agg_plan.append(("avg", len(pre_aggs), len(pre_aggs) + 1))
                pre_aggs.append(ir.AggExpr(a.type, ir.AggKind.SUM,
                                           rebase_l(a.operand)))
                pre_aggs.append(ir.AggExpr(t.int64(False), ir.AggKind.COUNT,
                                           rebase_l(a.operand)))
            else:
                agg_plan.append(("d", len(pre_aggs)))
                pre_aggs.append(ir.AggExpr(
                    a.type, a.kind,
                    rebase_l(a.operand) if a.operand is not None else None))
        npk = len(pre_keys)
        pre_fields = [f"__pk{i}" for i in range(npk)] + [
            f"__pa{j}" for j in range(len(pre_aggs))]
        preagg = nd.Aggregate(lhs_node, pre_keys, pre_aggs, pre_fields)

        new_pairs = [
            (ir.ColumnRef(preagg.output_types[i], preagg, i), rk)
            for i, (_, rk) in enumerate(join.key_pairs)
        ]
        newjoin = nd.Join(preagg, rhs_node, new_pairs, nd.JoinType.INNER)
        npre = len(pre_fields)

        new_keys: List[ir.Expr] = []
        for i, (k, s) in enumerate(zip(keys, key_sides)):
            if s == "L":
                p = key_slot[i]
                new_keys.append(
                    ir.ColumnRef(newjoin.output_types[p], newjoin, p))
            elif s == "R":
                new_keys.append(
                    _rebase_to(_rebase_to(k, join, rhs_node, -nl),
                               rhs_node, newjoin, npre))
            else:  # constant
                new_keys.append(k)
        # partial-agg column j sits at join output slot npk+j; its type
        # is the pre-agg output type there
        def pref(j: int) -> ir.ColumnRef:
            return ir.ColumnRef(newjoin.output_types[npk + j], newjoin,
                                npk + j)

        new_aggs: List[ir.AggExpr] = []
        out_plan: List[tuple] = []  # ("d", combined idx)|("avg", s, c)
        for plan, a in zip(agg_plan, aggs):
            if plan[0] == "d":
                out_plan.append(("d", len(new_aggs)))
                new_aggs.append(ir.AggExpr(a.type, _EAGER_COMBINE[a.kind],
                                           pref(plan[1])))
            else:
                out_plan.append(("avg", len(new_aggs), len(new_aggs) + 1))
                new_aggs.append(ir.AggExpr(a.type, ir.AggKind.SUM,
                                           pref(plan[1])))
                new_aggs.append(ir.AggExpr(t.int64(False), ir.AggKind.SUM,
                                           pref(plan[2])))
        if all(p[0] == "d" for p in out_plan):
            return nd.Aggregate(newjoin, new_keys, new_aggs, cur.fields)
        # AVG present: combine aggregate + a Project computing s/c (the
        # all-NULL-operand group yields a NULL partial sum, so the NULL
        # mask propagates through the division exactly like row-level AVG)
        nk = len(new_keys)
        fa_fields = list(cur.fields[:nk]) + [
            f"__fa{j}" for j in range(len(new_aggs))]
        final = nd.Aggregate(newjoin, new_keys, new_aggs, fa_fields)
        exprs: List[ir.Expr] = [
            ir.ColumnRef(final.output_types[i], final, i) for i in range(nk)]
        for plan, a in zip(out_plan, aggs):
            if plan[0] == "d":
                i = nk + plan[1]
                exprs.append(ir.ColumnRef(final.output_types[i], final, i))
            else:
                s_ref = ir.ColumnRef(final.output_types[nk + plan[1]],
                                     final, nk + plan[1])
                c_ref = ir.ColumnRef(final.output_types[nk + plan[2]],
                                     final, nk + plan[2])
                exprs.append(ir.BinOp(a.type, ir.BinOpKind.DIV, s_ref,
                                      c_ref))
        return nd.Project(final, exprs, cur.fields)

    mapping: Dict[int, nd.Node] = {}
    for node in dag.topo_order():
        new_inputs = [mapping[i.id] for i in node.inputs]
        changed = any(ni is not oi
                      for ni, oi in zip(new_inputs, node.inputs))
        cur = _rebuild_node(node, new_inputs, mapping) if changed else node
        repl = visit(node, cur)
        mapping[node.id] = repl if repl is not None else cur
    return nd.QueryDag(mapping[dag.root.id])


def pull_projections_above_sort(dag: nd.QueryDag) -> nd.QueryDag:
    """``Sort(Project(X))`` where the Project is pure column refs
    becomes ``Project(Sort(X))`` (sort fields remapped through the
    permutation).  Sorting commutes with a pure projection, and the
    swap unblocks the executor's agg→sort fusion (ONE device program
    for GROUP BY + ORDER BY/LIMIT, no trim step, no group-count host
    sync) for SQL plans, which always interpose the output Project the
    builder API doesn't.  Reference analog: RelAlgDag coalesces the
    Sort into the preceding compound node for the same reason
    (RelAlgDag.cpp create_compound)."""
    consumers: Dict[int, int] = {}
    for node in dag.topo_order():
        for i in node.inputs:
            consumers[i.id] = consumers.get(i.id, 0) + 1

    def visit(node: nd.Node) -> Optional[nd.Node]:
        if not isinstance(node, nd.Sort):
            return None
        proj = node.inputs[0]
        if (not isinstance(proj, nd.Project)
                or consumers.get(proj.id, 0) != 1
                or not all(isinstance(e, ir.ColumnRef)
                           for e in proj.exprs)):
            return None
        inner = proj.inputs[0]
        new_sf = [
            nd.SortField(proj.exprs[f.field_index].index, f.desc,
                         f.nulls_first)
            for f in node.sort_fields
        ]
        new_sort = nd.Sort(inner, new_sf, node.limit, node.offset)
        exprs = [ir.ColumnRef(e.type, new_sort, e.index)
                 for e in proj.exprs]
        return nd.Project(new_sort, exprs, proj.fields)

    return _transform(dag, visit)


def optimize_dag(dag: nd.QueryDag, config: Config) -> nd.QueryDag:
    dag = eliminate_identity_projections(dag)
    dag = fold_filters(dag)
    dag = rewrite_in_values(dag)
    dag = push_down_filters(dag)
    dag = reorder_join_chains(dag)
    dag = reorder_join_inputs(dag)
    dag = push_aggregation_below_join(dag, config)
    dag = pull_projections_above_sort(dag)
    return dag
