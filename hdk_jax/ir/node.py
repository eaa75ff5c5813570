"""Relational-algebra node DAG.

Analog of hdk::ir::Node (reference: omniscidb/IR/Node.h:72 —
Scan:219, Project:291, Aggregate:373, Join:463, Filter:634, Sort:693,
LogicalValues:785, LogicalUnion:849) and QueryDag
(IR/Node.h:~940).

Differences from the reference, chosen for the JAX executor:
  * Joins are equi-joins over explicit key-pair lists plus an optional
    residual condition (the reference keeps a single condition expr and
    later splits it in WorkUnitBuilder; splitting at construction keeps
    the physical hash-join contract visible in the IR).
  * The reference's Shuffle node (IR/Node.h:871-933) has no IR analog
    here: shuffles are an execution-layer concern (parallel/shuffle.py
    all_to_all inside shard_map), never a plan node.
"""

from __future__ import annotations

import enum
import itertools
from typing import List, Optional, Sequence, Tuple

from .. import types as t
from .expr import AggExpr, ColumnRef, Expr

_node_ids = itertools.count()


class JoinType(enum.Enum):
    """reference: IR/Node.h Join (INNER/LEFT/SEMI/ANTI)."""

    INNER = "inner"
    LEFT = "left"
    SEMI = "semi"
    ANTI = "anti"


class Node:
    """Base DAG node; ``fields`` names each output column, ``output_types``
    gives their types (reference: Node::size/getOutputMetainfo)."""

    def __init__(self, inputs: Sequence["Node"]) -> None:
        self.id = next(_node_ids)
        self.inputs: List[Node] = list(inputs)

    @property
    def fields(self) -> List[str]:
        raise NotImplementedError

    @property
    def output_types(self) -> List[t.Type]:
        raise NotImplementedError

    def size(self) -> int:
        return len(self.fields)

    def ref(self, i: int) -> ColumnRef:
        return ColumnRef(self.output_types[i], self, i)

    def ref_by_name(self, name: str) -> ColumnRef:
        try:
            return self.ref(self.fields.index(name))
        except ValueError:
            raise KeyError(f"no column {name!r} in node {self}") from None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}#{self.id}"


class Scan(Node):
    """reference: IR/Node.h:219 — leaf over a storage table."""

    def __init__(self, table) -> None:
        super().__init__([])
        self.table = table
        self._fields = table.column_names()
        self._types = [table.column(n).type for n in self._fields]

    @property
    def fields(self):
        return self._fields

    @property
    def output_types(self):
        return self._types

    def ensure_rowid(self) -> int:
        """Expose the hidden rowid column (reference: ArrowStorage hidden
        rowid; appended at the end so existing refs stay valid)."""
        from ..storage.table import ROWID_NAME

        if ROWID_NAME not in self._fields:
            col = self.table.column(ROWID_NAME)
            self._fields.append(ROWID_NAME)
            self._types.append(col.type)
        return self._fields.index(ROWID_NAME)


class Project(Node):
    """reference: IR/Node.h:291."""

    def __init__(self, input_node: Node, exprs: Sequence[Expr],
                 fields: Sequence[str]) -> None:
        assert len(exprs) == len(fields)
        super().__init__([input_node])
        self.exprs = list(exprs)
        self._fields = list(fields)

    @property
    def fields(self):
        return self._fields

    @property
    def output_types(self):
        return [e.type for e in self.exprs]

    def is_identity(self) -> bool:
        inp = self.inputs[0]
        return (
            len(self.exprs) == inp.size()
            and all(
                isinstance(e, ColumnRef) and e.node is inp and e.index == i
                for i, e in enumerate(self.exprs)
            )
        )


class Filter(Node):
    """reference: IR/Node.h:634 — passes through the input schema."""

    def __init__(self, input_node: Node, condition: Expr) -> None:
        assert condition.type.is_boolean(), "filter condition must be boolean"
        super().__init__([input_node])
        self.condition = condition

    @property
    def fields(self):
        return self.inputs[0].fields

    @property
    def output_types(self):
        return self.inputs[0].output_types


class Aggregate(Node):
    """reference: IR/Node.h:373 — output is [keys..., aggs...]."""

    def __init__(self, input_node: Node, keys: Sequence[Expr],
                 aggs: Sequence[AggExpr], fields: Sequence[str]) -> None:
        assert len(fields) == len(keys) + len(aggs)
        super().__init__([input_node])
        self.keys = list(keys)
        self.aggs = list(aggs)
        self._fields = list(fields)

    @property
    def fields(self):
        return self._fields

    @property
    def output_types(self):
        return [k.type for k in self.keys] + [a.type for a in self.aggs]


class Join(Node):
    """Equi-join; output schema = lhs fields ++ rhs fields (rhs join-key
    duplicates retained, as the reference does; reference: IR/Node.h:463).
    SEMI/ANTI output only lhs fields."""

    def __init__(self, lhs: Node, rhs: Node,
                 key_pairs: Sequence[Tuple[Expr, Expr]],
                 join_type: JoinType = JoinType.INNER,
                 residual: Optional[Expr] = None,
                 suffix: str = "_r") -> None:
        # empty key_pairs = cartesian (loop) join, INNER only
        # (reference: IRCodegen.cpp:513 loop-join fallback)
        assert key_pairs or join_type == JoinType.INNER, (
            "only INNER joins may be key-less (loop join)")
        super().__init__([lhs, rhs])
        self.key_pairs = list(key_pairs)
        self.join_type = join_type
        self.residual = residual
        lhs_fields = list(lhs.fields)
        if join_type in (JoinType.SEMI, JoinType.ANTI):
            self._fields = lhs_fields
            self._types = list(lhs.output_types)
        else:
            rhs_fields = [
                f + suffix if f in lhs_fields else f for f in rhs.fields
            ]
            self._fields = lhs_fields + rhs_fields
            rhs_types = list(rhs.output_types)
            if join_type == JoinType.LEFT:
                rhs_types = [ty.with_nullable(True) for ty in rhs_types]
            self._types = list(lhs.output_types) + rhs_types

    @property
    def fields(self):
        return self._fields

    @property
    def output_types(self):
        return self._types


class SortField:
    """reference: IR/Node.h:27 (SortField: field index, desc, nulls pos)."""

    def __init__(self, field_index: int, desc: bool = False,
                 nulls_first: Optional[bool] = None) -> None:
        self.field_index = field_index
        self.desc = desc
        # reference default: nulls sort as if +inf (NULLS LAST asc / FIRST desc)
        self.nulls_first = desc if nulls_first is None else nulls_first

    def __repr__(self) -> str:  # pragma: no cover
        return f"SortField({self.field_index}, desc={self.desc}, nulls_first={self.nulls_first})"


class Sort(Node):
    """reference: IR/Node.h:693 — sort + limit/offset."""

    def __init__(self, input_node: Node, sort_fields: Sequence[SortField],
                 limit: Optional[int] = None, offset: int = 0) -> None:
        super().__init__([input_node])
        self.sort_fields = list(sort_fields)
        self.limit = limit
        self.offset = offset

    @property
    def fields(self):
        return self.inputs[0].fields

    @property
    def output_types(self):
        return self.inputs[0].output_types


class Unnest(Node):
    """Explode one array column into rows (reference: Calcite UNNEST /
    IR ArrayExpr consumers).  Output schema = input schema with the
    array column's type replaced by its element type; every other
    column repeats per element.  Static-shape friendly: the executor
    emits nrows * width rows with absent elements masked dead."""

    def __init__(self, input_node: Node, field_index: int) -> None:
        super().__init__([input_node])
        typ = input_node.output_types[field_index]
        assert typ.is_array(), "UNNEST requires an array column"
        self.field_index = field_index
        self._types = list(input_node.output_types)
        self._types[field_index] = typ.elem_type.with_nullable(True)  # type: ignore[attr-defined]

    @property
    def fields(self):
        return self.inputs[0].fields

    @property
    def output_types(self):
        return self._types


class LogicalUnion(Node):
    """reference: IR/Node.h:849 (UNION ALL)."""

    def __init__(self, inputs: Sequence[Node], all: bool = True) -> None:
        assert len(inputs) >= 2
        first = inputs[0]
        for other in inputs[1:]:
            assert other.size() == first.size(), "union arity mismatch"
        super().__init__(inputs)
        self.all = all
        self._types = [
            _union_type([n.output_types[i] for n in inputs])
            for i in range(first.size())
        ]

    @property
    def fields(self):
        return self.inputs[0].fields

    @property
    def output_types(self):
        return self._types


class LogicalValues(Node):
    """reference: IR/Node.h:785 — inline literal rows."""

    def __init__(self, fields: Sequence[str], types: Sequence[t.Type],
                 rows: Sequence[Sequence]) -> None:
        super().__init__([])
        self._fields = list(fields)
        self._types = list(types)
        self.rows = [list(r) for r in rows]

    @property
    def fields(self):
        return self._fields

    @property
    def output_types(self):
        return self._types


def outer_join_rewrite(lnode: Node, rnode: Node, pairs, residual,
                       kind: str, suffix: str = "_r") -> Node:
    """RIGHT / FULL OUTER JOIN over the 4-type IR (reference: Calcite
    canonicalizes RIGHT to a swapped LEFT before the reference's IR —
    which also has only INNER/LEFT/SEMI/ANTI, IR/Node.h:463 — ever
    sees the plan).

    RIGHT = swapped LEFT + a column-reorder Project restoring the
    user-facing lhs ++ rhs order.  FULL = LEFT(l, r) UNION ALL the rhs
    rows with no surviving match (ANTI(r, l) under the same ON — key
    equalities AND residual) padded with typed NULLs on the lhs.
    Output schema in both cases matches what an unswapped join with
    ``suffix`` dedup would produce."""
    from .expr import Constant

    assert kind in ("right", "full")
    swapped = [(r, l) for l, r in pairs]
    nl, nr = lnode.size(), rnode.size()
    lhs_fields = list(lnode.fields)
    rhs_fields = [f + suffix if f in lhs_fields else f for f in rnode.fields]
    out_fields = lhs_fields + rhs_fields
    if kind == "right":
        sw = Join(rnode, lnode, swapped, JoinType.LEFT, residual)
        return Project(
            sw,
            [sw.ref(nr + i) for i in range(nl)]
            + [sw.ref(i) for i in range(nr)],
            out_fields)
    left = Join(lnode, rnode, pairs, JoinType.LEFT, residual,
                suffix=suffix)
    anti = Join(rnode, lnode, swapped, JoinType.ANTI, residual)
    null_lhs = [Constant(ty.with_nullable(True), None)
                for ty in lnode.output_types]
    pad = Project(anti, null_lhs + [anti.ref(i) for i in range(nr)],
                  out_fields)
    lj = Project(left, [left.ref(i) for i in range(nl + nr)], out_fields)
    return LogicalUnion([lj, pad])


def _union_type(ts: List[t.Type]) -> t.Type:
    out = ts[0]
    for ty in ts[1:]:
        out = t.common_type(out, ty)
    return out


class QueryDag:
    """Root + subqueries (reference: IR/Node.h QueryDag)."""

    def __init__(self, root: Node) -> None:
        self.root = root

    def topo_order(self) -> List[Node]:
        """Topologically ordered nodes (reference:
        QueryExecutionSequence.cpp:293 boost topological_sort)."""
        seen = {}
        order: List[Node] = []

        def visit(n: Node):
            state = seen.get(n.id)
            if state == 2:
                return
            if state == 1:
                raise ValueError("cycle in query DAG")
            seen[n.id] = 1
            for inp in n.inputs:
                visit(inp)
            seen[n.id] = 2
            order.append(n)

        visit(self.root)
        return order
