"""expr_flow: a dataflow summary diagram of an expression tree.

Port of ``dask_array_tpu/_expr_flow.py``.  Unlike ``pprint`` (one line
per expression node), the flow view groups linear same-shape chains into
ONE node carrying the chain's operation list, so the diagram reads as
"what data exists, at what shape, and what happens to it":
``(x + 1) * 2 - 0.5`` is a single box ``[Load, Add, Mul, Sub]``; a
reduction starts a new box because the shape changes.

Public surface: ``expr_flow`` / ``FlowDiagram`` / ``build_flow_graph`` /
``count_operations`` / ``render_flow_svg`` / ``FlowNode`` / ``FlowEdge``.
"""

from __future__ import annotations

import functools
import html as _html

from dask_array_tpu_torch._expr import ArrayExpr

_BOX_W = 200
_BOX_H = 56
_XGAP = 44
_YGAP = 30


class FlowNode:
    """One dataflow node: a same-shape chain of operations."""

    __slots__ = ("shape", "chunksize", "operations", "col", "key")

    def __init__(self, shape, chunksize, operations, col=0, key=None):
        self.shape = shape
        self.chunksize = chunksize
        self.operations = list(operations)
        self.col = col
        self.key = key

    def __repr__(self):
        ops = ", ".join(self.operations)
        return f"FlowNode(shape={self.shape}, col={self.col}, ops=[{ops}])"


class FlowEdge:
    """A data dependency between two flow nodes (src feeds dst)."""

    __slots__ = ("src", "dst")

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst

    def __repr__(self):
        return f"FlowEdge({self.src} -> {self.dst})"


@functools.lru_cache(maxsize=1)
def _numpy_names() -> dict:
    """id of a torch function of the ufunc table -> its (first) numpy name,
    so ``torch.mul`` shows as numpy's ``multiply``."""
    from dask_array_tpu_torch.ops.ufuncs import _TABLE

    out = {}
    for name, fn in _TABLE.items():
        out.setdefault(id(fn), name)
    return out


def _op_label(node: ArrayExpr) -> str:
    name = type(node).__name__
    if name in ("FromArray", "FromMap", "FromBlocks"):
        return "Load"
    try:
        func = node.operand("func")
        label = _numpy_names().get(id(func)) or getattr(func, "__name__", None) or str(func)
        label = label.strip("<>' ")
        if name in ("Elemwise", "Blockwise") and label:
            return label.split(".")[-1].capitalize()
    except Exception:
        pass
    return name


def _walk_unique(root: ArrayExpr):
    seen = {}
    stack = [root]
    order = []
    while stack:
        node = stack.pop()
        if node._name in seen:
            continue
        seen[node._name] = node
        order.append(node)
        stack.extend(node.dependencies())
    return order


def build_flow_graph(expr):
    """(nodes, edges): linear same-shape chains collapse into one node."""
    from dask_array_tpu_torch._collection import Array

    if isinstance(expr, Array):
        expr = expr.expr
    order = _walk_unique(expr)
    dependents: dict[str, int] = {}
    for node in order:
        for dep in node.dependencies():
            dependents[dep._name] = dependents.get(dep._name, 0) + 1

    # group assignment: a node joins its sole consumer's group when it is
    # that consumer's only input and the shape is unchanged
    group_of: dict[str, str] = {}
    for node in order:  # root-first order: consumers before producers
        gid = group_of.setdefault(node._name, node._name)
        deps = node.dependencies()
        if len(deps) == 1 and dependents.get(deps[0]._name, 0) == 1:
            try:
                same = tuple(deps[0].shape) == tuple(node.shape)
            except Exception:
                same = False
            if same:
                group_of[deps[0]._name] = gid

    groups: dict[str, list] = {}
    for node in order:
        groups.setdefault(group_of[node._name], []).append(node)

    nodes: dict[str, FlowNode] = {}
    for gid, members in groups.items():
        # producer-first operation order (leaf loads before arithmetic)
        ops = [_op_label(m) for m in reversed(members)]
        head = members[0]  # the group's consumer end defines shape
        try:
            shape = tuple(head.shape)
            chunksize = tuple(head.chunksize)
        except Exception:
            shape, chunksize = (), ()
        nodes[gid] = FlowNode(shape, chunksize, ops, key=gid)

    edge_pairs = set()
    for node in order:
        g = group_of[node._name]
        for dep in node.dependencies():
            gd = group_of[dep._name]
            if gd != g:
                edge_pairs.add((gd, g))
    edges = [FlowEdge(s, d) for s, d in sorted(edge_pairs)]

    # column = longest path from a source group
    incoming: dict[str, list] = {}
    for e in edges:
        incoming.setdefault(e.dst, []).append(e.src)
    cols: dict[str, int] = {}

    def col_of(gid, _depth=0):
        if gid in cols:
            return cols[gid]
        srcs = incoming.get(gid, [])
        cols[gid] = 0 if not srcs else 1 + max(col_of(s) for s in srcs)
        return cols[gid]

    for gid in groups:
        nodes[gid].col = col_of(gid)
    return list(nodes.values()), edges


def count_operations(expr) -> int:
    """Number of expression nodes in the tree (deduplicated)."""
    from dask_array_tpu_torch._collection import Array

    if isinstance(expr, Array):
        expr = expr.expr
    return len(_walk_unique(expr))


def _render_svg(nodes, edges) -> str:
    by_col: dict[int, list] = {}
    for n in nodes:
        by_col.setdefault(n.col, []).append(n)
    n_cols = max(by_col) + 1
    tallest = max(len(v) for v in by_col.values())
    width = n_cols * (_BOX_W + _XGAP) + _XGAP
    height = tallest * (_BOX_H + _YGAP) + _YGAP
    pos = {}
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        'font-family="monospace" font-size="11">'
    ]
    for col, members in sorted(by_col.items()):
        x = _XGAP / 2 + col * (_BOX_W + _XGAP)
        col_h = len(members) * (_BOX_H + _YGAP)
        y0 = (height - col_h) / 2 + _YGAP / 2
        for i, n in enumerate(members):
            y = y0 + i * (_BOX_H + _YGAP)
            pos[n.key] = (x, x + _BOX_W, y + _BOX_H / 2)
            ops = ", ".join(n.operations)
            if len(ops) > 30:
                ops = ops[:27] + "..."
            fill = "#D5EBD5" if n.col == 0 else "#DDEBF7"
            parts.append(
                f'<rect x="{x:.0f}" y="{y:.0f}" width="{_BOX_W}" height="{_BOX_H}" '
                f'rx="6" fill="{fill}" stroke="#555"/>'
                f'<text x="{x + _BOX_W / 2:.0f}" y="{y + 18:.0f}" text-anchor="middle" '
                f'font-weight="bold">{_html.escape(ops)}</text>'
                f'<text x="{x + _BOX_W / 2:.0f}" y="{y + 36:.0f}" text-anchor="middle" '
                f'fill="#333">{_html.escape(str(n.shape))} @ {_html.escape(str(n.chunksize))}</text>'
            )
    for e in edges:
        _, sx1, sy = pos[e.src]
        dx0, _, dy = pos[e.dst]
        parts.append(
            f'<line x1="{sx1:.0f}" y1="{sy:.0f}" x2="{dx0:.0f}" y2="{dy:.0f}" '
            'stroke="#888" stroke-width="1.2" />'
        )
    parts.append("</svg>")
    return "".join(parts)


def render_flow_svg(expr) -> str:
    """HTML fragment (a div wrapping the SVG) for the expression's flow."""
    nodes, edges = build_flow_graph(expr)
    return f'<div style="text-align:left">{_render_svg(nodes, edges)}</div>'


class FlowDiagram:
    """Dataflow summary of one expression; renders inline in notebooks."""

    def __init__(self, expr):
        from dask_array_tpu_torch._collection import Array

        self.expr = expr.expr if isinstance(expr, Array) else expr
        self.nodes, self.edges = build_flow_graph(self.expr)
        self.svg = _render_svg(self.nodes, self.edges)

    def __repr__(self):
        n_ops = count_operations(self.expr)
        lines = [f"Expression: {n_ops} operations, {len(self.nodes)} dataflow nodes"]
        for n in sorted(self.nodes, key=lambda n: n.col):
            lines.append(f"  [col {n.col}] {n.shape}: {', '.join(n.operations)}")
        return "\n".join(lines)

    def _repr_html_(self):
        return f'<div style="text-align:left">{self.svg}</div>'

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.svg)



def expr_flow(x, optimize: bool = False):
    """Dataflow diagram of ``x``'s expression tree (optionally optimized)."""
    from dask_array_tpu_torch._collection import Array

    expr = x.expr if isinstance(x, Array) else x
    if optimize:
        expr = expr.optimize()
    return FlowDiagram(expr)
