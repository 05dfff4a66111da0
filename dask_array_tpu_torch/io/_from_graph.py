"""from_graph: build an Array from an external dask-style task graph.

Port of ``dask_array_tpu/io/_from_graph.py``, the interop entry for
libraries that build task graphs by hand.  This runtime has no task
scheduler, so the graph is evaluated by a small host-side interpreter with
dask's task semantics (a task is a tuple whose head is callable; keys are
tuples or strings that resolve within the graph or into dependency
collections), one output block per key.  Blocks load lazily (first use)
and memoize, like any host IO leaf.
"""

from __future__ import annotations

import numpy as np


class GraphEvaluator:
    """Evaluate dask-style task tuples against a graph + dependencies."""

    def __init__(self, graph, dep_blocks=None):
        self.graph = dict(graph)
        self.dep_blocks = dep_blocks or {}  # key -> callable() -> block
        self.memo: dict = {}

    def _is_key(self, v):
        if isinstance(v, str):
            return v in self.graph or v in self.dep_blocks
        if isinstance(v, tuple) and v and isinstance(v[0], str):
            return v in self.graph or v in self.dep_blocks
        return False

    def get(self, key):
        if key in self.memo:
            return self.memo[key]
        if key in self.graph:
            out = self._eval(self.graph[key], _as_value=True)
        elif key in self.dep_blocks:
            out = self.dep_blocks[key]()
        else:
            raise KeyError(f"from_graph: key {key!r} not in graph or dependencies")
        self.memo[key] = out
        return out

    def _eval(self, v, _as_value=False):
        # task: tuple with callable head
        if isinstance(v, tuple) and v and callable(v[0]):
            fn = v[0]
            args = [self._eval(a) for a in v[1:]]
            return fn(*args)
        if not _as_value and self._is_key(v):
            return self.get(v)
        if isinstance(v, list):
            return [self._eval(a) for a in v]
        if _as_value and self._is_key(v):
            return self.get(v)
        return v


def from_graph(layer, _meta, chunks, keys, name, dependencies=(), rename=None):
    """Create an Array from an existing task-graph layer.

    ``keys`` are the layer's output-block keys in row-major block order
    (``(some_name, *block_id)``); ``chunks`` is the full per-axis grid;
    ``_meta`` supplies the dtype.  ``dependencies`` are collections whose
    keys the layer may reference — they compute (once, lazily) on first
    block access.
    """
    from dask_array_tpu_torch._collection import Array
    from dask_array_tpu_torch._executor import block_slices, iter_block_indices
    from dask_array_tpu_torch.io._from_map import from_map

    if rename is not None:
        name = rename.get(name, name)

    dep_blocks = {}
    for dep in dependencies:
        arr = dep if isinstance(dep, Array) else Array(dep)
        state: dict = {}

        def dense_of(arr=arr, state=state):
            if "v" not in state:
                state["v"] = np.asarray(arr.compute())
            return state["v"]

        dep_name = getattr(arr.expr, "_name", None)
        for bid in iter_block_indices(arr.numblocks):
            key = (dep_name,) + tuple(int(i) for i in bid)

            def load(arr=arr, bid=tuple(bid), dense_of=dense_of):
                return dense_of()[block_slices(arr.chunks, bid)]

            dep_blocks[key] = load

    ev = GraphEvaluator(layer, dep_blocks)
    keys = list(keys)
    nblocks = [len(c) for c in chunks]
    total = 1
    for n in nblocks:
        total *= n
    if len(keys) != total:
        raise ValueError(
            f"from_graph: got {len(keys)} keys for a grid of {total} blocks"
        )
    dtype = np.dtype(getattr(_meta, "dtype", _meta if _meta is not None else "f8"))

    def load_block(key):
        return np.asarray(ev.get(key))

    return from_map(load_block, keys, chunks=tuple(tuple(c) for c in chunks), dtype=dtype, name=name)
