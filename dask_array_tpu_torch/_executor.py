"""The executor: one walk of the lowered tree over torch tensors.

Port of ``dask_array_tpu/_executor.py``.  Where the reference traces the
lowered tree into one jitted XLA program, this executor walks it once,
eagerly, with PyTorch ops on the configured device (``config["device"]``):
leaf buffers move there first, every physical node's ``_build`` runs on
tensors, and the root's dense tensor comes back.

A ``BlockView`` lets a node produce its value in whichever form is natural —
a dict of per-block tensors, or a single dense tensor — and converts lazily:
dense -> block is slicing (a view); blocks -> dense is ``torch.cat``.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_array_tpu_torch import config
from dask_array_tpu_torch._chunks import cached_cumsum, cat, format_of, tensor_of
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._hostcopy import upload
from dask_array_tpu_torch._spans import call


def block_slices(chunks, index):
    """Slices of block ``index`` inside the dense array with these chunks."""
    out = []
    for ax, i in enumerate(index):
        bounds = cached_cumsum(chunks[ax], initial_zero=True)
        out.append(slice(int(bounds[i]), int(bounds[i + 1])))
    return tuple(out)


def iter_block_indices(numblocks):
    return np.ndindex(*numblocks)


class BlockView:
    """Lazy dual representation (blocks dict <-> dense) of one node's value."""

    __slots__ = ("chunks", "_blocks", "_dense")

    def __init__(self, chunks, blocks=None, dense=None):
        if blocks is None and dense is None:
            raise ValueError("BlockView needs blocks or a dense tensor")
        self.chunks = chunks
        self._blocks = blocks
        self._dense = dense

    @property
    def numblocks(self):
        return tuple(len(c) for c in self.chunks)

    def block(self, index):
        if self._blocks is not None:
            return self._blocks[tuple(index)]
        return self._dense[block_slices(self.chunks, index)]

    def blocks_dict(self):
        if self._blocks is None:
            self._blocks = {
                tuple(idx): self.block(idx) for idx in iter_block_indices(self.numblocks)
            }
        return self._blocks

    def dense(self):
        if self._dense is None:
            self._dense = _assemble(self._blocks, self.numblocks)
        return self._dense


def _assemble(blocks: dict, numblocks, axis: int = 0, prefix: tuple = ()):
    """Concatenate a full grid of blocks into one dense tensor.  A plain
    recursion: a closure that calls itself is a reference cycle, and its
    cell would keep every block on the device until a garbage collection."""
    if axis == len(numblocks):
        return blocks[prefix]
    parts = [_assemble(blocks, numblocks, axis + 1, prefix + (i,)) for i in range(numblocks[axis])]
    if len(parts) == 1:
        return parts[0]
    return cat(parts, dim=axis)


class BuildContext:
    """Carries the memo cache, leaf bindings, device and mesh through one
    walk.  Under a mesh (``parallel.Mesh``) the walk is partitioned
    (``parallel/partition.py``): leaves are bound sharded, nodes with a
    partition rule run per slot and hand their ``ShardedTensor`` on, and
    any other node runs dense on the mesh's first slot."""

    def __init__(self, leaf_values: dict, device: torch.device, mesh=None):
        self.cache: dict[str, BlockView] = {}
        self.leaf_values = leaf_values  # key -> tensor on ``device``
        self.device = device
        self.mesh = mesh
        self.shared_values: dict = {}

    def build(self, expr: ArrayExpr) -> BlockView:
        view = self.cache.get(expr._name)
        if view is None:
            check_narrow(expr)
            name = "node:" + type(expr).__name__
            if self.mesh is not None:
                from dask_array_tpu_torch.parallel.partition import build

                view = call(name, build, expr, self)
            else:
                view = call(name, expr._build, self)
            if not isinstance(view, BlockView):
                raise TypeError(f"{type(expr).__name__}._build returned {type(view).__name__}")
            self.cache[expr._name] = view
        return view

    def leaf(self, key):
        return self.leaf_values[key]

    def shared(self, key, make):
        """``make()``, once per walk under ``key``: nodes that are outputs of
        one computation (the q and r of one QR, say) share it this way."""
        if key not in self.shared_values:
            self.shared_values[key] = make()
        return self.shared_values[key]


def check_narrow(expr: ArrayExpr):
    """Raise where ``expr`` is a node whose build does not take narrow data
    (``ArrayExpr.takes_narrow``) with a narrow operand or result."""
    if expr.takes_narrow:
        return
    for node in (expr, *expr.dependencies()):
        if format_of(node.dtype) is not None:
            raise NotImplementedError(
                f"{type(expr).__name__} does not compute ml_dtypes.{node.dtype.name} data in dask_array_tpu_torch: "
                "astype a wider dtype first")


def collect_leaves(root: ArrayExpr):
    """(key, buffer) pairs in structural order (deterministic DFS over
    operand positions)."""
    pairs = []
    seen_nodes = set()
    seen_keys = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if node._name in seen_nodes:
            continue
        seen_nodes.add(node._name)
        for key, buf in node._leaf_buffers():
            if key not in seen_keys:
                seen_keys.add(key)
                pairs.append((key, buf))
        if getattr(node, "_leaf_stop", False):
            continue  # a barrier's buffer covers its subtree
        # push children reversed so they pop in operand order
        stack.extend(reversed(node.dependencies()))
    return pairs


def current_device() -> torch.device:
    """The device named by ``config["device"]``.

    Raises when it names a CUDA device and no card is present: the port
    never moves work to the CPU because it found no GPU."""
    device = torch.device(config.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"config 'device' is {str(device)!r} but torch finds no CUDA device"
        )
    return device


def to_device(buf, device: torch.device) -> torch.Tensor:
    """One leaf buffer on ``device``: a host buffer is copied there (on a
    CUDA device through the pinned ring of ``_hostcopy.upload``: the copy
    is queued, and the current stream waits for it); a tensor already there
    (a persisted or resident leaf) is used as it is.  A block a loader makes
    (``materialize()``: ``io/_from_map.py``) is made first; an array-like
    store without ``__array__`` is read whole by slicing.  A block of a
    dtype with no torch counterpart (an object payload) stays on the
    host.  So does a block with no device form (masked, of a registered
    duck type, of a host-only dtype: ``_host.is_host_block``), as it is;
    a datetime64/timedelta64 block goes up as its int64 ticks."""
    from dask_array_tpu_torch._host import is_host_block

    if hasattr(buf, "materialize"):
        buf = buf.materialize()
    if is_host_block(buf):
        return buf
    if isinstance(buf, torch.Tensor):
        if buf.device.type == "cpu" and device.type == "cuda":
            return upload(buf, device)
        return buf.to(device)
    if not isinstance(buf, np.ndarray) and not hasattr(buf, "__array__") and hasattr(buf, "shape"):
        buf = buf[(slice(None),) * len(buf.shape)]
    buf = np.asarray(buf)
    if is_host_block(buf):
        return buf
    if buf.dtype.kind in "Mm":
        buf = buf.view(np.int64)
    if device.type == "cuda":
        return upload(buf, device)
    # torch.from_numpy needs a writable, positively-strided buffer
    arr = np.require(buf, requirements=("C", "W"))
    return tensor_of(arr).to(device)


# nodes that keep a mask on the host lane: they move blocks (numpy.ma
# does), or run numpy(.ma)'s counterpart of their torch code
# (``_host.host_kernel``).  Any other node would drop the mask, and raises.
_MASKED_PASSTHROUGH = frozenset({
    "FromArray", "Slice", "Take", "Concatenate", "ExpandDims", "Rechunk", "MapBlocks", "Elemwise",
    "Blockwise", "Transpose", "Squeeze", "Reduction", "CumReduction", "ArgReduction",
})


def _masked_below(node, memo) -> bool:
    got = memo.get(node._name)
    if got is None:
        got = memo[node._name] = any(isinstance(b, np.ma.MaskedArray) for _, b in node._leaf_buffers()) or any(
            _masked_below(d, memo) for d in node.dependencies())
    return got


def check_masked_ops(root: ArrayExpr) -> None:
    """Raise for a node that cannot keep a mask, where a masked leaf lies
    below it.  Runs on the logical tree (before lowering, where
    ``MapBlocks`` is still itself); a branch with no masked leaf (a
    ``ones()`` meeting a masked array) computes as always."""
    if not any(isinstance(b, np.ma.MaskedArray) for _, b in collect_leaves(root)):
        return
    masked_below: dict[str, bool] = {}
    for node in root.walk():
        if _masked_below(node, masked_below) and type(node).__name__ not in _MASKED_PASSTHROUGH:
            raise NotImplementedError(
                f"{type(node).__name__} on a masked array would drop the mask; call x.filled(...) first "
                "(or use map_blocks with numpy.ma functions)")


def execute(root: ArrayExpr) -> torch.Tensor:
    """Execute a lowered expression tree; returns its dense tensor on
    ``config["device"]``."""
    return execute_many([root])[0]


def execute_many(roots) -> list:
    """Execute several lowered trees in one walk: shared nodes build once
    and every leaf moves to the device once."""
    return [view.dense() for view in execute_views(roots)]


def walk_device(mesh=None) -> torch.device:
    """The device a walk runs on: ``config["device"]``, or under a mesh
    its first slot (whose device type must be the configured one)."""
    device = current_device()
    if mesh is None:
        return device
    first = mesh.devices.flat[0]
    if first.type != device.type:
        raise RuntimeError(f"the mesh's devices are {first.type!r} but config 'device' is {str(device)!r}")
    return first


def execute_views(roots) -> list:
    """``execute_many``, returning each root's ``BlockView`` (its blocks,
    where the root built them per block).

    Under a mesh (``parallel.use_mesh``) config ``"execution-lane"``
    ("auto" or "shard-map") first offers each root to the shard lane
    (``parallel/shardlane.py``): a root its planner matches runs as
    per-slot programs.  Every other root, and every root under "gspmd",
    takes the partitioned walk (``parallel/partition.py``); a root held
    sharded comes back as its ``ShardedView`` (``dense()`` gathers it
    once to the mesh's first slot).  A decline is decided in planning; an
    error while the lane executes propagates."""
    return call("execute", _execute_views, roots)


def _execute_views(roots) -> list:
    from dask_array_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    device = walk_device(mesh)
    views: dict = {}
    if mesh is not None and config.get("execution-lane", "auto") in ("auto", "shard-map"):
        from dask_array_tpu_torch.parallel.shardlane import try_execute_shard

        for i, root in enumerate(roots):
            res = try_execute_shard(root, mesh)
            if res is not None:
                views[i] = BlockView(root.chunks, dense=res)
    leaves = call("bind", _bind_leaves, [r for i, r in enumerate(roots) if i not in views], device, mesh)
    ctx = BuildContext(leaves, device, mesh)
    return [views[i] if i in views else ctx.build(root) for i, root in enumerate(roots)]


def _bind_leaves(roots, device, mesh) -> dict:
    """Every leaf buffer of ``roots``, once, bound for the walk (``_bind``)."""
    leaves = {}
    for root in roots:
        for key, buf in collect_leaves(root):
            if key not in leaves:
                leaves[key] = _bind(buf, device, mesh)
    return leaves


def _bind(buf, device, mesh):
    """A leaf buffer for the walk: ``to_device``'s, or a persisted
    ``ShardedTensor`` as it is under its own mesh (gathered once to
    ``device`` under none or another)."""
    from dask_array_tpu_torch.parallel._sharded import ShardedTensor

    if isinstance(buf, ShardedTensor):
        return buf if mesh is not None and buf.mesh == mesh else buf.gather(device)
    return to_device(buf, device)


def structural_key(root: ArrayExpr) -> str:
    """A key of the program's structure that ignores the contents of its
    leaf buffers: two same-shaped datasets through the same plan share it.
    Every other operand, scalar literals included, stays in the key, and
    leaves carry their first-visit ordinal, so sharing patterns (f(A, A, B)
    against f(A, B, B)) key apart.

    The plan-record fingerprint (``_planrec``) first; a plan its grammar
    declines takes the tokenize walk.  The two kinds of key have prefixes
    of their own, so they never collide.  The streaming lane's single-plan
    rule (``_streaming._keys_bounded``) reads it; ``plan_table`` shows the
    plan record it is taken over.  Under a mesh the key carries the mesh's
    identity (``Mesh.key``: axis names, shape, slot devices)."""
    from dask_array_tpu_torch._planrec import plan_fingerprint
    from dask_array_tpu_torch.parallel.mesh import current_mesh
    from dask_array_tpu_torch.utils._tokenize import tokenize

    mesh = current_mesh()
    mkey = None if mesh is None else mesh.key()
    cached = getattr(root, "_skey_memo", None)
    if cached is not None and cached[0] == mkey:
        return cached[1]
    pf = plan_fingerprint(root)
    if pf is not None:
        out = "plan:" + pf[0]
    else:
        memo: dict[str, str] = {}
        leaf_ordinal: dict[str, int] = {}

        def rec(node: ArrayExpr) -> str:
            got = memo.get(node._name)
            if got is not None:
                return got
            parts: list = [type(node).__qualname__]
            spec = node._structural_operands() if hasattr(node, "_structural_operands") else None
            if spec is not None:
                parts.append(("leaf", leaf_ordinal.setdefault(node._name, len(leaf_ordinal))))
                ops = spec
            else:
                ops = node.operands
            for op in ops:
                parts.append(rec(op) if isinstance(op, ArrayExpr) else op)
            tok = tokenize(*parts)
            memo[node._name] = tok
            return tok

        out = "walk:" + rec(root)
    if mkey is not None:
        # a program keys apart on each mesh (the JAX package's _mesh_key)
        out += "|mesh:" + tokenize(mkey)
    root._skey_memo = (mkey, out)
    return out
