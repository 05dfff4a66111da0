"""Explicit collectives between mesh slots: halo exchange, all-to-all
reshard, axis swap, the rechunk relayout schedule and psum reduction.

Port of ``dask_array_tpu/parallel/collectives.py``.  Where the JAX package
writes a ``shard_map`` body around ``lax.ppermute``/``psum``/``all_to_all``,
this port runs the same schedule as plain functions over the slot list of a
``ShardedTensor``: each collective is one call that moves tensors between
slots (``Tensor.to(device, non_blocking=True)``: a peer copy between
distinct cards, nothing or a view on one device) and records itself in
``_sharded.COLLECTIVES``.  The values and the schedule (which collectives,
how many, over which mesh axes) are the JAX package's.

The primitives (``ppermute``, ``all_reduce``, ``all_gather``) take a list of
per-slot values and return one; the shard lane (``shardlane.py``) and
``ShardStencil`` (``ops/_overlap.py``) build their per-slot programs on
them.
"""

from __future__ import annotations

import functools

import torch

from dask_array_tpu_torch.parallel._sharded import (
    COLLECTIVES,
    ShardedTensor,
    as_sharded,
    entry_names,
    groups,
    nbytes,
    reshard,
)

# ---------------------------------------------------------------------------
# primitives over per-slot values
# ---------------------------------------------------------------------------


def ppermute(values, mesh, axes, perm, record=True):
    """Send each group member's value along ``perm`` (``(source, dest)``
    positions within every group over ``axes``, as ``lax.ppermute``);
    a slot that receives nothing gets None."""
    slots = mesh.slots
    out = [None] * mesh.size
    moved = 0
    for group in groups(mesh, axes):
        for s, d in perm:
            src, dst = group[s], group[d]
            v = values[src]
            if v is None:
                continue
            if src != dst:
                moved += nbytes(v)
            out[dst] = v.to(slots[dst], non_blocking=True)
    if record:
        COLLECTIVES.add("ppermute", moved)
    return out


_COMBINE = {"psum": torch.add, "pmin": torch.minimum, "pmax": torch.maximum}


def all_reduce(kind, values, mesh, axes, combine=None, record=True):
    """``psum``/``pmin``/``pmax`` over the groups of ``axes``: every slot
    gets its group's combined value, on its device.  ``combine`` (a list
    of tensors on one device -> one tensor) replaces the default chain of
    ``torch.add``/``minimum``/``maximum`` where the combine has typed
    semantics of its own (the shard lane's reductions)."""
    slots = mesh.slots
    out = [None] * mesh.size
    moved = 0
    if combine is None:
        op = _COMBINE[kind]

        def combine(ts):
            return functools.reduce(op, ts)

    for group in groups(mesh, axes):
        # a slot that holds nothing (None) sits the combine out
        parts = [values[s] for s in group if values[s] is not None]
        if not parts:
            continue
        by_device: dict = {}
        for dst in group:
            dev = slots[dst]
            if dev not in by_device:
                by_device[dev] = combine([p.to(dev, non_blocking=True) for p in parts])
            out[dst] = by_device[dev]
        moved += sum(nbytes(p) for p in parts) * (len(group) - 1)
    if record:
        COLLECTIVES.add(kind, moved)
    return out


def all_gather(values, mesh, axes, record=True):
    """``lax.all_gather(tiled=False)``: every slot gets the list of its
    group's values, in group order, on its device.  A value may be a list
    of tensors (a slot's several pieces) or None (a slot with nothing)."""
    slots = mesh.slots
    out = [None] * mesh.size
    moved = 0
    for group in groups(mesh, axes):
        parts = [values[s] for s in group]
        for dst in group:
            out[dst] = [_move(p, slots[dst]) for p in parts]
        moved += sum(_nbytes_all(p) for p in parts) * (len(group) - 1)
    if record:
        COLLECTIVES.add("all_gather", moved)
    return out


def _move(v, device):
    if isinstance(v, (list, tuple)):
        return [_move(x, device) for x in v]
    return None if v is None else v.to(device, non_blocking=True)


def _nbytes_all(v) -> int:
    if isinstance(v, (list, tuple)):
        return sum(_nbytes_all(x) for x in v)
    return nbytes(v)


def group_size(mesh, axes) -> int:
    n = 1
    for nm in entry_names(axes):
        n *= mesh.shape[nm]
    return n


# ---------------------------------------------------------------------------
# the JAX package's collectives over ShardedTensors
# ---------------------------------------------------------------------------


def halo_exchange(x, mesh, axis_name, axis: int, depth: int, wrap: bool = False):
    """Attach ghost cells from ring neighbors along a sharded axis.

    Each shard receives ``depth`` rows from its left and right neighbors
    (one ``ppermute`` each way).  Edge shards get zero halos unless
    ``wrap`` (periodic).  ``axis_name`` may be a tuple of mesh axes for an
    axis sharded over a nested group (``("dcn", "x")``): the ring runs over
    the linearised group order.  Returns a ``ShardedTensor`` whose shards
    grew by ``2 * depth`` along ``axis`` (callers trim per shard).
    """
    names = entry_names(axis_name)
    n = group_size(mesh, names)
    spec = [None] * x.ndim
    spec[axis] = axis_name if isinstance(axis_name, str) else names
    st = as_sharded(x, mesh, spec)
    lo_edge = [s.narrow(axis, 0, depth) for s in st.shards]
    hi_edge = [s.narrow(axis, s.shape[axis] - depth, depth) for s in st.shards]
    fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
    bwd = [(i, (i - 1) % n) for i in range(n) if wrap or i > 0]
    from_left = ppermute(hi_edge, mesh, names, fwd)   # my left neighbor's tail
    from_right = ppermute(lo_edge, mesh, names, bwd)  # my right neighbor's head
    shards = []
    for s, shard in enumerate(st.shards):
        left = from_left[s] if from_left[s] is not None else torch.zeros_like(hi_edge[s])
        right = from_right[s] if from_right[s] is not None else torch.zeros_like(lo_edge[s])
        shards.append(torch.cat([left, shard, right], dim=axis))
    shape = list(st.global_shape)
    shape[axis] += n * 2 * depth
    return ShardedTensor(mesh, st.spec, shards, shape)


def alltoall_reshard(x, mesh, axis_name: str, from_axis: int, to_axis: int, spec=None,
                     spec_in=None, spec_out=None):
    """Move the sharded dimension from ``from_axis`` to ``to_axis``: one
    ``all_to_all`` over ``axis_name``.

    ``spec`` optionally carries the full partition assignment so other mesh
    axes stay sharded through the exchange; ``spec_in``/``spec_out``
    override the full in/out assignments (nested entries, as the relayout
    scheduler uses them).
    """
    if spec_in is None or spec_out is None:
        base = list(spec) if spec is not None else [None] * x.ndim
        spec_in = list(base)
        spec_in[from_axis] = axis_name
        if spec_in[to_axis] == axis_name:
            spec_in[to_axis] = None
        spec_out = list(spec_in)
        spec_out[from_axis] = None
        spec_out[to_axis] = axis_name
    st = as_sharded(x, mesh, spec_in)
    return reshard(st, spec_out, kind="all_to_all")


def swap_reshard(x, mesh, name_a, name_b, axis_a, axis_b, spec=None):
    """Trade the array axes of two mesh axes without any all-gather.

    - ``|a| == |b|`` (square): out-shard ``(i, j)`` is in-shard ``(j, i)``;
      one whole-shard ``ppermute`` over the combined group.
    - ``|a| != |b|``: three stages through a nested sharding of ``axis_b``:
      ``all_to_all`` moves ``a`` into ``axis_b`` as the minor divisor, one
      whole-shard ``ppermute`` reorders the nesting, ``all_to_all`` pulls
      ``b`` out to ``axis_a``.

    Returns None when the axis sizes do not divide the nested grid.
    """
    n_a = mesh.shape[name_a]
    n_b = mesh.shape[name_b]
    base = list(spec) if spec is not None else [None] * x.ndim
    spec_in = list(base)
    spec_in[axis_a] = name_a
    spec_in[axis_b] = name_b
    spec_out = list(base)
    spec_out[axis_a] = name_b
    spec_out[axis_b] = name_a

    if n_a == n_b:
        st = as_sharded(x, mesh, spec_in)
        perm = [(i * n_a + j, j * n_a + i) for i in range(n_a) for j in range(n_a)]
        shards = ppermute(st.shards, mesh, (name_a, name_b), perm)
        return ShardedTensor(mesh, spec_out, shards, st.global_shape)

    size_a = x.shape[axis_a]
    size_b = x.shape[axis_b]
    if size_b % (n_a * n_b) != 0 or size_a % n_b != 0 or size_a % n_a != 0:
        return None
    spec_mid1 = list(base)
    spec_mid1[axis_a] = None
    spec_mid1[axis_b] = (name_b, name_a)
    spec_mid2 = list(base)
    spec_mid2[axis_a] = None
    spec_mid2[axis_b] = (name_a, name_b)
    st = as_sharded(x, mesh, spec_in)
    mid = reshard(st, spec_mid1, kind="all_to_all")
    # nesting reorder: piece p = j*n_a + i (b-major) lands on the slot that
    # owns piece p under a-major nesting
    perm = [(i * n_b + j, j * n_a + i) for i in range(n_a) for j in range(n_b)]
    shards = ppermute(mid.shards, mesh, (name_a, name_b), perm)
    mid2 = ShardedTensor(mesh, spec_mid2, shards, st.global_shape)
    return reshard(mid2, spec_out, kind="all_to_all")


def mesh_collective_relayout(x, old_chunks, new_chunks, mesh, method=None):
    """Explicit collective schedule for a rechunk layout boundary.

    Compares the mesh layouts of the old and new chunk grids
    (``plan_layout``); every mesh axis whose array-axis assignment moves is
    resharded with one explicit ``all_to_all`` stage (other mesh axes stay
    sharded through each stage), and a two-axis cycle takes
    ``swap_reshard``.  ``x`` is the dense tensor or a ``ShardedTensor``
    under the old layout.  Returns the resharded ``ShardedTensor``, or None
    when no axis moves or the method forbids it (the caller keeps the dense
    tensor).
    """
    import math

    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.parallel.layout import plan_layout

    if method is None:
        method = config.get("array.rechunk.method", "auto")
    if method == "tasks":
        return None
    shape = tuple(sum(c) for c in old_chunks)
    if any(isinstance(s, float) and math.isnan(s) for s in shape):
        return None

    def _tup(entry):
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def _entry(t):
        return None if not t else (t[0] if len(t) == 1 else t)

    in_spec = [_tup(e) for e in plan_layout(shape, old_chunks, mesh)]
    out_spec = [_tup(e) for e in plan_layout(shape, new_chunks, mesh)]

    def _axis_of(spec, name):
        for ax, entry in enumerate(spec):
            if name in entry:
                return ax
        return None

    moves = []
    for name in mesh.shape:
        a = _axis_of(in_spec, name)
        b = _axis_of(out_spec, name)
        if a is not None and b is not None and a != b:
            moves.append((name, a, b))
    if not moves:
        return None
    # moves of slow-fabric axes stage last
    from dask_array_tpu_torch.parallel.mesh import dcn_axis_names

    dcn = dcn_axis_names(mesh)
    moves.sort(key=lambda mv: mv[0] in dcn)
    # non-moving names must keep their nesting position (whole-axis moves
    # only); anything else keeps the dense tensor
    moving = {mv[0] for mv in moves}
    for ax in range(len(shape)):
        if tuple(n for n in in_spec[ax] if n not in moving) != tuple(
            n for n in out_spec[ax] if n not in moving
        ):
            return None

    # stage the moves so each is a clean tiled all_to_all: the moving mesh
    # axis must be minor-most at its source and land minor-most on its
    # destination's current occupants (which must equal the target prefix)
    def _occ(t):
        n = 1
        for nm in t:
            n *= mesh.shape[nm]
        return n

    local = [s // _occ(e) for s, e in zip(shape, in_spec)]
    cur = [tuple(e) for e in in_spec]
    ordered = []
    pending = list(moves)
    while pending:
        progress = False
        for mv in list(pending):
            name, a, b = mv
            if cur[a] and cur[a][-1] != name:
                continue  # not minor-most yet; a later-nested move first
            target_prefix = out_spec[b][: out_spec[b].index(name)]
            if cur[b] != target_prefix:
                continue  # destination occupied/incomplete; retry later
            n = mesh.shape[name]
            if local[b] % n != 0:
                return None  # unsplittable at this stage
            spec_in_stage = [list(e) for e in cur]
            cur[a] = cur[a][:-1]
            cur[b] = cur[b] + (name,)
            spec_out_stage = [list(e) for e in cur]
            ordered.append(("a2a", name, a, b, spec_in_stage, spec_out_stage))
            local[b] //= n
            local[a] *= n
            pending.remove(mv)
            progress = True
        if progress:
            continue

        # cycle: a two-move axis swap resolves through swap_reshard; longer
        # cycles or indivisible shapes keep the dense tensor
        def _swap_ok(name_a, name_b, axis_a, axis_b):
            na, nb = mesh.shape[name_a], mesh.shape[name_b]
            if na == nb:
                return True
            return (
                shape[axis_b] % (na * nb) == 0
                and shape[axis_a] % na == 0
                and shape[axis_a] % nb == 0
            )

        swap = None
        for m1 in pending:
            for m2 in pending:
                if m1 is m2:
                    continue
                n1, a1, b1 = m1
                n2, a2, b2 = m2
                if a1 != b2 or b1 != a2:
                    continue
                if cur[a1] != (n1,) or cur[b1] != (n2,):
                    continue
                if _swap_ok(n1, n2, a1, b1):
                    swap = (n1, n2, a1, b1, m1, m2)
                    break
                if _swap_ok(n2, n1, a2, b2):
                    swap = (n2, n1, a2, b2, m2, m1)
                    break
            if swap:
                break
        if swap is None:
            return None
        name_a, name_b, a1, b1, m1, m2 = swap
        ordered.append(("swap", name_a, name_b, a1, b1, [_entry(e) for e in cur]))
        cur[a1], cur[b1] = (name_b,), (name_a,)
        pending.remove(m1)
        pending.remove(m2)
    out = x
    for stage in ordered:
        if stage[0] == "a2a":
            _, name, a, b, s_in, s_out = stage
            out = alltoall_reshard(
                out, mesh, name, from_axis=a, to_axis=b,
                spec_in=[_entry(tuple(e)) for e in s_in],
                spec_out=[_entry(tuple(e)) for e in s_out],
            )
        else:
            _, name_a, name_b, a, b, spec = stage
            out = swap_reshard(out, mesh, name_a, name_b, a, b, spec=spec)
            if out is None:
                return None
    return out


def psum_reduce(x, mesh, axis_name: str, axis: int):
    """Sum over a sharded axis: a local sum per slot, then one ``psum``
    over ``axis_name``.  The result is replicated on every slot."""
    spec_in = [None] * x.ndim
    spec_in[axis] = axis_name
    st = as_sharded(x, mesh, spec_in)
    local = [s.sum(dim=axis) for s in st.shards]
    total = all_reduce("psum", local, mesh, axis_name)
    shape = tuple(s for i, s in enumerate(st.global_shape) if i != axis)
    return ShardedTensor(mesh, (None,) * len(shape), total, shape)
