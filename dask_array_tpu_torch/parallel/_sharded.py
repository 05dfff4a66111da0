"""Sharded tensors: one tensor per mesh slot, and the record of collectives.

The port's counterpart of a ``jax.Array`` under a ``NamedSharding``.  A
``ShardedTensor`` holds one tensor per slot of a ``Mesh`` (slot order is
``mesh.devices.flat``), each on its slot's device, together with the
partition ``spec``: one entry per array axis, ``None`` (the axis is whole on
every slot), a mesh-axis name, or a tuple of names (the axis splits over
their product, the first name major).  Slots that differ only on mesh axes
the spec does not name hold copies of the same part.

``shard`` is ``jax.device_put``'s analog: each slot narrows its part out of
a dense tensor and moves it to its device.  An axis of ``dim`` elements over
``n`` parts gives part ``p`` the range ``[p*c, (p+1)*c)`` with
``c = ceil(dim / n)``, clipped at ``dim``: the last parts are short (or
empty) where ``n`` does not divide ``dim``, the padding rule of a GSPMD
constraint.  ``gather`` assembles the dense tensor back from the shards'
own sizes, so a shard grown by a halo exchange gathers to the
concatenation of the grown shards, as the JAX package's ``shard_map``
output does.

``COLLECTIVES`` counts every collective by kind and the bytes it moves
between slots.  The port compiles no HLO; the tests read this record where
the JAX package's tests read the compiled HLO ("no all-gather", "one psum",
"two permutes").
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dask_array_tpu_torch._executor import BlockView, _assemble

KINDS = ("psum", "pmin", "pmax", "ppermute", "all_gather", "all_to_all", "gather")


class CollectiveRecord(dict):
    """``{kind: count}`` over ``KINDS``, with ``nbytes[kind]``: the bytes
    each kind sent from one slot to another, whether or not the two slots
    share a device (copies a slot makes of its own data are not
    counted)."""

    def __init__(self):
        super().__init__({k: 0 for k in KINDS})
        self.nbytes = {k: 0 for k in KINDS}

    def add(self, kind, nbytes=0):
        self[kind] += 1
        self.nbytes[kind] += int(nbytes)

    def reset(self):
        for k in KINDS:
            self[k] = 0
            self.nbytes[k] = 0

    def snapshot(self) -> dict:
        return dict(self)

    def delta(self, before: dict) -> dict:
        """The kinds that moved since ``before`` (a ``snapshot()``)."""
        return {k: self[k] - before.get(k, 0) for k in KINDS if self[k] != before.get(k, 0)}


COLLECTIVES = CollectiveRecord()


def nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def normalize_spec(spec, ndim) -> tuple:
    spec = tuple(spec) if spec is not None else ()
    spec = spec + (None,) * (ndim - len(spec))
    return tuple(None if not entry_names(e) else (e if isinstance(e, str) else tuple(e)) for e in spec)


def slot_coords(mesh, slot) -> dict:
    """``{axis name: coordinate}`` of one slot."""
    idx = np.unravel_index(slot, mesh.devices.shape)
    return dict(zip(mesh.axis_names, (int(i) for i in idx)))


def part_index(mesh, coords, entry) -> tuple:
    """(part, parts) of one array axis on a slot: its linearised position
    over the entry's mesh axes, and their size product."""
    p, n = 0, 1
    for name in entry_names(entry):
        p = p * mesh.shape[name] + coords[name]
        n *= mesh.shape[name]
    return p, n


def part_range(dim, p, n) -> tuple:
    c = -(-int(dim) // n) if n else int(dim)
    return min(p * c, int(dim)), min((p + 1) * c, int(dim))


def slot_region(mesh, spec, shape, slot, bounds=None) -> tuple:
    """The slices of the global array a slot holds under ``spec`` (and the
    part offsets ``bounds`` where the layout is not regular)."""
    coords = slot_coords(mesh, slot)
    out = []
    for ax, (dim, entry) in enumerate(zip(shape, spec)):
        p, n = part_index(mesh, coords, entry)
        b = bounds[ax] if bounds is not None else None
        a, e = part_range(dim, p, n) if b is None else (b[p], b[p + 1])
        out.append(slice(a, e))
    return tuple(out)


def regular_bounds(dim, n) -> tuple:
    """The part offsets of ``part_range``: ``n + 1`` of them."""
    return tuple(part_range(dim, p, n)[0] for p in range(n)) + (int(dim),)


def normalize_bounds(mesh, spec, shape, bounds):
    """``bounds`` with each regular (or unsharded) axis as None, and None
    where every axis is: the one form two equal layouts share."""
    if bounds is None:
        return None
    out = []
    for dim, entry, b in zip(shape, spec, bounds):
        if b is None or entry is None:
            out.append(None)
            continue
        b = tuple(int(v) for v in b)
        if len(b) != spec_size(mesh, entry) + 1 or b[0] != 0 or b[-1] != int(dim):
            raise ValueError(f"part offsets {b} do not split an axis of {dim} into {spec_size(mesh, entry)} parts")
        out.append(None if b == regular_bounds(dim, spec_size(mesh, entry)) else b)
    return None if all(b is None for b in out) else tuple(out)


def groups(mesh, axes) -> list:
    """Slots grouped by their coordinates off ``axes``; each group lists
    its slots by their linearised position over ``axes`` (first axis
    major), the order ``lax.axis_index`` gives inside ``shard_map``."""
    axes = entry_names(axes)
    out: dict = {}
    for s in range(mesh.size):
        c = slot_coords(mesh, s)
        key = tuple(c[n] for n in mesh.axis_names if n not in axes)
        pos, _ = part_index(mesh, c, axes)
        out.setdefault(key, {})[pos] = s
    return [[g[p] for p in sorted(g)] for g in out.values()]


class ShardedTensor:
    """One tensor per mesh slot under a partition ``spec`` (see the module
    docstring).  ``global_shape`` is the shape ``gather()`` returns.
    ``bounds`` gives, per array axis, the offsets of its parts where they
    are not ``part_range``'s (a slice narrows each part by what it keeps);
    None where every axis is regular."""

    __slots__ = ("mesh", "spec", "shards", "global_shape", "bounds")

    def __init__(self, mesh, spec, shards, global_shape, bounds=None):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} slots")
        self.mesh = mesh
        self.spec = normalize_spec(spec, len(global_shape))
        self.shards = list(shards)
        self.global_shape = tuple(int(s) for s in global_shape)
        self.bounds = normalize_bounds(mesh, self.spec, self.global_shape, bounds)

    def region(self, slot) -> tuple:
        """The slices of the global array ``slot`` holds."""
        return slot_region(self.mesh, self.spec, self.global_shape, slot, self.bounds)

    def axis_bounds(self, ax) -> tuple:
        """The part offsets of array axis ``ax`` (``(0, dim)`` when whole)."""
        entry = self.spec[ax]
        if entry is None:
            return (0, self.global_shape[ax])
        if self.bounds is not None and self.bounds[ax] is not None:
            return self.bounds[ax]
        return regular_bounds(self.global_shape[ax], spec_size(self.mesh, entry))

    def same_layout(self, spec, bounds=None) -> bool:
        spec = normalize_spec(spec, self.ndim)
        return self.spec == spec and self.bounds == normalize_bounds(self.mesh, spec, self.global_shape, bounds)

    @property
    def ndim(self):
        return len(self.global_shape)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def shape(self):
        return self.global_shape

    def parts(self) -> dict:
        """``{part tuple: slot}``: one slot holding each distinct part (the
        first in slot order)."""
        out = {}
        for s in range(self.mesh.size):
            c = slot_coords(self.mesh, s)
            key = tuple(part_index(self.mesh, c, e)[0] for e in self.spec)
            out.setdefault(key, s)
        return out

    def gather(self, device=None, record=True) -> torch.Tensor:
        """The dense tensor on ``device`` (by default the mesh's first slot),
        assembled from one copy of each part; records one ``gather`` with
        the bytes of the parts that leave their slot (every part but the
        first slot's, or those on another device than ``device``)."""
        first = device is None
        device = self.mesh.devices.flat[0] if first else torch.device(device)
        parts = self.parts()
        numblocks = tuple(part_index(self.mesh, slot_coords(self.mesh, 0), e)[1] for e in self.spec)
        moved = 0
        blocks = {}
        for key, s in parts.items():
            t = self.shards[s]
            if (s != 0) if first else (t.device != device):
                moved += nbytes(t)
            blocks[key] = t.to(device, non_blocking=True)
        if record:
            COLLECTIVES.add("gather", moved)
        if not numblocks:
            return blocks[()]
        return _assemble(blocks, numblocks)

    def __repr__(self):
        return f"ShardedTensor(shape={self.global_shape}, spec={self.spec}, dtype={self.dtype}, mesh={self.mesh.shape})"


def shard(t, mesh, spec, bounds=None) -> ShardedTensor:
    """``device_put`` of a dense tensor: every slot takes its part under
    ``spec`` and moves it to its device (a view where it is there already)."""
    spec = normalize_spec(spec, t.ndim)
    shards = []
    for s, dev in enumerate(mesh.devices.flat):
        shards.append(t[slot_region(mesh, spec, t.shape, s, bounds)].to(dev, non_blocking=True))
    return ShardedTensor(mesh, spec, shards, tuple(t.shape), bounds)


def as_sharded(x, mesh, spec, bounds=None) -> ShardedTensor:
    """``x`` under ``spec`` (and part offsets ``bounds``): a dense tensor is
    sharded (``device_put``); a sharded one already so laid out passes as
    it is, and one under another layout moves to it (``reshard``,
    recorded with its bytes: an ``all_gather`` where every slot takes the
    whole array, an ``all_to_all`` otherwise; the traffic the JAX
    package's ``shard_map`` makes outside its body)."""
    spec = normalize_spec(spec, x.ndim)
    if not isinstance(x, ShardedTensor):
        return shard(x, mesh, spec, bounds)
    if x.same_layout(spec, bounds):
        return x
    kind = "all_gather" if all(e is None for e in spec) else "all_to_all"
    return reshard(x, spec, kind=kind, bounds=bounds)


def _source_slot(mesh, candidates, dst):
    """Among the slots holding a part, the one a copy to ``dst`` reads:
    ``dst`` itself, else one on its device, else the nearest by mesh
    coordinates (so a move stays inside the destination's group)."""
    if dst in candidates:
        return dst
    dev = mesh.devices.flat[dst]
    same = [s for s in candidates if mesh.devices.flat[s] == dev]
    if same:
        return same[0]
    cd = slot_coords(mesh, dst)

    def dist(s):
        cs = slot_coords(mesh, s)
        return sum(cs[n] != cd[n] for n in mesh.axis_names)

    return min(candidates, key=dist)


def reshard(x: ShardedTensor, spec, kind="all_to_all", bounds=None) -> ShardedTensor:
    """``x`` under another partition ``spec`` (and part offsets ``bounds``):
    each slot assembles its new part from the pieces of the old parts that
    overlap it.  The global array is unchanged; only its distribution
    moves.  Records one ``kind`` (None records nothing) with the bytes
    that crossed slots."""
    mesh = x.mesh
    spec = normalize_spec(spec, x.ndim)
    shape = x.global_shape
    bounds = normalize_bounds(mesh, spec, shape, bounds)
    holders: dict = {}
    for s in range(mesh.size):
        holders.setdefault(x.region(s), []).append(s)
    moved = 0
    shards = []
    for dst, dev in enumerate(mesh.devices.flat):
        region = slot_region(mesh, spec, shape, dst, bounds)
        if region in holders and dst in holders[region]:
            shards.append(x.shards[dst])
            continue
        out = torch.empty(tuple(r.stop - r.start for r in region), dtype=x.dtype, device=dev)
        for src_region, cands in holders.items() if out.numel() else ():
            inter = [slice(max(a.start, b.start), min(a.stop, b.stop)) for a, b in zip(region, src_region)]
            if any(i.stop <= i.start for i in inter):
                continue
            src = _source_slot(mesh, cands, dst)
            piece = x.shards[src][tuple(slice(i.start - r.start, i.stop - r.start) for i, r in zip(inter, src_region))]
            if src != dst:
                moved += nbytes(piece)
            out[tuple(slice(i.start - r.start, i.stop - r.start) for i, r in zip(inter, region))] = piece.to(
                dev, non_blocking=True)
        shards.append(out)
    if kind is not None:
        COLLECTIVES.add(kind, moved)
    return ShardedTensor(mesh, spec, shards, shape, bounds)


def spec_size(mesh, entry) -> int:
    return math.prod(mesh.shape[n] for n in entry_names(entry))


class ShardedView(BlockView):
    """A node's value held as a ``ShardedTensor``.  A consumer with a
    partition rule (``parallel/partition.py``) reads ``sharded`` as it is;
    any other reads ``dense()`` (or a block), and the first such read
    gathers it to the mesh's first slot, recorded as one ``gather`` and
    kept, so a node read both ways gathers once.  ``dense`` may be given
    where the dense tensor is already on the first slot (a leaf bound
    sharded): reading it then moves nothing."""

    __slots__ = ("sharded", "gathered")

    def __init__(self, chunks, sharded, dense=None):
        self.chunks = chunks
        self._blocks = None
        self._dense = dense
        self.sharded = sharded
        self.gathered = False  # whether a dense read gathered it

    def dense(self):
        if self._dense is None:
            self._dense = self.sharded.gather()
            self.gathered = True
        return self._dense

    def block(self, index):
        if any(isinstance(c, float) and math.isnan(c) for dim in self.chunks for c in dim):
            return self.dense()  # unknown chunks: one block
        return self.dense()[_block_slices(self.chunks, index)]


def _block_slices(chunks, index):
    from dask_array_tpu_torch._executor import block_slices

    return block_slices(chunks, index)
