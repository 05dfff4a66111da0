"""Device mesh context for multi-device execution.

Port of ``dask_array_tpu/parallel/mesh.py``.  The JAX package drives every
device of a ``jax.sharding.Mesh`` from one process; so does this port.  A
``Mesh`` here is a numpy object array of ``torch.device`` **slots** with one
name per axis.  A slot is a place a shard lives and a per-slot program runs;
slots may repeat a device (four slots on ``cuda:0``, eight on the CPU), the
analog of the JAX package's forced host device count.  Collectives between
slots (``parallel/collectives.py``) are peer copies between distinct cards
and views or copies on one device; no process group is involved.

``use_mesh`` activates a mesh for every ``compute()`` in its context: the
executor walks on the mesh's first slot, the shard lane runs per-slot
programs, rechunk boundaries relayout through explicit collectives and
``ShardStencil`` exchanges halos between slots.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_state = threading.local()


class Mesh:
    """An n-dimensional grid of device slots with named axes.

    ``devices`` is an array-like of ``torch.device`` (or device strings);
    its shape is the mesh shape.  ``shape`` is an ordered ``{name: size}``
    dict, as ``jax.sharding.Mesh.shape`` is; ``size`` is the slot count.
    Slots are numbered row-major over ``devices`` (``devices.flat``).
    """

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.flat]
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh of {arr.ndim} dims needs {arr.ndim} axis names, got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"mesh devices mix device types: {sorted({d.type for d in flat})}")
        self.devices = np.asarray(flat, dtype=object).reshape(arr.shape)
        self.axis_names = names
        self.shape = dict(zip(names, (int(s) for s in arr.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> list:
        """The slot devices in slot order."""
        return list(self.devices.flat)

    def key(self) -> tuple:
        """Stable identity for plan memos (the JAX package's ``_mesh_key``):
        axis names, shape and the slot devices in order."""
        return (self.axis_names, tuple(self.devices.shape), tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, [{devs}])"


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_mesh():
    """The active mesh, or None (single-device execution)."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a ``Mesh`` for computations in this context."""
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def set_mesh(mesh):
    """Imperatively set (or clear, with None) the process-default mesh."""
    st = _stack()
    st.clear()
    if mesh is not None:
        st.append(mesh)


#: mesh-axis names treated as the slow inter-node fabric unless config
#: ``"dcn-axes"`` pins the set explicitly
DCN_AXIS_NAMES = frozenset({"dcn", "slice", "pod"})


def dcn_axis_names(mesh):
    """The mesh-axis names that cross the slow inter-node fabric.

    Layout and collective scheduling treat them specially: the layout
    solver pins them grid-independently (``plan_layout``) and relayout
    stages that move them run last (``mesh_collective_relayout``).
    """
    from dask_array_tpu_torch import config

    pinned = config.get("dcn-axes", None)
    if pinned is not None:
        return frozenset(pinned) & set(mesh.shape)
    return DCN_AXIS_NAMES & set(mesh.shape)


def _default_devices():
    """Every CUDA card present; raises where there is none (a mesh is never
    built on the CPU unless the caller names the devices)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("auto_mesh/multislice_mesh found no CUDA device; pass devices=[...] explicitly")
    return [torch.device("cuda", i) for i in range(n)]


def _near_square(n):
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def multislice_mesh(n_slices, ici_axis_names=("x", "y"), devices=None):
    """Mesh over a multi-node topology: leading ``dcn`` axis, fast axes inside.

    Devices split contiguously into ``n_slices`` groups (torch devices carry
    no slice index); each group forms a near-square sub-mesh and the group
    axis is named ``dcn``, so the layout solver and the relayout scheduler
    apply the slow-fabric discipline.
    """
    if devices is None:
        devices = _default_devices()
    devices = [torch.device(d) for d in devices]
    if len(devices) % n_slices:
        raise ValueError(f"{len(devices)} devices do not split into {n_slices} slices")
    per = len(devices) // n_slices
    a, b = _near_square(per)
    if a == 1 or len(ici_axis_names) == 1:
        return Mesh(np.asarray(devices, dtype=object).reshape(n_slices, per), ("dcn", ici_axis_names[0]))
    return Mesh(np.asarray(devices, dtype=object).reshape(n_slices, a, b), ("dcn",) + tuple(ici_axis_names[:2]))


def auto_mesh(n_devices=None, axis_names=("x", "y"), devices=None):
    """Build a near-square 2-D mesh over the available devices (every CUDA
    card by default)."""
    if devices is None:
        devices = _default_devices()
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    a, b = _near_square(len(devices))
    return Mesh(np.asarray(devices, dtype=object).reshape(a, b), axis_names[:2])
