"""Process-global configuration with context-manager overrides.

The PyTorch port keeps the reference package's configuration mechanism
(``dask_array_tpu/config.py``) with only the keys the ported slice reads,
plus ``"device"``: the ``torch.device`` every ``compute()`` runs on.  Its
default is ``"cuda"``: the port runs on the card unless the caller asks for
the CPU with ``config.set({"device": "cpu"})``.  Without a card, a
``compute()`` under ``"cuda"`` raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Any

_global: dict[str, Any] = {
    # -- optimizer / planner (same meaning as in the reference package) --
    "array.rechunk.threshold": 32,
    # under a mesh: "auto" relayouts with explicit all_to_all stages when a
    # mesh axis moves between array axes; "tasks" never does;
    # "collective"/"p2p" always try the explicit schedule
    "array.rechunk.method": "auto",
    "array.unify-chunks-policy": "auto",  # "auto" | "coarse" | "refine"
    "array.unify-chunks-limit": "512 MiB",
    "array.chunk-size": "128 MiB",
    "array.optimize-graph": True,
    # -- execution --
    # the torch.device every compute() runs on ("cpu", "cuda", "cuda:1", ...)
    "device": "cuda",
    # float32 contractions (ops/linalg.py): "highest" keeps full-f32
    # products whatever torch's global setting; "high"/"default" allow TF32
    "matmul-precision": "highest",
    # 2-D map_overlap through the hand-written band-stencil kernel
    # (kernels/stencil.py): "auto" routes every eligible map_overlap to a
    # BandStencil node; "off" keeps the Overlap -> map_blocks -> trim form
    "stencil-kernel": "auto",
    # the out-of-core lane (_streaming.py): "auto" streams a program whose
    # estimated device bytes exceed "memory-budget", "force" streams
    # whatever it can plan, "off" never streams
    "out-of-core": "auto",
    # bytes ("12 GiB", an int) or "auto": three quarters of the configured
    # CUDA device's free memory; on the CPU "auto" is unbounded
    "memory-budget": "auto",
    # panels in flight beyond the one being fetched (1: double buffering)
    "stream-depth": 1,
    # -- multi-device (parallel/) --
    # the shard lane under a mesh: "auto" and "shard-map" run every program
    # its planner matches as per-slot programs (parallel/shardlane.py);
    # "gspmd" keeps the executor's walk
    "execution-lane": "auto",
    # map_overlap under a mesh: "shard" routes an eligible stencil to one
    # ShardStencil node (halo exchange between slots, the func per slot)
    "overlap-method": "auto",
    # mesh axes of the slow inter-node fabric; None = by name
    # ("dcn"/"slice"/"pod"), a tuple pins them
    "dcn-axes": None,
}

# reference keys that keep their name and meaning in the port
_SHARED_KEYS = (
    "array.rechunk.threshold",
    "array.rechunk.method",
    "array.unify-chunks-policy",
    "array.unify-chunks-limit",
    "array.chunk-size",
    "array.optimize-graph",
)

# bumped on every mutation: optimization caches key on this so a config
# change (unify policy, stencil routing, ...) invalidates cached plans
_epoch = 0


def epoch() -> int:
    return _epoch


def _bump() -> None:
    global _epoch
    _epoch += 1


def get(key: str, default: Any = None) -> Any:
    return _global.get(key, default)


def set_global(values: dict[str, Any]) -> None:
    _global.update(values)
    _bump()


_MISSING = object()


class set(contextlib.AbstractContextManager):
    """``with config.set({"device": "cuda"}): ...``

    Applies the values to the global layer immediately (imperative use); when
    used as a context manager, the previous values are restored on exit.
    """

    def __init__(self, values: dict[str, Any] | None = None, **kwargs):
        vals = dict(values or {})
        # dask-style keyword form: array__rechunk__threshold=4 means
        # "array.rechunk.threshold"; remaining single underscores map to
        # hyphens ONLY when that spelling is the registered key
        for k, v in kwargs.items():
            key = k.replace("__", ".")
            hyphened = key.replace("_", "-")
            if key not in _global and hyphened in _global:
                key = hyphened
            vals[key] = v
        self._saved = {k: _global.get(k, _MISSING) for k in vals}
        _global.update(vals)
        _bump()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is _MISSING:
                _global.pop(k, None)
            else:
                _global[k] = old
        _bump()
        return False


def from_reference(values: dict[str, Any]) -> dict[str, Any]:
    """Map a ``dask_array_tpu`` config dict onto this package's keys.

    Keys with a meaning here (the optimizer, chunk-policy and
    ``array.rechunk.method`` keys) carry over unchanged;
    ``tpu.stencil-kernel`` becomes ``"stencil-kernel"`` ("off" stays off,
    every engaging setting becomes "auto"), ``tpu.matmul-precision``
    becomes ``"matmul-precision"``; ``tpu.out-of-core``,
    ``tpu.memory-budget``, ``tpu.stream-depth`` and the mesh keys
    ``tpu.execution-lane``, ``tpu.overlap-method`` and ``tpu.dcn-axes``
    lose their ``tpu.`` prefix.  The TPU-only keys (PRNG, QR/SVD methods,
    Gram precision, jit, donation) have no counterpart and are dropped.
    """
    out: dict[str, Any] = {}
    for key, value in values.items():
        if key in _SHARED_KEYS:
            out[key] = value
        elif key == "tpu.matmul-precision":
            out["matmul-precision"] = value
        elif key in ("tpu.out-of-core", "tpu.memory-budget", "tpu.stream-depth", "tpu.execution-lane",
                     "tpu.overlap-method", "tpu.dcn-axes"):
            out[key.removeprefix("tpu.")] = value
        elif key == "tpu.stencil-kernel":
            out["stencil-kernel"] = "off" if value in ("off", False, None) else "auto"
    return out
