"""xarray ChunkManager integration.

Port of ``dask_array_tpu/_xarray.py``: a ``ChunkManagerEntrypoint`` so
xarray objects can hold lazy ``dask_array_tpu_torch`` arrays, named
``"dask_array_tpu_torch"``.  Registration is opt-in only (never a side
effect of importing this package): call
``dask_array_tpu_torch.xarray.register()``.  Without xarray the manager
class builds on a vendored stand-in for xarray's abstract base, so it is
constructible and testable; its ``reduction``, ``scan``, ``map_blocks``,
``blockwise`` and ``apply_gufunc`` take numpy callables, which run in the
host lane (``_host.py``).
"""

from __future__ import annotations


def _entrypoint_base():
    try:
        from xarray.namedarray.parallelcompat import ChunkManagerEntrypoint

        return ChunkManagerEntrypoint
    except ImportError:
        # vendored stand-in with xarray's abstract surface
        # (xarray/namedarray/parallelcompat.py), so the manager class is
        # constructible and testable without the optional dependency;
        # registration itself still requires real xarray
        class ChunkManagerEntrypoint:
            array_cls: type
            available: bool = True

            def is_chunked_array(self, data) -> bool:
                return isinstance(data, self.array_cls)

            def chunks(self, data):
                raise NotImplementedError()

            def normalize_chunks(self, chunks, shape=None, limit=None, dtype=None, previous_chunks=None):
                raise NotImplementedError()

            def from_array(self, data, chunks, **kwargs):
                raise NotImplementedError()

            def rechunk(self, data, chunks, **kwargs):
                return data.rechunk(chunks, **kwargs)

            def compute(self, *data, **kwargs):
                raise NotImplementedError()

            def persist(self, *data, **kwargs):
                raise NotImplementedError()

            def reduction(self, arr, func, combine_func=None, aggregate_func=None, axis=None, dtype=None, keepdims=False):
                raise NotImplementedError()

            def scan(self, func, binop, ident, arr, axis=None, dtype=None, **kwargs):
                raise NotImplementedError()

            def apply_gufunc(self, func, signature, *args, axes=None, keepdims=False, output_dtypes=None, vectorize=None, **kwargs):
                raise NotImplementedError()

            def map_blocks(self, func, *args, dtype=None, chunks=None, drop_axis=None, new_axis=None, **kwargs):
                raise NotImplementedError()

            def blockwise(self, func, out_ind, *args, adjust_chunks=None, new_axes=None, align_arrays=True, **kwargs):
                raise NotImplementedError()

            def unify_chunks(self, *args, **kwargs):
                raise NotImplementedError()

            def store(self, sources, targets, **kwargs):
                raise NotImplementedError()

        return ChunkManagerEntrypoint


def make_manager_class():
    """Build the manager class (deferred: xarray is an optional dependency)."""
    from dask_array_tpu_torch._collection import Array

    Base = _entrypoint_base()

    class DaskArrayTpuTorchManager(Base):
        """xarray chunk manager over dask_array_tpu_torch Arrays."""

        array_cls = Array
        available = True

        def __init__(self):
            self.array_cls = Array

        def is_chunked_array(self, data) -> bool:
            return isinstance(data, Array)

        def chunks(self, data):
            return data.chunks

        def normalize_chunks(self, chunks, shape=None, limit=None, dtype=None, previous_chunks=None):
            from dask_array_tpu_torch._chunks import normalize_chunks

            return normalize_chunks(chunks, shape, limit=limit, dtype=dtype, previous_chunks=previous_chunks)

        def from_array(self, data, chunks, **kwargs):
            from dask_array_tpu_torch.ops._from_array import from_array

            return from_array(data, chunks=chunks)

        def rechunk(self, data, chunks, **kwargs):
            return data.rechunk(chunks)

        def compute(self, *data, **kwargs):
            return tuple(
                d.compute() if isinstance(d, Array) else d for d in data
            )

        def persist(self, *data, **kwargs):
            return tuple(
                d.persist() if isinstance(d, Array) else d for d in data
            )

        def apply_gufunc(self, func, signature, *args, axes=None, keepdims=False, output_dtypes=None, output_sizes=None, vectorize=None, allow_rechunk=False, meta=None, **kwargs):
            from dask_array_tpu_torch.ops._gufunc import apply_gufunc

            return apply_gufunc(
                func,
                signature,
                *args,
                axes=axes,
                keepdims=keepdims,
                output_dtypes=output_dtypes,
                output_sizes=output_sizes,
                vectorize=vectorize,
                allow_rechunk=allow_rechunk,
                meta=meta,
                **kwargs,
            )

        def map_blocks(self, func, *args, dtype=None, chunks=None, drop_axis=None, new_axis=None, **kwargs):
            from dask_array_tpu_torch.ops._map_blocks import map_blocks

            return map_blocks(
                func, *args, dtype=dtype, chunks=chunks, drop_axis=drop_axis, new_axis=new_axis, **kwargs
            )

        def blockwise(self, func, out_ind, *args, adjust_chunks=None, new_axes=None, align_arrays=True, **kwargs):
            from dask_array_tpu_torch._blockwise import blockwise

            return blockwise(
                func,
                out_ind,
                *args,
                adjust_chunks=adjust_chunks,
                new_axes=new_axes,
                align_arrays=align_arrays,
                **kwargs,
            )

        def unify_chunks(self, *args, **kwargs):
            from dask_array_tpu_torch.ops.routines import unify_chunks

            return unify_chunks(*args, **kwargs)

        def store(self, sources, targets, **kwargs):
            from dask_array_tpu_torch.io._store import store

            return store(sources, targets, **kwargs)

        def reduction(self, arr, func, combine_func=None, aggregate_func=None, axis=None, dtype=None, keepdims=False):
            from dask_array_tpu_torch.ops.reductions import reduction

            return reduction(
                arr,
                func,
                aggregate_func or func,
                combine=combine_func,
                axis=axis,
                dtype=dtype,
                keepdims=keepdims,
            )

        def scan(self, func, binop, ident, arr, axis=None, dtype=None, **kwargs):
            from dask_array_tpu_torch.ops.reductions import cumreduction

            return cumreduction(func, binop, ident, arr, axis=axis, dtype=dtype, **kwargs)

        def shuffle(self, x, indexer, axis, chunks=None):
            from dask_array_tpu_torch._shuffle import shuffle

            return shuffle(x, indexer, axis=axis)

    return DaskArrayTpuTorchManager


_registered = False


def register():
    """Register the chunk manager with xarray (opt-in, idempotent).

    After calling this, ``xr.Dataset(...).chunk(..., chunked_array_type=
    "dask_array_tpu_torch")`` (or the default, if no other manager is
    installed) flows through this package.
    """
    global _registered
    try:
        import xarray  # noqa: F401
    except ImportError as e:
        raise ImportError("xarray integration requires the optional dependency `xarray`") from e
    if _registered:
        return
    from xarray.namedarray import parallelcompat

    cls = make_manager_class()
    # xarray discovers managers via entrypoints; monkeypatch the loader to
    # ADD ours while keeping every other registered manager (dask, cubed...)
    orig = parallelcompat.list_chunkmanagers

    def patched():
        try:
            base = getattr(orig, "__wrapped__", orig)()
        except Exception:
            base = {}
        out = dict(base)
        out["dask_array_tpu_torch"] = cls()
        return out

    parallelcompat.list_chunkmanagers = patched
    _registered = True
