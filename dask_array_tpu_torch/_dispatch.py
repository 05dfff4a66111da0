"""NEP-18 ``__array_function__`` dispatch: numpy functions -> the port's
lazy functions.

Port of the table in ``dask_array_tpu/_dispatch.py`` (``_table``,
``lookup_array_function``), pointing at the port's functions and holding
only the ones the port has.  A numpy function without an entry returns
``NotImplemented`` (numpy then raises ``TypeError``): nothing computes in
numpy on the host instead.

The chunk-type registry (``register_chunk_type``) names the duck-array
types a block may be: their blocks stay as they are, on the host lane
(``_host.py``), and compute through numpy's API, which dispatches through
the type's ``__array_ufunc__``/``__array_function__``.
"""

from __future__ import annotations

import numpy as np


def _np_take(a, indices, axis=None, out=None, mode="raise"):
    """numpy's take: no axis means the raveled array (``take``'s own
    default is dask's axis 0)."""
    from dask_array_tpu_torch.ops._fancy_indexing import take

    if out is not None or mode != "raise":
        raise NotImplementedError("take with out= or mode= is not supported")
    return take(a.ravel(), indices) if axis is None else take(a, indices, axis=axis)


def _table():
    from dask_array_tpu_torch.ops import _fancy_indexing as _fi
    from dask_array_tpu_torch.ops import _reshape as _rs
    from dask_array_tpu_torch.ops import creation as _cr
    from dask_array_tpu_torch.ops import linalg as _linalg
    from dask_array_tpu_torch.ops import manipulation as _manip
    from dask_array_tpu_torch.ops import reductions as _red
    from dask_array_tpu_torch.ops import routines as _rt
    from dask_array_tpu_torch.ops import stacking as _st
    from dask_array_tpu_torch.ops import ufuncs as _uf

    return {
        np.sum: _red.sum, np.prod: _red.prod, np.mean: _red.mean,
        np.var: _red.var, np.std: _red.std, np.min: _red.min, np.max: _red.max,
        np.any: _red.any, np.all: _red.all, np.argmin: _red.argmin,
        np.argmax: _red.argmax, np.nansum: _red.nansum, np.nanmean: _red.nanmean,
        np.nanmin: _red.nanmin, np.nanmax: _red.nanmax, np.nanstd: _red.nanstd,
        np.nanvar: _red.nanvar, np.nanprod: _red.nanprod,
        np.cumsum: _red.cumsum, np.cumprod: _red.cumprod, np.trace: _red.trace,
        np.transpose: _manip.transpose, np.swapaxes: _manip.swapaxes,
        np.moveaxis: _manip.moveaxis, np.rollaxis: _manip.rollaxis,
        np.squeeze: _manip.squeeze, np.expand_dims: _manip.expand_dims,
        np.broadcast_to: _manip.broadcast_to, np.flip: _manip.flip,
        np.flipud: _manip.flipud, np.fliplr: _manip.fliplr, np.rot90: _manip.rot90,
        np.roll: _manip.roll, np.atleast_1d: _manip.atleast_1d,
        np.atleast_2d: _manip.atleast_2d, np.atleast_3d: _manip.atleast_3d,
        np.concatenate: _st.concatenate, np.stack: _st.stack,
        np.vstack: _st.vstack, np.hstack: _st.hstack, np.dstack: _st.dstack,
        np.block: _st.block,
        np.reshape: _rs.reshape, np.ravel: _rs.ravel,
        np.dot: _linalg.dot, np.matmul: _linalg.matmul,
        np.tensordot: _linalg.tensordot, np.vdot: _linalg.vdot,
        np.einsum: _linalg.einsum, np.outer: _linalg.outer,
        np.where: _rt.where, np.round: _rt.round, np.around: _rt.around,
        np.isclose: _rt.isclose, np.allclose: _rt.allclose,
        np.count_nonzero: _rt.count_nonzero, np.nonzero: _rt.nonzero,
        np.flatnonzero: _rt.flatnonzero, np.argwhere: _rt.argwhere,
        np.diff: _rt.diff, np.ediff1d: _rt.ediff1d, np.average: _rt.average,
        np.ptp: _rt.ptp, np.select: _rt.select, np.piecewise: _rt.piecewise,
        np.choose: _rt.choose, np.compress: _rt.compress, np.extract: _rt.extract,
        np.tril: _rt.tril, np.triu: _rt.triu, np.diagonal: _cr.diagonal, np.diag: _cr.diag,
        np.insert: _rt.insert, np.delete: _rt.delete, np.append: _rt.append,
        np.take: _np_take, np.broadcast_arrays: _rt.broadcast_arrays,
        np.result_type: _rt.result_type, np.ndim: _rt.ndim, np.shape: _rt.shape,
        np.real: _uf.real, np.imag: _uf.imag, np.clip: _uf.clip,
        np.angle: _uf.angle, np.i0: _uf.i0, np.sinc: _uf.sinc, np.nan_to_num: _uf.nan_to_num,
        np.fix: _uf.fix, np.isneginf: _uf.isneginf, np.isposinf: _uf.isposinf,
        np.isreal: _uf.isreal, np.iscomplex: _uf.iscomplex,
        np.median: _red.median, np.nanmedian: _red.nanmedian,
        np.quantile: _red.quantile, np.nanquantile: _red.nanquantile,
        np.percentile: _red.percentile, np.nanpercentile: _red.nanpercentile,
        np.unique: _rt.unique, np.union1d: _rt.union1d, np.isin: _rt.isin,
        np.bincount: _rt.bincount, np.digitize: _rt.digitize, np.searchsorted: _rt.searchsorted,
        np.cov: _rt.cov, np.corrcoef: _rt.corrcoef, np.gradient: _rt.gradient,
        np.ravel_multi_index: _rt.ravel_multi_index, np.unravel_index: _rt.unravel_index,
        np.apply_along_axis: _rt.apply_along_axis, np.apply_over_axes: _rt.apply_over_axes,
    }


_TABLE = None


def lookup_array_function(func):
    global _TABLE
    if _TABLE is None:
        _TABLE = _table()
    return _TABLE.get(func)


# ---------------------------------------------------------------------------
# the chunk-type registry: duck-array types a block may be
# ---------------------------------------------------------------------------

_HANDLED_CHUNK_TYPES: list = [np.ndarray, np.ma.MaskedArray]

# the registered types that are not numpy arrays: their blocks ride the
# host lane with their type kept (a tuple: ``is_duck_chunk`` is on every
# block's path)
_DUCK_TYPES: tuple = ()


def _refresh_duck_types():
    global _DUCK_TYPES
    _DUCK_TYPES = tuple(t for t in _HANDLED_CHUNK_TYPES if isinstance(t, type) and not issubclass(t, np.ndarray))


def register_chunk_type(type_):
    """Register a duck-array type as a valid block type: an array that is
    not numpy's, that the port wraps as a block and does not defer to in
    arithmetic and numpy functions.  Its blocks stay on the host, as they
    are, and compute through numpy's API (NEP-13/NEP-18 dispatch)."""
    _HANDLED_CHUNK_TYPES.append(type_)
    _refresh_duck_types()


def is_valid_chunk_type(type_) -> bool:
    """Is ``type_`` a registered block type?  Anything that is not a type
    is not one."""
    try:
        return issubclass(type_, tuple(_HANDLED_CHUNK_TYPES))
    except TypeError:
        return False


def is_valid_array_chunk(array) -> bool:
    """Is ``array`` of a type the port can wrap as a block?"""
    return array is None or isinstance(array, tuple(_HANDLED_CHUNK_TYPES))


def is_duck_chunk(x) -> bool:
    """Is ``x`` a block of a registered duck type (not a numpy array)?"""
    return bool(_DUCK_TYPES) and isinstance(x, _DUCK_TYPES)
