"""dask_array_tpu_torch: the PyTorch/CUDA port of dask_array_tpu.

NumPy-compatible lazy chunked arrays over a content-addressed expression
tree (``simplify -> lower -> fuse`` with slice/rechunk/transpose pushdown
and blockwise fusion), executed by one walk of the optimized tree over
torch tensors on ``config["device"]`` (the card, unless the caller asks
for ``"cpu"``).  Four hand-written CUDA kernels serve it on a GPU: the
band stencil of 2-D ``map_overlap`` (``kernels/stencil.py``), the halo
assembly of every other ``overlap``/``map_overlap`` and of ``pad``
(``kernels/halo.py``), the multi-statistic reduction (``kernels/mstat.py``),
the tiled transpose of the last two axes (``kernels/transpose.py``) and the
broadcast scale of a real float multiply by a scalar, a row or a column
(``kernels/scale.py``).

The ported slices: creation, ``from_array``, elementwise ops and ufuncs,
basic slicing, rechunk, ``map_blocks``, ``map_overlap`` and ``blockwise``
(with contractions); the typed, moment, arg and cumulative reductions, the
generic ``reduction()`` tree, and ``einsum``/``tensordot``/``dot``/
``matmul``/``vdot``/``outer``; the shape and layout ops (transpose,
reshape/ravel, concatenate/stack/block, squeeze/expand_dims/broadcast_to,
flips/roll, ``.blocks``, ``persist``, ``freeze_chunks``); the general halo
path (``overlap``/``map_overlap``/``trim_overlap``, ``pad``,
``sliding_window_view``, the ``move_*`` reductions in ``ops._sliding``,
``push``) and the rest of creation (``*_like``, ``linspace``, ``eye``,
``diag``/``diagonal``, ``tri``, ``tile``, ``repeat``, ``meshgrid``,
``indices``, ``fromfunction``); the decompositions (``qr``/``tsqr``/``sfqr``,
``svd`` and ``linalg.svd_flip``, ``lu``, ``cholesky``, ``solve``,
``solve_triangular``, ``inv``, ``lstsq``, ``norm``), which are
``linalg``'s names, as in dask, and attributes here as in the JAX package,
but not in ``__all__``; the NumPy surface (the ufunc table, fancy indexing
and assignment, the routines with ``cov``/``gradient``/``unique``/
``histogram``/``topk``/``coarsen``/``apply_along_axis``), the gufuncs,
``shuffle`` and the quantiles.  ``svd_compressed``, IO and diagnostics
wait (ROADMAP.md).
"""

from __future__ import annotations

from dask_array_tpu_torch import config
from dask_array_tpu_torch import linalg, reductions
from dask_array_tpu_torch._blockwise import blockwise, elemwise
from dask_array_tpu_torch._chunks import PerformanceWarning, normalize_chunks
from dask_array_tpu_torch._collection import Array, new_collection
from dask_array_tpu_torch._rechunk import rechunk
from dask_array_tpu_torch.ops._from_array import asarray, from_array
from dask_array_tpu_torch.ops._map_blocks import map_blocks
from dask_array_tpu_torch.ops._overlap import (
    map_overlap,
    overlap,
    push,
    sliding_window_view,
    trim_internal,
    trim_overlap,
)
from dask_array_tpu_torch.ops.creation import (
    arange,
    diag,
    diagonal,
    empty,
    empty_like,
    eye,
    fromfunction,
    full,
    full_like,
    indices,
    linspace,
    meshgrid,
    ones,
    ones_like,
    pad,
    repeat,
    tile,
    tri,
    zeros,
    zeros_like,
)
from dask_array_tpu_torch.ops._reshape import ravel, reshape, reshape_blockwise
from dask_array_tpu_torch.ops.linalg import dot, einsum, matmul, outer, tensordot, vdot
from dask_array_tpu_torch.ops.linalg_decomp import (
    cholesky,
    inv,
    lstsq,
    lu,
    norm,
    qr,
    sfqr,
    solve,
    solve_triangular,
    svd,
    tsqr,
)
from dask_array_tpu_torch.ops.manipulation import (
    atleast_1d,
    atleast_2d,
    atleast_3d,
    broadcast_to,
    expand_dims,
    flip,
    fliplr,
    flipud,
    moveaxis,
    roll,
    rollaxis,
    rot90,
    squeeze,
    swapaxes,
    transpose,
)
from dask_array_tpu_torch.ops.stacking import block, concatenate, dstack, hstack, stack, vstack
from dask_array_tpu_torch.ops.reductions import *  # noqa: F403 (sum, mean, ...)
from dask_array_tpu_torch.ops.reductions import __all__ as _reduction_names
from dask_array_tpu_torch.ops.routines import *  # noqa: F403 (where, round, diff, ...)
from dask_array_tpu_torch.ops.routines import __all__ as _routine_names
from dask_array_tpu_torch.ops.ufuncs import *  # noqa: F403 (the ufunc table)
from dask_array_tpu_torch.ops.ufuncs import __all__ as _ufunc_names
from dask_array_tpu_torch.ops.ufuncs import gcd, heaviside, lcm, wrap_elemwise  # noqa: F401 (not in __all__)
from dask_array_tpu_torch.ops._fancy_indexing import take
from dask_array_tpu_torch.ops._from_array import array, asanyarray
from dask_array_tpu_torch.ops._gufunc import apply_gufunc, as_gufunc, gufunc
from dask_array_tpu_torch.ops._histogram import histogram, histogram2d, histogramdd
from dask_array_tpu_torch._shuffle import shuffle



def compute(*collections, **kwargs):
    """Compute one or more arrays together (returns a tuple of numpy).

    The arrays are optimized together and run in one executor walk, so
    shared work builds once, every leaf moves to the device once, and
    reductions of one operand that the multi-statistic kernel computes go
    through it in one read.  Other arguments pass through unchanged;
    keyword arguments are accepted for dask compatibility and ignored.
    """
    from dask_array_tpu_torch._materialize import compute_exprs, to_numpy

    arrays = [(i, c) for i, c in enumerate(collections) if isinstance(c, Array)]
    out = list(collections)
    denses = compute_exprs([c.expr for _, c in arrays]) if arrays else []
    for (i, c), dense in zip(arrays, denses):
        arr = to_numpy(dense, c.expr)
        out[i] = arr[()] if arr.ndim == 0 else arr
    return tuple(out)


def optimize(x, keys=None, **kwargs):
    """``x`` with its expression optimized (``Array.optimize``); anything
    else passes through unchanged."""
    if isinstance(x, Array):
        return x.optimize()
    return x


# numpy's constants and dtype names, as in the JAX package
import numpy as _np  # noqa: E402

newaxis = None
nan = _np.nan
inf = _np.inf
e = _np.e
pi = _np.pi
euler_gamma = _np.euler_gamma

bool = _np.bool_
int8 = _np.int8
int16 = _np.int16
int32 = _np.int32
int64 = _np.int64
uint8 = _np.uint8
uint16 = _np.uint16
uint32 = _np.uint32
uint64 = _np.uint64
float32 = _np.float32
float64 = _np.float64
complex64 = _np.complex64
complex128 = _np.complex128

_CONSTANTS = [
    "newaxis", "nan", "inf", "e", "pi", "euler_gamma", "bool", "int8", "int16", "int32", "int64", "uint8",
    "uint16", "uint32", "uint64", "float32", "float64", "complex64", "complex128",
]

__all__ = [
    "Array",
    "PerformanceWarning",
    "apply_gufunc",
    "arange",
    "as_gufunc",
    "array",
    "asanyarray",
    "asarray",
    "atleast_1d",
    "atleast_2d",
    "atleast_3d",
    "block",
    "blockwise",
    "broadcast_to",
    "compute",
    "concatenate",
    "config",
    "diag",
    "diagonal",
    "dot",
    "dstack",
    "einsum",
    "elemwise",
    "empty",
    "empty_like",
    "expand_dims",
    "eye",
    "flip",
    "fliplr",
    "flipud",
    "from_array",
    "fromfunction",
    "full",
    "full_like",
    "gufunc",
    "histogram",
    "histogram2d",
    "histogramdd",
    "hstack",
    "indices",
    "linspace",
    "map_blocks",
    "map_overlap",
    "matmul",
    "meshgrid",
    "moveaxis",
    "new_collection",
    "normalize_chunks",
    "ones",
    "ones_like",
    "optimize",
    "outer",
    "overlap",
    "pad",
    "push",
    "ravel",
    "rechunk",
    "repeat",
    "reshape",
    "reshape_blockwise",
    "roll",
    "rollaxis",
    "rot90",
    "shuffle",
    "sliding_window_view",
    "squeeze",
    "stack",
    "swapaxes",
    "take",
    "tensordot",
    "tile",
    "transpose",
    "tri",
    "trim_internal",
    "trim_overlap",
    "vdot",
    "vstack",
    "zeros",
    "zeros_like",
    *_reduction_names,
    *_routine_names,
    *_ufunc_names,
    *_CONSTANTS,
]
