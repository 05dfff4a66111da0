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
``shuffle`` and the quantiles; the ``random`` submodule (numpy's
``Generator`` and ``RandomState`` with every distribution, drawn on the
device from a seeded ``torch.Generator``), the ``fft`` submodule (over
``torch.fft``), the randomized ``svd_compressed`` (also ``linalg``'s,
with ``compression_level`` and ``compression_matrix``) and
``ops._map_blocks.map_blocks_multi_output``; IO (``io``: stores, zarr
with a vendored store, hdf5, npy stacks, ``from_map``/``from_delayed``/
``from_blocks``, ``from_graph``, the tiledb shim), ``barrier``, the xarray
chunk manager (``xarray.register()``), block functions written in numpy
(run on the host: ``_host.py``), and the native plan algebra
(``native``, built with g++ at first use).  ``barrier`` and
``from_blocks`` are attributes, as in the JAX package, but not in
``__all__`` (dask has neither).  The out-of-core lane streams programs
larger than the card's memory panel by panel (``_streaming.py``, config
``"out-of-core"``), and every host copy goes through pinned staging rings
(``_hostcopy.py``).  The diagnostics (``explain``, ``chunk_report``,
``expr_table``, ``expr_flow``, ``trace_rewrites``; ``plan_table``,
``tier_report`` and ``xla_profile``, a ``torch.profiler`` trace, are
attributes but not in ``__all__``) are ported.  Masked, structured,
object and string arrays and registered duck chunk types
(``register_chunk_type``) compute on the host lane (``_host.py``);
datetime64/timedelta64 blocks are int64 ticks on the device, and
ml_dtypes' bfloat16 and float8 types are torch's.
"""

from __future__ import annotations

from dask_array_tpu_torch import config
from dask_array_tpu_torch import fft, linalg, random, reductions
from dask_array_tpu_torch._blockwise import blockwise, elemwise
from dask_array_tpu_torch._chunks import PerformanceWarning, normalize_chunks
from dask_array_tpu_torch._dispatch import register_chunk_type
from dask_array_tpu_torch._collection import Array, new_collection
from dask_array_tpu_torch._diagnostics import (
    chunk_report,
    explain,
    expr_table,
    plan_table,
    tier_report,
    trace_rewrites,
    xla_profile,
)
from dask_array_tpu_torch._expr_flow import expr_flow
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
    svd_compressed,
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
from dask_array_tpu_torch._materialize import barrier
from dask_array_tpu_torch import chunk, creation, io, xarray
from dask_array_tpu_torch.io import (
    from_blocks,
    from_delayed,
    from_map,
    from_npy_stack,
    from_tiledb,
    from_zarr,
    store,
    to_hdf5,
    to_npy_stack,
    to_tiledb,
    to_zarr,
)



def compute(*collections, **kwargs):
    """Compute one or more arrays together (returns a tuple of numpy).

    The arrays are optimized together and run in one executor walk, so
    shared work builds once, every leaf moves to the device once, and
    reductions of one operand that the multi-statistic kernel computes go
    through it in one read.  Other arguments pass through unchanged;
    keyword arguments are accepted for dask compatibility and ignored.
    """
    from dask_array_tpu_torch._spans import compute as in_compute

    arrays = [(i, c) for i, c in enumerate(collections) if isinstance(c, Array)]
    out = list(collections)
    if arrays:
        in_compute(_compute_arrays, arrays, out)
    return tuple(out)


def _compute_arrays(arrays, out):
    """``compute``'s walk of ``arrays`` ((position, Array) pairs), each
    answer put into ``out`` at its position."""
    from dask_array_tpu_torch._materialize import compute_exprs, to_numpy

    denses = compute_exprs([c.expr for _, c in arrays])
    for (i, c), dense in zip(arrays, denses):
        arr = to_numpy(dense, c.expr)
        out[i] = arr[()] if arr.ndim == 0 and type(arr) is _np.ndarray else arr


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
    "chunk_report",
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
    "explain",
    "expr_flow",
    "expr_table",
    "eye",
    "flip",
    "fliplr",
    "flipud",
    "from_array",
    "fromfunction",
    "full",
    "full_like",
    "from_delayed",
    "from_map",
    "from_npy_stack",
    "from_tiledb",
    "from_zarr",
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
    "register_chunk_type",
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
    "store",
    "swapaxes",
    "take",
    "tensordot",
    "tile",
    "to_hdf5",
    "to_npy_stack",
    "to_tiledb",
    "to_zarr",
    "trace_rewrites",
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


# -- derived docstrings -----------------------------------------------------------
# functions that shadow a numpy name and carry no docstring of their own
# inherit numpy's (with a note), as in the JAX package
from dask_array_tpu_torch.utils._derived import derive_docstrings as _derive_docstrings  # noqa: E402

_derive_docstrings(
    globals(),
    __all__,
    [
        ("", _np),
        ("linalg.", _np.linalg),
        ("fft.", _np.fft),
        ("lib.stride_tricks.", _np.lib.stride_tricks),
        ("ma.", _np.ma),
    ],
)
for _mod, _srcs in (
    (linalg, [("linalg.", _np.linalg), ("", _np)]),
    (fft, [("fft.", _np.fft)]),
    (random, [("random.", _np.random)]),
):
    _derive_docstrings(
        {_n: getattr(_mod, _n) for _n in dir(_mod) if not _n.startswith("_")},
        [_n for _n in dir(_mod) if not _n.startswith("_")],
        _srcs,
    )
del _derive_docstrings, _mod, _srcs
