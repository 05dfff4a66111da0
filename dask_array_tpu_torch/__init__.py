"""dask_array_tpu_torch: the PyTorch/CUDA port of dask_array_tpu.

NumPy-compatible lazy chunked arrays over a content-addressed expression
tree (``simplify -> lower -> fuse`` with slice/rechunk/transpose pushdown
and blockwise fusion), executed by one walk of the optimized tree over
torch tensors on ``config["device"]``.  2-D ``map_overlap`` stencils run
through a hand-written CUDA band-stencil kernel on a GPU.

This is the first slice of the port: creation, ``from_array``, elementwise
ops and ufuncs, basic slicing, transpose, rechunk, ``map_blocks`` and
``map_overlap``.  Reductions, contractions and the rest wait (ROADMAP.md).
"""

from __future__ import annotations

from dask_array_tpu_torch import config
from dask_array_tpu_torch._blockwise import elemwise
from dask_array_tpu_torch._chunks import PerformanceWarning, normalize_chunks
from dask_array_tpu_torch._collection import Array, new_collection
from dask_array_tpu_torch._rechunk import rechunk
from dask_array_tpu_torch.ops._from_array import asarray, from_array
from dask_array_tpu_torch.ops._map_blocks import map_blocks
from dask_array_tpu_torch.ops._overlap import map_overlap, overlap, trim_internal
from dask_array_tpu_torch.ops.creation import arange, empty, full, ones, zeros
from dask_array_tpu_torch.ops.manipulation import transpose
from dask_array_tpu_torch.ops.ufuncs import *  # noqa: F403 (the ufunc table)
from dask_array_tpu_torch.ops.ufuncs import __all__ as _ufunc_names

__all__ = [
    "Array",
    "PerformanceWarning",
    "arange",
    "asarray",
    "config",
    "elemwise",
    "empty",
    "from_array",
    "full",
    "map_blocks",
    "map_overlap",
    "new_collection",
    "normalize_chunks",
    "ones",
    "overlap",
    "rechunk",
    "transpose",
    "trim_internal",
    "zeros",
    *_ufunc_names,
]
