"""Submodule alias: dask_array_tpu_torch.linalg (contractions; the
decompositions wait for a later slice)."""
from dask_array_tpu_torch.ops.linalg import *  # noqa: F401,F403
from dask_array_tpu_torch.ops.linalg import dot, matmul, outer, tensordot, vdot  # noqa: F401
