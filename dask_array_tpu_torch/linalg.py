"""Submodule alias: dask_array_tpu_torch.linalg (contractions and
decompositions)."""
from dask_array_tpu_torch.ops.linalg import *  # noqa: F401,F403
from dask_array_tpu_torch.ops.linalg import dot, matmul, outer, tensordot, vdot  # noqa: F401
from dask_array_tpu_torch.ops.linalg_decomp import *  # noqa: F401,F403
