"""Submodule alias: dask_array_tpu_torch.routines."""
from dask_array_tpu_torch.ops.routines import *  # noqa: F401,F403
