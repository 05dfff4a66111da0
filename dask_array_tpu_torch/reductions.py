"""Submodule alias: dask_array_tpu_torch.reductions."""
from dask_array_tpu_torch.ops.reductions import *  # noqa: F401,F403
