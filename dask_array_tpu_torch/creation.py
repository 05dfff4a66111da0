"""Submodule alias: dask_array_tpu_torch.creation."""
from dask_array_tpu_torch.ops.creation import *  # noqa: F401,F403
