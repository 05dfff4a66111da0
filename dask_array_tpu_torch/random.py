"""Submodule alias: dask_array_tpu_torch.random (numpy.random's names)."""
from dask_array_tpu_torch.ops.random import *  # noqa: F401,F403
from dask_array_tpu_torch.ops.random import (  # noqa: F401
    Generator, RandomState, choice, default_rng,
)
