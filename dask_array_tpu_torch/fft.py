"""Submodule alias: dask_array_tpu_torch.fft (numpy.fft's names)."""
from dask_array_tpu_torch.ops.fft import *  # noqa: F401,F403
from dask_array_tpu_torch.ops.fft import fft_wrap  # noqa: F401
