"""Opt-in xarray integration: registration never happens as an import
side effect; call ``register()``."""

from dask_array_tpu_torch._xarray import register  # noqa: F401
