"""IO: from_map/from_delayed/from_blocks, stores, zarr, hdf5, npy stacks,
tiledb and from_graph.

Port of ``dask_array_tpu/io/``.  Readers run on the host and each block
goes up to the configured device once per walk; writers compute on the
device and write on the host.
"""

from dask_array_tpu_torch.io._from_graph import GraphEvaluator, from_graph
from dask_array_tpu_torch.io._from_map import Delayed, delayed, from_blocks, from_delayed, from_map
from dask_array_tpu_torch.io._hdf5_read import from_hdf5
from dask_array_tpu_torch.io._npy_stack import from_npy_stack, to_npy_stack
from dask_array_tpu_torch.io._store import SerializableLock, store, to_hdf5
from dask_array_tpu_torch.io._tiledb import from_tiledb, to_tiledb
from dask_array_tpu_torch.io._zarr import from_zarr, to_zarr

__all__ = [
    "Delayed",
    "SerializableLock",
    "delayed",
    "from_blocks",
    "from_delayed",
    "from_graph",
    "from_hdf5",
    "from_map",
    "from_npy_stack",
    "from_tiledb",
    "from_zarr",
    "store",
    "to_hdf5",
    "to_npy_stack",
    "to_tiledb",
    "to_zarr",
]
