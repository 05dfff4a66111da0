"""Multi-device execution: the mesh, the chunk-grid -> mesh layout solver,
explicit collectives and the per-block shard lane.

Port of ``dask_array_tpu/parallel/``.  One process drives every slot of a
``Mesh`` (``mesh.py``), as the JAX package drives every device of a
``jax.sharding.Mesh``; collectives between slots are peer copies between
cards, and views or copies on one device (``collectives.py``).
"""

from dask_array_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    current_mesh,
    dcn_axis_names,
    multislice_mesh,
    set_mesh,
    use_mesh,
)
from dask_array_tpu_torch.parallel.layout import (
    constrain_to_mesh,
    sharding_for,
    sharding_for_chunks,
)

__all__ = [
    "auto_mesh",
    "current_mesh",
    "dcn_axis_names",
    "multislice_mesh",
    "use_mesh",
    "constrain_to_mesh",
    "sharding_for",
    "sharding_for_chunks",
]
