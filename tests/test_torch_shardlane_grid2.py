"""The shard lane's two-axis grids, stencils and declines through the port
on 8 CPU slots, beside the JAX package.

The cases, meshes and checks are ``tests/test_torch_shardlane.py``'s (the
same values within the stated tolerances, ``ENGAGED`` moving in both
packages or in neither, the port's collective schedule); this file runs
the pairs that file leaves out: the 2-D chunk grids (flattened blocks,
straddling reductions, the grouped Blelloch scan, the arg-extremum votes),
the halo stencils and every decline row of the matrix.
"""

import pytest

from test_torch_shardlane import ALL_PAIRS, SECOND_FILE, _cpu_device, check_case, jax_side  # noqa: F401

PAIRS = [(m, c) for m, c in ALL_PAIRS if c.startswith(SECOND_FILE)]


@pytest.mark.parametrize("mesh_name,case", PAIRS, ids=[f"{m}-{c}" for m, c in PAIRS])
def test_lane_matches_the_jax_package(jax_side, mesh_name, case):  # noqa: F811
    check_case(jax_side, mesh_name, case)
