"""Run chip_smoke.py's mesh phases alone on the card: phase 32 (the mesh,
the shard lane) and phase 33 (the partitioned walk), after building the
hand kernels.  Prints each phase's lines as chip_smoke.py does.

    python3 scripts/run_mesh_phases.py [--phase 32|33]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int, action="append", choices=(32, 33))
    phases = ap.parse_args().phase or [32, 33]
    if not torch.cuda.is_available():
        print("run_mesh_phases: torch finds no CUDA device", file=sys.stderr)
        return 1
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import _build

    config.set_global({"device": "cuda"})
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["band_stencil", "mstat", "transpose", "halo", "scale", "histogram"])
    if 32 in phases:
        t = time.perf_counter()
        mp, launches = cs.mesh_paths(da, torch, cs.MESH_SIZES)
        for name, num in mp.items():
            cs.phase(32, name, **num)
        cs.phase(32, "seconds", launches=launches, seconds=time.perf_counter() - t)
    if 33 in phases:
        t = time.perf_counter()
        pp, launches = cs.partitioned_paths(da, torch, cs.PARTITIONED_SIZES)
        for name, num in pp.items():
            cs.phase(33, name, **num)
        cs.phase(33, "seconds", launches=launches, seconds=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
