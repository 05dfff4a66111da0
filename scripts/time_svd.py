"""Time the tall-skinny SVD of one checkout on one CUDA card.

    python3 scripts/time_svd.py [--root DIR] [--label NAME]

Imports ``dask_array_tpu_torch`` from ``DIR`` (default: the checkout
holding this script), persists a 1e6 x 128 float32 standard normal (numpy
seed 23) on the card in row chunks of 100 000, and prints one JSON line:
the host milliseconds of ``da.linalg.svd``'s device walk (the three
outputs computed together, median and minimum of 15 after 3 warm-up
walks) and the largest relative error of its singular values against
``torch.linalg.svdvals`` of the same array in float64.  Two checkouts are
compared by running this script for each, one after another on one card,
in the order old, new, new, old.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_svd: torch finds no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch._materialize import compute_exprs

    if not pathlib.Path(da.__file__).resolve().is_relative_to(root):
        print(f"time_svd: imported {da.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    da.config.set_global({"device": "cuda"})
    x = np.random.default_rng(23).standard_normal((1_000_000, 128), dtype=np.float32)
    xp = da.from_array(x, chunks=(100_000, 128)).persist()
    exprs = [a.expr for a in da.linalg.svd(xp)]
    for _ in range(3):
        compute_exprs(exprs)
    torch.cuda.synchronize()
    times = []
    for _ in range(15):
        t0 = time.perf_counter()
        compute_exprs(exprs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    s = compute_exprs(exprs)[1].double()
    s64 = torch.linalg.svdvals(torch.from_numpy(x).cuda().double())
    print(json.dumps({"label": args.label, "root": str(root), "card": smi, "shape": [1_000_000, 128],
                      "walk_ms_median": statistics.median(times), "walk_ms_min": min(times),
                      "s_max_rel_err_vs_f64": float(((s - s64).abs() / s64).max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
