"""Time the multi-statistic kernel of one checkout on one CUDA card.

    python3 scripts/time_mstat.py [--root DIR] [--label NAME]

Imports ``dask_array_tpu_torch.kernels.mstat`` from ``DIR`` (default: the
checkout holding this script), builds its kernel, and at (10000, 10000),
(1000000, 128) and (128, 1000000) float32 prints one JSON line each: the
kernel per call and on the device alone, torch's trio (``x.sum(0)``,
``x.sum(1) / N``, ``x.std(correction=0)``) and a device copy of ``x`` the
same two ways, and the bound (the bytes the function must move over
3.35 TB/s).  Two checkouts are compared by running this script for each,
one after another on one card, in the order old, new, new, old.  Exits 1
without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

SHAPES = [(10000, 10000), (1_000_000, 128), (128, 1_000_000)]
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_mstat: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))
    from dask_array_tpu_torch.kernels import mstat

    from chip_smoke import cuda_ms, device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for M, N in SHAPES:
        x = torch.randn((M, N), generator=gen, device="cuda")
        shift = x[0, 0]
        kernel = lambda: mstat.multi_stat_packed(x, shift)  # noqa: E731
        trio = lambda: (x.sum(0), x.sum(1) / N, x.std(correction=0))  # noqa: E731
        copy = lambda: x.clone()  # noqa: E731
        bound_ms = (M * N + M + N + 3) * 4 / HBM_BYTES_PER_S * 1e3
        row = {"label": args.label, "root": args.root, "shape": [M, N], "card": smi,
               "kernel_ms": cuda_ms(kernel), "kernel_device_ms": device_ms(kernel),
               "trio_ms": cuda_ms(trio), "trio_device_ms": device_ms(trio),
               "copy_ms": cuda_ms(copy), "copy_device_ms": device_ms(copy), "bound_ms": bound_ms}
        row["kernel_of_bound_device"] = bound_ms / row["kernel_device_ms"]
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
