"""Time the histogram kernel (K2) of one checkout on one CUDA card.

    python3 scripts/time_histogram.py [--root DIR] [--label NAME]

Imports ``dask_array_tpu_torch.kernels.histogram`` from ``DIR`` (default:
the checkout holding this script), builds its kernel, and runs the cases
of ``chip_smoke.k2_cases`` and ``chip_smoke.k2_two_byte_cases`` (this
checkout's) on 2**26 values: float32 into 256 bins, weighted, into 65536
bins and into 65536 bins with every value in one bin; a 65536-bin
bincount of int64, and weighted; bfloat16 and float16 into 256 and 65536
bins, and bfloat16 with every value in one of 65536 bins.  For each case it
prints one JSON line: the kernel per call and on the device alone, the
library call the same two ways, the bound (the bytes the function must
move over 3.35 TB/s) and the kernel's share of it, and whether the kernel
equals its plain version on the card (weighted sums to rtol 1e-12).  Two
checkouts are compared by running this script for each, one after another
on one card, in the order old, new, new, old (unpack the old one with
``git archive`` into ``build/``).  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

FLAT = 1 << 26


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_histogram: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from dask_array_tpu_torch.kernels import histogram as hk

    # the cases and timers of this checkout's chip_smoke.py, whatever DIR holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, cases = smoke.k2_cases(torch, hk, FLAT)
    cases += smoke.k2_two_byte_cases(torch, hk, FLAT)
    for name, kernel, plain, lib, nbytes, rtol, _ in cases:
        got, ref = kernel(), plain()
        if rtol:
            agrees = bool(torch.allclose(got, ref.to(got.dtype), rtol=rtol, atol=0))
        else:
            agrees = bool(torch.equal(got, ref.to(got.dtype)))
        row = {"label": args.label, "root": args.root, "case": name, "card": smi, "equals_plain": agrees,
               "kernel_ms": smoke.cuda_ms(kernel, reps=20), "kernel_device_ms": smoke.device_ms(kernel),
               "library": lib[0], "library_ms": smoke.cuda_ms(lib[1], reps=20),
               "library_device_ms": smoke.device_ms(lib[1]), "bound_ms": smoke.bound(nbytes, 4 * FLAT)[0]}
        row["kernel_of_bound_device"] = row["bound_ms"] / row["kernel_device_ms"]
        print(json.dumps(row), flush=True)
        del got, ref
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
