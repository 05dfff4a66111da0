"""Time the histogram kernel (K2) of one or two checkouts on one CUDA card.

    python3 scripts/time_histogram.py [--root DIR] [--old DIR] [--label NAME]

Imports ``dask_array_tpu_torch`` from ``--root`` (default: the checkout
holding this script) as "new" and, with ``--old``, the package of a second
checkout beside it in the same process as "old" (``scripts/_twin.py``;
unpack a parent with ``git archive`` into ``build/``), builds their
kernels, and times each case on each side in the order old, new, new,
old.  The cases are this checkout's ``chip_smoke.k2_cases``,
``k2_two_byte_cases`` and ``k2_byte_cases`` on 2**26 values: float32 into
256 bins, weighted, into 65536 bins and into 65536 bins with every value
in one bin; a 65536-bin bincount of int64, and weighted; bfloat16 and
float16 into 256 and 65536 bins, and bfloat16 with every value in one of
65536 bins; the byte route on float8_e4m3fn, float8_e5m2 and int4 data
into 256 bins of (-4, 4), and on float8_e4m3fn bytes of one pattern and
of 16.  For each case it prints one JSON line: for each side the kernel
per call (a median of 20 CUDA-event runs each time the side runs) and on
the device alone (the least, quartiles, median and most of 30 runs each
time), and whether it equals the plain version on the card (weighted sums
to rtol 1e-12; the byte route also the plain count of its patterns); the
library call per call and on the device, and the bound (the bytes the
function must move over 3.35 TB/s).  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np

FLAT = 1 << 26


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--old", default=None, help="a second checkout, timed beside --root in this process")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_histogram: torch finds no CUDA device", file=sys.stderr)
        return 1
    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sides = {"new": importlib.import_module("dask_array_tpu_torch")}
    if args.old is not None:
        sys.path.insert(0, str(here))
        import _twin

        sides = {"old": _twin.load(args.old, "dask_array_tpu_torch_old"), **sides}
    hks = {k: importlib.import_module(f"{m.__name__}.kernels.histogram") for k, m in sides.items()}

    # the cases and timers of this checkout's chip_smoke.py
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", here.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # name -> {side: kernel}, plain version, (library name, call), bytes, rtol
    cases = {}
    for side, hk in hks.items():
        for name, kernel, plain, lib, nbytes, rtol, _ in (smoke.k2_cases(torch, hk, FLAT)[1]
                                                          + smoke.k2_two_byte_cases(torch, hk, FLAT)):
            entry = cases.setdefault(name, {"kernel": {}, "plain": plain, "library": lib, "bytes": nbytes,
                                            "rtol": rtol})
            entry["kernel"][side] = kernel
    nb = 256
    e = torch.from_numpy(np.linspace(-4, 4, nb + 1)).cuda()  # phase 34's edges
    for name, (t, ndt) in smoke.k2_byte_cases(torch, FLAT).items():
        kind = ndt if ndt is not None else t.dtype
        values = hks["new"].byte_values(kind).to(t.device)[t.view(torch.uint8).to(torch.int64)]
        cases[f"bytes_{name}"] = {
            "kernel": {side: (lambda hk=hk, t=t, ndt=ndt: hk.histogram_counts_cuda(t, e, dtype=ndt))
                       for side, hk in hks.items()},
            "plain": lambda t=t, ndt=ndt: hks["new"].histogram_counts_plain(t, e, None, ndt),
            "patterns": lambda t=t, kind=kind: hks["new"].histogram_bytes_plain(t, e, kind),
            # torch.histc refuses float8 and has no int4: the float32 cast of a
            # float8 tensor inside the call, the int4 values before it (phase 34)
            "library": ("torch.histc of the float32 values",
                        lambda t=t, v=values: torch.histc((t if t.dtype != torch.uint8 else v).float(), nb, -4, 4)),
            "bytes": FLAT + nb * 8, "rtol": 0.0}

    for name, case in cases.items():
        ref = case["plain"]()
        row = {"label": args.label, "case": name, "card": smi}
        for side, kernel in case["kernel"].items():
            got = kernel()
            if case["rtol"]:
                agrees = bool(torch.allclose(got, ref.to(got.dtype), rtol=case["rtol"], atol=0))
            else:
                agrees = bool(torch.equal(got, ref.to(got.dtype)))
            if "patterns" in case:
                agrees = agrees and bool(torch.equal(got, case["patterns"]()))
            row[side] = {"equals_plain": agrees, "kernel_ms": [], "kernel_device_spread_ms": []}
            del got
        order = ["old", "new", "new", "old"] if "old" in hks else ["new", "new"]
        for side in order:
            row[side]["kernel_ms"].append(smoke.cuda_ms(case["kernel"][side], reps=20))
            row[side]["kernel_device_spread_ms"].append(smoke.spread(smoke.device_runs(case["kernel"][side])))
        lib_name, lib = case["library"]
        row.update(library=lib_name, library_ms=smoke.cuda_ms(lib, reps=20), library_device_ms=smoke.device_ms(lib),
                   bound_ms=smoke.bound(case["bytes"], 4 * FLAT)[0])
        for side in case["kernel"]:
            best = min(s[2] for s in row[side]["kernel_device_spread_ms"])
            row[side]["kernel_of_bound_device"] = row["bound_ms"] / best
        print(json.dumps(row), flush=True)
        del ref
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
