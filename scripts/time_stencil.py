"""Time the band-stencil kernel (K1) of one checkout on one CUDA card.

    python3 scripts/time_stencil.py [--root DIR] [--label NAME]

Imports ``dask_array_tpu_torch.kernels.stencil`` from ``DIR`` (default:
the checkout holding this script), builds its kernel, and runs K1 on
float32, bfloat16 and float16 normals at 4096^2 and 16384^2 with the
5-point Laplacian (depth (1, 1), reflect: the register window, the main
path's stencil), and at 4096^2 with a stencil reaching (2, 3) (the tap
list).  For each case it prints one JSON line: the kernel per call and on
the device alone (medians of 30 CUDA-event runs), the bound (the bytes
the function must move over 3.35 TB/s, or its float32 operations over 67
TFLOP/s, the larger) and the device time's share of it, and whether the
kernel agrees with its plain version on the card (float32: rtol 1e-5 and
2^-21 * sum|w| * max|x|; the 2-byte types: ``chip_smoke.close16`` against
the plain version in float32, rounded once).  Two checkouts are compared
by running this script for each, one after another on one card, in the
order old, new, new, old (unpack the old one with ``git archive`` into
``build/``).  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

SIZES = (4096, 16384)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_stencil: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from dask_array_tpu_torch.kernels import stencil

    # the timers and stencils of this checkout's chip_smoke.py, whatever DIR holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def laplace(b):
        return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b

    bnd = ("reflect", "reflect")
    cases = [(dt, n, laplace, (1, 1)) for dt in (torch.float32, torch.bfloat16, torch.float16) for n in SIZES]
    cases += [(dt, SIZES[0], smoke.stencil_for(2, 3), (2, 3)) for dt in (torch.float32, torch.bfloat16, torch.float16)]
    g = torch.Generator(device="cuda").manual_seed(16)
    for dt, n, func, depth in cases:
        taps = stencil.capture_taps(func, depth)
        x = torch.randn((n, n), generator=g, device="cuda").to(dt)
        got = stencil.band_stencil_cuda(x, taps, depth, bnd)
        scale = sum(abs(w) for _, _, w in taps) * float(x.float().abs().max())
        if dt == torch.float32:
            ref = stencil.band_stencil_plain(x, func, depth, bnd)
            agrees = bool(torch.allclose(got, ref, rtol=1e-5, atol=scale * 2.0**-21))
        else:
            ref = stencil.band_stencil_plain(x.float(), func, depth, bnd).to(dt)
            agrees = smoke.close16(got, ref, scale)
        torch.cuda.synchronize()

        def kernel():
            return stencil.band_stencil_cuda(x, taps, depth, bnd)

        row = {"label": args.label, "root": args.root, "dtype": str(dt).removeprefix("torch."), "size": n,
               "depth": list(depth), "card": smi, "equals_plain": agrees,
               "max_abs_err": float((got.float() - ref.float()).abs().max()),
               "kernel_ms": smoke.cuda_ms(kernel), "kernel_device_ms": smoke.device_ms(kernel),
               "bound_ms": smoke.bound(2 * n * n * x.element_size(), 2 * len(taps) * n * n)[0]}
        row["kernel_of_bound_device"] = row["bound_ms"] / row["kernel_device_ms"]
        print(json.dumps(row), flush=True)
        del x, got, ref
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
