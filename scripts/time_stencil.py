"""Time the band-stencil kernels (K1) of one or two checkouts on one CUDA card.

    python3 scripts/time_stencil.py [--root DIR] [--old DIR] [--label NAME]

Imports ``dask_array_tpu_torch`` from ``--root`` (default: the checkout
holding this script) as "new" and, with ``--old``, the package of a second
checkout beside it in the same process as "old" (``scripts/_twin.py``;
unpack a parent with ``git archive`` into ``build/``), builds their
kernels, and times each case on each side in the order old, new, new, old.
The cases: the linear K1 on float32, bfloat16 and float16 normals at
4096^2 and 16384^2 with the 5-point Laplacian (depth (1, 1), reflect: the
register window, the main path's stencil) and at 4096^2 with a stencil
reaching (2, 3) (the tap list); then K1's programs, the five funcs of
``chip_smoke.program_funcs`` (tanh(laplace), the Sobel magnitude, the max
filter, the limited diffusion, a depth-2 tanh(laplace)) at 4096^2 float32
and 16384^2 float32, bfloat16 and float16, reflect.  For each case it
prints one JSON line: for each side the kernel per call and on the device
alone (a median of 30 CUDA-event runs each time the side runs), whether
the kernel agrees with its plain version on the card (linear, float32:
rtol 1e-5 and 2^-21 * sum|w| * max|x|; the 2-byte types:
``chip_smoke.close16`` against the plain version in float32, rounded
once; programs: 0 ulps, or at most 2 where a transcendental function
appears, as phase 35 holds them) and, for a program, the registers and
spilled bytes ptxas reports; and the bound (the bytes the function must
move over 3.35 TB/s, or its float32 operations over 67 TFLOP/s, the
larger).  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

SIZES = (4096, 16384)
PROGRAM_GROUPS = ((4096, "float32"), (16384, "float32"), (16384, "bfloat16"), (16384, "float16"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--old", default=None, help="a second checkout, timed beside --root in this process")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_stencil: torch finds no CUDA device", file=sys.stderr)
        return 1
    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sides = {"new": importlib.import_module("dask_array_tpu_torch")}
    if args.old is not None:
        sys.path.insert(0, str(here))
        import _twin

        sides = {"old": _twin.load(args.old, "dask_array_tpu_torch_old"), **sides}
    kernels = {k: importlib.import_module(f"{m.__name__}.kernels.stencil") for k, m in sides.items()}
    builds = {k: importlib.import_module(f"{m.__name__}.kernels._build") for k, m in sides.items()}

    # the timers, stencils and funcs of this checkout's chip_smoke.py
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", here.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def laplace(b):
        return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b

    bnd = ("reflect", "reflect")
    cases = [("laplace", dt, n, laplace, {}, (1, 1), None) for dt in ("float32", "bfloat16", "float16")
             for n in SIZES]
    cases += [("stencil_2_3", dt, SIZES[0], smoke.stencil_for(2, 3), {}, (2, 3), None)
              for dt in ("float32", "bfloat16", "float16")]
    cases += [(name, dt, n, func, kw, depth, exact) for n, dt in PROGRAM_GROUPS
              for name, (func, kw, depth, exact) in smoke.program_funcs().items()]

    # every program of every side, built at once (one nvcc each)
    programs = {}
    for side, st in kernels.items():
        items = {(name, dt): st.program_build_item(st.capture_program(st.bind_kwargs(func, kw), depth), depth,
                                                   getattr(torch, dt))
                 for name, dt, _, func, kw, depth, exact in cases if exact is not None}
        _, programs[side] = smoke.build_timed(builds[side], ["band_stencil"], items)

    g = torch.Generator(device="cuda").manual_seed(16)
    for name, dt_name, n, func, kw, depth, exact in cases:
        dt = getattr(torch, dt_name)
        x = torch.randn((n, n), generator=g, device="cuda").to(dt)
        row = {"label": args.label, "case": name, "dtype": dt_name, "size": n, "depth": list(depth), "card": smi}
        run = {}
        for side, st in kernels.items():
            bound_func = st.bind_kwargs(func, kw)
            if exact is None:
                taps = st.capture_taps(func, depth)
                run[side] = (lambda st=st, taps=taps: st.band_stencil_cuda(x, taps, depth, bnd))
            else:
                program = st.capture_program(bound_func, depth)
                run[side] = (lambda st=st, program=program: st.band_program_cuda(x, program, depth, bnd))
        plain_func = kernels["new"].bind_kwargs(func, kw)
        ref = kernels["new"].band_stencil_plain(x, plain_func, depth, bnd)
        if exact is None:
            taps = kernels["new"].capture_taps(func, depth)
            scale = sum(abs(w) for _, _, w in taps) * float(x.float().abs().max())
            ref = ref if dt == torch.float32 else kernels["new"].band_stencil_plain(x.float(), func, depth, bnd).to(dt)
            flops = 2 * len(taps) * n * n
        else:
            flops = len(kernels["new"].capture_program(plain_func, depth)) * n * n
        out = {side: {"kernel_ms": [], "kernel_device_ms": []} for side in kernels}
        for side in kernels:
            got = run[side]()
            torch.cuda.synchronize()
            if exact is None:
                agrees = (bool(torch.allclose(got, ref, rtol=1e-5, atol=scale * 2.0**-21)) if dt == torch.float32
                          else smoke.close16(got, ref, scale))
                out[side]["equals_plain"] = agrees
            else:
                ulps = smoke.ulps_apart(torch, got, ref)
                out[side].update(ulps_from_plain=ulps, equals_plain=ulps == 0 if exact else ulps <= 2,
                                 **{k: programs[side][name, dt_name][k]
                                    for k in ("registers", "spill_store_bytes")})
            out[side]["max_abs_err"] = float((got.double() - ref.double()).abs().max())
            del got
        order = ["old", "new", "new", "old"] if "old" in kernels else ["new", "new"]
        for side in order:
            out[side]["kernel_ms"].append(smoke.cuda_ms(run[side]))
            out[side]["kernel_device_ms"].append(smoke.device_ms(run[side]))
        row["bound_ms"], row["bound_by"] = smoke.bound(2 * n * n * x.element_size(), flops)
        for side, num in out.items():
            num["kernel_of_bound_device"] = row["bound_ms"] / min(num["kernel_device_ms"])
        row.update(out)
        print(json.dumps(row), flush=True)
        del x, ref, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
