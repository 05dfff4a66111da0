"""GPU smoke run of dask_array_tpu_torch, the PyTorch/CUDA port.

Drives the port's main path on one CUDA card through its public entry
points and checks every kernel on that path against its plain PyTorch
version.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints one line of its own numbers; any failure raises):
  1. setup: config "device" = "cuda", build the band-stencil kernel from
     dask_array_tpu_torch/csrc, print the card's name and power limit;
  2. the kernel against its plain version on the card: every boundary and
     every mixed pair, depths (1,1) (2,1) (1,0) (8,8), float16/32/64, a
     ragged shape;
  3. the README example (slice pushdown + fusion) on the card;
  4. stencil2d (BASELINE config 4): 4096x4096 float32, chunks 1024,
     depth 1, reflect, in the roll form (BandStencil) and the slices form
     (Overlap), both against a float64 numpy reference;
  5. stencil2d at 16384x16384 float32, chunks 4096, through compute(),
     against the plain version on the card;
  6. timing: the kernel and the plain version at both sizes (CUDA events,
     median of 30 after warm-up, in the order plain, kernel, kernel, plain;
     the faster median of each is reported), a device copy of the same
     bytes for reference, and the whole compute().

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when torch finds no CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(n, name, **numbers):
    print(f"phase {n} {name}: {json.dumps(numbers)}", flush=True)


def cuda_ms(fn, reps=30, warmup=3):
    """Median milliseconds of ``fn`` on the card, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps):
    """Median host milliseconds of ``fn`` (which ends in a synchronize)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stencil_for(d0, d1):
    """A linear stencil reaching exactly (d0, d1), with asymmetric weights
    so a wrong tap sign shows, and a corner tap when both depths are set."""
    import torch

    def f(b):
        out = -3.0 * b
        for s in range(1, d0 + 1):
            out = out + torch.roll(b, s, 0) * (0.5 / s) - torch.roll(b, -s, 0) * (0.25 / s)
        for s in range(1, d1 + 1):
            out = out + torch.roll(b, s, 1) * (0.75 / s) + torch.roll(b, -s, 1) / (2.0 * s)
        if d0 and d1:
            out = out + torch.roll(torch.roll(b, d0, 0), -d1, 1) * 0.125
        return out

    return f


def numpy_laplace(x):
    import numpy as np

    p = np.pad(x.astype(np.float64), 1, mode="symmetric")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.models.pipelines import laplace_roll, readme_example, stencil2d
    from dask_array_tpu_torch.ops._overlap import BandStencil

    # -- phase 1: setup ------------------------------------------------------
    config.set_global({"device": "cuda"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib_path, ptxas = stencil.build_library()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(ptxas.strip(), flush=True)
    phase(1, "setup", build_s=build_s, library=lib_path.name, torch=torch.__version__,
          cuda=torch.version.cuda, device=kind)
    print(smi, flush=True)

    # -- phase 2: the kernel against its plain version ------------------------
    modes = ["reflect", "nearest", "periodic", 0.0, 2.5]
    cases = [((1000, 1003), (1, 1), (b0, b1), torch.float32) for b0 in modes for b1 in modes]
    for depth in [(2, 1), (1, 0), (8, 8)]:
        for bnd in [("reflect", "periodic"), (2.5, "nearest"), ("periodic", 0.0)]:
            cases.append(((1000, 1003), depth, bnd, torch.float32))
    for dt in (torch.float16, torch.float64):
        for depth in [(1, 1), (2, 1), (8, 8)]:
            for bnd in [("reflect", "reflect"), ("periodic", 2.5), (0.0, "nearest")]:
                cases.append(((1000, 1003), depth, bnd, dt))
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for shape, depth, bnd, dt in cases:
        func = stencil_for(*depth)
        taps = stencil.capture_taps(func, depth)
        check(taps is not None, f"capture_taps declined the depth-{depth} test stencil")
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dt)
        got = stencil.band_stencil_cuda(x, taps, depth, bnd)
        torch.cuda.synchronize()
        scale = sum(abs(w) for _, _, w in taps) * float(x.abs().max())
        if dt == torch.float16:
            # the kernel accumulates float16 in float32: its reference is the
            # plain version in float32 on the same inputs, rounded once
            want = stencil.band_stencil_plain(x.float(), func, depth, bnd).half()
            rtol, atol = 1e-3, scale * 2.0**-11
        elif dt == torch.float32:
            want = stencil.band_stencil_plain(x, func, depth, bnd)
            rtol, atol = 1e-5, scale * 2.0**-21
        else:
            want = stencil.band_stencil_plain(x, func, depth, bnd)
            rtol, atol = 1e-12, scale * 1e-12
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{shape} {dt}: shape/dtype")
        err = float((got.double() - want.double()).abs().max())
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        key = str(dt).replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), err)
    phase(2, "kernel-vs-plain", cases=len(cases), shape=[1000, 1003],
          max_abs_err=worst, tolerance={"float32": "rtol 1e-5, atol sum|w|*max|x|*2^-21",
                                        "float64": "rtol 1e-12, atol sum|w|*max|x|*1e-12",
                                        "float16": "vs float32 plain: rtol 1e-3, atol sum|w|*max|x|*2^-11"})

    # -- phases 3-5: the main path, counting kernel launches ------------------
    stencil.LAUNCHES = 0

    y = readme_example()
    plan = y.optimize().expr.tree_repr()
    check(plan.startswith("FusedBlockwise[3]"), f"README plan not fused:\n{plan}")
    check(plan.count("Ones(chunks_=((100,), (100,))") == 2, f"slice not pushed into leaves:\n{plan}")
    dev = y.compute_device()
    check(dev.is_cuda, f"README result on {dev.device}")
    yv = y.compute()
    check(yv.shape == (100, 100) and bool(np.all(yv == 2.0)), "README values are not 2.0")
    phase(3, "readme", shape=list(yv.shape), value=float(yv[0, 0]), plan_nodes=plan.count("\n"))

    rng = np.random.default_rng(0)
    x4 = rng.standard_normal((4096, 4096), dtype=np.float32)
    ref4 = numpy_laplace(x4)
    atol4 = 8 * float(np.abs(x4).max()) * 2.0**-21
    roll4 = stencil2d(x4, chunk=1024, form="roll")
    check(isinstance(roll4.expr, BandStencil), f"roll form is {type(roll4.expr).__name__}")
    before = stencil.LAUNCHES
    out4 = roll4.compute_device()
    check(out4.is_cuda, f"stencil2d result on {out4.device}")
    check(stencil.LAUNCHES > before, "stencil2d roll form did not launch the kernel")
    r4 = out4.cpu().numpy()
    slices4 = stencil2d(x4, chunk=1024, form="slices")
    check(not isinstance(slices4.expr, BandStencil), "slices form routed to BandStencil")
    s4 = slices4.compute()
    for name, res in (("roll", r4), ("slices", s4)):
        check(res.shape == (4096, 4096) and res.dtype == np.float32, f"{name}: shape/dtype")
        check(bool(np.isfinite(res).all()), f"{name}: non-finite values")
        np.testing.assert_allclose(res, ref4, rtol=1e-5, atol=atol4)
    phase(4, "stencil2d-4096", roll_err=float(np.abs(r4 - ref4).max()),
          slices_err=float(np.abs(s4 - ref4).max()), atol=atol4)

    x16 = rng.standard_normal((16384, 16384), dtype=np.float32)
    roll16 = stencil2d(x16, chunk=4096, form="roll")
    check(isinstance(roll16.expr, BandStencil), "16384 roll form is not BandStencil")
    res16 = roll16.compute()
    check(res16.shape == (16384, 16384) and res16.dtype == np.float32, "16384: shape/dtype")
    check(bool(np.isfinite(res16).all()), "16384: non-finite values")
    x16d = torch.from_numpy(x16).cuda()
    want16 = stencil.band_stencil_plain(x16d, laplace_roll, (1, 1), ("reflect", "reflect"))
    got16 = torch.from_numpy(res16).cuda()
    torch.cuda.synchronize()
    atol16 = 8 * float(x16d.abs().max()) * 2.0**-21
    torch.testing.assert_close(got16, want16, rtol=1e-5, atol=atol16)
    err16 = float((got16 - want16).abs().max())
    del res16, got16, want16, x16d
    phase(5, "stencil2d-16384", max_abs_err=err16, atol=atol16)

    launches = stencil.LAUNCHES
    check(launches > 0, "the main path launched the band-stencil kernel no time")

    # -- phase 6: timing -------------------------------------------------------
    bnd = ("reflect", "reflect")
    taps = stencil.capture_taps(laplace_roll, (1, 1))
    timings = {}
    for n, x_np, arr, reps in ((4096, x4, roll4, 5), (16384, x16, roll16, 3)):
        xd = torch.from_numpy(x_np).cuda()
        nbytes = 2 * n * n * xd.element_size()
        # plain, kernel, kernel, plain: drift in clocks hits both alike
        p_ms = cuda_ms(lambda: stencil.band_stencil_plain(xd, laplace_roll, (1, 1), bnd))
        k_ms = cuda_ms(lambda: stencil.band_stencil_cuda(xd, taps, (1, 1), bnd))
        k2_ms = cuda_ms(lambda: stencil.band_stencil_cuda(xd, taps, (1, 1), bnd))
        p2_ms = cuda_ms(lambda: stencil.band_stencil_plain(xd, laplace_roll, (1, 1), bnd))
        kernel_ms, plain_ms = min(k_ms, k2_ms), min(p_ms, p2_ms)
        # the same bytes read and written by a plain device copy: the
        # card's copy-stream reference for a memory-bound kernel
        copy_ms = cuda_ms(lambda: xd.clone())
        dev_ms = host_ms(lambda: (arr.compute_device(), torch.cuda.synchronize()), reps)
        compute_ms = host_ms(arr.compute, reps)
        err = float((stencil.band_stencil_cuda(xd, taps, (1, 1), bnd)
                     - stencil.band_stencil_plain(xd, laplace_roll, (1, 1), bnd)).abs().max())
        timings[n] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                          kernel_runs_ms=[k_ms, k2_ms], plain_runs_ms=[p_ms, p2_ms],
                          kernel_GBps=nbytes / kernel_ms / 1e6, plain_GBps=nbytes / plain_ms / 1e6,
                          copy_ms=copy_ms, copy_GBps=nbytes / copy_ms / 1e6,
                          compute_device_ms=dev_ms, compute_device_GBps=nbytes / dev_ms / 1e6,
                          compute_ms=compute_ms, compute_GBps=nbytes / compute_ms / 1e6,
                          max_abs_err=err)
        phase(6, f"timing-{n}", card=smi, **timings[n])
        del xd
    slices_ms = host_ms(slices4.compute, 5)
    phase(6, "timing-4096-slices-form", card=smi, compute_ms=slices_ms,
          compute_GBps=2 * 4096 * 4096 * 4 / slices_ms / 1e6)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "band_stencil",
        "route": "cuda",
        "source": "dask_array_tpu_torch/csrc/band_stencil.cu",
        "replaces": "dask_array_tpu/kernels/stencil.py:83",
        "launches": launches,
        "max_abs_err": timings[4096]["max_abs_err"],
        "ms": timings[4096]["kernel_ms"],
        "plain_ms": timings[4096]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
