"""Time K3, the step-rounded scan, of one or two checkouts on one CUDA card.

    python3 scripts/time_scan.py [--root DIR] [--old DIR] [--label NAME]

Imports ``dask_array_tpu_torch`` from ``--root`` (default: the checkout
holding this script) as "new" and, with ``--old``, the package of a second
checkout beside it in the same process as "old" (``scripts/_twin.py``;
unpack a parent with ``git archive`` into ``build/``), builds their
kernels, and times each case on each side in the order old, new, new,
old.  The cases are chip_smoke.py phase 36's, on its data: float16 and
bfloat16 at 16384^2 through ``cumsum``, ``cumprod`` and ``nancumsum``
along each axis; 1e6 x 128 bfloat16 along axis 0; 2^24 float16 raveled;
the five narrow float types at 16384^2 along axis 0; and float8_e4m3fn
raveled at 2^24, along axis 0 at 1e6 x 128 and along axis 1 at 8 x 2^21
and 64 x 2^18.  On the float8_e4m3fn rows it also times, as the side
"other", this checkout's kernel through the route its launch plan did not
pick (the ring for a lone row, else the row-batch route), where the
crossover between them lies.  For each case it prints
one JSON line: for each side the kernel on the device alone (least, first
quartile, median, third quartile and most of 30 runs, 5 on chains of 1e6
steps or more, each time the side runs) and per call (CUDA events, the
median), whether it equals the plain version on the card (a chain longer
than 65536 steps on its first 4096 and, scanned from the output before
them, its last 4096 steps) and whether the two sides agree byte for byte;
the bound from bytes (one read and one write over 3.35 TB/s), the latency
floor (the steps times one step of this checkout's kernel, from
chip_smoke.step_floor_ns) and the card's name and power limit.  Exits 1
without a card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

LONG_CHAIN = 65536  # past this many steps the plain version checks the first and the last 4096
LONG_REPS = 5  # timed runs of chains of 1e6 steps or more


def agrees_with_plain(torch, scan, got, t, kind, axis, dt):
    """``got`` (the kernel's scan of ``t``) equals the plain version byte
    for byte: whole, or for a long chain its first 4096 steps and its last
    4096 scanned from the output before them."""
    width = torch.int16 if t.element_size() == 2 else torch.uint8
    n = t.shape[axis]
    if n <= LONG_CHAIN:
        return bool(torch.equal(got.view(width), scan.rounded_scan_plain(t, kind, axis, dt).view(width)))
    m = n - 4096
    head = scan.rounded_scan_plain(t.narrow(axis, 0, 4096), kind, axis, dt)
    tail = scan.rounded_scan_plain(torch.cat([got.narrow(axis, m - 1, 1), t.narrow(axis, m, n - m)], dim=axis),
                                   kind, axis, dt)
    return bool(torch.equal(got.narrow(axis, 0, 4096).view(width), head.view(width))
                and torch.equal(got.narrow(axis, m - 1, n - m + 1).view(width), tail.view(width)))


def cases(np, torch, ml_dtypes, smoke):
    """(tag, terms on the card, kind, axis, numpy dtype) of every case, made
    one group at a time from chip_smoke.py's data."""
    from dask_array_tpu_torch._chunks import tensor_of

    sizes = smoke.SCAN_SIZES
    n, corner = sizes["n"], sizes["corner"]
    for seed, (name, dt) in enumerate((("float16", np.dtype(np.float16)),
                                       ("bfloat16", np.dtype(ml_dtypes.bfloat16))), 360):
        for data_kind in ("cumsum", "cumprod"):
            t = tensor_of(smoke.scan_data(np, dt, (n, n), data_kind, corner, seed)).cuda()
            for kind in ((data_kind, "nancumsum") if data_kind == "cumsum" else (data_kind,)):
                terms = torch.where(torch.isnan(t), 0, t) if kind.startswith("nan") else t
                for axis in (0, 1):
                    yield f"{name}-{kind}-axis{axis}", terms, kind, axis, dt
                del terms
            del t
            torch.cuda.empty_cache()
    rows, width = sizes["tall"]
    t = tensor_of(smoke.scan_data(np, np.dtype(ml_dtypes.bfloat16), (rows, width), "cumsum", 0, 370)).cuda()
    yield "bfloat16-cumsum-1e6x128-axis0", t, "cumsum", 0, np.dtype(ml_dtypes.bfloat16)
    x = smoke.scan_data(np, np.dtype(np.float16), (sizes["flat"],), "cumsum", 0, 371)
    x = (x.astype(np.float32) / 300).astype(np.float16)  # phase 36's walk of N(0, 1) steps
    x.view(np.uint16)[-1000::37] = 0x7E01
    yield "float16-cumsum-2^24-flat", tensor_of(x).cuda(), "cumsum", 0, np.dtype(np.float16)
    del t, x
    for seed, name in enumerate(smoke.SCAN_NARROW, 380):
        yield (f"{name}-cumsum-axis0", tensor_of(smoke.narrow_data(torch, name, (n, n), seed)).cuda(), "cumsum", 0,
               np.dtype(getattr(ml_dtypes, name)))
    torch.cuda.empty_cache()
    e4 = np.dtype(ml_dtypes.float8_e4m3fn)
    for tag, shape, seed in (("2^24-flat", (sizes["flat"],), 390), ("1e6x128-axis0", (rows, width), 391)):
        g = torch.Generator(device="cuda").manual_seed(seed)  # normals times 2, made on the card
        yield (f"float8_e4m3fn-cumsum-{tag}", (torch.randn(shape, generator=g, device="cuda") * 2).to(
            torch.float8_e4m3fn), "cumsum", 0, e4)
    for rows, log_steps, seed in ((8, 21, 392), (64, 18, 393)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        yield (f"float8_e4m3fn-cumsum-{rows}x2^{log_steps}-axis1",
               (torch.randn((rows, 1 << log_steps), generator=g, device="cuda") * 2).to(torch.float8_e4m3fn),
               "cumsum", 1, e4)


def other_route(torch, scan, t, kind, axis, dt):
    """``t``'s aligned 1-byte rows scanned through the route
    ``launch_plan`` did not pick: the ring for a lone row, else the
    row-batch route."""
    x = t.contiguous()
    out = torch.empty_like(x)
    p, n, q = scan.scan_plan(x.shape, axis)
    plan = scan.launch_plan(p, n, q, 1, scan._sm_count(x.get_device()), x.data_ptr(), out.data_ptr())
    plan = plan._replace(batches=False) if plan.batches else scan.row_batch_plan(plan)
    table = scan.device_table(dt, kind, x.device)
    scan._launcher()(x.get_device(), x.data_ptr(), out.data_ptr(), table.data_ptr(), p, n, q, scan.scan_type(dt),
                     0, plan.fields())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--old", default=None, help="a second checkout, timed beside --root in this process")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_scan: torch finds no CUDA device", file=sys.stderr)
        return 1
    import ml_dtypes
    import numpy as np

    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sides = {"new": importlib.import_module("dask_array_tpu_torch")}
    if args.old is not None:
        sys.path.insert(0, str(here))
        import _twin

        sides = {"old": _twin.load(args.old, "dask_array_tpu_torch_old"), **sides}
    scans = {k: importlib.import_module(f"{m.__name__}.kernels.scan") for k, m in sides.items()}

    # the data, timers and step floors of this checkout's chip_smoke.py
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", here.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    new = scans["new"]
    floors = {}

    def floor_ns(dt, kind):
        base = "cumsum" if kind.endswith("cumsum") else "cumprod"
        key = (dt.name, base)
        if key not in floors:
            floors[key] = smoke.step_floor_ns(torch, new, dt, base)
        return floors[key]

    order = ["old", "new", "new", "old"] if "old" in scans else ["new", "new"]
    for tag, t, kind, axis, dt in cases(np, torch, ml_dtypes, smoke):
        steps = t.shape[axis]
        chains = t.numel() // steps
        reps = LONG_REPS if steps >= 10**6 else 30
        row = {"label": args.label, "case": tag, "card": smi, "chains": chains, "steps": steps}
        runs = {side: (lambda scan=scan: scan.rounded_scan_cuda(t, kind, axis, dt)) for side, scan in scans.items()}
        if dt.name == "float8_e4m3fn" and new.scan_plan(t.shape, axis)[2] == 1:  # rows
            runs["other"] = lambda: other_route(torch, new, t, kind, axis, dt)
        got = {}
        for side, fn in runs.items():
            got[side] = fn()
            row[side] = {"equals_plain": agrees_with_plain(torch, new, got[side], t, kind, axis, dt),
                         "device_spread_ms": [], "call_ms": []}
        if "old" in got:
            row["old_equals_new"] = bool(torch.equal(got["old"].view(torch.uint8), got["new"].view(torch.uint8)))
        del got
        turns = order[:len(order) // 2] + (["other", "other"] if "other" in runs else []) + order[len(order) // 2:]
        for side in turns:
            row[side]["device_spread_ms"].append(smoke.spread(smoke.device_runs(runs[side], reps, warmup=1)))
            row[side]["call_ms"].append(smoke.cuda_ms(runs[side], reps=reps, warmup=1))
        nbytes = 2 * t.numel() * t.element_size()
        step_ns = floor_ns(dt, kind)
        row.update(bytes_bound_ms=nbytes / smoke.HBM_BYTES_PER_S * 1e3, step_ns=step_ns,
                   latency_floor_ms=steps * step_ns * 1e-6)
        row["bound_ms"] = max(row["bytes_bound_ms"], row["latency_floor_ms"])
        for side in runs:  # the median of the turns' medians
            row[side]["device_ms"] = statistics.median(s[2] for s in row[side]["device_spread_ms"])
            row[side]["of_bound"] = row["bound_ms"] / row[side]["device_ms"]
        print(json.dumps(row), flush=True)
        del t
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
