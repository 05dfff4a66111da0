"""Time the host copies of one checkout on one CUDA card.

    python3 scripts/time_host_copies.py [--root DIR] [--label NAME] [--reps N]

Imports ``dask_array_tpu_torch`` from ``DIR`` (default: the checkout
holding this script) and prints one JSON line per measurement:

* the four numpy-input BASELINE pipelines of ``chip_smoke.py`` phase 28
  (c): ``reduction_tree`` 10000^2 (chunks 1000, the three statistics
  through ``compute(...)``), ``stencil2d``'s roll form 4096^2 (chunks
  1024), ``tall_skinny_svd`` 1e6 x 128 (row chunks 100 000; u, s, vh
  together) and ``rechunk_relayout`` 8192^2 (chunks 1024), all float32
  from a numpy seed: ``compute()`` (numpy in, numpy out) and
  ``compute_device()`` (numpy in, the result left on the card), and beside
  them the same pipeline drawn on the card by ``da.random``, whose
  ``compute_device()`` is the device work alone;
* a 1 GiB float32 copy each way: up through the checkout's executor
  (``_executor.to_device``) beside a pageable ``torch.from_numpy(x).to()``;
  down through the checkout's ``_materialize.to_numpy`` beside a pageable
  ``t.cpu().numpy()`` and beside a fresh numpy array registered with
  ``cudaHostRegister`` for one copy (registered, copied, unregistered).

Host clocks, each value the median of ``--reps`` runs after one warm-up,
every run ending in a synchronize.  Two checkouts are compared by running
this script for each, one after another on one card, in the order old,
new, new, old.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import types


def host_times(fn, sync, reps):
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_host_copies: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import numpy as np

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch._executor import to_device
    from dask_array_tpu_torch._materialize import compute_exprs, to_numpy
    from dask_array_tpu_torch.models import pipelines as P

    da.config.set_global({"device": "cuda"})
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sync = torch.cuda.synchronize
    reps = args.reps
    rng = np.random.default_rng(0)

    def emit(name, **numbers):
        print(json.dumps({"label": args.label, "root": args.root, "card": smi, "name": name, **numbers}), flush=True)

    def pipeline(name, numpy_arrays, random_arrays):
        exprs = [a.expr for a in numpy_arrays]
        rexprs = [a.expr for a in random_arrays]
        c_ms, c_runs = host_times(lambda: da.compute(*numpy_arrays), sync, reps)
        d_ms, d_runs = host_times(lambda: compute_exprs(exprs), sync, reps)
        r_ms, r_runs = host_times(lambda: compute_exprs(rexprs), sync, reps)
        emit(name, compute_ms=c_ms, compute_device_ms=d_ms, random_compute_device_ms=r_ms,
             compute_runs=c_runs, compute_device_runs=d_runs, random_compute_device_runs=r_runs)

    x = rng.standard_normal((10000, 10000), dtype=np.float32)
    pipeline("reduction_tree-10000", P.reduction_tree(chunk=1000, x_np=x), P.reduction_tree(chunk=1000, n=10000))
    x = rng.standard_normal((4096, 4096), dtype=np.float32)
    pipeline("stencil2d-roll-4096", [P.stencil2d(chunk=1024, form="roll", x_np=x)],
             [P.stencil2d(chunk=1024, form="roll", n=4096)])
    x = rng.standard_normal((1_000_000, 128), dtype=np.float32)
    pipeline("tall_skinny_svd-1e6x128", P.tall_skinny_svd(chunk_rows=100_000, x_np=x),
             P.tall_skinny_svd(chunk_rows=100_000, rows=1_000_000, cols=128))
    x = rng.standard_normal((8192, 8192), dtype=np.float32)
    pipeline("rechunk_relayout-8192", [P.rechunk_relayout(chunk=1024, x_np=x)], [P.rechunk_relayout(chunk=1024, n=8192)])
    del x

    device = torch.device("cuda")
    n = 1 << 28  # 1 GiB of float32
    host = rng.standard_normal(n, dtype=np.float32)
    up_ms, up_runs = host_times(lambda: to_device(host, device), sync, reps)
    page_up_ms, page_up_runs = host_times(lambda: torch.from_numpy(host).to(device), sync, reps)
    emit("h2d-1GiB", executor_ms=up_ms, pageable_ms=page_up_ms, executor_runs=up_runs, pageable_runs=page_up_runs,
         executor_GBps=host.nbytes / up_ms / 1e6, pageable_GBps=host.nbytes / page_up_ms / 1e6,
         equal_bytes=bool(torch.equal(to_device(host, device), torch.from_numpy(host).to(device))))
    t = torch.from_numpy(host).to(device)
    meta = types.SimpleNamespace(dtype=np.dtype(np.float32))
    down_ms, down_runs = host_times(lambda: to_numpy(t, meta), sync, reps)
    page_ms, page_runs = host_times(lambda: t.cpu().numpy(), sync, reps)
    cudart = torch.cuda.cudart()

    def registered():
        out = np.empty(n, np.float32)
        ptr = out.ctypes.data
        err = cudart.cudaHostRegister(ptr, out.nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister failed: {err}")
        torch.from_numpy(out).copy_(t)
        cudart.cudaHostUnregister(ptr)
        return out

    reg_ms, reg_runs = host_times(registered, sync, reps)
    same = to_numpy(t, meta).tobytes() == host.tobytes() and registered().tobytes() == host.tobytes()
    emit("d2h-1GiB", to_numpy_ms=down_ms, pageable_ms=page_ms, host_register_ms=reg_ms, to_numpy_runs=down_runs,
         pageable_runs=page_runs, host_register_runs=reg_runs, to_numpy_GBps=host.nbytes / down_ms / 1e6,
         pageable_GBps=host.nbytes / page_ms / 1e6, host_register_GBps=host.nbytes / reg_ms / 1e6, equal_bytes=same)
    return 0


if __name__ == "__main__":
    sys.exit(main())
