"""Read the out-of-core lane's "auto" budget around in-core and streamed
computes on one CUDA card.

    python3 scripts/probe_auto_budget.py

Runs ``chip_smoke.py`` phase 30's cases (a) and (b) (stencil2d's roll form
and ``tanh(laplace)`` of a host 32768^2 float32, chunks 4096) in core and
streamed under 3 GiB, and prints after each compute, after dropping its
result and collecting garbage, and after a synchronize and one small
allocation: the card's free memory, the caching allocator's reserved,
allocated, active and inactive-split bytes, free + reserved - allocated,
and ``_streaming._budget()`` (all GiB).  A tensor that a compute leaves in
a reference cycle shows as allocated bytes that fall at the collection.
Needs about 16 GiB of host memory.  Exits 1 without a card.
"""

import gc
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dask_array_tpu_torch as da  # noqa: E402
from dask_array_tpu_torch import _streaming, config  # noqa: E402
from dask_array_tpu_torch.models.pipelines import laplace_roll  # noqa: E402


def report(dev, tag):
    free, _total = torch.cuda.mem_get_info(dev)
    r = torch.cuda.memory_reserved(dev)
    a = torch.cuda.memory_allocated(dev)
    st = torch.cuda.memory_stats(dev)
    print(f"{tag:28s} free {free/2**30:8.3f} reserved {r/2**30:8.3f} allocated {a/2**30:8.3f} "
          f"active {st.get('active_bytes.all.current', 0)/2**30:8.3f} "
          f"inactive_split {st.get('inactive_split_bytes.all.current', 0)/2**30:8.3f} "
          f"sum {(free + r - a)/2**30:8.3f} budget {_streaming._budget()/2**30:8.3f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    report(dev, "start")
    n = 32768
    x = np.empty((n, n), np.float32)
    np.add(np.arange(n, dtype=np.float32)[:, None] * np.float32(1e-6),
           np.random.default_rng(0).random(n, dtype=np.float32)[None, :], out=x)
    xa = da.from_array(x, chunks=4096)
    for name, fn in (("a", laplace_roll), ("b", lambda b: torch.tanh(laplace_roll(b)))):
        s = da.map_overlap(fn, xa, depth=1, boundary="reflect", dtype="float32")
        for mode, cfg in (("in-core", {"out-of-core": "off"}),
                          ("streamed", {"out-of-core": "auto", "memory-budget": "3 GiB"})):
            with config.set(cfg):
                r = s.compute()
            report(dev, f"{name} {mode}")
            del r
            gc.collect()
            report(dev, f"{name} {mode} del+gc")
        torch.cuda.synchronize()
        t = torch.empty(1 << 20, device=dev)
        del t
        report(dev, f"{name} sync+malloc")
    torch.cuda.empty_cache()
    report(dev, "empty_cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
