"""Hold each side of the card-against-CPU stencil check to numpy, many times.

    python3 scripts/check_stencil_sides.py [--reps N] [--core-reps N]

``tests/test_torch_gpu.py::test_program_kernel_through_map_overlap``
compares ``map_overlap(func)`` computed on the card with the same call
computed by the port on the CPU.  This script repeats that comparison and
holds every side on its own against numpy: the float32 steps of the
depth-1 Laplace in torch's order with numpy's ``symmetric`` pad (dask's
"reflect"), and ``tanh`` taken in float64 and rounded once to float32.
The sides, ``--reps`` times each on a 512 x 384 float32 normal in chunks of
128 (the test's input):

- ``cpu``: the port's ``compute()`` under device "cpu" (``tanh_laplace``);
- ``card_program``: ``compute()`` on the card from a numpy input (the
  pinned rings up and down; the program kernel), ``tanh_laplace``;
- ``card_linear``: the same for ``laplace_roll`` (the linear K1);
- ``card_persisted``: ``compute_device()`` of ``tanh_laplace`` on a
  persisted input (no host copy on the way);
- ``cpu_core<k>``: before anything touches the card, ``torch.tanh`` of the
  Laplace on the CPU in one process pinned to core k, one thread,
  ``--core-reps`` times per core.

A run is off when an element differs from the reference by more than
1e-6 + 1e-6 |reference| (the test's tolerance).  One JSON line per side:
runs, runs off, the worst error, the share of elements off and the first
and last row off in the first run off.  Exits 1 without a card, 2 when a
run was off.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE, CHUNK, SEED = (512, 384), 128, 35


def _input():
    import numpy as np

    return np.random.default_rng(SEED).standard_normal(SHAPE).astype(np.float32)


def _laplace32(x):
    """The float32 Laplace of ``x`` in torch's order (laplace_roll)."""
    import numpy as np

    p = np.pad(x, 1, mode="symmetric")
    r = lambda dy, dx: np.roll(p, (dy, dx), (0, 1))  # noqa: E731
    lap = r(1, 0) + r(-1, 0) + r(0, 1) + r(0, -1) - np.float32(4) * p
    return lap[1:-1, 1:-1], p


def _reference():
    import numpy as np

    lap, _ = _laplace32(_input())
    return np.tanh(lap.astype(np.float64)).astype(np.float32), lap


class _Tally:
    def __init__(self, side):
        self.side, self.runs, self.off, self.worst, self.first = side, 0, 0, 0.0, None

    def add(self, got, want):
        import numpy as np

        got = np.asarray(got, dtype=np.float32)
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        bad = err > 1e-6 + 1e-6 * np.abs(want)
        self.runs += 1
        self.worst = max(self.worst, float(err.max()))
        if bad.any():
            self.off += 1
            if self.first is None:
                rows = np.nonzero(bad.any(axis=1))[0]
                self.first = {"share_off": float(bad.mean()), "max_abs": float(err.max()),
                              "rows": [int(rows[0]), int(rows[-1])]}

    def line(self, **extra):
        return {"side": self.side, "runs": self.runs, "runs_off": self.off, "worst_abs": self.worst,
                "first_off": self.first, **extra}


def _core_run(args):
    """torch.tanh of the Laplace on one core, one thread, ``reps`` times."""
    core, reps = args
    os.sched_setaffinity(0, {core})
    import torch

    torch.set_num_threads(1)
    want, _ = _reference()
    _, p = _laplace32(_input())
    t = torch.from_numpy(p)
    lapt = (torch.roll(t, 1, 0) + torch.roll(t, -1, 0) + torch.roll(t, 1, 1) + torch.roll(t, -1, 1) - 4 * t)
    tally = _Tally(f"cpu_core{core}")
    for _ in range(reps):
        tally.add(torch.tanh(lapt).numpy()[1:-1, 1:-1], want)
    return tally.line()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--core-reps", type=int, default=300)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    out = []
    cores = sorted(os.sched_getaffinity(0))
    with multiprocessing.get_context("spawn").Pool(len(cores)) as pool:
        out += pool.map(_core_run, [(c, args.core_reps) for c in cores])

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.models.pipelines import laplace_roll, tanh_laplace

    x = _input()
    want, lap = _reference()
    sides = {k: _Tally(k) for k in ("cpu", "card_program", "card_linear", "card_persisted")}
    with config.set({"device": "cuda"}):
        held = da.from_array(x, chunks=CHUNK).persist()
    for _ in range(args.reps):
        with config.set({"device": "cpu"}):
            sides["cpu"].add(da.map_overlap(tanh_laplace, da.from_array(x, chunks=CHUNK), depth=1,
                                            boundary="reflect").compute(), want)
        with config.set({"device": "cuda"}):
            sides["card_program"].add(da.map_overlap(tanh_laplace, da.from_array(x, chunks=CHUNK), depth=1,
                                                     boundary="reflect").compute(), want)
            sides["card_linear"].add(da.map_overlap(laplace_roll, da.from_array(x, chunks=CHUNK), depth=1,
                                                    boundary="reflect").compute(), lap)
            dev = da.map_overlap(tanh_laplace, held, depth=1, boundary="reflect").compute_device()
            sides["card_persisted"].add(dev.cpu().numpy(), want)
    out += [t.line() for t in sides.values()]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    for line in out:
        print(json.dumps({**line, "card": card}), flush=True)
    return 0 if all(line["runs_off"] == 0 for line in out) else 2


if __name__ == "__main__":
    sys.exit(main())
