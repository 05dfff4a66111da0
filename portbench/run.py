"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (importing the port, loading or, the
first time in a checkout, building its kernels, making the field on the
card from the seed and holding it there, warm requests) is timed as
``setup_s``; then one client sends the cell's requests back to back for
``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  The answers
are then compared with the plain reference (``check.py``): each number
compared goes beside its limit as the last lines on standard error and as
the result's last key.  The last line on standard output is the result.

Exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), when modules of JAX or the JAX package are
loaded once the window has closed, or when the port cannot be imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / "build" / "portbench"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout; the
    # bytecode of the modules it imports too, whatever the environment says
    # of writing it: with none, every run compiles torch's sources anew
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from portbench import core

    cell = core.Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        core.log(f"no result: the cell needs {chips} CUDA card(s), torch finds {found}")
        return 2
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except core.ForbiddenImport as exc:
        core.log(f"no result: {exc}")
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
