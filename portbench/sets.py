"""Runs of one cell, each in a process of its own as a check makes them,
and the spread of each metric over them.

    python3 portbench/sets.py --workload <cell> --seeds 1,2,3 [--seconds 10] [--trace 0] [--out FILE]

Runs ``run.py`` once a seed, one after another, writes every run's
result line (and the end of its standard error) to ``--out`` as JSON
lines, and prints for each metric the median and the spread: the distance
between the first and third quartiles over the median
(``yardstick.spread``).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(CHECKOUT / "portbench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CHECKOUT)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0, "result": result, "stderr": proc.stderr[-3000:]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from portbench.yardstick import spread

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = one_run(args.workload, seed, args.seconds, args.trace)
        runs.append(run)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(run) + "\n")
        res = run["result"] or {}
        print(json.dumps({"seed": seed, "rc": run["rc"], "wall_s": round(run["wall_s"], 2),
                          "correct": res.get("correct"), "attempted": res.get("attempted"),
                          "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "checks": res.get("checks")}), flush=True)
        if run["rc"] != 0 or not res.get("correct"):
            print(run["stderr"][-1500:], flush=True)
    values = {}
    for run in runs:
        for k, v in ((run["result"] or {}).get("metrics") or {}).items():
            values.setdefault(k, []).append(v["value"])
    summary = {k: {"median": statistics.median(vs), "spread": spread(vs) if len(vs) >= 2 else None, "values": vs}
               for k, vs in values.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
