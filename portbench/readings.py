"""The two readings each limit of ``limits/<cell>.json`` is set from, on
the card, at the cell's own size, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--control-seeds 1,2,3] \
        [--fault-seeds 1,2,3]

For each of ``--seeds``, one run of the cell (set-up, a short window at
the cell's own load, the comparison) gives the program's numbers; the
largest over the seeds is the lower reading.  For each of
``--control-seeds``, the control takes the program's place: the plain
reference computed in bfloat16, the precision below the configuration's
float32, compared with the float64 reference as the program's answers
are; the smallest over the seeds is the upper reading.  For each of
``--fault-seeds``, a fault takes the program's place: each statistic
taken over half of the field, the mean over the rest (the first half of
the rows; of the columns for a statistic along axis 1), computed in the
configuration's float32 and judged the same way.  The benchmark's own
runs never run the control or the fault.  Prints one JSON line a run and
a summary line last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device: str = "cuda", cfg_override=None, precision=None) -> dict:
    """The control's numbers for ``seed``: every op of one request answered
    by the reference in ``precision`` (bfloat16 by default), judged as the
    program's last request is."""
    import torch

    from portbench import check, core
    from portbench.traffic import Traffic

    precision = torch.bfloat16 if precision is None else precision
    cfg = dict(cell.cfg, **(cfg_override or {}))
    traffic = Traffic(cell.mix, cfg)
    field = core.make_field(cfg, seed, device)
    outs = []
    for op in traffic.ops:
        if check.is_field_sized(op):
            rows = [cell.reference.rows(field, cfg, op, torch.arange(r0, min(r0 + 2048, cfg["shape"][0])), precision)
                    for r0 in range(0, cfg["shape"][0], 2048)]
            outs.append(torch.cat(rows))
        else:
            outs.append(cell.reference.full(field, cfg, op, precision))
    plan = check.Plan(seed, cfg["shape"], cfg["chunks"])
    kept = check.keep(plan, 0, True, traffic.ops, outs)
    del outs
    return check.gaps(kept, field, cfg, cell.reference)


def half_field_numbers(cell, seed: int, device: str = "cuda", cfg_override=None) -> dict:
    """The numbers of the half-field fault for ``seed``: every reduction
    of one request answered over half of the field in float32, judged as
    the program's last request is."""
    import torch

    from portbench import check, core
    from portbench.traffic import Traffic

    cfg = dict(cell.cfg, **(cfg_override or {}))
    traffic = Traffic(cell.mix, cfg)
    field = core.make_field(cfg, seed, device)
    outs = []
    for op in traffic.ops:
        if op["op"] != "reduce":
            raise ValueError(f"the half-field fault takes reductions, not {op['op']!r}")
        half = field[:, : field.shape[1] // 2] if op["axis"] == 1 else field[: field.shape[0] // 2]
        outs.append(cell.reference.full(half, cfg, op, torch.float32))
    plan = check.Plan(seed, cfg["shape"], cfg["chunks"])
    kept = check.keep(plan, 0, True, traffic.ops, outs)
    del outs
    return check.gaps(kept, field, cfg, cell.reference)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from portbench import core

    if not torch.cuda.is_available():
        core.log("no card")
        return 2
    cell = core.Cell(args.workload)
    program, control = {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        result = core.run_cell(args.workload, seed, args.seconds, False)
        numbers = {k: v["value"] for k, v in result["checks"].items() if k != "failed_requests"}
        for k, v in numbers.items():
            program[k] = max(program.get(k, 0.0), float("inf") if v is None else v)
        print(json.dumps({"side": "program", "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"], "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        numbers = control_numbers(cell, seed)
        for k, v in numbers.items():
            control[k] = min(control.get(k, float("inf")), v)
        print(json.dumps({"side": "control", "seed": seed, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    fault = {}
    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        numbers = half_field_numbers(cell, seed)
        for k, v in numbers.items():
            fault[k] = min(fault.get(k, float("inf")), v)
        print(json.dumps({"side": "half_field", "seed": seed, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": program, "upper": control, "half_field": fault,
                      "kind": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
