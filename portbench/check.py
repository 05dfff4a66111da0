"""The comparison that decides ``correct``.

A run keeps, of the answers its timed requests returned, those of a few
requests drawn from the seed and all of the last one.  Of an answer the
size of the field (a stencil's) a sampled request keeps rows drawn from
the seed, with the field's first and last rows and the rows on each side
of every seam between blocks; the last request keeps the whole.  Of a
small answer (a statistic) every kept request keeps the whole.

Once the window has closed and the program's state is freed, the plain
reference (``reference/<config>.py``) computes the same outputs in float64
from the field, which the benchmark makes again from the seed, and each
output's gap is the largest absolute difference over the largest absolute
value of the reference: ``max |got - ref| / max |ref|``, over every kept
answer.  A run is correct when every request returned, none raised, and
each gap is at most the cell's limit (``limits/<cell>.json``).
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

SAMPLED_REQUESTS = 4
SAMPLE_SPAN = 32  # sampled requests are drawn among the window's first ones
SAMPLED_ROWS = 32


class Plan:
    """Which requests and which rows a run keeps, drawn from its seed."""

    def __init__(self, seed: int, shape, chunks):
        rng = random.Random(seed)
        self.requests = set(rng.sample(range(SAMPLE_SPAN), SAMPLED_REQUESTS))
        n0 = shape[0]
        fixed = {0, n0 - 1}
        for seam in range(chunks[0], n0, chunks[0]):
            fixed.update((seam - 1, seam))
        drawn = rng.sample(range(n0), min(SAMPLED_ROWS, n0))
        self.rows = torch.tensor(sorted(fixed.union(drawn)), dtype=torch.long)


def is_field_sized(op: dict) -> bool:
    return op["op"] == "map_overlap"


def keep(plan: Plan, i: int, last: bool, ops, outs) -> list:
    """What request ``i`` leaves for the comparison: ``(op, rows, value)``
    entries, ``rows`` None for a whole answer."""
    if not last and i not in plan.requests:
        return []
    kept = []
    for op, out in zip(ops, outs):
        if is_field_sized(op) and not last:
            idx = plan.rows.to(out.device) if isinstance(out, torch.Tensor) else plan.rows.numpy()
            kept.append((op, plan.rows, out[idx].clone() if isinstance(out, torch.Tensor) else np.array(out[idx])))
        elif isinstance(out, torch.Tensor):
            kept.append((op, None, out))
        else:
            kept.append((op, None, np.array(out)))
    return kept


def _as_tensor(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.array(value, copy=True)).to(device)


def _gap_block(got, ref) -> float:
    """max |got - ref| over one block; inf where the shapes differ or the
    answer holds a NaN that the reference does not."""
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    diff = (got.to(ref.dtype) - ref).abs()
    if diff.numel() == 0:
        return 0.0
    worst = diff.max().item()
    return math.inf if math.isnan(worst) else worst


def gaps(kept, field: torch.Tensor, cfg: dict, reference, dtype=torch.float64,
         block_rows: int = 2048) -> dict:
    """``{"<name>_gap": max |got - ref| / max |ref|}`` over every kept
    answer, the reference computed in ``dtype`` in blocks of rows.  Each op
    is scaled by its own reference; ops that share a name give the largest
    of their gaps."""
    worst: dict = {}
    scale: dict = {}
    whole: dict = {}
    names: dict = {}
    for op, rows, value in kept:
        name = id(op)
        names[name] = op["name"]
        got = _as_tensor(value, field.device)
        if is_field_sized(op):
            if rows is None:
                if tuple(got.shape) != tuple(field.shape):
                    worst[name] = math.inf
                    continue
                for r0 in range(0, field.shape[0], block_rows):
                    index = torch.arange(r0, min(r0 + block_rows, field.shape[0]))
                    ref = reference.rows(field, cfg, op, index, dtype)
                    worst[name] = max(worst.get(name, 0.0), _gap_block(got[r0:r0 + len(index)], ref))
                    scale[name] = max(scale.get(name, 0.0), ref.abs().max().item())
            else:
                ref = reference.rows(field, cfg, op, rows, dtype)
                worst[name] = max(worst.get(name, 0.0), _gap_block(got, ref))
                scale[name] = max(scale.get(name, 0.0), ref.abs().max().item())
        else:
            if name not in whole:
                whole[name] = reference.full(field, cfg, op, dtype)
            ref = whole[name]
            worst[name] = max(worst.get(name, 0.0), _gap_block(got, ref))
            scale[name] = max(scale.get(name, 0.0), ref.abs().max().item())
    out = {}
    for name, w in worst.items():
        s = scale.get(name, 0.0)
        gap = math.inf if math.isinf(w) else (w / s if s > 0 else w)
        key = f"{names[name]}_gap"
        out[key] = max(out.get(key, 0.0), gap)
    return out


def verdict(found: dict, limits: dict, expected: list, failed: int) -> tuple:
    """(correct, [(name, value, limit)]): every expected number present and
    within its limit, and no request failed."""
    lines = []
    ok = failed == 0
    for name in expected:
        value = found.get(name, math.inf)
        limit = limits[name]
        lines.append((name, value, limit))
        ok = ok and value <= limit
    return ok, lines
