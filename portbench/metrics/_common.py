"""What the per-layer readers share: the bytes a kernel must move, counted
from the shapes (each input byte read once, each output byte written
once)."""

from __future__ import annotations

import statistics

import numpy as np


def itemsize(r) -> int:
    return np.dtype(r.cfg["dtype"]).itemsize


def field_bytes(r) -> int:
    return int(np.prod(r.cfg["shape"])) * itemsize(r)


def stencil_ops(r) -> int:
    return sum(1 for op in r.traffic.ops if op["op"] == "map_overlap")


def median_ms(r, span: str):
    per_request = r.spans.get(span)
    if not per_request:
        return None
    return statistics.median(per_request) * 1e3
