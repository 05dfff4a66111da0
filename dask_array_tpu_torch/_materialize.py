"""The optimize -> execute choke point.

Port of ``dask_array_tpu/_materialize.py``: optimize the expression tree
(simplify -> lower -> fuse) and hand it to the executor.
"""

from __future__ import annotations

import numpy as np

from dask_array_tpu_torch import config
from dask_array_tpu_torch._executor import execute
from dask_array_tpu_torch._expr import ArrayExpr


def optimize_expr(expr: ArrayExpr, fuse: bool = True) -> ArrayExpr:
    """Optimize with a per-expression memo keyed on the config epoch, so
    repeated computes of one collection skip the optimizer walk."""
    opt_flag = config.get("array.optimize-graph", True)
    key = (fuse, bool(opt_flag), config.epoch())
    cached = getattr(expr, "_opt_memo", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    if not opt_flag:
        out = expr.lower_completely()
    else:
        out = expr.optimize(fuse=fuse)
    expr._opt_memo = (key, out)
    return out


def compute_expr(expr: ArrayExpr, optimize: bool = True):
    """Optimize + execute; returns the dense tensor on ``config["device"]``."""
    lowered = optimize_expr(expr) if optimize else expr
    return execute(lowered)


def compute_to_numpy(expr: ArrayExpr) -> np.ndarray:
    out = compute_expr(expr)
    arr = out.detach().cpu().numpy()
    if arr.dtype != expr.dtype:
        raise TypeError(f"computed {arr.dtype} where the metadata says {expr.dtype}")
    return arr
