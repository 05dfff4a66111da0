"""The optimize -> execute choke point.

Port of ``dask_array_tpu/_materialize.py``: optimize the expression tree
(simplify -> lower -> fuse) and hand it to the executor.  Before the
optimizer, the reductions that the multi-statistic kernel computes in one
read are routed to it (``ops/_multistat.py``), across every array
computed together.
"""

from __future__ import annotations

import numpy as np

from dask_array_tpu_torch import config
from dask_array_tpu_torch._executor import execute, execute_many
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
        from dask_array_tpu_torch.ops._multistat import fuse_multi_stat

        out = fuse_multi_stat([expr])[0].optimize(fuse=fuse)
    expr._opt_memo = (key, out)
    return out


def compute_expr(expr: ArrayExpr, optimize: bool = True):
    """Optimize + execute; returns the dense tensor on ``config["device"]``."""
    lowered = optimize_expr(expr) if optimize else expr
    return execute(lowered)


def compute_exprs(exprs) -> list:
    """Optimize several expressions together and execute them in one walk;
    returns their dense tensors on ``config["device"]``."""
    if config.get("array.optimize-graph", True):
        from dask_array_tpu_torch.ops._multistat import fuse_multi_stat

        exprs = fuse_multi_stat(exprs)
    return execute_many([optimize_expr(e) for e in exprs])


def to_numpy(out, expr: ArrayExpr) -> np.ndarray:
    arr = out.detach().cpu().numpy()
    if arr.dtype != expr.dtype:
        raise TypeError(f"computed {arr.dtype} where the metadata says {expr.dtype}")
    return arr


def compute_to_numpy(expr: ArrayExpr) -> np.ndarray:
    return to_numpy(compute_expr(expr), expr)
