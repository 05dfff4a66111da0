"""The plain reference of the ``stencil2d`` configurations: the depth-1
Laplace of the field with dask's "reflect" boundary, in plain PyTorch.

dask's "reflect" mirrors the edge with the edge element repeated (numpy's
``pad(mode="symmetric")``): the row above row 0 is row 0, the column right
of the last column is the last column.  ``laplace_roll`` and
``laplace_slices`` are two ways of writing the same stencil, so both take
this one function.  It imports nothing of the port and reads only the
field the benchmark made.
"""

from __future__ import annotations

import torch


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """Indices one step outside [0, n) mirrored onto the edge element."""
    return torch.where(i < 0, -1 - i, torch.where(i >= n, 2 * n - 1 - i, i))


def laplace_rows(field: torch.Tensor, rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``rows`` (a 1-D index tensor) of the Laplace of ``field``,
    computed in ``dtype``."""
    n0, n1 = field.shape
    rows = rows.to(field.device)
    up = field.index_select(0, _reflect(rows - 1, n0)).to(dtype)
    mid = field.index_select(0, rows).to(dtype)
    down = field.index_select(0, _reflect(rows + 1, n0)).to(dtype)
    cols = torch.arange(n1, device=field.device)
    left = mid.index_select(1, _reflect(cols - 1, n1))
    right = mid.index_select(1, _reflect(cols + 1, n1))
    return up + down + left + right - 4 * mid


STENCILS = {"laplace_roll": laplace_rows, "laplace_slices": laplace_rows}


def check_config(cfg: dict) -> None:
    if cfg["depth"] != 1 or cfg["boundary"] != "reflect":
        raise ValueError("this reference computes depth 1 with the reflect boundary only")


def rows(field, cfg: dict, op: dict, index: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``index`` of the output of ``op`` (a ``map_overlap``)."""
    check_config(cfg)
    return STENCILS[op["func"]](field, index, dtype)
