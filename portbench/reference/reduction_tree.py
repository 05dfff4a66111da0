"""The plain reference of the ``reduction_tree`` configuration: sums,
means, variances and standard deviations of the field along axis 0, axis
1 or all of it, in plain PyTorch, read in blocks of rows so that a float64
copy never holds more than a block.

The variance is numpy's (``ddof=0``), taken in two passes: the mean, then
the mean of squared deviations from it.  It imports nothing of the port
and reads only the field the benchmark made.
"""

from __future__ import annotations

import torch

BLOCK_ELEMENTS = 1 << 28


def _blocks(field: torch.Tensor):
    step = max(1, BLOCK_ELEMENTS // max(1, field.shape[1]))
    for r0 in range(0, field.shape[0], step):
        yield r0, field[r0:r0 + step]


def _sum(field, axis, dtype, shift=None):
    """The sum along ``axis`` of the field (minus ``shift``, squared,
    where a shift is given), accumulated in ``dtype``."""
    parts = []
    acc = None
    for r0, block in _blocks(field):
        b = block.to(dtype)
        if shift is not None:
            s = shift if axis == 0 or axis is None else shift[r0:r0 + block.shape[0], None]
            b = (b - s) ** 2
        if axis == 1:
            parts.append(b.sum(1))
            continue
        part = b.sum(0) if axis == 0 else b.sum()
        acc = part if acc is None else acc + part
    return torch.cat(parts) if axis == 1 else acc


def full(field, cfg: dict, op: dict, dtype: torch.dtype) -> torch.Tensor:
    """The whole output of ``op`` (a ``reduce``), computed in ``dtype``."""
    how, axis = op["how"], op["axis"]
    count = field.numel() if axis is None else field.shape[axis]
    total = _sum(field, axis, dtype)
    if how == "sum":
        return total
    mean = total / count
    if how == "mean":
        return mean
    var = _sum(field, axis, dtype, shift=mean) / count
    if how == "var":
        return var
    if how == "std":
        return torch.sqrt(var)
    raise ValueError(f"the reduction_tree reference has no statistic {how!r}")
