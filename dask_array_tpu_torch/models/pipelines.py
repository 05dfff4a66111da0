"""Workload pipelines of the ported slice.

Port of ``dask_array_tpu/models/pipelines.py``: the README example (slice
pushdown + fusion) and the 2-D ``map_overlap`` Laplace stencil (BASELINE
config 4).  Inputs are numpy arrays made by the caller from a seed, since
the reference's ``da.random`` streams cannot be reproduced in torch.
"""

from __future__ import annotations

import numpy as np
import torch


def readme_example(n=1000, chunk=100):
    """(x + x.T)[:chunk, :chunk] on ones — the slice-pushdown showcase."""
    import dask_array_tpu_torch as da

    x = da.ones((n, n), chunks=(chunk, chunk))
    return (x + x.T)[:chunk, :chunk]


def laplace_roll(b):
    """The depth-1 Laplace as shifted windows of the padded block (the form
    the band-stencil kernel takes)."""
    return (
        torch.roll(b, 1, 0) + torch.roll(b, -1, 0)
        + torch.roll(b, 1, 1) + torch.roll(b, -1, 1)
        - 4 * b
    )


def laplace_slices(p):
    """The depth-1 Laplace of a block with a 1-cell ghost ring: five
    shifted windows of ``p``, already the trimmed output shape."""
    return (
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        - 4 * p[1:-1, 1:-1]
    )


def stencil2d(x_np, chunk=1024, form="auto"):
    """depth-1 map_overlap Laplace stencil (BASELINE config 4) of ``x_np``.

    ``form="auto"`` picks the ROLL form when the band-stencil kernel will
    engage (config ``stencil-kernel`` is not "off"), otherwise the
    shifted-slices form (``trim=False``).  ``form="slices"`` /
    ``form="roll"`` force a formulation.
    """
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    if form == "auto":
        form = "slices" if config.get("stencil-kernel", "auto") in ("off", False, None) else "roll"
    x = da.from_array(np.asarray(x_np), chunks=chunk)
    dtype = x.dtype
    if form == "roll":
        return da.map_overlap(laplace_roll, x, depth=1, boundary="reflect", dtype=dtype)
    if form != "slices":
        raise ValueError(f"unknown stencil2d form {form!r}")
    return da.map_overlap(
        laplace_slices, x, depth=1, boundary="reflect", trim=False, dtype=dtype,
        chunks=x.chunks,
    )
