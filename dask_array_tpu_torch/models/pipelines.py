"""Workload pipelines of the ported slice.

Port of ``dask_array_tpu/models/pipelines.py``: the README example (slice
pushdown + fusion), the flagship ``normalize_contract`` step, the
``split_every`` tree reductions (BASELINE config 2), the blocked matmul
with misaligned chunks (BASELINE config 3), the 2-D ``map_overlap``
Laplace stencil (BASELINE config 4) and four non-linear funcs of that
stencil's sizes (``tanh_laplace``, ``sobel_magnitude``, ``max_filter3``,
``limited_diffusion``), the tall-skinny SVD (BASELINE config 5) and the
rows-to-columns relayout of a transposed array (BASELINE metric 2).

Each function takes the JAX package's positional parameters, with their
names and defaults, in its order.  ``reduction_tree``, ``stencil2d``,
``tall_skinny_svd`` and ``rechunk_relayout`` take their input in two
forms.  Given no numpy array, they build it as the JAX package does, on the
device with ``da.random.default_rng(seed).standard_normal(...)`` and the
same sizes, chunks and seeds (the values are torch's stream, not JAX's).
Given a numpy array in the keyword-only ``x_np``, they read it through
``from_array``, so a test can feed both packages the same values.
``blocked_matmul`` draws its operands with numpy from ``seed`` exactly as
the JAX package does, or takes them as ``a_np`` and ``b_np``.
"""

from __future__ import annotations

import numpy as np
import torch


def readme_example(n=1000, chunk=100):
    """(x + x.T)[:chunk, :chunk] on ones — the slice-pushdown showcase."""
    import dask_array_tpu_torch as da

    x = da.ones((n, n), chunks=(chunk, chunk))
    return (x + x.T)[:chunk, :chunk]


def normalize_contract(a, b):
    """Feature-normalize then contract: the flagship forward step."""
    centered = a - a.mean(axis=0)
    scaled = centered / (a.std(axis=0) + 1e-6)
    y = scaled @ b.T
    return (y * y).sum(axis=1)


def _input(x_np, shape, dtype, chunks, seed):
    """``x_np`` through ``from_array``, or, without one, the JAX package's
    input: a standard normal of ``shape`` drawn on the device."""
    import dask_array_tpu_torch as da

    if x_np is None:
        return da.random.default_rng(seed).standard_normal(shape, dtype=dtype, chunks=chunks)
    return da.from_array(np.asarray(x_np), chunks=chunks)


def reduction_tree(n=10000, chunk=1000, split_every=4, *, x_np=None):
    """sum/mean/std cascade with explicit split_every (BASELINE config 2):
    ``x.sum(axis=0)``, ``x.mean(axis=1)`` and ``x.std()`` of ``x_np``, or
    of an (n, n) float32 standard normal drawn with seed 0.

    Computed together (``dask_array_tpu_torch.compute(*reduction_tree())``)
    the three go through the multi-statistic kernel in one read."""
    x = _input(x_np, (n, n), "float32", chunk, 0)
    s = x.sum(axis=0, split_every=split_every)
    m = x.mean(axis=1, split_every=split_every)
    sd = x.std(split_every=split_every)
    return s, m, sd


def blocked_matmul(n=8192, chunk=1024, dtype="bfloat16", seed=0, *, a_np=None, b_np=None):
    """``a @ b`` with misaligned operand chunks (BASELINE config 3): ``b``
    is chunked at ``chunk // 2``, which exercises chunk unification.

    The (n, n) operands are drawn as the JAX package draws them, standard
    normals from ``np.random.default_rng(seed)`` cast to ``dtype`` (bfloat16
    is ml_dtypes' type), or given as ``a_np`` and ``b_np``.  A bfloat16
    product stays bfloat16, each block product accumulated in float32 by
    cuBLAS."""
    import dask_array_tpu_torch as da

    if (a_np is None) != (b_np is None):
        raise ValueError("blocked_matmul takes both a_np and b_np, or neither")
    if a_np is None:
        if dtype == "bfloat16":
            import ml_dtypes

            dt = ml_dtypes.bfloat16
        else:
            dt = np.dtype(dtype)
        rng = np.random.default_rng(seed)
        a_np = rng.standard_normal((n, n)).astype(dt)
        b_np = rng.standard_normal((n, n)).astype(dt)
    a = da.from_array(np.asarray(a_np), chunks=chunk)
    b = da.from_array(np.asarray(b_np), chunks=chunk // 2)
    return a @ b


def laplace_roll(b):
    """The depth-1 Laplace as shifted windows of the padded block (the form
    the band-stencil kernel takes)."""
    return (
        torch.roll(b, 1, 0) + torch.roll(b, -1, 0)
        + torch.roll(b, 1, 1) + torch.roll(b, -1, 1)
        - 4 * b
    )


def tanh_laplace(b):
    """tanh of the depth-1 Laplace: a program the band-stencil kernel
    takes (``kernels.stencil.capture_program``)."""
    return torch.tanh(laplace_roll(b))


def sobel_magnitude(b):
    """The 3x3 Sobel gradient magnitude, ``sqrt(gx*gx + gy*gy)``."""
    up, down = torch.roll(b, 1, 0), torch.roll(b, -1, 0)
    gx = (torch.roll(up, -1, 1) + 2 * torch.roll(b, -1, 1) + torch.roll(down, -1, 1)
          - torch.roll(up, 1, 1) - 2 * torch.roll(b, 1, 1) - torch.roll(down, 1, 1))
    gy = (torch.roll(down, 1, 1) + 2 * down + torch.roll(down, -1, 1)
          - torch.roll(up, 1, 1) - 2 * up - torch.roll(up, -1, 1))
    return torch.sqrt(gx * gx + gy * gy)


def max_filter3(b):
    """The 3x3 max filter (a morphological dilation): ``torch.maximum`` of
    the nine shifted windows."""
    out = b
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.maximum(out, torch.roll(b, (dy, dx), (0, 1)))
    return out


def limited_diffusion(b, rate=0.2, limit=0.05):
    """One explicit diffusion step whose change is cut to ``limit`` where
    it is larger: ``where(|d| > limit, sign(d) * limit, d)`` with ``d =
    rate * laplace(b)``.  ``rate`` and ``limit`` are the scalar keywords a
    ``map_overlap`` call passes."""
    d = rate * laplace_roll(b)
    return b + torch.where(torch.abs(d) > limit, torch.sign(d) * limit, d)


def laplace_slices(p):
    """The depth-1 Laplace of a block with a 1-cell ghost ring: five
    shifted windows of ``p``, already the trimmed output shape."""
    return (
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        - 4 * p[1:-1, 1:-1]
    )


def stencil2d(n=4096, chunk=1024, dtype="float32", seed=0, form="auto", persist=False, *, x_np=None):
    """depth-1 map_overlap Laplace stencil (BASELINE config 4) of ``x_np``,
    or of an (n, n) standard normal drawn with ``seed``.

    ``form="auto"`` picks the ROLL form when the band-stencil kernel will
    engage (config ``stencil-kernel`` is not "off"), otherwise the
    shifted-slices form (``trim=False``).  ``form="slices"`` /
    ``form="roll"`` force a formulation.  ``persist=True`` holds the input
    on the device first.
    """
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    if form == "auto":
        form = "slices" if config.get("stencil-kernel", "auto") in ("off", False, None) else "roll"
    x = _input(x_np, (n, n), dtype, chunk, seed)
    if persist:
        x = x.persist()
    dtype = x.dtype
    if form == "roll":
        return da.map_overlap(laplace_roll, x, depth=1, boundary="reflect", dtype=dtype)
    if form != "slices":
        raise ValueError(f"unknown stencil2d form {form!r}")
    return da.map_overlap(
        laplace_slices, x, depth=1, boundary="reflect", trim=False, dtype=dtype,
        chunks=x.chunks,
    )


def rechunk_relayout(n=8192, chunk=1024, dtype="float32", seed=0, persist=False, *, x_np=None):
    """Rows->cols block relayout of a transposed array (BASELINE metric 2).

    ``x_np`` (n0, n1), or an (n, n) standard normal drawn with ``seed``,
    is read in row panels of ``chunk`` rows; the result
    is its transpose in row panels of ``chunk`` rows, (chunk, n0) each.  On
    one device this is one physical transpose of the whole array (read and
    write every byte once), which the tiled transpose kernel performs on a
    GPU.  ``persist=True`` holds the input on the device first, so
    ``compute_device()`` of the result measures only the relayout.  The
    freeze keeps the rechunk from being pushed below the transpose, where
    it would merge with the input's chunking and leave no relayout.
    """
    n0, n1 = (n, n) if x_np is None else np.shape(x_np)
    x = _input(x_np, (n0, n1), dtype, (chunk, n1), seed)
    if persist:
        x = x.persist()
    return x.T.freeze_chunks().rechunk((chunk, n0))


def tall_skinny_svd(rows=1_000_000, cols=128, chunk_rows=100_000, dtype="float32", seed=0, *, x_np=None):
    """TSQR-based SVD of a tall-skinny matrix (BASELINE config 5: 1e6 x 128
    float32 in row chunks of 100 000): ``(u, s, vh)`` of ``x_np``, or of a
    (rows, cols) standard normal drawn with ``seed``.

    Computed together (``dask_array_tpu_torch.compute(u, s, vh)``) the three
    share one CholeskyQR3 factorization; ``svd_flip``'s multiplies go
    through the scale kernel."""
    import dask_array_tpu_torch as da

    cols = cols if x_np is None else np.shape(x_np)[1]
    return da.linalg.svd(_input(x_np, (rows, cols), dtype, (chunk_rows, cols), seed))
