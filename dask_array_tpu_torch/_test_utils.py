"""assert_eq: check a lazy array against numpy and its own metadata.

Port of ``dask_array_tpu/_test_utils.py``: the values against numpy, and
the structural contracts: dtype, shape, and declared chunks against the
computed shape.
"""

from __future__ import annotations

import math

import numpy as np

from dask_array_tpu_torch._collection import Array


def _chunks_consistent(arr: Array, computed: np.ndarray):
    chunks = arr.chunks
    shape = computed.shape
    assert len(chunks) == len(shape), f"ndim mismatch: chunks {chunks} vs shape {shape}"
    for c, s in zip(chunks, shape):
        if any(isinstance(x, float) and math.isnan(x) for x in c):
            continue
        assert sum(c) == s, f"chunks {c} do not sum to dim {s}"


def assert_eq(a, b, check_dtype=True, check_chunks=True, check_shape=True, rtol=1e-6, atol=1e-9, **kwargs):
    a_original = a

    if isinstance(a, Array):
        if check_chunks:
            _ = a.chunks  # chunks must be known without computing
        a = a.compute()
        if check_chunks:
            _chunks_consistent(a_original, np.asarray(a))
    if isinstance(b, Array):
        b = b.compute()

    a = np.asarray(a)
    b = np.asarray(b)

    if check_shape:
        assert a.shape == b.shape, f"shape mismatch: {a.shape} != {b.shape}"
    if check_dtype:
        assert a.dtype == b.dtype, f"dtype mismatch: {a.dtype} != {b.dtype}"
    if isinstance(a_original, Array) and check_dtype:
        assert np.dtype(a_original.dtype) == a.dtype, f"declared dtype {a_original.dtype} != computed {a.dtype}"

    if a.dtype.kind in "fc":
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
    else:
        np.testing.assert_array_equal(a, b)
    return True
