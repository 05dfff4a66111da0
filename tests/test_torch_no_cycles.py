"""A compute leaves no reference cycle that holds a tensor.

A cycle is freed only by Python's cyclic garbage collector, so a block
caught in one stays on the device after ``compute()`` returns, for as long
as the collector does not run: the card's free memory, and the out-of-core
lane's ``"auto"`` budget with it, then depend on the collector's timing.
Each program below is computed with the collector off; then every object
the collector finds unreachable is kept (``gc.DEBUG_SAVEALL``) and none may
be a tensor.  The executor's block assembly, a blockwise contraction's
gather and a tree reduction's windows each recursed through a closure that
called itself, a cycle holding the blocks; an expression that optimized to
itself kept itself in its optimize memo, a cycle holding its leaves.
"""

import gc

import numpy as np
import pytest
import torch

import dask_array_tpu_torch as da
from dask_array_tpu_torch import config as tconfig


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def _laplace(b):
    return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b


def _tsum(b, axis, keepdims):
    return torch.sum(b, dim=axis, keepdim=keepdims)


def _src():
    return np.random.default_rng(40).standard_normal((64, 48))


PROGRAMS = {
    "map_overlap-tanh-laplace": lambda x: da.map_overlap(lambda b: torch.tanh(_laplace(b)), x, depth=1,
                                                         boundary="reflect", dtype="f8"),
    "dense-of-a-grid": lambda x: (x + 1).rechunk((64, 48)),
    "blockwise-contraction": lambda x: da.blockwise(lambda a: a.sum(1), "i", x, "ij", concatenate=True, dtype="f8"),
    "tree-reduction": lambda x: da.reduction(x, _tsum, _tsum, axis=0, split_every=2, dtype="f8"),
    "tree-reduction-2d": lambda x: da.reduction(x, _tsum, _tsum, split_every={0: 2, 1: 2}, dtype="f8"),
}

WANT = {
    "map_overlap-tanh-laplace": lambda s: np.tanh(
        np.pad(s, 1, mode="symmetric")[:-2, 1:-1] + np.pad(s, 1, mode="symmetric")[2:, 1:-1]
        + np.pad(s, 1, mode="symmetric")[1:-1, :-2] + np.pad(s, 1, mode="symmetric")[1:-1, 2:] - 4 * s),
    "dense-of-a-grid": lambda s: s + 1,
    "blockwise-contraction": lambda s: s.sum(1),
    "tree-reduction": lambda s: s.sum(axis=0),
    "tree-reduction-2d": lambda s: s.sum(),
}


def _cyclic_tensors(fn):
    """(fn's result, the tensors in reference cycles that fn left)."""
    gc.collect()
    gc.disable()
    flags = gc.get_debug()
    try:
        out = fn()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        found = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        gc.enable()
    return out, found


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_a_compute_leaves_no_tensor_in_a_cycle(name):
    src = _src()
    arr = PROGRAMS[name](da.from_array(src, chunks=(8, 16)))
    out, found = _cyclic_tensors(arr.compute)
    np.testing.assert_allclose(out, WANT[name](src), rtol=1e-12, atol=1e-12)
    assert found == []


def _persisted_then_sliced(src):
    y = (da.from_array(src, chunks=(8, 16)) * 3).persist()
    y.compute()
    return y[1:].compute()


def _chunk_sizes_computed(src):
    x = da.from_array(src, chunks=(8, 16))
    y = x[x > 0]
    y.compute_chunk_sizes()
    y.compute()
    return y[1:].compute()


def _persisted_then_fused(src):
    y = (da.from_array(src, chunks=(8, 16)) * 3).persist()
    z = (y + 1) * 2
    z.compute()
    return z.compute()


@pytest.mark.parametrize("make, want", [
    (_persisted_then_sliced, lambda s: (s * 3)[1:]),
    (_persisted_then_fused, lambda s: (s * 3 + 1) * 2),
    (_chunk_sizes_computed, lambda s: s[s > 0][1:]),
], ids=["persist", "persist-fused", "compute_chunk_sizes"])
def test_dropped_leaves_of_device_blocks_leave_no_cycle(make, want):
    # a persisted tensor and computed blocks are leaves on the card: an
    # expression whose optimize memo named itself kept them there
    src = _src()
    out, found = _cyclic_tensors(lambda: make(src))
    np.testing.assert_array_equal(out, want(src))
    assert found == []


def test_assemble_drops_its_blocks():
    from dask_array_tpu_torch._executor import _assemble

    def run():
        blocks = {(i, j): torch.full((2, 3), float(3 * i + j)) for i in range(2) for j in range(3)}
        return _assemble(blocks, (2, 3))

    out, found = _cyclic_tensors(run)
    assert out.shape == (4, 9) and found == []
