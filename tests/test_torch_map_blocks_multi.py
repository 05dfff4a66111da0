"""Multi-output ``map_blocks`` through the port against the JAX package.

``map_blocks_multi_output`` applies a function of several outputs to every
block.  Each function is written once per backend (a jnp/torch pair) and
runs on the same seeded inputs through both packages; numpy gives the
expected values.  The function must run once per block however many of
its outputs are computed (the walk builds the inner node once).

Tolerance: float64 results rtol 1e-12 (the same elementwise functions in
another library); counts and layouts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops._map_blocks import map_blocks_multi_output as jmulti
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops._map_blocks import map_blocks_multi_output as tmulti

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def sample(shape=(9, 10), seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


class Counted:
    """A function of one backend with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


SIN_COS = {"torch": lambda b: (torch.sin(b), torch.cos(b)), "jax": lambda b: (jnp.sin(b), jnp.cos(b))}


@pytest.mark.parametrize("chunks", [(4, 5), (1, 3), (9, 10)])
def test_sin_cos_against_the_reference_once_per_block(chunks):
    x = sample()
    port_fn, ref_fn = Counted(SIN_COS["torch"]), Counted(SIN_COS["jax"])
    s, c = tmulti(port_fn, tda.from_array(x, chunks=chunks), dtypes=[np.float64, np.float64])
    rs, rc = jmulti(ref_fn, jda.from_array(x, chunks=chunks), dtypes=[np.float64, np.float64])
    nblocks = int(np.prod(s.numblocks))
    got = tda.compute(s, c)
    assert port_fn.calls == nblocks  # both outputs, one call per block
    want = jda.compute(rs, rc)
    for g, r, w in zip(got, want, (np.sin(x), np.cos(x))):
        assert g.dtype == r.dtype == np.float64 and g.shape == x.shape
        np.testing.assert_allclose(g, w, rtol=1e-12)
        np.testing.assert_allclose(r, w, rtol=1e-12)
    port_fn.calls = 0
    s.compute()
    assert port_fn.calls == nblocks  # one output alone: once per block too


def test_two_arrays_a_scalar_and_keywords():
    x, y = sample(seed=1), sample(seed=2)
    fns = {
        "torch": lambda a, b, k, scale=1.0: (a * b * scale + k, torch.maximum(a, b)),
        "jax": lambda a, b, k, scale=1.0: (a * b * scale + k, jnp.maximum(a, b)),
    }
    p, q = tmulti(fns["torch"], tda.from_array(x, chunks=4), tda.from_array(y, chunks=4), 3.0,
                  dtypes=["f8", "f8"], scale=0.5)
    rp, rq = jmulti(fns["jax"], jda.from_array(x, chunks=4), jda.from_array(y, chunks=4), 3.0,
                    dtypes=["f8", "f8"], scale=0.5)
    for g, r, w in zip(tda.compute(p, q), jda.compute(rp, rq), (x * y * 0.5 + 3.0, np.maximum(x, y))):
        np.testing.assert_allclose(g, w, rtol=1e-12)
        np.testing.assert_allclose(r, w, rtol=1e-12)


def test_per_output_chunks_and_dtypes():
    """The second output is one count per row of each block: its chunks
    are declared apart (``chunkss``), its dtype int64."""
    x = sample()
    fns = {
        "torch": lambda b: (b * 2, (b > 0).sum(dim=1, keepdim=True)),
        "jax": lambda b: (b * 2, (b > 0).sum(axis=1, keepdims=True)),
    }
    chunks = (4, 5)
    port_x = tda.from_array(x, chunks=chunks)
    counts_chunks = (port_x.chunks[0], (1,) * port_x.numblocks[1])
    doubled, counts = tmulti(fns["torch"], port_x, dtypes=[np.float64, np.int64],
                             chunkss=[port_x.chunks, counts_chunks])
    rd, rcounts = jmulti(fns["jax"], jda.from_array(x, chunks=chunks), dtypes=[np.float64, np.int64],
                         chunkss=[port_x.chunks, counts_chunks])
    assert counts.chunks == rcounts.chunks == counts_chunks and counts.dtype == rcounts.dtype == np.int64
    want = np.stack([(x[:, :5] > 0).sum(1), (x[:, 5:] > 0).sum(1)], axis=1)
    got = counts.compute()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rcounts.compute(), want)
    np.testing.assert_allclose(doubled.compute(), 2 * x, rtol=0)


def test_wrong_arity_raises_the_reference_error():
    x = sample()
    port = tmulti(lambda b: (b, b, b), tda.from_array(x, chunks=5), dtypes=["f8", "f8"])[0]
    ref = jmulti(lambda b: (b, b, b), jda.from_array(x, chunks=5), dtypes=["f8", "f8"])[0]
    with pytest.raises(ValueError) as want:
        ref.compute()
    with pytest.raises(ValueError, match="must return a tuple of 2 arrays") as got:
        port.compute()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must return a tuple of 2 arrays"):
        tmulti(lambda b: [b, b], tda.from_array(x, chunks=5), dtypes=["f8", "f8"])[1].compute()


def test_no_array_argument_raises_the_reference_error():
    with pytest.raises(ValueError, match="requires at least one Array"):
        tmulti(lambda a: (a, a), 3.0, dtypes=["f8", "f8"])
    with pytest.raises(ValueError, match="requires at least one Array"):
        jmulti(lambda a: (a, a), 3.0, dtypes=["f8", "f8"])


def test_outputs_feed_further_work():
    """A selected output is an array like any other: slicing, arithmetic
    and reductions run on it, and the function still runs once per block."""
    x = sample((12, 8))
    fn = Counted(SIN_COS["torch"])
    s, c = tmulti(fn, tda.from_array(x, chunks=(3, 4)), dtypes=["f8", "f8"])
    total = (s * s + c * c).sum(axis=0)
    np.testing.assert_allclose(total.compute(), np.full(8, 12.0), rtol=1e-12)
    assert fn.calls == 8
    np.testing.assert_allclose(s[2:7, 1:].compute(), np.sin(x[2:7, 1:]), rtol=1e-12)
