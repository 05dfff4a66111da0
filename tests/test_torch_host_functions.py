"""Block functions written in numpy: the port's host lane, on the CPU.

The JAX package runs a numpy block function eagerly on its blocks; the
port decides once per node, from the function (``_host.py``), whether it
is torch code or host code, and runs host code on the blocks' numpy
copies, uploading the results.  Each case goes through the port, the JAX
package and numpy:

- ``reduction`` with ``np.sum``, ``np.nansum`` and ``np.max``;
- ``cumreduction`` (xarray's ``scan``) with ``np.cumsum`` and
  ``np.maximum.accumulate``;
- ``map_blocks`` and ``blockwise`` of numpy functions that return arrays;
- ``apply_gufunc`` of ``np.mean``; a multi-output ``map_blocks``;

over ragged chunks and chunks of 1, in float32, float64, int64 and uint32.
numpy's side applies the same numpy function to the same blocks in the
same order, so the port's values equal its bytes; the JAX package's equal
them where numpy itself runs on its blocks, and are within rtol 1e-12
(float64; 1e-6 for float32) where numpy hands the call to the jax array's
own method (``np.sum``, ``np.mean`` of a jax array compute in XLA).
``_host.HOST_CALLS`` counts the host calls: one a block, and none for a
torch function.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops._map_blocks import map_blocks_multi_output as jmulti
from dask_array_tpu_torch import _host
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops._map_blocks import map_blocks_multi_output as tmulti

torch.set_num_threads(1)

DTYPES = ["float32", "float64", "int64", "uint32"]
# (chunks along axis 0, chunks along axis 1) of a (8, 7) array: ragged, ones
CHUNKINGS = {"ragged": ((3, 1, 4), (5, 2)), "ones": ((1,) * 8, (1,) * 7)}


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(autouse=True)
def _count():
    _host.HOST_CALLS = 0
    yield


def data(dtype, seed=0, nan=False):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal((8, 7)).astype(dtype)
        if nan:
            x[rng.random(x.shape) < 0.2] = np.nan
        return x
    if np.dtype(dtype).kind == "u":
        return rng.integers(0, 2**32 - 1, size=(8, 7), dtype=np.uint64).astype(dtype)
    return rng.integers(-(2**40), 2**40, size=(8, 7)).astype(dtype)


def blocks_of(x, chunks):
    """numpy's side: the blocks of ``x`` under ``chunks``, as a nested list."""
    b0 = np.cumsum((0,) + chunks[0])
    b1 = np.cumsum((0,) + chunks[1])
    return [[x[b0[i]:b0[i + 1], b1[j]:b1[j + 1]] for j in range(len(chunks[1]))] for i in range(len(chunks[0]))]


def nblocks(chunks):
    return len(chunks[0]) * len(chunks[1])


def close(got, want, exact=True):
    got = np.asarray(got)
    assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want)
    if exact or got.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6 if got.dtype == np.float32 else 1e-12, atol=0)


# numpy function -> does numpy itself run on a jax array's data (else it
# calls the array's own method, computed in XLA)?
REDUCTIONS = {"sum": (np.sum, False), "nansum": (np.nansum, True), "max": (np.max, True)}


def out_dtype(func, dtype):
    return np.asarray(func(np.ones((1, 1), dtype))).dtype


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_of_a_numpy_function(name, dtype, chunking):
    """``reduction(x, f, f, axis=1)``: f on each block (keepdims), then f on
    the concatenated partials of each row of blocks."""
    func, numpy_runs = REDUCTIONS[name]
    chunks = CHUNKINGS[chunking]
    x = data(dtype, nan=name == "nansum")
    dt = out_dtype(func, dtype)
    kw = {"dtype": dt} if name != "max" else {}
    rows = []
    for row in blocks_of(x, chunks):
        partials = np.concatenate([func(b, axis=(1,), keepdims=True, **kw) for b in row], axis=1)
        rows.append(func(partials, axis=(1,), keepdims=False, **kw))
    want = np.concatenate(rows)
    got = tda.reduction(tda.from_array(x, chunks=chunks), func, func, axis=1, dtype=dt).compute()
    close(got, want)
    assert _host.HOST_CALLS == nblocks(chunks) + len(chunks[0])  # a chunk call a block, an aggregate a row
    ref = jda.reduction(jda.from_array(x, chunks=chunks), func, func, axis=1, dtype=dt).compute()
    close(ref, want, exact=numpy_runs)


def test_reduction_of_a_numpy_function_over_a_tree_of_combines():
    """``split_every=2`` over 7 blocks: combines run on the host too."""
    x = data("float64")
    d = tda.from_array(x, chunks=((8,), (1,) * 7))
    got = tda.reduction(d, np.nansum, np.nansum, combine=np.nansum, axis=1, dtype="f8", split_every=2).compute()
    ref = jda.reduction(jda.from_array(x, chunks=((8,), (1,) * 7)), np.nansum, np.nansum, combine=np.nansum,
                        axis=1, dtype="f8", split_every=2).compute()
    close(got, ref)
    np.testing.assert_allclose(got, x.sum(1), rtol=1e-12)
    assert _host.HOST_CALLS == 7 + 4 + 2 + 1  # chunks, then 4, 2 and 1 windows


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_of_numpy_functions(dtype, chunking):
    """xarray's scans: ``np.cumsum`` (the port's own cumsum) and
    ``np.maximum.accumulate`` with ``np.maximum`` as the carry (host lane)."""
    chunks = CHUNKINGS[chunking]
    x = data(dtype)

    def cummax(b, axis=None):
        return np.maximum.accumulate(b, axis=axis)

    got = tda.cumreduction(cummax, np.maximum, None, tda.from_array(x, chunks=chunks), axis=1).compute()
    want = np.maximum.accumulate(x, axis=1)
    close(got, want)
    assert _host.HOST_CALLS == nblocks(chunks) + len(chunks[0]) * (len(chunks[1]) - 1)
    close(jda.cumreduction(cummax, np.maximum, None, jda.from_array(x, chunks=chunks), axis=1).compute(), want)
    _host.HOST_CALLS = 0
    got = tda.cumreduction(np.cumsum, np.add, 0, tda.from_array(x, chunks=chunks), axis=1, dtype=x.dtype).compute()
    close(got, np.cumsum(x, axis=1, dtype=x.dtype), exact=False)
    assert _host.HOST_CALLS == 0  # np.cumsum is the port's cumsum


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_map_blocks_of_a_numpy_function(dtype, chunking):
    """``np.nansum(b, 0, keepdims=True)`` a block: the grid keeps its
    blocks, each one row."""
    chunks = CHUNKINGS[chunking]
    x = data(dtype)

    def colsum(b):
        return np.nansum(b, 0, keepdims=True)

    out_chunks = ((1,) * len(chunks[0]), chunks[1])
    dt = out_dtype(np.nansum, dtype)
    want = np.block([[colsum(b) for b in row] for row in blocks_of(x, chunks)])
    got = tda.map_blocks(colsum, tda.from_array(x, chunks=chunks), chunks=out_chunks, dtype=dt).compute()
    close(got, want)
    assert _host.HOST_CALLS == nblocks(chunks)
    close(jda.map_blocks(colsum, jda.from_array(x, chunks=chunks), chunks=out_chunks, dtype=dt).compute(), want)


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_blockwise_of_a_numpy_function(dtype, chunking):
    chunks = CHUNKINGS[chunking]
    x = data(dtype)

    def add(a, b):
        return np.add(np.asarray(a), np.asarray(b))

    got = tda.blockwise(add, "ij", tda.from_array(x, chunks=chunks), "ij", tda.from_array(x, chunks=chunks), "ij",
                        dtype=x.dtype).compute()
    close(got, x + x)
    assert _host.HOST_CALLS == nblocks(chunks)
    ref = jda.blockwise(add, "ij", jda.from_array(x, chunks=chunks), "ij", jda.from_array(x, chunks=chunks), "ij",
                        dtype=x.dtype).compute()
    close(ref, x + x)


# where the JAX package differs from numpy, each checked to differ: np.mean
# of a jax uint32 array is jax's mean, which accumulates in float32
KNOWN_REFERENCE_FAULTS = {("mean", "uint32")}


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_gufunc_of_np_mean(dtype):
    chunks = CHUNKINGS["ragged"]
    x = data(dtype)

    def mean(a):
        return np.mean(a, axis=-1)

    want = np.concatenate([mean(x[a:b]) for a, b in ((0, 3), (3, 4), (4, 8))])
    got = tda.apply_gufunc(mean, "(i)->()", tda.from_array(x, chunks=chunks), output_dtypes=want.dtype,
                           allow_rechunk=True).compute()
    close(got, want)
    assert _host.HOST_CALLS == 3
    ref = jda.apply_gufunc(mean, "(i)->()", jda.from_array(x, chunks=chunks), output_dtypes=want.dtype,
                           allow_rechunk=True).compute()
    if ("mean", dtype) in KNOWN_REFERENCE_FAULTS:
        assert not np.allclose(ref, want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ref, want, rtol=1e-6)
    else:
        close(ref, want, exact=False)


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_multi_output_map_blocks_of_a_numpy_function(chunking):
    chunks = CHUNKINGS[chunking]
    x = data("float64")

    def split(b):
        return np.sin(b), np.floor(b).astype(np.int64)

    got = tda.compute(*tmulti(split, tda.from_array(x, chunks=chunks), dtypes=["f8", "i8"]))
    close(got[0], np.sin(x))
    close(got[1], np.floor(x).astype(np.int64))
    assert _host.HOST_CALLS == nblocks(chunks)  # both outputs, one call a block
    ref = jda.compute(*jmulti(split, jda.from_array(x, chunks=chunks), dtypes=["f8", "i8"]))
    close(ref[0], np.sin(x))
    close(ref[1], np.floor(x).astype(np.int64))


def test_elemwise_of_a_numpy_ufunc():
    x = data("float32")
    got = tda.elemwise(np.hypot, tda.from_array(x, chunks=3), tda.from_array(x[::-1].copy(), chunks=3)).compute()
    close(got, np.hypot(x, x[::-1]))
    assert _host.HOST_CALLS == 1  # Elemwise computes on the dense array


@pytest.mark.parametrize("case", ["map_blocks", "blockwise", "reduction", "scan", "gufunc", "duck"])
def test_a_torch_function_is_never_sent_to_the_host(case):
    x = data("float64")
    d = tda.from_array(x, chunks=CHUNKINGS["ragged"])
    if case == "map_blocks":
        got, want = tda.map_blocks(lambda b: torch.sin(b) * 2, d, dtype="f8"), np.sin(x) * 2
    elif case == "blockwise":
        got, want = tda.blockwise(torch.add, "ij", d, "ij", d, "ij", dtype="f8"), x + x
    elif case == "reduction":
        got, want = tda.reduction(d, torch.sum, torch.sum, axis=1, dtype="f8"), x.sum(1)
    elif case == "scan":
        got = tda.cumreduction(lambda b, axis=None: torch.cummax(b, dim=axis).values, torch.maximum, None, d, axis=1)
        want = np.maximum.accumulate(x, axis=1)
    elif case == "gufunc":
        got = tda.apply_gufunc(lambda a: a.mean(-1), "(i)->()", d, output_dtypes="f8", allow_rechunk=True)
        want = x.mean(-1)
    else:  # methods of the block, data-dependent: meta tensors refuse it, torch runs it
        got = tda.map_blocks(lambda b: b * b.sum().item(), d, dtype="f8")
        want = np.block([[b * b.sum() for b in row] for row in blocks_of(x, CHUNKINGS["ragged"])])
    np.testing.assert_allclose(got.compute(), want, rtol=1e-12)
    assert _host.HOST_CALLS == 0


def test_a_function_that_reads_its_block_through_numpy_is_host_code():
    """A function that reads its block with ``np.asarray`` refuses the
    probe (as it would fail on the card) and computes on the numpy copy:
    host code, whatever it returns."""
    x = data("float64")

    def via_numpy(b):
        return torch.from_numpy(np.sort(np.asarray(b), axis=1))

    got = tda.map_blocks(via_numpy, tda.from_array(x, chunks=((4, 4), (7,))), dtype="f8").compute()
    close(got, np.sort(x, axis=1))
    assert _host.HOST_CALLS == 2


def test_a_function_that_refuses_both_lanes_runs_as_it_is():
    """A function that takes only a plain tensor refuses the probe and the
    numpy copy: it runs as it always did, on its tensors."""
    x = data("float64")

    def strict(b):
        if type(b) is not torch.Tensor:
            raise TypeError("a plain tensor only")
        return b * 2

    got = tda.map_blocks(strict, tda.from_array(x, chunks=((4, 4), (7,))), dtype="f8").compute()
    close(got, x * 2)
    assert _host.HOST_CALLS == 0


def test_a_function_that_fails_both_lanes_raises_as_before():
    d = tda.from_array(data("float64"), chunks=3)

    def broken(b):
        raise ValueError("broken block function")

    with pytest.raises(ValueError, match="broken block function"):
        tda.map_blocks(broken, d, dtype="f8").compute()


def test_the_lane_is_decided_once_and_shown_in_pprint(capsys):
    x = data("float64")

    def colsum(b):
        return np.nansum(b, 0, keepdims=True)

    lam = tda.map_blocks(lambda b: colsum(b), tda.from_array(x, chunks=(4, 7)), chunks=((1, 1), (7,)), dtype="f8")
    lam.expr.pprint()
    assert "[host lane: func?]" in capsys.readouterr().out  # decided at the first block
    lam.compute()
    lam.expr.pprint()
    assert "[host lane: func]" in capsys.readouterr().out
    named = tda.reduction(tda.from_array(x, chunks=(4, 7)), np.nansum, np.nansum, axis=1, dtype="f8")
    named.expr.pprint()
    assert "[host lane: func]" in capsys.readouterr().out  # a numpy function: known at once
    torchy = tda.map_blocks(torch.sin, tda.from_array(x, chunks=(4, 7)), dtype="f8")
    torchy.expr.pprint()
    assert "host lane" not in capsys.readouterr().out


def test_the_decision_does_not_depend_on_the_device():
    """On the CPU a numpy ufunc reads a CPU tensor through ``__array__``
    (and ``__array_wrap__`` hands a tensor back), which it cannot on the
    card; the probe refuses that read, so the CPU takes the card's route."""
    assert _host.fixed_lane(np.maximum.accumulate) is True
    assert _host.fixed_lane(np.nansum) is True
    assert _host.fixed_lane(torch.sum) is False
    assert _host.fixed_lane(torch.Tensor.sum) is False
    assert _host.fixed_lane(tda.sum) is False
    assert _host.fixed_lane(lambda b: b) is None
    probe = torch.ones(2, 2).as_subclass(_host._NoHostCopy)
    with pytest.raises(TypeError):
        np.maximum.accumulate(probe, axis=0)


def test_uint64_blocks_reach_numpy_as_uint64():
    a = np.array([[2**64 - 1, 3], [2**63, 7]], dtype=np.uint64)
    got = tda.reduction(tda.from_array(a, chunks=1), np.max, np.max, axis=0, dtype="u8").compute()
    close(got, a.max(0))
    got = tda.map_blocks(lambda b: np.right_shift(b, np.uint64(1)), tda.from_array(a, chunks=1), dtype="u8")
    close(got.compute(), a >> np.uint64(1))
