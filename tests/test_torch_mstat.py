"""The multi-statistic kernel's plain version and its route, on the CPU.

``kernels/mstat.py::multi_stat_plain`` against the Pallas probe's own
reference ``triple`` (``bench/probe_reduction.py``, imported by path; it is
the jnp computation the probe checks its kernel against) and against numpy
in float64; the packed form with a shift; the wrappers' device rule; and
``ops/_multistat.py``, which routes the ``reduction_tree`` statistics
through the kernel when they are computed together.  The CUDA kernel
itself cannot run here: ``chip_smoke.py`` phase 7 and
``tests/test_torch_gpu.py`` hold it against this plain version on the card.

Tolerances (float32): colsum rtol 1e-5 with atol 4 * sqrt(M) * max|x| *
2^-23, rowmean rtol 1e-5 with atol 4 * sqrt(N) * max|x| * 2^-23 / N (sums
of M and N terms taken in another order), std rtol 1e-4.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.kernels import mstat
from dask_array_tpu_torch.models.pipelines import reduction_tree
from dask_array_tpu_torch.ops._multistat import MultiStat, fuse_multi_stat

torch.set_num_threads(1)

PROBE = pathlib.Path(__file__).resolve().parents[1] / "bench" / "probe_reduction.py"
SHAPES = [(37, 53), (1, 7), (4097, 33), (200, 1000)]


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("probe_reduction", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(shape, shift=0.0):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    return (rng.standard_normal(shape) + shift).astype("f4")


def assert_stats(got, want, x):
    M, N = x.shape
    amax = float(np.abs(x).max())
    colsum, rowmean, std = (np.asarray(g, dtype="f8") for g in got)
    np.testing.assert_allclose(colsum, want[0], rtol=1e-5, atol=4 * np.sqrt(M) * amax * 2.0**-23)
    np.testing.assert_allclose(rowmean, want[1], rtol=1e-5, atol=4 * np.sqrt(N) * amax * 2.0**-23 / N)
    np.testing.assert_allclose(std, want[2], rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_the_probe_and_numpy(shape, probe):
    import jax.numpy as jnp

    x = sample(shape)
    got = mstat.multi_stat_plain(torch.from_numpy(x))
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert [tuple(g.shape) for g in got] == [(shape[1],), (shape[0],), ()]
    ref = [np.asarray(r, dtype="f8") for r in probe.triple(jnp.asarray(x))]
    x64 = x.astype("f8")
    assert_stats(got, [x64.sum(0), x64.mean(1), x64.std()], x)
    assert_stats(got, ref, x)


def test_plain_uses_the_probes_formula_and_the_shift():
    x = sample((64, 64), shift=3.0)
    t = torch.from_numpy(x)
    x64 = x.astype("f8")
    s, ss = x64.sum(), (x64 * x64).sum()
    _, _, std = mstat.multi_stat_plain(t)
    np.testing.assert_allclose(float(std), np.sqrt(ss / x.size - (s / x.size) ** 2), rtol=1e-4)
    # with a shift, s and ss are the power sums of x - shift
    packed = mstat.multi_stat_packed_plain(t, t[0, 0])
    assert packed.shape == (64 + 64 + 3,)
    d = x64 - x64[0, 0]
    np.testing.assert_allclose(float(packed[-3]), float(std), rtol=1e-4)
    np.testing.assert_allclose(float(packed[-2]), d.sum(), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(packed[-1]), (d * d).sum(), rtol=1e-5)


def test_wrappers_follow_the_tensors_device():
    x = torch.from_numpy(sample((8, 8)))
    for a, b in zip(mstat.multi_stat(x), mstat.multi_stat_plain(x)):
        assert torch.equal(a, b)
    before = mstat.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        mstat.multi_stat_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mstat.multi_stat_packed_cuda(x, x[0, 0])
    assert mstat.LAUNCHES == before


# ---------------------------------------------------------------------------
# the route: reduction_tree's statistics in one read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split_every", [None, 4])
def test_reduction_tree_joint_matches_jax(split_every):
    x = sample((300, 250), shift=20.0)
    arrays = reduction_tree(chunk=64, split_every=split_every, x_np=x)
    fused = fuse_multi_stat([a.expr for a in arrays])
    assert len({n._name for e in fused for n in e.walk() if isinstance(n, MultiStat)}) == 1
    got = tda.compute(*arrays)
    jx = jda.from_array(x, chunks=64)
    ref = jda.compute(jx.sum(axis=0, split_every=split_every), jx.mean(axis=1, split_every=split_every),
                      jx.std(split_every=split_every))
    x64 = x.astype("f8")
    assert_stats(got, [x64.sum(0), x64.mean(1), x64.std()], x)
    assert_stats(got, [np.asarray(r, "f8") for r in ref], x)
    assert [g.dtype for g in got] == [np.float32] * 3
    # one at a time, sum and mean are ordinary typed reductions; std alone
    # still reads x once for its two power sums
    for a, g, alone in zip(arrays, got, (False, False, True)):
        assert any(isinstance(n, MultiStat) for n in fuse_multi_stat([a.expr])[0].walk()) == alone
        np.testing.assert_allclose(a.compute(), g, rtol=1e-4, atol=1e-3)


def test_route_declines_what_the_kernel_does_not_compute():
    x = sample((40, 30))
    a = tda.from_array(x, chunks=10)
    a64 = tda.from_array(x.astype("f8"), chunks=10)

    def routed(*arrays):
        return any(isinstance(n, MultiStat) for e in fuse_multi_stat([r.expr for r in arrays]) for n in e.walk())

    assert routed(a.sum(axis=0), a.mean(axis=1))
    assert routed(a.sum(axis=0), a.sum())
    assert not routed(a.sum(axis=0))
    assert not routed(a64.sum(axis=0), a64.mean(axis=1))
    assert not routed(a.sum(axis=0, keepdims=True), a.mean(axis=1, keepdims=True))
    assert not routed(a.sum(axis=1), a.mean(axis=0))
    assert not routed(a.std(), a.sum())  # two different shifts
    got = tda.compute(a.sum(axis=0), a.mean(axis=1), a.var(), 3)
    assert got[3] == 3
    assert tda.compute(3, "x") == (3, "x")
    x64 = x.astype("f8")
    np.testing.assert_allclose(got[2], x64.var(), rtol=1e-4)
    np.testing.assert_allclose(got[0], x64.sum(0), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel's launch plan (kernels/mstat.py::launch_plan, mirrored by
# csrc/mstat.cu): a pure function of (M, N) and the SM count
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 7), (4097, 33), (1000, 1003), (10000, 10000), (1_000_000, 128), (128, 1_000_000)]
H100_SMS = 132


def _covered(plan, M, N):
    """How many times the plan's segments cover each (row, column), as a
    count of row cover per strip (the columns follow from the strips)."""
    rows = np.zeros((plan.strips, M), dtype=np.int64)
    for b, s, r0, r1 in mstat.segments(plan, M):
        assert 0 <= b < plan.blocks and 0 <= s < plan.strips and 0 <= r0 < r1 <= M
        rows[s, r0:r1] += 1
    return rows


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_element_once(shape):
    M, N = shape
    plan = mstat.launch_plan(M, N, H100_SMS)
    assert np.array_equal(_covered(plan, M, N), np.ones((plan.strips, M), dtype=np.int64))
    # the strips tile the columns: every column in exactly one strip
    assert plan.width == 4 * plan.lanes * plan.across
    assert (plan.strips - 1) * plan.width < N <= plan.strips * plan.width
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.across in (1, 2, 4, 8) and (plan.across == 1 or plan.lanes == 32)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_fills_the_card(shape):
    """One wave of resident blocks, each with the same work to a row."""
    M, N = shape
    plan = mstat.launch_plan(M, N, H100_SMS)
    assert plan.blocks >= H100_SMS * mstat.BLOCKS_PER_SM
    assert plan.blocks % H100_SMS == 0
    work = np.zeros(plan.blocks, dtype=np.int64)
    for b, _s, r0, r1 in mstat.segments(plan, M):
        work[b] += r1 - r0
    assert work.max() - work.min() <= 1
    # a narrow array gives a warp several rows: more than half of the
    # columns the threads own are the array's
    assert 2 * N > plan.strips * plan.width


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_partials_stay_small(shape):
    """Column partials (one strip row a segment), row partials (one a
    warp-wide strip) and the (s, ss) pairs: under 2 % of x's bytes, or under
    2 MiB for an array too small for that to matter."""
    M, N = shape
    plan = mstat.launch_plan(M, N, H100_SMS)
    nbytes = M * N * 4
    assert plan.scratch * 4 <= max(0.02 * nbytes, 2 << 20)
    assert plan.colpart == (plan.blocks + plan.strips) * plan.width
    assert plan.rowpart == (plan.strips * plan.across * M if plan.strips * plan.across > 1 else 0)
    if nbytes >= 1 << 28:
        assert plan.scratch * 4 <= 0.02 * nbytes


def test_plan_is_pure():
    for shape in PLAN_SHAPES:
        assert mstat.launch_plan(*shape) == mstat.launch_plan(*shape)
        assert mstat.launch_plan(*shape, sms=66).blocks == 66 * mstat.BLOCKS_PER_SM


@pytest.mark.parametrize("case", ["aligned", "N=1003", "offset 1", "N=6", "N=128"])
def test_vector_path_only_for_16_byte_rows_and_pointers(case):
    if case == "aligned":
        x, want = torch.zeros((16, 1024)), True
    elif case == "N=1003":
        x, want = torch.zeros((16, 1003)), False
    elif case == "offset 1":
        x, want = torch.zeros(16 * 1024 + 1)[1:].view(16, 1024), False
    elif case == "N=6":
        x, want = torch.zeros((16, 6)), False
    else:
        x, want = torch.zeros((100, 128)), True
    assert x.is_contiguous()
    assert mstat.vector_ok(x) == want
    assert (x.shape[1] * 4 % 16 == 0 and x.data_ptr() % 16 == 0) == want


def test_plain_matches_the_probe_at_the_plan_shapes_cut_down(probe):
    """The plain version, which the kernel is held to on the card, against
    the probe's jnp reference on (M, N) with the skinny shapes' aspect."""
    import jax.numpy as jnp

    for shape in [(4000, 128), (128, 4000), (1000, 1003)]:
        x = sample(shape)
        got = mstat.multi_stat_plain(torch.from_numpy(x))
        ref = [np.asarray(r, dtype="f8") for r in probe.triple(jnp.asarray(x))]
        assert_stats(got, ref, x)
        x64 = x.astype("f8")
        assert_stats(got, [x64.sum(0), x64.mean(1), x64.std()], x)
