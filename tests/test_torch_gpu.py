"""The port on a CUDA card: the band-stencil, multi-statistic, transpose,
halo and scale kernels against their plain versions, their input checks,
and the main paths through ``compute()`` (stencil2d in both forms, a
non-linear map_overlap, pad, sliding windows and push, reduction_tree,
normalize_contract, rechunk_relayout, tall_skinny_svd), uint64
arithmetic and order above 2**63, and ``da.random``'s surroundings: a
random leaf's determinism and grid independence, the laws' moments,
``integers`` up to 2**64, fft against numpy, svd_compressed, multi-output
map_blocks and the random-input pipelines with their kernel launches;
the histogram kernel (K2) against its plain version and numpy (every
held dtype, complex data, NaN and infinities, int64 edges to INT64_MAX,
values on and beside every edge, 1 and 2**16 bins, bincounts, unaligned
and ragged inputs, weighted sums that repeat their bits) and the paths
held to numpy's own steps: nonzero and pad of unsigned integers, float16
scans, complex histograms and svd_compressed, norms of integers.

Every test here needs a card and carries the ``gpu`` marker; without one
it skips.  The file imports neither jax nor the JAX package, so a machine
without JAX runs it with the repo's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: float32 rtol 1e-5 with atol scaled by sum|w| * max|x|, float64
1e-12 (kernel and plain version sum the taps in different orders).  The
multi-statistic kernel: colsum/rowmean rtol 1e-5 with atol 4 * sqrt(terms)
* max|x| * 2^-23, std rtol 1e-4.  The transpose and halo kernels move
bytes: their results must equal the plain versions' byte for byte.  The
scale kernel rounds one product as torch does: equal bytes, a NaN matching
any NaN.  tall_skinny_svd: singular values rtol 1e-4 against float64
numpy, reconstruction and orthogonality 20 * eps * n.  Random draws:
mean and variance within 6 standard errors of scipy's law.  fft: rtol
1e-5 of the max for single precision, 1e-12 for double, 2**-10 for
float16 input.  svd_compressed of an exact-rank input: s to 1e-8 of s_max
in float64, 1e-4 in float32.  Histogram counts equal exactly; weighted
sums rtol 1e-12 (the kernel adds in another order than the plain
version's bincount).
"""

import numpy as np
import pytest
import torch

MODES = ["reflect", "nearest", "periodic", 0.0, 2.5]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def laplace(b):
    return (
        torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1)
        - 4 * b
    )


def far(b):
    return torch.roll(b, 8, 0) - 0.5 * torch.roll(b, -8, 1) + torch.roll(torch.roll(b, -3, 0), 5, 1) / 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("func, depth", [(laplace, (1, 1)), (far, (8, 8))])
def test_kernel_matches_plain_for_every_boundary_pair(cuda, dtype, func, depth):
    from dask_array_tpu_torch.kernels import stencil

    taps = stencil.capture_taps(func, depth)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for b0 in MODES:
        for b1 in MODES:
            x = torch.randn((67, 131), generator=gen, device=cuda, dtype=dtype)
            got = stencil.band_stencil_cuda(x, taps, depth, (b0, b1))
            want = stencil.band_stencil_plain(x, func, depth, (b0, b1))
            torch.cuda.synchronize()
            scale = sum(abs(w) for _, _, w in taps) * float(x.abs().max())
            rtol, atol = (1e-5, scale * 2.0**-21) if dtype == torch.float32 else (1e-12, scale * 1e-12)
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def stencil_reaching(d0, d1):
    """A linear stencil reaching exactly (d0, d1), with a corner tap."""

    def f(b):
        out = -3.0 * b
        for s in range(1, d0 + 1):
            out = out + torch.roll(b, s, 0) * (0.5 / s) - torch.roll(b, -s, 0) * (0.25 / s)
        for s in range(1, d1 + 1):
            out = out + torch.roll(b, s, 1) * (0.75 / s) + torch.roll(b, -s, 1) / (2.0 * s)
        if d0 and d1:
            out = out + torch.roll(torch.roll(b, d0, 0), -d1, 1) * 0.125
        return out

    return f


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("depth", [(1, 1), (2, 1), (8, 8)])
@pytest.mark.parametrize("layout", ["vector", "n_not_multiple_of_4", "storage_offset_1"])
def test_kernel_paths_match_plain(cuda, dtype, depth, layout):
    """The redesigned kernel's paths: 300 rows make 24x128 tiles both interior
    (no index mapped) and at the edge; 16-byte rows where the row length and
    the pointer allow, scalars for a row length not a multiple of 4 and for
    a contiguous tensor one element into its storage; the register window at
    depth (1, 1), the tap list at (2, 1) and (8, 8)."""
    from dask_array_tpu_torch.kernels import stencil

    n = {"vector": 1024, "n_not_multiple_of_4": 1003, "storage_offset_1": 1024}[layout]
    gen = torch.Generator(device=cuda).manual_seed(sum(depth))
    flat = torch.randn(300 * n + 1, generator=gen, device=cuda, dtype=torch.float32).to(dtype)
    x = flat[1:].view(300, n) if layout == "storage_offset_1" else flat[: 300 * n].view(300, n)
    assert stencil.vector_ok(x, torch.empty_like(x)) is (layout == "vector")
    assert stencil.kernel_variant(depth) == (1 if depth == (1, 1) else 0)
    func = stencil_reaching(*depth)
    taps = stencil.capture_taps(func, depth)
    for bnd in (("reflect", "periodic"), (2.5, "nearest"), ("periodic", 0.0)):
        got = stencil.band_stencil_cuda(x, taps, depth, bnd)
        scale = sum(abs(w) for _, _, w in taps) * float(x.abs().max())
        if dtype == torch.float16:  # accumulated in float32, rounded once
            want = stencil.band_stencil_plain(x.float(), func, depth, bnd).half()
            rtol, atol = 1e-3, scale * 2.0**-11
        else:
            want = stencil.band_stencil_plain(x, func, depth, bnd)
            rtol, atol = (1e-5, scale * 2.0**-21) if dtype == torch.float32 else (1e-12, scale * 1e-12)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_kernel_window_skips_the_taps_a_stencil_lacks(cuda):
    """The 5-point stencil in the dense 3x3 window: an inf input gives the
    plain version's infs and no NaN (0 * inf in an empty corner would)."""
    from dask_array_tpu_torch.kernels import stencil

    x = torch.randn((256, 512), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    x[100, 200] = float("inf")
    x[30, 300] = -float("inf")
    taps = stencil.capture_taps(laplace, (1, 1))
    got = stencil.band_stencil_cuda(x, taps, (1, 1), ("reflect", "reflect"))
    want = stencil.band_stencil_plain(x, laplace, (1, 1), ("reflect", "reflect"))
    torch.cuda.synchronize()
    assert not bool(got.isnan().any()) and torch.equal(got.isinf(), want.isinf())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    from dask_array_tpu_torch.kernels import stencil

    taps = stencil.capture_taps(laplace, (1, 1))
    x = torch.zeros((16, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.band_stencil_cuda(x.T[:, :8], taps, (1, 1), ("reflect", "reflect"))
    with pytest.raises(TypeError):
        stencil.band_stencil_cuda(x.to(torch.int32), taps, (1, 1), ("reflect", "reflect"))
    with pytest.raises(ValueError, match="do not fit"):
        stencil.band_stencil_cuda(x, ((2, 0, 1.0),), (1, 1), ("reflect", "reflect"))
    with pytest.raises(ValueError, match="boundary"):
        stencil.band_stencil_cuda(x, taps, (1, 1), ("none", "reflect"))


@pytest.mark.gpu
def test_stencil2d_through_compute_launches_the_kernel(cuda):
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.models.pipelines import stencil2d
    from dask_array_tpu_torch.ops._overlap import BandStencil

    x = np.random.default_rng(0).standard_normal((512, 384)).astype(np.float32)
    p = np.pad(x.astype(np.float64), 1, mode="symmetric")
    want = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]
    with config.set({"device": "cuda"}):
        roll = stencil2d(x, chunk=128, form="roll")
        assert isinstance(roll.expr, BandStencil)
        before = stencil.LAUNCHES
        out = roll.compute_device()
        assert out.device.type == "cuda"
        assert stencil.LAUNCHES == before + 1
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-5, atol=1e-4)
        slices = stencil2d(x, chunk=128, form="slices").compute()
        np.testing.assert_allclose(slices, want, rtol=1e-5, atol=1e-4)


def assert_stats(got, want, x):
    M, N = x.shape
    amax = float(x.abs().max())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=4 * M**0.5 * amax * 2.0**-23)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=4 * N**0.5 * amax * 2.0**-23 / N)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 1003), (1, 7), (4097, 33), (64, 5000), (1_000_000, 128), (128, 1_000_000),
                                   "offset1"], ids=str)
def test_mstat_kernel_matches_plain(cuda, shape):
    """Every shape the launch plan cuts differently: one strip or many,
    narrow rows shared by a warp, the skinny shapes, and a contiguous
    tensor at storage offset 1 (the scalar loads)."""
    from dask_array_tpu_torch.kernels import mstat

    gen = torch.Generator(device=cuda).manual_seed(1)
    if shape == "offset1":
        x = (torch.randn(1000 * 1024 + 1, generator=gen, device=cuda) + 2.0)[1:].view(1000, 1024)
        assert x.is_contiguous() and not mstat.vector_ok(x)
    else:
        x = torch.randn(shape, generator=gen, device=cuda) + 2.0
    before = mstat.LAUNCHES
    got = mstat.multi_stat_cuda(x)
    assert mstat.LAUNCHES == before + 1
    want = mstat.multi_stat_plain(x)
    torch.cuda.synchronize()
    assert_stats(got, want, x)
    # the same bits twice: no atomics, a fixed order of additions
    again = mstat.multi_stat_cuda(x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # with a shift, s and ss are the power sums of x - shift (against float64)
    shift = x[0, 0]
    packed = mstat.multi_stat_packed_cuda(x, shift)
    d = (x - shift).double()
    torch.testing.assert_close(packed[-2].double(), d.sum(), rtol=1e-4, atol=2.0**-20 * float(d.abs().sum()))
    torch.testing.assert_close(packed[-1].double(), (d * d).sum(), rtol=1e-4, atol=0.0)


@pytest.mark.gpu
def test_mstat_kernel_refuses_what_it_does_not_take(cuda):
    from dask_array_tpu_torch.kernels import mstat

    x = torch.zeros((16, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mstat.multi_stat_cuda(x.T[:, :8])
    with pytest.raises(TypeError):
        mstat.multi_stat_cuda(x.double())
    with pytest.raises(ValueError, match="non-empty"):
        mstat.multi_stat_cuda(x[:0])
    with pytest.raises(ValueError, match="2-D"):
        mstat.multi_stat_cuda(x[0])
    with pytest.raises(ValueError, match="shift"):
        mstat.multi_stat_packed_cuda(x, x[0])


@pytest.mark.gpu
def test_reduction_tree_on_the_card_goes_through_the_kernel(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import mstat
    from dask_array_tpu_torch.models.pipelines import reduction_tree

    x = (np.random.default_rng(2).standard_normal((900, 700)) + 5).astype(np.float32)
    with config.set({"device": "cuda"}):
        before = mstat.LAUNCHES
        s, m, sd = da.compute(*reduction_tree(x, chunk=100, split_every=4))
        assert mstat.LAUNCHES == before + 1
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(s, x64.sum(0), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(m, x64.mean(1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sd, x64.std(), rtol=1e-4)


@pytest.mark.gpu
def test_normalize_contract_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.models.pipelines import normalize_contract

    rng = np.random.default_rng(3)
    a = (rng.standard_normal((512, 256)) * 2 + 1).astype(np.float32)
    b = rng.standard_normal((96, 256)).astype(np.float32)
    with config.set({"device": "cuda"}):
        out = normalize_contract(da.from_array(a, chunks=128), da.from_array(b, chunks=64))
        dev = out.compute_device()
        assert dev.device.type == "cuda"
        got = dev.cpu().numpy()
    a64 = a.astype(np.float64)
    y = ((a64 - a64.mean(0)) / (a64.std(0) + 1e-6)) @ b.astype(np.float64).T
    np.testing.assert_allclose(got, (y * y).sum(1), rtol=1e-4)


@pytest.mark.gpu
def test_integer_and_float_contractions_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    rng = np.random.default_rng(4)
    i = rng.integers(-2**20, 2**20, size=(96, 80)).astype(np.int64)
    j = rng.integers(-2**20, 2**20, size=(80, 64)).astype(np.int64)
    f = rng.standard_normal((96, 80)).astype(np.float32)
    with config.set({"device": "cuda"}):
        # cuBLAS has no integer GEMM: the exact route, bit for bit numpy's
        got = (da.from_array(i, chunks=32) @ da.from_array(j, chunks=16)).compute()
        np.testing.assert_array_equal(got, i @ j)
        b = (da.from_array(i, chunks=32) > 0) @ (da.from_array(j, chunks=16) > 0)
        np.testing.assert_array_equal(b.compute(), (i > 0) @ (j > 0))
        # float32 under the default "highest": full-f32 products, no TF32
        ff = (da.from_array(f, chunks=32) @ da.from_array(f.T.copy(), chunks=32)).compute()
    want = f.astype(np.float64) @ f.T.astype(np.float64)
    np.testing.assert_allclose(ff, want, rtol=1e-5, atol=1e-4)


TRANSPOSE_DTYPES = [torch.bool, torch.int8, torch.float16, torch.float32, torch.float64, torch.int64,
                    torch.complex64, torch.complex128, torch.uint16, torch.uint32, torch.uint64]


def random_bytes(shape, dtype, device, seed):
    """Random bits of ``dtype`` (NaN payloads and -0.0 included), made
    through an integer view of the bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    size = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (*shape[:-1], shape[-1] * size), generator=gen, device=device,
                        dtype=torch.uint8)
    if dtype == torch.bool:
        return raw % 2 == 1
    return raw.view(dtype)


def same_bytes(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)
    )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TRANSPOSE_DTYPES, ids=str)
def test_transpose_kernel_matches_plain_byte_for_byte(cuda, dtype):
    from dask_array_tpu_torch.kernels import transpose as tk

    for i, shape in enumerate([(1000, 1003), (1, 7), (4097, 33), (3, 513, 257), (2, 2, 31, 65)]):
        x = random_bytes(shape, dtype, cuda, seed=i)
        before = tk.LAUNCHES
        got = tk.transpose_last2_cuda(x)
        assert tk.LAUNCHES == before + 1
        assert got.is_contiguous() and got.device.type == "cuda"
        assert same_bytes(got, tk.transpose_last2_plain(x))
    # strided sources: row- and column-slice views are read in place, a
    # transposed or strided-last-axis view is made contiguous first
    x = random_bytes((900, 700), dtype, cuda, seed=9)
    for view in (x[100:400], x[:, 37:500], x[5:300, 134:], x.mT, x[:, ::3], x[None, 10:20]):
        assert same_bytes(tk.transpose_last2_cuda(view), tk.transpose_last2_plain(view))


@pytest.mark.gpu
def test_transpose_kernel_refuses_what_it_does_not_take(cuda):
    from dask_array_tpu_torch.kernels import transpose as tk

    before = tk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.transpose_last2_cuda(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="2 dimensions"):
        tk.transpose_last2_cuda(torch.zeros(4, device=cuda))
    assert tk.LAUNCHES == before
    # an empty input launches nothing and gives the swapped empty shape
    assert tuple(tk.transpose_last2_cuda(torch.zeros((0, 5), device=cuda)).shape) == (5, 0)
    # a lazy conjugate view is resolved before the bytes move
    z = torch.randn((33, 17), dtype=torch.complex64, device=cuda)
    assert torch.equal(tk.transpose_last2_cuda(z.conj()), z.conj().mT.resolve_conj())


@pytest.mark.gpu
@pytest.mark.parametrize("persist", [False, True])
def test_rechunk_relayout_on_the_card_launches_the_kernel(cuda, persist):
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models.pipelines import rechunk_relayout

    x = np.random.default_rng(5).standard_normal((1024, 768)).astype(np.float32)
    with config.set({"device": "cuda"}):
        y = rechunk_relayout(x, chunk=128, persist=persist)
        assert y.chunks == ((128,) * 6, (1024,))
        before = tk.LAUNCHES
        dev = y.compute_device()
        assert tk.LAUNCHES == before + 1
        assert dev.device.type == "cuda" and dev.is_contiguous()
        np.testing.assert_array_equal(dev.cpu().numpy(), x.T)
        np.testing.assert_array_equal(y.compute(), x.T)


# (shape, widths, modes): every mode, widths past the axis, constant corners
# against index-map axes, per-side fills, unpadded axes that merge
HALO_CASES = [
    ((1000, 1003), ((1, 1), (1, 1)), ("symmetric", "symmetric")),
    ((1000, 1003), ((3, 0), (0, 5)), ("reflect", "wrap")),
    ((257, 300), ((8, 8), (8, 8)), ("edge", (1.5, -2.0))),
    ((3, 5), ((7, 7), (7, 6)), ("wrap", "symmetric")),
    ((3, 5), ((7, 2), (9, 7)), ("reflect", "reflect")),
    ((40, 50), ((2, 3), (4, 1)), (2.5, "edge")),
    ((40, 50), ((2, 3), (4, 1)), ((1.0, -1.0), (7.0, 3.0))),
    ((5000,), ((17, 3),), ("symmetric",)),
    ((1, 7), ((2, 2), (3, 0)), ("reflect", "edge")),
    ((6, 33, 17), ((1, 2), (0, 0), (3, 1)), ("wrap", "edge", 0.0)),
    ((2, 3, 4, 5, 6), ((0, 0), (0, 0), (1, 1), (0, 0), (2, 0)), ("edge", "edge", (4.0, 5.0), "edge", "wrap")),
    ((0, 9), ((2, 1), (1, 1)), (3.0, "edge")),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TRANSPOSE_DTYPES, ids=str)
def test_halo_kernel_matches_plain_byte_for_byte(cuda, dtype):
    from dask_array_tpu_torch.kernels import halo

    for i, (shape, widths, modes) in enumerate(HALO_CASES):
        x = random_bytes(shape, dtype, cuda, seed=i)
        before = halo.LAUNCHES
        got = halo.halo_pad_cuda(x, widths, modes)
        assert halo.LAUNCHES == before + 1
        assert got.is_contiguous() and got.device.type == "cuda"
        assert same_bytes(got, halo.halo_pad_plain(x, widths, modes)), (shape, widths, modes)
    # sliced views are read in place through their strides
    x = random_bytes((900, 700), dtype, cuda, seed=99)
    for view in (x[100:400], x[:, 37:500], x[5:300, 134:], x.mT, x[:, ::3]):
        for modes in (("symmetric", "wrap"), (1.0, "reflect")):
            widths = ((2, 1), (3, 3))
            assert same_bytes(halo.halo_pad_cuda(view, widths, modes), halo.halo_pad_plain(view, widths, modes))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bool, torch.float16, torch.float32, torch.float64, torch.complex128], ids=str)
@pytest.mark.parametrize("lo", range(5))
def test_halo_row_kernel_matches_strided_kernel_byte_for_byte(cuda, dtype, lo):
    """Element sizes 1, 2, 4, 8 and 16 bytes, lo 0-4 on the last axis: the
    row kernel (a contiguous input; a view one element into its rows, whose
    source it realigns) and the strided kernel (the same values laid out
    column-major) against each other and the plain version."""
    from dask_array_tpu_torch.kernels import halo

    x = random_bytes((67, 1001), dtype, cuda, seed=lo)
    column_major = x.mT.contiguous().mT
    shifted = random_bytes((67, 1003), dtype, cuda, seed=10 + lo)[:, 1:1002]
    for mode in ("symmetric", "reflect", "edge", "wrap", (0.5, -1.0)):
        widths, modes = ((1, 2), (lo, 3)), ("edge", mode)
        assert halo.kernel_for(x, widths, modes) == "rows"
        assert halo.kernel_for(shifted, widths, modes) == "rows"
        assert halo.kernel_for(column_major, widths, modes) == "strided"
        rows = halo.halo_pad_cuda(x, widths, modes)
        assert same_bytes(rows, halo.halo_pad_plain(x, widths, modes))
        assert same_bytes(halo.halo_pad_cuda(column_major, widths, modes), rows)
        assert same_bytes(halo.halo_pad_cuda(shifted, widths, modes), halo.halo_pad_plain(shifted, widths, modes))


@pytest.mark.gpu
def test_halo_kernel_fill_is_converted_as_the_plain_version(cuda):
    from dask_array_tpu_torch.kernels import halo

    x = torch.arange(12, device=cuda).reshape(3, 4)
    for fill in (0.5, -1.5, 7):
        got = halo.halo_pad_cuda(x, ((1, 1), (2, 0)), (fill, "edge"))
        assert torch.equal(got, halo.halo_pad_plain(x, ((1, 1), (2, 0)), (fill, "edge")))
    z = torch.zeros((4, 4), dtype=torch.bool, device=cuda)
    assert bool(halo.halo_pad_cuda(z, ((1, 0), (0, 0)), (2, "edge"))[0].all())


@pytest.mark.gpu
def test_halo_kernel_refuses_what_it_does_not_take(cuda):
    from dask_array_tpu_torch.kernels import halo

    before = halo.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        halo.halo_pad_cuda(torch.zeros((4, 4)), ((1, 1), (1, 1)), ("edge", "edge"))
    with pytest.raises(ValueError, match="empty axis"):
        halo.halo_pad_cuda(torch.zeros((0, 4), device=cuda), ((1, 1), (0, 0)), ("edge", "edge"))
    with pytest.raises(ValueError, match="unknown mode"):
        halo.halo_pad_cuda(torch.zeros((4, 4), device=cuda), ((1, 1), (0, 0)), ("nearest", "edge"))
    nine = torch.zeros((2,) * 9, device=cuda)
    with pytest.raises(ValueError, match="at most 8"):
        halo.halo_pad_cuda(nine, ((1, 0),) * 9, ("edge",) * 9)
    assert halo.LAUNCHES == before
    # a 9-d tensor with one unpadded pair merges to 8 axes and goes through
    got = halo.halo_pad_cuda(nine, ((1, 0),) * 7 + ((0, 0),) * 2, ("edge",) * 9)
    assert torch.equal(got, halo.halo_pad_plain(nine, ((1, 0),) * 7 + ((0, 0),) * 2, ("edge",) * 9))
    # a lazy conjugate view is resolved before the bytes move
    zc = torch.randn((33, 17), dtype=torch.complex64, device=cuda).conj()
    assert torch.equal(halo.halo_pad_cuda(zc, ((1, 1), (1, 1)), ("wrap", "wrap")),
                       halo.halo_pad_plain(zc.resolve_conj(), ((1, 1), (1, 1)), ("wrap", "wrap")))


def _np_laplace(x):
    p = np.pad(x.astype(np.float64), 1, mode="symmetric")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]


@pytest.mark.gpu
def test_general_halo_path_on_the_card_launches_the_halo_kernel(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import halo, stencil
    from dask_array_tpu_torch.models.pipelines import laplace_roll, stencil2d

    x = np.random.default_rng(6).standard_normal((512, 384)).astype(np.float32)
    want = _np_laplace(x)
    with config.set({"device": "cuda"}):
        for arr, expect in (
            (stencil2d(x, chunk=128, form="slices"), want),
            (da.map_overlap(lambda b: torch.tanh(laplace_roll(b)), da.from_array(x, chunks=128),
                            depth=1, boundary="reflect"), np.tanh(want)),
        ):
            h0, s0 = halo.LAUNCHES, stencil.LAUNCHES
            got = arr.compute()
            assert (halo.LAUNCHES - h0, stencil.LAUNCHES - s0) == (1, 0)
            np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4)
        # boundary "none" pads nothing and launches nothing
        h0 = halo.LAUNCHES
        got = da.map_overlap(lambda b: b * 2, da.from_array(x, chunks=128), depth=1, boundary="none").compute()
        assert halo.LAUNCHES == h0
        np.testing.assert_array_equal(got, x * 2)


@pytest.mark.gpu
def test_pad_sliding_and_push_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import halo
    from dask_array_tpu_torch.ops._sliding import move_mean, move_std

    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 257)).astype(np.float32)
    v = rng.standard_normal(5000)
    v[rng.random(5000) < 0.2] = np.nan
    swv = np.lib.stride_tricks.sliding_window_view
    with config.set({"device": "cuda"}):
        d = da.from_array(x, chunks=100)
        for mode in ("constant", "edge", "reflect", "symmetric", "wrap"):
            h0 = halo.LAUNCHES
            got = da.pad(d, ((3, 5), (7, 2)), mode=mode).compute()
            assert halo.LAUNCHES == h0 + 1
            np.testing.assert_array_equal(got, np.pad(x, ((3, 5), (7, 2)), mode=mode))
        for mode, kw in (("linear_ramp", {"end_values": 2}), ("mean", {})):
            got = da.pad(d, ((3, 5), (7, 2)), mode=mode, **kw).compute()
            np.testing.assert_allclose(got, np.pad(x, ((3, 5), (7, 2)), mode=mode, **kw), rtol=1e-5, atol=1e-6)
        dv = da.from_array(v, chunks=1000)
        np.testing.assert_allclose(da.sliding_window_view(dv, 64).sum(-1).compute(), swv(v, 64).sum(-1),
                                   rtol=1e-10, equal_nan=True)
        m = move_mean(dv, 64, min_count=1).compute()
        s = move_std(dv, 64, min_count=2).compute()
        np.testing.assert_array_equal(da.push(dv, 3).compute(), _np_push(v, 3))
    for i in (100, 2500, 4999):
        w = v[i - 63:i + 1]
        np.testing.assert_allclose(m[i], np.nanmean(w), rtol=1e-10)
        np.testing.assert_allclose(s[i], np.nanstd(w), rtol=1e-8)


def _np_push(v, n):
    out = v.copy()
    last = -1
    for i in range(len(v)):
        if not np.isnan(v[i]):
            last = i
        elif last >= 0 and i - last <= n:
            out[i] = v[last]
    return out


SCALE_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64]


def same_values(a, b):
    """Equal bytes, a NaN matching any NaN (the kernel and torch may
    canonicalise a NaN differently)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(((a.view(bits) == b.view(bits)) | (a.isnan() & b.isnan())).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SCALE_DTYPES, ids=str)
def test_scale_kernel_matches_plain_byte_for_byte(cuda, dtype):
    from dask_array_tpu_torch.kernels import scale as sk

    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in [(256, 256), (1000, 1003), (1, 7), (4097, 33), (3, 5, 130)]:
        x = (torch.randn(shape, generator=gen, device=cuda) * 100).to(dtype)
        x.view(-1)[::97] = float("nan")
        for s in (2.0, 0.1, -0.0, 3, torch.randn((), device=cuda).to(dtype), torch.randn(shape[-1], device=cuda).to(dtype),
                  torch.randn((1, shape[-1]), device=cuda).to(dtype)):
            before = sk.LAUNCHES
            got = sk.scale_cuda(x, s)
            assert sk.LAUNCHES == before + 1 and got.is_contiguous()
            assert same_values(got, sk.scale_plain(x, s))
        if len(shape) == 2:
            col = torch.randn((shape[0], 1), generator=gen, device=cuda).to(dtype)
            assert same_values(sk.scale_cuda(x, col), sk.scale_plain(x, col))
    # a column-sliced view is read in place, a strided one is made contiguous
    x = torch.randn((900, 700), generator=gen, device=cuda).to(dtype)
    row = torch.randn((1, 300), device=cuda).to(dtype)
    for view in (x[:, 100:400], x[50:, 200:500], x[:, ::2][:, :300]):
        assert same_values(sk.scale_cuda(view, row), sk.scale_plain(view, row))
    # 1-D, an unaligned 1-D view (no 16-byte vectors) and narrow last axes
    flat = torch.randn((100_003,), generator=gen, device=cuda).to(dtype)
    for view, s in ((flat, 2.0), (flat[1:], 0.5), (flat[3:], torch.randn((100_000,), device=cuda).to(dtype))):
        assert same_values(sk.scale_cuda(view, s), sk.scale_plain(view, s))
    for cols in (1, 3, 5):
        x = torch.randn((10_007, cols), generator=gen, device=cuda).to(dtype)
        for s in (0.3, torch.randn((1, cols), device=cuda).to(dtype), torch.randn((10_007, 1), device=cuda).to(dtype)):
            assert same_values(sk.scale_cuda(x, s), sk.scale_plain(x, s))


@pytest.mark.gpu
def test_scale_kernel_refuses_what_it_does_not_take(cuda):
    from dask_array_tpu_torch.kernels import scale as sk

    before = sk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.scale_cuda(torch.zeros((4, 4)), 2.0)
    with pytest.raises(TypeError, match="float16, bfloat16"):
        sk.scale_cuda(torch.zeros((4, 4), dtype=torch.int32, device=cuda), 2)
    with pytest.raises(ValueError, match="scalar, row or column"):
        sk.scale_cuda(torch.zeros((4, 4), device=cuda), torch.ones((4, 4), device=cuda))
    assert tuple(sk.scale_cuda(torch.zeros((0, 5), device=cuda), 2.0).shape) == (0, 5)
    assert sk.LAUNCHES == before


@pytest.mark.gpu
def test_tall_skinny_svd_on_the_card(cuda):
    from dask_array_tpu_torch import compute, config
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.models.pipelines import tall_skinny_svd
    from dask_array_tpu_torch.ops import linalg_decomp as ld

    x = np.random.default_rng(6).standard_normal((20000, 32)).astype(np.float32)
    with config.set({"device": "cuda"}):
        arrays = tall_skinny_svd(x, chunk_rows=2500)
        sk.LAUNCHES = 0
        before = ld.FACTORIZATIONS
        u, s, vh = compute(*arrays)
        assert sk.LAUNCHES == 3 and ld.FACTORIZATIONS - before == 1
    np.testing.assert_allclose(s, np.linalg.svd(x.astype(np.float64), compute_uv=False), rtol=1e-4)
    assert np.linalg.norm((u * s) @ vh - x) / np.linalg.norm(x) < 20 * 2.0**-23 * 32
    assert np.abs(u.T @ u - np.eye(32)).max() < 20 * 2.0**-23 * 32
    assert (vh.sum(axis=1) >= 0).all()


@pytest.mark.gpu
def test_uint64_arithmetic_and_order_above_2_63_on_the_card(cuda):
    """A uint64 sum takes arithmetic; uint64 values of 2**63 and more keep
    numpy's order, division and float conversion on the card."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    with config.set({"device": "cuda"}):
        x = da.from_array(np.arange(42, dtype=np.uint8).reshape(6, 7), chunks=3)
        got = (x.sum() + 1).compute()
        assert got == np.uint64(862) and np.asarray(got).dtype == np.uint64
        a = np.array([[2**63 + 7, 5, 2**64 - 1], [0, 2**63, 2**63 - 1]], dtype=np.uint64)
        d = da.from_array(a, chunks=2)
        cases = {"max": (d.max(), a.max()), "argmax": (d.argmax(), a.argmax()), "// 3": (d // 3, a // 3),
                 "% 7": (d % 7, a % 7), ">> 1": (d >> 1, a >> 1), "< 2**63": (d < 2**63, a < 2**63),
                 "astype(float64)": (d.astype(np.float64), a.astype(np.float64)), "* 3 + 1": (d * 3 + 1, a * 3 + 1),
                 "mean": (d.mean(), a.mean())}
        for name, (got, want) in cases.items():
            got = np.asarray(got.compute())
            assert got.dtype == np.asarray(want).dtype, name
            if name == "mean":  # the card sums in another order than numpy
                np.testing.assert_allclose(got, want, rtol=1e-15, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_unsigned_layout_goes_through_the_kernels_byte_for_byte(cuda, dtype):
    """x.T through the transpose kernel and pad through the halo kernel, in
    the unsigned dtypes, equal to numpy byte for byte."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import halo
    from dask_array_tpu_torch.kernels import transpose as tk

    a = np.random.default_rng(3).integers(0, np.iinfo(dtype).max, size=(300, 257), dtype=dtype, endpoint=True)
    with config.set({"device": "cuda"}):
        x = da.from_array(a, chunks=100)
        before = (tk.LAUNCHES, halo.LAUNCHES)
        t = x.T.compute()
        p = da.pad(x, ((2, 1), (0, 3)), mode="symmetric").compute()
        assert tk.LAUNCHES > before[0] and halo.LAUNCHES > before[1]
    assert t.dtype == a.dtype and t.tobytes() == np.ascontiguousarray(a.T).tobytes()
    want = np.pad(a, ((2, 1), (0, 3)), mode="symmetric")
    assert p.dtype == want.dtype and p.tobytes() == want.tobytes()



@pytest.mark.gpu
def test_out_of_range_index_raises_and_the_card_keeps_working(cuda):
    """An index out of range raises numpy's IndexError before any gather on
    the card (a device-side assert would leave the CUDA context unusable),
    and the next compute() in the process works."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    a = np.arange(60, dtype=np.float32).reshape(6, 10)
    with config.set({"device": "cuda"}):
        x = da.from_array(a, chunks=3)
        with pytest.raises(IndexError):
            x[[10**9]]
        with pytest.raises(IndexError):
            x[da.from_array(np.array([1, 10**9]), chunks=1)].compute()
        with pytest.raises(IndexError):
            x.vindex[da.from_array(np.array([-7]), chunks=1), [0]].compute()
        with pytest.raises(IndexError):
            z = da.from_array(a, chunks=3)
            z[da.from_array(np.array([0, 99]))] = 1.0
            z.compute()
        got = x[da.from_array(np.array([5, -6]), chunks=1)].compute()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, a[[5, -6]])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nextafter", "spacing", "i0", "sinc"])
def test_float16_ufuncs_on_the_card(cuda, name):
    """float16 nextafter/spacing equal numpy's; sinc to 2 units in the last
    place of numpy's float16 sinc, i0 of numpy's float64 i0 rounded to
    float16."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    fi = np.finfo(np.float16)
    a = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -65504.0, 65504.0, fi.smallest_subnormal, np.inf, -np.inf, np.nan,
                  1e-3, 7.0, -3.5, 11.0, 0.25], np.float16).reshape(4, 4)
    b = np.roll(a, 3)
    with np.errstate(all="ignore"), config.set({"device": "cuda"}):
        x, y = da.from_array(a, chunks=2), da.from_array(b, chunks=2)
        if name == "nextafter":
            got, want = da.nextafter(x, y).compute(), np.nextafter(a, b)
        elif name == "spacing":
            got, want = da.spacing(x).compute(), np.spacing(a)
        elif name == "sinc":  # numpy's float16 steps (pi * x rounded to float16 first)
            got, want = da.sinc(x).compute(), np.sinc(a)
        else:
            got, want = da.i0(x).compute(), np.i0(a.astype(np.float64)).astype(np.float16)
    assert got.dtype == np.float16
    if name in ("nextafter", "spacing"):
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2 * np.spacing(np.abs(want))
        assert np.all((np.abs(got - want) <= tol) | (got == want) | (np.isnan(got) & np.isnan(want))), (got, want)


@pytest.mark.gpu
def test_compute_chunk_sizes_keeps_the_blocks_on_the_card(cuda):
    """x[x > 0].compute_chunk_sizes(): the grid is kept, its blocks are the
    CUDA tensors the boolean index computed, one host sync per block."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.ops import _fancy_indexing
    from dask_array_tpu_torch.ops._blocks import FromBlocks

    a = np.random.default_rng(8).standard_normal((64, 48)).astype(np.float32)
    with config.set({"device": "cuda"}):
        x = da.from_array(a, chunks=16)
        y = x[x > 0]
        nblocks = len(y.chunks[0])
        _fancy_indexing.SYNCS = 0
        y.compute_chunk_sizes()
        assert _fancy_indexing.SYNCS == nblocks
        assert isinstance(y.expr, FromBlocks) and len(y.chunks[0]) == nblocks
        assert all(t.device.type == "cuda" for t in y.expr.blocks.values())
        np.testing.assert_array_equal(y.compute(), a[a > 0])
        np.testing.assert_array_equal(y[5:].compute(), a[a > 0][5:])


@pytest.mark.gpu
def test_unique_on_the_card(cuda):
    """unique's four outputs (NaNs folded into one, numpy 2's rule) from one
    sort and one sync on the card."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.ops import _fancy_indexing

    rng = np.random.default_rng(9)
    a = np.round(rng.standard_normal(5000) * 3, 1)
    a[::97] = np.nan
    a[1::101] = -0.0
    with config.set({"device": "cuda"}):
        outs = da.unique(da.from_array(a, chunks=700), return_index=True, return_inverse=True, return_counts=True)
        _fancy_indexing.SYNCS = 0
        got = da.compute(*outs)
        assert _fancy_indexing.SYNCS == 1
    want = np.unique(a, return_index=True, return_inverse=True, return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.ravel(g), np.ravel(w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int64", "uint64"])
def test_histogram_with_int64_edges_on_the_card(cuda, dtype):
    """Integer edges up to INT64_MAX: the last bin closed with no edge + 1;
    int64 data against float edges compared in float64, as numpy does."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    top = np.iinfo(np.int64).max
    a = np.array([top, top - 1, 0, 5, 3, top, 2**62, 2**53 + 1], dtype=dtype)
    edges = np.array([0, 4, 2**62, top], dtype=np.int64)
    fedges = np.array([0.0, 2.0**53, 2.0**53 + 2, 1e19])
    with config.set({"device": "cuda"}):
        x = da.from_array(a, chunks=3)
        h, e = da.histogram(x, bins=edges)
        hf, _ = da.histogram(x, bins=fedges)
        got, got_e, got_f = h.compute(), e.compute(), hf.compute()
    np.testing.assert_array_equal(got, np.histogram(a, bins=edges)[0])
    np.testing.assert_array_equal(got_e, edges)
    np.testing.assert_array_equal(got_f, np.histogram(a, bins=fedges)[0])


@pytest.mark.gpu
def test_topk_of_uint64_with_negative_k_on_the_card(cuda):
    """k < 0 gives the smallest values in unsigned order (never a negation);
    NaN counts as the largest float."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    u = np.array([2**64 - 1, 2**63, 1, 0, 2**63 + 5, 7], np.uint64)
    f = np.array([1.0, np.nan, -1.0, 3.0, np.inf], np.float32)
    with config.set({"device": "cuda"}):
        got_u = da.topk(da.from_array(u, chunks=4), -3).compute()
        got_top = da.topk(da.from_array(u, chunks=4), 2).compute()
        got_f = da.topk(da.from_array(f, chunks=2), 2).compute()
        got_i = da.argtopk(da.from_array(f, chunks=2), -2).compute()
    np.testing.assert_array_equal(got_u, np.array([0, 1, 7], np.uint64))
    np.testing.assert_array_equal(got_top, np.array([2**64 - 1, 2**63 + 5], np.uint64))
    np.testing.assert_array_equal(got_f, np.array([np.nan, np.inf], np.float32))
    np.testing.assert_array_equal(got_i, [2, 0])


@pytest.mark.gpu
def test_quantile_past_2_24_elements_on_the_card(cuda):
    """torch.quantile refuses more than 2**24 values; the port sorts and
    gathers, so a quantile of 2**24 + 3 values works, with numpy's value."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    b = np.random.default_rng(10).standard_normal((1 << 24) + 3).astype(np.float32)
    a = b.copy()
    a[::1000] = np.nan
    with config.set({"device": "cuda"}):
        q = da.nanquantile(da.from_array(a, chunks=1 << 22), [0.01, 0.5, 0.99]).compute()
        m = da.median(da.from_array(b, chunks=1 << 22)).compute()
    np.testing.assert_allclose(q, np.nanquantile(a, [0.01, 0.5, 0.99]), rtol=1e-6)
    assert m == np.median(b)


@pytest.mark.gpu
def test_ravel_multi_index_raise_then_a_working_compute_on_the_card(cuda):
    """mode "raise": numpy's ValueError from a device-side range check, with
    no device assert; the next compute() in the process works."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    with config.set({"device": "cuda"}):
        bad = (da.from_array(np.array([0, 5, 1]), chunks=2), da.from_array(np.array([1, 1, 0]), chunks=2))
        with pytest.raises(ValueError, match="invalid entry"):
            da.ravel_multi_index(bad, (3, 4)).compute()
        with pytest.raises(ValueError, match="Sorter index out of range"):
            da.searchsorted(da.arange(5.0, chunks=2), da.from_array(np.array([1.5])),
                            sorter=da.from_array(np.array([0, 1, 2, 3, 9]))).compute()
        ok = (da.from_array(np.array([0, 2, 1]), chunks=2), bad[1])
        got = da.ravel_multi_index(ok, (3, 4)).compute()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, np.ravel_multi_index(([0, 2, 1], [1, 1, 0]), (3, 4)))


@pytest.mark.gpu
def test_repeat_with_counts_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    a = np.arange(48, dtype=np.float32).reshape(8, 6)
    counts = [0, 2, 1, 3, 0, 1, 1, 2]
    with config.set({"device": "cuda"}):
        got = da.repeat(da.from_array(a, chunks=3), counts, axis=0).compute()
        flat = da.from_array(a, chunks=3).repeat(np.arange(48) % 3).compute()
    np.testing.assert_array_equal(got, np.repeat(a, counts, axis=0))
    np.testing.assert_array_equal(flat, np.repeat(a, np.arange(48) % 3))


@pytest.mark.gpu
def test_cov_launches_the_transpose_and_scale_kernels(cuda):
    """cov's conj(Xc).T goes through the transpose kernel, a weighted
    cov's Xc * w and the 1 / fact multiply through the scale kernel."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk

    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 3000)).astype(np.float32)
    w = rng.random(3000) + 0.5
    with config.set({"device": "cuda"}):
        tk.LAUNCHES = sk.LAUNCHES = 0
        got = da.cov(da.from_array(x, chunks=(16, 700)), aweights=w).compute()
        assert tk.LAUNCHES >= 1 and sk.LAUNCHES >= 1
        cc = da.corrcoef(da.from_array(x, chunks=(16, 700))).compute()
    np.testing.assert_allclose(got, np.cov(x, aweights=w), rtol=1e-10)
    np.testing.assert_allclose(cc, np.corrcoef(x), rtol=1e-10, atol=1e-14)


@pytest.mark.gpu
def test_a_random_leaf_on_the_card_is_deterministic_and_grid_independent(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    with config.set({"device": "cuda"}):
        def draw(chunks, seed=0):
            return da.random.default_rng(seed).standard_normal((1000, 600), dtype="float32", chunks=chunks)

        a = draw(7).compute_device()
        assert a.device.type == "cuda" and a.dtype == torch.float32
        assert torch.equal(a, draw(7).compute_device())  # one seed, the same bytes
        assert torch.equal(a, draw(250).compute_device())  # another grid, the same bytes
        assert torch.equal(a, draw(7).rechunk((300, 600)).compute_device())
        r = da.random.default_rng(0)
        first, second = r.standard_normal((1000, 600), chunks=250), r.standard_normal((1000, 600), chunks=250)
        assert not torch.equal(first.compute_device(), second.compute_device())
        card = da.random.default_rng(5).random(1000).compute()
    with config.set({"device": "cpu"}):
        host = da.random.default_rng(5).random(1000).compute()
    # one seed, two generators: the card's stream is not the CPU's
    assert not np.array_equal(card, host)


@pytest.mark.gpu
@pytest.mark.parametrize("name, call, law", [
    ("standard_normal", lambda r, n: r.standard_normal(n), ("norm", ())),
    ("gamma", lambda r, n: r.gamma(2.5, 1.5, n), ("gamma", (2.5, 0, 1.5))),
    ("binomial", lambda r, n: r.binomial(10, 0.3, n), ("binom", (10, 0.3))),
    ("poisson", lambda r, n: r.poisson(4, n), ("poisson", (4,))),
    ("vonmises", lambda r, n: r.vonmises(0.0, 2, n), ("vonmises", (2,))),
    ("zipf", lambda r, n: r.zipf(6, n), ("zipf", (6,))),
    ("hypergeometric", lambda r, n: r.hypergeometric(20, 30, 10, n), ("hypergeom", (50, 20, 10))),
    ("integers", lambda r, n: r.integers(-5, 12, n), ("randint", (-5, 12))),
    ("multinomial", lambda r, n: r.multinomial(20, [0.2, 0.3, 0.5], n)[:, 1], ("binom", (20, 0.3))),
    ("multivariate_normal", lambda r, n: r.multivariate_normal([1.0, -2.0], [[2.0, 0.5], [0.5, 1.0]], n)[:, 0],
     ("norm", (1.0, 2.0**0.5))),
])
def test_distributions_on_the_card_follow_their_laws(cuda, name, call, law):
    """Mean and variance within 6 standard errors of scipy's, 1e5 draws."""
    from scipy import stats

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    n = 100_000
    with config.set({"device": "cuda"}):
        x = call(da.random.default_rng(11), n).compute().astype(np.float64)
    mean, var, kurt = (float(v) for v in getattr(stats, law[0])(*law[1]).stats(moments="mvk"))
    assert np.isfinite(x).all()
    assert abs(x.mean() - mean) <= 6 * np.sqrt(var / n)
    assert abs(x.var() - var) <= 6 * np.sqrt((kurt + 2) * var**2 / n)


@pytest.mark.gpu
def test_integers_up_to_2_64_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    with config.set({"device": "cuda"}):
        r = da.random.default_rng(3)
        u = r.integers(0, 2**64, size=10_000, dtype=np.uint64).compute()
        w = r.integers(0, 2**63 + 2**61, size=10_000, dtype=np.uint64).compute()
        s = r.integers(-(2**63), 2**63, size=10_000).compute()
    assert u.dtype == np.uint64 and (u >= 2**63).any() and (u < 2**63).any()
    assert w.max() < 2**63 + 2**61 and (w >= 2**63).any()
    assert s.dtype == np.int64 and (s < 0).any() and (s > 0).any()


FFT_CASES = [(kind, kw, dtype)
             for kind, kw in [("fft", {}), ("rfft", {"axis": 0}), ("irfft", {"n": 30}), ("fft2", {}),
                              ("ifftn", {"axes": (0, 1)}), ("hfft", {}), ("rfftn", {"s": (32, 20), "axes": (0, 1)})]
             for dtype in ["float16", "float32", "float64", "complex64", "int32"]
             if not (dtype == "complex64" and kind in ("rfft", "rfftn"))]  # numpy refuses those


@pytest.mark.gpu
@pytest.mark.parametrize("kind, kw, dtype", FFT_CASES)
def test_fft_on_the_card_against_numpy(cuda, dtype, kind, kw):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    rng = np.random.default_rng(4)
    a = rng.standard_normal((48, 30)) * 3
    if dtype == "complex64":
        a = a + 1j * rng.standard_normal((48, 30))
    a = a.astype(dtype)
    want = getattr(np.fft, kind)(a, **kw)
    with config.set({"device": "cuda"}):
        got = getattr(da.fft, kind)(da.from_array(a, chunks=-1), **kw).compute()
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 2.0**-10 if dtype == "float16" else 1e-5 if want.dtype in (np.complex64, np.float32) else 1e-12
    scale = float(np.abs(want).max())
    assert float(np.abs(got.astype(np.complex128) - want).max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, tol", [("float64", 1e-8), ("float32", 1e-4)])
def test_svd_compressed_on_the_card(cuda, dtype, tol):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import scale as sk

    rng = np.random.default_rng(7)
    k = 8
    u0, _ = np.linalg.qr(rng.standard_normal((4000, k)))
    v0, _ = np.linalg.qr(rng.standard_normal((200, k)))
    x = ((u0 * np.linspace(9.0, 2.0, k)) @ v0.T).astype(dtype)
    with config.set({"device": "cuda"}):
        sk.LAUNCHES = 0
        u, s, vh = da.compute(*da.svd_compressed(da.from_array(x, chunks=(500, 200)), k, n_power_iter=2, seed=0))
        assert sk.LAUNCHES >= 1  # svd_flip's multiplies
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)[:k]
    assert s.dtype == np.dtype(dtype) and u.shape == (4000, k) and vh.shape == (k, 200)
    np.testing.assert_allclose(s, want, rtol=0, atol=tol * want[0])
    assert (vh.astype(np.float64).sum(axis=1) >= 0).all()


@pytest.mark.gpu
def test_multi_output_map_blocks_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.ops._map_blocks import map_blocks_multi_output

    calls = []

    def sin_cos(b):
        calls.append(b.device.type)
        return torch.sin(b), torch.cos(b)

    x = np.random.default_rng(8).standard_normal((300, 200)).astype(np.float32)
    with config.set({"device": "cuda"}):
        s, c = map_blocks_multi_output(sin_cos, da.from_array(x, chunks=100), dtypes=["f4", "f4"])
        got_s, got_c = da.compute(s, c)
    assert calls == ["cuda"] * 6
    np.testing.assert_allclose(got_s, np.sin(x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_c, np.cos(x), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_random_input_pipelines_on_the_card_launch_their_kernels(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import mstat, stencil
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models import pipelines as p

    with config.set({"device": "cuda"}):
        mstat.LAUNCHES = stencil.LAUNCHES = tk.LAUNCHES = 0
        tree = da.compute(*p.reduction_tree(chunk=100, n=600))
        assert mstat.LAUNCHES == 1
        st = p.stencil2d(chunk=128, form="roll", n=512).compute()
        assert stencil.LAUNCHES == 1
        rel = p.rechunk_relayout(chunk=128, n=512).compute()
        assert tk.LAUNCHES == 1
        x = da.random.default_rng(0).standard_normal((600, 600), dtype="float32", chunks=100).compute()
        x2 = da.random.default_rng(0).standard_normal((512, 512), dtype="float32", chunks=128).compute()
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(tree[0], x64.sum(0), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tree[2], x64.std(), rtol=1e-4)
    assert rel.tobytes() == np.ascontiguousarray(x2.T).tobytes()
    assert st.shape == (512, 512) and np.isfinite(st).all()


@pytest.mark.gpu
def test_svd_of_a_numerically_rank_deficient_float32_panel_on_the_card(cuda):
    """The Gram's eigendecomposition of a float32 R whose squared condition
    passes 1/eps runs in float64: cuSOLVER's float32 syevd did not
    converge on such a panel (rank 32 plus 1e-4 noise, 1e6 x 1024)."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    rng = np.random.default_rng(9)
    x = rng.standard_normal((50_000, 16)) @ rng.standard_normal((16, 512)) + 1e-4 * rng.standard_normal((50_000, 512))
    x = x.astype(np.float32)
    with config.set({"device": "cuda"}):
        s = da.linalg.svd(da.from_array(x, chunks=(5000, 512)))[1].compute()
        cs = da.svd_compressed(da.from_array(x, chunks=(5000, 512)), 16, n_power_iter=2, seed=0)[1].compute()
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    rel = np.abs(s - want) / want
    assert rel[:16].max() <= 2.0**-20 and rel.max() <= 1e-3
    assert (np.abs(cs - want[:16]) / want[:16]).max() <= 1e-3


# -- the histogram kernel (K2) ---------------------------------------------------------

HIST_REAL = ["bool", "uint8", "int8", "int16", "uint16", "int32", "uint32", "int64", "uint64", "float16", "float32",
             "float64"]


def _hist_data(dtype, n, seed=0):
    """Values in about [-12, 12] with ties; NaN, ±inf and -0.0 for floats."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.standard_normal(n) * 5, 1)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return a > 0
    if dt.kind == "u":
        a = np.abs(a)
    a = a.astype(dt)
    if dt.kind == "f" and n >= 4:
        a[:4] = [np.nan, np.inf, -np.inf, -0.0]
    return a


def _hist_check(a, edges, weights=None, offset=0):
    """The kernel against the plain version on the card and numpy: counts
    equal, weighted sums to rtol 1e-12 (the two add in other orders)."""
    from dask_array_tpu_torch.kernels import histogram as hk

    buf = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype), a])).cuda()
    x = buf[offset:]
    e = torch.from_numpy(np.asarray(edges)).cuda()
    w = None if weights is None else torch.from_numpy(weights).cuda()
    got = hk.histogram_counts_cuda(x, e, w).cpu().numpy()
    plain = hk.histogram_counts_plain(x, e, w).cpu().numpy()
    with np.errstate(all="ignore"):
        want = np.histogram(a, bins=edges, weights=weights)[0]
    if weights is None:
        np.testing.assert_array_equal(got, want.astype(np.int64))
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(weights).sum())
        np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12 * np.abs(weights).sum())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HIST_REAL)
@pytest.mark.parametrize("edges", ["uniform", "nonuniform", "int", "65536"])
@pytest.mark.parametrize("n", [0, 1, 1001, 1 << 16])
def test_histogram_kernel_every_real_dtype(cuda, dtype, edges, n):
    a = _hist_data(dtype, n, seed=n)
    e = {"uniform": np.linspace(-6.0, 6.0, 25), "nonuniform": np.array([-8.0, -1.5, 0.0, 0.0, 2.5, 3.0, 9.0]),
         "int": np.array([-5, -1, 0, 3, 8]),
         "65536": np.linspace(-13.0, 13.0, 65537)}[edges]  # past one copy a block: 16-bit counters
    _hist_check(a, e)
    _hist_check(a, e, offset=1)  # unaligned: element loads


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("real_edges", [True, False])
def test_histogram_kernel_complex_data(cuda, dtype, real_edges):
    """numpy's lexicographic order: a value on an edge with a negative
    imaginary part belongs below it; a NaN part drops the value."""
    rng = np.random.default_rng(3)
    a = (np.round(rng.standard_normal(5000) * 3, 0) + 1j * np.round(rng.standard_normal(5000), 1)).astype(dtype)
    a[:6] = [1 - 0.5j, 1 + 0j, 3 + 0.5j, complex(np.nan, 1), complex(1, np.nan), -3 - 1j]
    e = np.linspace(-3.0, 3.0, 7)
    _hist_check(a, e if real_edges else e.astype(dtype))
    _hist_check(a, np.array([-3.0, -1.0, 1.0, 1.5, 3.0]) if real_edges else e.astype(dtype) * (1 + 0.5j), offset=1)
    _hist_check(a, e, weights=rng.standard_normal(5000) * (1 - 2j))
    _hist_check(a.real.copy(), e.astype(dtype) * (1 + 0.5j))  # real data against complex edges


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int64", "uint64"])
def test_histogram_kernel_integer_edges_up_to_int64_max(cuda, dtype):
    top = np.iinfo(np.int64).max
    a = np.array([top, top - 1, 0, 5, 3, top, 2**62, 2**53 + 1] * 300, dtype=dtype)
    _hist_check(a, np.array([0, 4, 2**62, top], dtype=np.int64))
    _hist_check(a, np.array([0.0, 2.0**53, 2.0**53 + 2, 1e19]))


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", [1, 1 << 16])
@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_kernel_one_and_many_bins(cuda, nbins, weighted):
    a = np.random.default_rng(4).standard_normal(300_001)
    w = np.random.default_rng(5).standard_normal(300_001) if weighted else None
    _hist_check(a, np.linspace(-4, 4, nbins + 1), weights=w)
    _hist_check(a.astype(np.float32), np.sort(np.random.default_rng(6).standard_normal(nbins + 1)), weights=w)


@pytest.mark.gpu
def test_histogram_kernel_weighted_sums_repeat_their_bits(cuda):
    from dask_array_tpu_torch.kernels import histogram as hk

    x = torch.randn(1 << 22, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    w = torch.rand(1 << 22, device="cuda", dtype=torch.float64, generator=torch.Generator("cuda").manual_seed(1))
    e = torch.linspace(-4, 4, 257, device="cuda", dtype=torch.float64)
    assert hk.launch_plan(x.numel(), 256, hk._sm_count(0), 4, 1, 8).copies > 0
    runs = [hk.histogram_counts_cuda(x, e, w) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    wc = torch.complex(w, -w)
    runs = [hk.histogram_counts_cuda(x, e.sort().values ** 3 / 16, wc) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 300, 1 << 16])
@pytest.mark.parametrize("weighted", [False, True])
def test_bincount_kernel(cuda, length, weighted):
    from dask_array_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(length)
    a = rng.integers(0, length, 100_003)
    w = rng.standard_normal(100_003) if weighted else None
    x = torch.from_numpy(a).cuda()
    wt = None if w is None else torch.from_numpy(w).cuda()
    got = hk.bincount_cuda(x, length, wt).cpu().numpy()
    want = np.bincount(a, weights=w, minlength=length)
    if w is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(w).sum())
    assert hk.bincount_cuda(x[:0], 0).numel() == 0


# the bins around the shared-memory budget: three copies in exactly 48 KB
# (4096, float64 edges: the opt-in past 48 KB with the static share), one
# block's copy (57344), 16-bit counters (58112: one copy would take the
# whole 227 KB; 65536) and global atomics (131072, 2**20); weighted sums
# past a copy a warp in global atomics
BUDGET_BINS = [4096, 57344, 58112, 65536, 131072, 1 << 20]


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", BUDGET_BINS)
@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_kernel_at_the_shared_memory_budget(cuda, nbins, weighted):
    from dask_array_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(nbins)
    a = rng.uniform(-1.1, 1.1, 3_000_017).astype(np.float32)
    w = rng.standard_normal(a.size) if weighted else None
    edges = np.linspace(-1.0, 1.0, nbins + 1)
    plan = hk.launch_plan(a.size, nbins, hk._sm_count(0), 4, int(weighted), 8)
    assert plan.smem + hk.STATIC_SHARED <= hk.BLOCK_SHARED
    _hist_check(a, edges, weights=w)
    _hist_check(a, edges, weights=w, offset=1)


@pytest.mark.gpu
@pytest.mark.parametrize("length", BUDGET_BINS)
@pytest.mark.parametrize("weighted", [False, True])
def test_bincount_kernel_at_the_shared_memory_budget(cuda, length, weighted):
    from dask_array_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(length + 1)
    a = rng.integers(0, length, 3_000_017)
    w = rng.standard_normal(a.size) if weighted else None
    got = hk.bincount_cuda(torch.from_numpy(a).cuda(), length, None if w is None else torch.from_numpy(w).cuda())
    want = np.bincount(a, weights=w, minlength=length)
    if w is None:
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(w).sum())


@pytest.mark.gpu
def test_histogram_kernel_all_values_in_one_bin(cuda):
    """2**26 values in one of 65536 bins: the worst contention, and some 8
    wraps of the 16-bit counter in each block; the count is exact.  The same for a
    65536-bin bincount, into its first and its last bin."""
    from dask_array_tpu_torch.kernels import histogram as hk

    n = 1 << 26
    x = torch.full((n,), 0.3, device="cuda")
    e = torch.linspace(-4, 4, 65537, device="cuda", dtype=torch.float64)
    got = hk.histogram_counts_cuda(x, e)
    want = np.histogram(np.full(4, 0.3, np.float32), bins=e.cpu().numpy())[0] * (n // 4)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    for value in (0, 65535):
        got = hk.bincount_cuda(torch.full((n,), value, device="cuda", dtype=torch.int64), 65536).cpu().numpy()
        assert got[value] == n and got.sum() == n
    del x


@pytest.mark.gpu
def test_weighted_65536_bins_past_the_budget(cuda):
    """Weighted 65536-bin sums, past a copy a warp: within rtol 1e-12 of
    numpy on every run (float64 atomics in global memory: their order, and
    so the last bits, may change between runs)."""
    from dask_array_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(12)
    a = rng.integers(0, 65536, 1 << 22)
    w = rng.random(a.size)
    plan = hk.launch_plan(a.size, 65536, hk._sm_count(0), 8, 1, 0)
    assert plan.mode == hk.GLOBAL
    want = np.bincount(a, weights=w, minlength=65536)
    x, wt = torch.from_numpy(a).cuda(), torch.from_numpy(w).cuda()
    for _ in range(3):
        np.testing.assert_allclose(hk.bincount_cuda(x, 65536, wt).cpu().numpy(), want, rtol=1e-12, atol=0)
    h = rng.standard_normal(1 << 22)
    e = np.linspace(-4, 4, 65537)
    _hist_check(h, e, weights=w)
    _hist_check(h, e, weights=w * (1 - 2j))  # complex128 sums


@pytest.mark.gpu
def test_persisted_leaf_pickles_from_the_card(cuda):
    """A leaf persisted on the card pickles from host memory and loads on
    the configured device: the CPU, or the card."""
    import gc
    import pickle

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    a = np.random.default_rng(13).standard_normal((64, 32))
    with config.set({"device": "cuda"}):
        p = da.from_array(a, chunks=16).persist()
        blob = pickle.dumps((p + 1).sum(0))
        assert p.expr.buffer.device.type == "cuda"
    del p
    gc.collect()  # no leaf of that name is left: the load builds it from the pickled tensor
    with config.set({"device": "cpu"}):
        y = pickle.loads(blob)
        np.testing.assert_allclose(y.compute(), (a + 1).sum(0), rtol=1e-12)
    with config.set({"device": "cuda"}):
        np.testing.assert_allclose(pickle.loads(blob).compute(), (a + 1).sum(0), rtol=1e-12)


@pytest.mark.gpu
def test_histogram_and_bincount_launch_the_kernel(cuda):
    """Histogram._build and Bincount._build launch K2 on the card (never
    the plain version), and the kernel refuses what it does not take."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import histogram as hk

    a = np.random.default_rng(7).standard_normal(10_000).astype(np.float32)
    ints = np.random.default_rng(8).integers(0, 50, 10_000)
    with config.set({"device": "cuda"}):
        hk.LAUNCHES = 0
        h, _ = da.histogram(da.from_array(a, chunks=3000), bins=16, range=(-3, 3))
        hw, _ = da.histogram(da.from_array(a, chunks=3000), bins=16, weights=da.from_array(a, chunks=3000))
        b = da.bincount(da.from_array(ints, chunks=3000))
        got = da.compute(h, hw, b)
        assert hk.LAUNCHES == 3
    np.testing.assert_array_equal(got[0], np.histogram(a, bins=16, range=(-3, 3))[0])
    np.testing.assert_allclose(got[1], np.histogram(a, bins=16, weights=a)[0], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[2], np.bincount(ints))
    x = torch.zeros(4, device="cuda")
    with pytest.raises(ValueError):
        hk.histogram_counts_cuda(x, torch.zeros(1, device="cuda"))
    with pytest.raises(TypeError):
        hk.histogram_counts_cuda(x, torch.linspace(0, 1, 3, device="cuda"), torch.ones(4, device="cuda"))
    with pytest.raises(TypeError):
        hk.bincount_cuda(x, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, nbins, lo, hi", [
    (dt, *r) for dt in ["float16", "float32", "float64", "int64", "complex64"]
    for r in [(1, -1.0, 1.0), (7, -3.0, 4.0), (256, -4.0, 4.0), (255, 1e6, 1e6 + 3.0), (1 << 16, -4.0, 4.0),
              (100, -1e4, 1e4)]
    # (numpy refuses edges that repeat: float16 has no 65536 bins in [-4, 4], float32 no 255 in [1e6, 1e6 + 3])
    if not (dt == "float16" and r[0] > 256) and not (dt in ("float16", "float32", "complex64") and r[1] > 1e5)])
def test_histogram_kernel_guess_at_every_edge(cuda, dtype, nbins, lo, hi):
    """Values on every edge and one step either side of it: the guess's
    margin must send each of them where numpy's search does."""
    dt = np.dtype(dtype)
    edges = np.histogram_bin_edges(np.empty(0, dt), nbins, (lo, hi))
    real = edges.real.astype(dt if dt.kind != "c" else np.float32) if dt.kind != "i" else np.round(edges)
    vals = np.concatenate([real, np.nextafter(real, np.inf), np.nextafter(real, -np.inf)]) if dt.kind in "fc" \
        else np.concatenate([real, real + 1, real - 1])
    a = np.tile(vals.astype(dt), 3)
    _hist_check(a, edges)


@pytest.mark.gpu
def test_port_fault_repairs_on_the_card(cuda):
    """The repaired paths on CUDA tensors: nonzero and pad of unsigned
    integers, float16 scans, complex histograms, svd_compressed of complex
    input and norms of integers, each against numpy."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    rng = np.random.default_rng(21)
    u = rng.integers(0, 3, (40, 30)).astype(np.uint64) * np.uint64(2**63 - 5)
    h = (rng.random((12, 10)) * 10).astype(np.float16)
    z = np.round(rng.standard_normal(500) * 2, 0) + 1j * np.round(rng.standard_normal(500), 1)
    z[:3] = [1 - 0.5j, complex(np.nan, 1), 3 + 0.5j]
    zm = rng.standard_normal((40, 12)) + 1j * rng.standard_normal((40, 12))
    ints = rng.integers(-2**61, 2**61, (6, 5))
    with config.set({"device": "cuda"}):
        x = da.from_array(u, chunks=7)
        np.testing.assert_array_equal(da.flatnonzero(x).compute(), np.flatnonzero(u))
        for mode, kw in [("maximum", {}), ("mean", {"stat_length": 3}), ("median", {}), ("linear_ramp", {}),
                         ("reflect", {"reflect_type": "odd"})]:
            got = da.pad(x, ((2, 3), (1, 4)), mode, **kw).compute()
            want = np.pad(u, ((2, 3), (1, 4)), mode, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want), mode
        for axis in (0, 1, None):
            assert da.cumsum(da.from_array(h, chunks=5), axis=axis).compute().tobytes() == \
                np.cumsum(h, axis=axis).tobytes()
        np.testing.assert_array_equal(da.histogram(da.from_array(z, chunks=100), bins=4, range=(-2, 2))[0].compute(),
                                      np.histogram(z, bins=4, range=(-2, 2))[0])
        s = da.svd_compressed(da.from_array(zm, chunks=(10, 12)), 5, n_power_iter=2, seed=0)[1].compute()
        np.testing.assert_allclose(s, np.linalg.svd(zm, compute_uv=False)[:5], rtol=1e-10)
        for o in (None, 1, np.inf):
            np.testing.assert_allclose(da.linalg.norm(da.from_array(ints, chunks=2), ord=o).compute(),
                                       np.linalg.norm(ints, ord=o), rtol=1e-12)
