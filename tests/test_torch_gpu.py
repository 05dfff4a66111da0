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
and ragged inputs, weighted sums that repeat their bits; float16 and
bfloat16 counts by bit pattern over every pattern, with 16-bit counters
that wrap) and K1's 256-column tile of 2-byte types; the paths
held to numpy's own steps: nonzero and pad of unsigned integers, float16
scans, complex histograms and svd_compressed, norms of integers; the
pinned host copies (uploads and fetches byte for byte as the pageable
copies in 13 dtypes and strided views, more pieces than slots, the
compute stream ordered after the copy, concurrent callers) and the
out-of-core lane (streamed stencils equal in bytes to in-core with K1 once
a panel; streamed reductions and a panel-swept matmul).

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


def median3(b):
    """The 3x3 median filter: a stack and a median, a func the band
    kernel's capture declines (it keeps the halo path)."""
    return torch.stack([torch.roll(b, (dy, dx), (0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).median(0).values


def np_median3(x, mode):
    p = np.pad(x, 1, mode=mode)
    m, n = x.shape
    return np.median(np.stack([p[1 + dy:m + 1 + dy, 1 + dx:n + 1 + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)]),
                     axis=0)


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
        roll = stencil2d(chunk=128, form="roll", x_np=x)
        assert isinstance(roll.expr, BandStencil)
        before = stencil.LAUNCHES
        out = roll.compute_device()
        assert out.device.type == "cuda"
        assert stencil.LAUNCHES == before + 1
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-5, atol=1e-4)
        slices = stencil2d(chunk=128, form="slices", x_np=x).compute()
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
        s, m, sd = da.compute(*reduction_tree(chunk=100, split_every=4, x_np=x))
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
                    torch.complex64, torch.complex128, torch.uint16, torch.uint32, torch.uint64, torch.bfloat16]


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
        y = rechunk_relayout(chunk=128, persist=persist, x_np=x)
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
    from dask_array_tpu_torch.models.pipelines import stencil2d

    x = np.random.default_rng(6).standard_normal((512, 384)).astype(np.float32)
    want = _np_laplace(x)
    with config.set({"device": "cuda"}):
        for arr, expect in (
            (stencil2d(chunk=128, form="slices", x_np=x), want),
            (da.map_overlap(median3, da.from_array(x, chunks=128), depth=1, boundary="reflect"),
             np_median3(x, "symmetric")),
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
        arrays = tall_skinny_svd(chunk_rows=2500, x_np=x)
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


@pytest.mark.gpu
def test_block_functions_written_in_numpy_on_the_card(cuda):
    """The host lane on CUDA tensors: numpy's reduction, scan, map_blocks,
    blockwise and gufunc functions run on the blocks' host copies and give
    numpy's bytes; a torch function stays on the card."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import _host, config
    from dask_array_tpu_torch.ops._map_blocks import map_blocks_multi_output

    x = np.random.default_rng(22).standard_normal((40, 30))
    x[::7, ::5] = np.nan
    with config.set({"device": "cuda"}):
        d = da.from_array(x, chunks=(10, (12, 8, 10)))
        _host.HOST_CALLS = 0
        got = da.reduction(d, np.nansum, np.nansum, axis=1, dtype="f8").compute()
        want = np.concatenate([np.nansum(np.concatenate([np.nansum(x[i:i + 10, a:b], axis=(1,), keepdims=True)
                                                         for a, b in ((0, 12), (12, 20), (20, 30))], axis=1), axis=(1,))
                               for i in range(0, 40, 10)])
        assert got.tobytes() == want.tobytes() and _host.HOST_CALLS == 12 + 4
        got = da.cumreduction(lambda b, axis=None: np.fmax.accumulate(b, axis=axis), np.fmax, None, d,
                              axis=1).compute()
        assert got.tobytes() == np.fmax.accumulate(x, axis=1).tobytes()
        got = da.map_blocks(lambda b: np.nansum(b, 0, keepdims=True), d, chunks=((1,) * 4, (12, 8, 10)),
                            dtype="f8").compute()
        assert got.shape == (4, 30)
        got = da.blockwise(lambda a, b: np.add(np.asarray(a), np.asarray(b)), "ij", d, "ij", d, "ij",
                           dtype="f8").compute()
        np.testing.assert_array_equal(got, x + x)
        m = da.apply_gufunc(lambda a: np.nanmean(a, axis=-1), "(i)->()", d, output_dtypes="f8",
                            allow_rechunk=True).compute()
        np.testing.assert_array_equal(m, np.nanmean(x, axis=-1))
        s, c = map_blocks_multi_output(lambda b: (np.sin(b), np.cos(b)), d, dtypes=["f8", "f8"])
        np.testing.assert_array_equal(da.compute(s, c)[0], np.sin(x))
        _host.HOST_CALLS = 0
        dev = da.map_blocks(lambda b: torch.nan_to_num(b) * 2, d, dtype="f8").compute_device()
        assert dev.device.type == "cuda" and _host.HOST_CALLS == 0


@pytest.mark.gpu
def test_io_on_the_card(cuda, tmp_path):
    """zarr, npy stacks, store and from_map on the card: the blocks go up
    to the card once a walk, a slice loads only its blocks."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.io import _from_map

    x = np.random.default_rng(23).random((64, 48), dtype=np.float32)
    with config.set({"device": "cuda"}):
        d = da.from_array(x, chunks=(16, 24))
        da.to_zarr(d, str(tmp_path / "a.zarr"))
        z = da.from_zarr(str(tmp_path / "a.zarr"))
        assert z.compute_device().device.type == "cuda"
        _from_map.LOADS = 0
        assert z[16:32, :24].compute().tobytes() == x[16:32, :24].tobytes() and _from_map.LOADS == 1
        np.testing.assert_allclose(z.sum(0).compute(), x.sum(0), rtol=1e-5)
        da.to_npy_stack(str(tmp_path / "s"), d.T)
        assert da.from_npy_stack(str(tmp_path / "s")).compute().tobytes() == np.ascontiguousarray(x.T).tobytes()
        target = np.zeros((64, 48), np.float32)
        stored = da.store(d * 2, target, return_stored=True)
        assert stored.compute().tobytes() == (x * 2).tobytes() == target.tobytes()
        fm = da.from_map(lambda i: torch.full((4, 5), float(i), device="cuda"), range(3), chunks=((4,) * 3, (5,)))
        np.testing.assert_array_equal(fm.compute(), np.repeat(np.arange(3.0, dtype=np.float32), 20).reshape(12, 5))
        assert da.barrier(d + 1)[3:9].compute().tobytes() == (x[3:9] + 1).tobytes()


# ---------------------------------------------------------------------------
# pinned host copies (_hostcopy) and the out-of-core lane (_streaming)
# ---------------------------------------------------------------------------

HOSTCOPY_DTYPES = ["f2", "f4", "f8", "i1", "i4", "i8", "u1", "u2", "u4", "u8", "b1", "c8", "c16"]


def _pageable_up(arr, cuda):
    return torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HOSTCOPY_DTYPES)
@pytest.mark.parametrize("view", ["contiguous", "columns", "reversed", "transpose", "scalar", "empty"])
def test_pinned_upload_and_fetch_equal_pageable_bytes(cuda, dtype, view):
    from dask_array_tpu_torch import _hostcopy

    rng = np.random.default_rng(40)
    base = (rng.standard_normal((300, 257)) * 100).astype(dtype)
    arr = {"contiguous": base, "columns": base[:, 3:200], "reversed": base[::-1, ::-2], "transpose": base.T,
           "scalar": np.asarray(base[1, 2]), "empty": base[:0]}[view]
    up = _hostcopy.upload(arr, cuda)
    want = _pageable_up(arr, cuda)
    assert up.dtype == want.dtype and up.shape == want.shape
    assert torch.equal(up.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))
    back = _hostcopy.fetch(up)
    assert back.dtype == want.cpu().numpy().dtype and back.tobytes() == want.cpu().numpy().tobytes()
    assert back.flags.writeable and not torch.from_numpy(back).is_pinned()


@pytest.mark.gpu
def test_pinned_copies_of_more_than_a_ring(cuda, monkeypatch):
    """More pieces than slots, strided sources and destinations, a slot size
    that does not divide the rows: every byte as the pageable copy."""
    from dask_array_tpu_torch import _hostcopy

    # fresh rings of small slots, dropped after the test
    monkeypatch.setattr(_hostcopy, "SLOT_BYTES", 4096 + 8)
    monkeypatch.setattr(_hostcopy, "_rings", {})
    arr = np.random.default_rng(41).standard_normal((513, 97))
    strided = arr[::3, 1::2]
    up = _hostcopy.upload(strided, cuda)
    assert torch.equal(up, _pageable_up(strided, cuda))
    out = np.zeros((171 * 2, 48 * 2))
    _hostcopy.fetch_into(up, out[::2, 1::2])
    np.testing.assert_array_equal(out[::2, 1::2], strided)
    assert (out[1::2] == 0).all() and (out[:, ::2] == 0).all()


@pytest.mark.gpu
def test_compute_goes_up_and_down_through_the_rings(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import _hostcopy

    x = np.random.default_rng(42).standard_normal((2048, 1536)).astype("f4")
    before = dict(_hostcopy.COPIES)
    with da.config.set({"device": "cuda"}):
        got = (da.from_array(x, chunks=512) * 2 + 1).compute()
    assert got.tobytes() == (torch.from_numpy(x).to(cuda) * 2 + 1).cpu().numpy().tobytes()
    assert _hostcopy.COPIES["h2d_bytes"] - before["h2d_bytes"] == x.nbytes
    assert _hostcopy.COPIES["d2h_bytes"] - before["d2h_bytes"] == x.nbytes
    assert not torch.from_numpy(got).is_pinned()  # a plain pageable array for the caller
    assert _hostcopy.ring_bytes() == 2 * _hostcopy.SLOTS * _hostcopy.SLOT_BYTES  # one ring each way


@pytest.mark.gpu
def test_an_upload_is_ordered_before_the_work_that_reads_it(cuda):
    """The compute stream waits on the copy: a kernel queued right after
    the upload reads the new values, not the recycled block's old ones."""
    from dask_array_tpu_torch import _hostcopy

    for i in range(20):
        arr = np.full((4096, 1024), float(i), dtype="f4")
        t = _hostcopy.upload(arr, cuda)
        assert float(t.sum()) == float(i) * arr.size
        del t


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["reflect", "nearest", 0.5])
def test_streamed_stencil_equals_in_core(cuda, boundary):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch._streaming import STREAMED
    from dask_array_tpu_torch.kernels import stencil

    x = np.random.default_rng(43).standard_normal((4096, 1024)).astype("f4")
    with da.config.set({"device": "cuda"}):
        st = da.map_overlap(laplace, da.from_array(x, chunks=(512, 1024)), depth=1, boundary=boundary, dtype="f4")
        with da.config.set({"out-of-core": "off"}):
            in_core = st.compute()
        before = dict(STREAMED)
        launches = stencil.LAUNCHES
        with da.config.set({"out-of-core": "auto", "memory-budget": 8 << 20}):
            out = st.compute()
    panels = STREAMED["panels"] - before["panels"]
    assert STREAMED["count"] - before["count"] == 1 and panels >= 2
    assert stencil.LAUNCHES - launches == panels
    assert out.tobytes() == in_core.tobytes()


@pytest.mark.gpu
def test_streamed_reductions_and_matmul_on_the_card(cuda):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch._streaming import STREAMED

    rng = np.random.default_rng(44)
    a = rng.standard_normal((1 << 16, 256)).astype("f4")
    w = rng.standard_normal((256, 64)).astype("f4")
    with da.config.set({"device": "cuda", "out-of-core": "force"}):
        x = da.from_array(a, chunks=(4096, 256))
        before = dict(STREAMED)
        s0 = x.sum(axis=0).compute()
        m = x.mean().compute()
        nm = da.nanmax(x).compute()
        mm = (x @ w).compute()
    assert STREAMED["count"] - before["count"] == 4 and STREAMED["pinned"] - before["pinned"] == 1
    np.testing.assert_allclose(s0, a.astype("f8").sum(axis=0), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(m, a.astype("f8").mean(), rtol=1e-4, atol=1e-6)
    assert nm == a.max()
    np.testing.assert_allclose(mm, a.astype("f8") @ w.astype("f8"), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_pinned_rings_under_concurrent_callers(cuda):
    """More caller threads than cores share the rings (each ring's lock
    orders its slots): every round trip returns its own bytes."""
    import sys
    import threading

    from dask_array_tpu_torch import _hostcopy

    errors = []

    def worker(k):
        rng = np.random.default_rng(100 + k)
        for _ in range(4):
            arr = rng.standard_normal((1 << 12, 1 << 9 + k % 3)).astype("f4")
            back = _hostcopy.fetch(_hostcopy.upload(arr, cuda) * 2)
            if back.tobytes() != (arr * 2).tobytes():
                errors.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- S9: bfloat16 in K1 and K2, datetime ticks, the host lanes on the card ----------


def _close16(got, want, scale):
    """1 step of the 2-byte type (2^-7 of the value for bfloat16, 2^-10 for
    float16) plus 4 float32 steps of ``scale`` (sum |w| * max |x|): kernel
    and plain version each add the taps in float32, in other orders, and
    round once."""
    step = 2.0**-7 if want.dtype == torch.bfloat16 else 2.0**-10
    d = (got.float() - want.float()).abs()
    return bool((d <= step * want.float().abs() + 2.0**-21 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("func, depth", [(laplace, (1, 1)), (far, (8, 8))])
def test_kernel_bf16_matches_plain_for_every_boundary_pair(cuda, func, depth):
    from dask_array_tpu_torch.kernels import stencil

    taps = stencil.capture_taps(func, depth)
    gen = torch.Generator(device=cuda).manual_seed(31)
    for b0 in MODES:
        for b1 in MODES:
            x = torch.randn((67, 131), generator=gen, device=cuda).to(torch.bfloat16)
            got = stencil.band_stencil_cuda(x, taps, depth, (b0, b1))
            want = stencil.band_stencil_plain(x, func, depth, (b0, b1))
            assert got.dtype == torch.bfloat16
            scale = sum(abs(w) for _, _, w in taps) * float(x.float().abs().max())
            assert _close16(got, want, scale), (b0, b1)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [(1, 1), (2, 1), (8, 8)])
@pytest.mark.parametrize("layout", ["vector", "n_not_multiple_of_8", "storage_offset_1"])
def test_kernel_bf16_paths_match_plain(cuda, depth, layout):
    """16-byte rows hold 8 bfloat16 values, as for float16; odd rows and an
    odd storage offset take scalar loads."""
    from dask_array_tpu_torch.kernels import stencil

    f = stencil_reaching(*depth)
    taps = stencil.capture_taps(f, depth)
    n = {"vector": 512, "n_not_multiple_of_8": 509, "storage_offset_1": 512}[layout]
    base = torch.randn((300 * n + 1,), device=cuda).to(torch.bfloat16)
    x = base[1:].view(300, n) if layout == "storage_offset_1" else base[: 300 * n].view(300, n)
    got = stencil.band_stencil_cuda(x, taps, depth, ("reflect", 2.5))
    want = stencil.band_stencil_plain(x, f, depth, ("reflect", 2.5))
    assert stencil.vector_ok(x, got) == (layout == "vector")
    assert _close16(got, want, sum(abs(w) for _, _, w in taps) * float(x.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", [1, 7, 256, 4096, 65536])
@pytest.mark.parametrize("edges_dtype", [torch.float64, torch.float32, torch.bfloat16], ids=str)
def test_histogram_kernel_bf16_data(cuda, nbins, edges_dtype):
    """bfloat16 values are exact in float32: the counts equal the plain
    version's and numpy's on the float32 values, aligned and not."""
    from dask_array_tpu_torch.kernels import histogram as hk

    gen = torch.Generator(device=cuda).manual_seed(nbins)
    x = (torch.randn(100_003, generator=gen, device=cuda) * 2).to(torch.bfloat16)
    x[::101] = float("nan")
    e = torch.linspace(-4, 4, nbins + 1, device=cuda, dtype=torch.float64).to(edges_dtype)
    for v in (x, x[1:]):
        got = hk.histogram_counts_cuda(v, e)
        torch.testing.assert_close(got, hk.histogram_counts_plain(v, e), rtol=0, atol=0)
        f = v.float().cpu().numpy()
        want = np.histogram(f[~np.isnan(f)], bins=e.double().cpu().numpy())[0]
        np.testing.assert_array_equal(got.cpu().numpy(), want)


# -- 2-byte floats: K1's 256-column tile, K2's pattern route ----------------------------

TWO_BYTE = [torch.bfloat16, torch.float16]


def _plain16(x, func, depth, bnd):
    """The plain version in float32, rounded once to x's 2-byte type (the
    kernel's arithmetic; float16's own plain version rounds each step)."""
    from dask_array_tpu_torch.kernels import stencil

    fills = tuple(float(torch.tensor(b, dtype=x.dtype)) if not isinstance(b, str) else b for b in bnd)
    return stencil.band_stencil_plain(x.float(), func, depth, fills).to(x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TWO_BYTE, ids=str)
@pytest.mark.parametrize("depth", [(1, 1), (2, 3)])
@pytest.mark.parametrize("width", [255, 256, 257, 264, 4097])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_two_byte_tile_widths_match_plain(cuda, dtype, depth, width, offset):
    """The 256-column tile of 2-byte types: widths one short of, at, one
    past and 8 past a tile, and 4097 (16 tiles and one column); rows of 16
    bytes (whole 16-byte vectors and column pairs) and, one element into
    the storage, rows that take scalar loads and stores; the register
    window at (1, 1) (six blocks an SM), the tap list at (2, 3) (eight
    columns a lane, odd and even column offsets)."""
    from dask_array_tpu_torch.kernels import stencil

    gen = torch.Generator(device=cuda).manual_seed(width + offset)
    rows = 101
    base = torch.randn(rows * width + 1, generator=gen, device=cuda).to(dtype)
    x = base[offset:offset + rows * width].view(rows, width)
    f = laplace if depth == (1, 1) else stencil_reaching(*depth)
    taps = stencil.capture_taps(f, depth)
    for bnd in (("reflect", "periodic"), (2.5, "nearest"), ("periodic", 0.0)):
        got = stencil.band_stencil_cuda(x, taps, depth, bnd)
        want = _plain16(x, f, depth, bnd)
        assert got.dtype == dtype and stencil.vector_ok(x, got) == (offset == 0 and width * 2 % 16 == 0)
        assert _close16(got, want, sum(abs(w) for _, _, w in taps) * float(x.float().abs().max())), (bnd, width)


def _every_pattern(dtype, copies=2, seed=0):
    """Every 2-byte pattern ``copies`` times, shuffled, on the card."""
    bits = np.tile(np.arange(65536, dtype=np.uint16), copies)
    bits = np.random.default_rng(seed).permutation(bits)
    return torch.from_numpy(bits.view(np.int16)).cuda().view(dtype)


def _two_byte_check(x, e):
    """The kernel against the plain version and numpy of the float32 values
    (NaN dropped), aligned and one element in."""
    from dask_array_tpu_torch.kernels import histogram as hk

    for v in (x, x[1:]):
        got = hk.histogram_counts_cuda(v, e)
        torch.testing.assert_close(got, hk.histogram_counts_plain(v, e), rtol=0, atol=0)
        f = v.float().cpu().numpy()
        with np.errstate(all="ignore"):
            want = np.histogram(f[~np.isnan(f)], bins=e.double().cpu().numpy())[0]
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TWO_BYTE, ids=str)
@pytest.mark.parametrize("edges_dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("nbins", [1, 7, 256, 4096, 65536])
def test_histogram_kernel_two_byte_every_pattern(cuda, dtype, edges_dtype, nbins):
    """Every pattern as data (NaN, ±0, ±inf, subnormals, the edges' own
    values), through the pattern route: [-4, 4] (32-bit counters),
    edges no 2-byte float holds, and -inf .. inf (16-bit counters)."""
    from dask_array_tpu_torch.kernels import histogram as hk

    x = _every_pattern(dtype, seed=nbins)
    hk.LAUNCHES = 0
    for e in (np.linspace(-4.0, 4.0, nbins + 1), np.linspace(-0.3, 0.7, nbins + 1) + 1e-9,
              np.concatenate([[-np.inf], np.linspace(-100.0, 100.0, nbins - 1), [np.inf]]) if nbins > 1
              else np.array([-np.inf, np.inf])):
        _two_byte_check(x, torch.from_numpy(e).to(edges_dtype).cuda())
    assert hk.LAUNCHES == 6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TWO_BYTE, ids=str)
def test_histogram_kernel_two_byte_sixteen_bit_counters(cuda, dtype):
    """A window of every key takes 16-bit counters: 4e7 copies of one value
    and 2e7 of its high neighbour (one 32-bit word) wrap both counters
    in every block, beside every pattern; the counts stay exact."""
    from dask_array_tpu_torch.kernels import histogram as hk

    e = torch.tensor([-np.inf, -1.0, 0.0, 0.5, 1.0, np.inf], dtype=torch.float64, device=cuda)
    lo, span = hk.key_window(-np.inf, np.inf, dtype, "float64")
    assert hk.counter_bits(hk.launch_plan(1 << 22, 5, hk._sm_count(0), 2, 0, 8, True), span) == 16
    low, high = hk.pattern_of(lo + 2 * 20000), hk.pattern_of(lo + 2 * 20000 + 1)
    bits = np.concatenate([np.full(40_000_000, low, np.uint16), np.full(20_000_000, high, np.uint16),
                           np.arange(65536, dtype=np.uint16)])
    for b in (bits, np.random.default_rng(2).permutation(bits)):
        _two_byte_check(torch.from_numpy(b.view(np.int16)).cuda().view(dtype), e)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TWO_BYTE, ids=str)
def test_histogram_kernel_two_byte_weighted_keeps_its_route(cuda, dtype):
    """Weighted sums of 2-byte data keep the copies route: float64 sums to
    rtol 1e-12 of the plain version and numpy."""
    from dask_array_tpu_torch.kernels import histogram as hk

    x = _every_pattern(dtype, copies=3, seed=5)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(x.numel())).cuda()
    assert hk.launch_plan(x.numel(), 256, hk._sm_count(0), 2, 1, 8).mode == hk.COPIES
    e = torch.linspace(-4, 4, 257, dtype=torch.float64, device=cuda)
    keep = ~torch.isnan(x)
    for v, wv in ((x, w), (x[1:], w[1:])):
        got = hk.histogram_counts_cuda(v, e, wv)
        torch.testing.assert_close(got, hk.histogram_counts_plain(v, e, wv), rtol=1e-12, atol=1e-9)
    f, wn = x.float().cpu().numpy(), w.cpu().numpy()
    want = np.histogram(f[keep.cpu().numpy()], bins=e.cpu().numpy(), weights=wn[keep.cpu().numpy()])[0]
    np.testing.assert_allclose(hk.histogram_counts_cuda(x, e, w).cpu().numpy(), want, rtol=1e-12, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TWO_BYTE, ids=str)
@pytest.mark.parametrize("edges", ["uniform", "infinite"])
def test_histogram_kernel_two_byte_all_values_in_one_bin(cuda, dtype, edges):
    """2**26 copies of one value: one key takes every count (32-bit counters
    of [-4, 4]; 16-bit ones, wrapping some 8 times a block, of -inf ..
    inf); the count is exact."""
    from dask_array_tpu_torch.kernels import histogram as hk

    n = 1 << 26
    x = torch.full((n,), 0.3, device=cuda, dtype=dtype)
    e = torch.linspace(-4, 4, 65537, device=cuda, dtype=torch.float64)
    if edges == "infinite":
        e[0], e[-1] = -np.inf, np.inf
    got = hk.histogram_counts_cuda(x, e).cpu().numpy()
    want = np.histogram(np.full(4, float(x[0]), np.float64), bins=e.cpu().numpy())[0] * (n // 4)
    np.testing.assert_array_equal(got, want)
    del x


@pytest.mark.gpu
def test_bf16_public_paths_launch_k1_and_k2(cuda):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.kernels import histogram as hk
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.models.pipelines import stencil2d

    x = np.random.default_rng(0).standard_normal((512, 512), dtype=np.float32).astype(ml_dtypes.bfloat16)
    st = stencil2d(chunk=128, form="roll", x_np=x)
    h, _ = da.histogram(da.from_array(x, chunks=128), bins=64, range=(-4, 4))
    stencil.LAUNCHES = hk.LAUNCHES = 0
    got, counts = st.compute(), h.compute()
    assert stencil.LAUNCHES == 1 and hk.LAUNCHES == 1
    assert got.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(counts, np.histogram(x.astype(np.float32), bins=64, range=(-4, 4))[0])


@pytest.mark.gpu
def test_datetime_on_the_card(cuda):
    import dask_array_tpu_torch as da

    rng = np.random.default_rng(9)
    ticks = rng.integers(-(10**17), 10**17, 4096)
    ticks[::37] = np.iinfo(np.int64).min
    t = ticks.view("M8[ns]")
    d = da.from_array(t, chunks=1000)
    dev = da.diff(d).compute_device()
    assert dev.is_cuda and dev.dtype == torch.int64
    for got, want in ((da.diff(d), np.diff(t)), (d.max(), t.max()), (d.min(), t.min()),
                      (da.where(d > t[1], d, d[0]), np.where(t > t[1], t, t[0])), (d.astype("M8[s]"), t.astype("M8[s]"))):
        g = np.asarray(got.compute())
        assert g.dtype == np.asarray(want).dtype and np.array_equal(g.view("i8"), np.asarray(want).view("i8"))


@pytest.mark.gpu
def test_host_lanes_beside_the_card(cuda):
    """Masked blocks stay on the host (numpy.ma), a device operand meets
    them there; a record's field computes on the card."""
    import dask_array_tpu_torch as da

    m = np.ma.masked_array(np.arange(64.0).reshape(8, 8), mask=np.arange(64).reshape(8, 8) % 7 == 0)
    x = da.from_array(m, chunks=4)
    got = (x + da.ones((8, 8), chunks=4)).sum(axis=0).compute()
    want = (m + 1).sum(axis=0)
    assert isinstance(got, np.ma.MaskedArray)
    np.testing.assert_array_equal(got.filled(0), want.filled(0))
    assert float(x.var().compute()) == pytest.approx(float(m.var()), rel=1e-12)
    rec = np.zeros(100, dtype=[("a", "f8"), ("b", "i4")])
    rec["a"], rec["b"] = np.linspace(0, 1, 100), np.arange(100)
    r = da.from_array(rec, chunks=30)
    assert (r["a"] * 2 + r["b"]).compute_device().is_cuda
    np.testing.assert_allclose((r["a"] * 2 + r["b"]).compute(), rec["a"] * 2 + rec["b"], rtol=1e-15)


@pytest.mark.gpu
@pytest.mark.parametrize("dst", ["uint16", "int32", "uint8", "float64", "bfloat16"])
def test_view_on_the_card(cuda, dst):
    import dask_array_tpu_torch as da

    if dst == "bfloat16":
        dst = pytest.importorskip("ml_dtypes").bfloat16
    x = np.random.default_rng(5).standard_normal((16, 32)).astype(np.float32)
    v = da.from_array(x, chunks=(8, 16)).view(dst)
    assert v.compute_device().is_cuda
    np.testing.assert_array_equal(v.compute().view(np.uint8), x.view(dst).view(np.uint8))


@pytest.mark.gpu
def test_bf16_through_the_layout_and_scale_kernels_on_public_paths(cuda):
    """bfloat16 ``.T`` (P3t), ``pad`` (the halo kernel) and a multiply by a
    bfloat16 scalar (P3c) on the card, each through ``compute()`` with one
    launch, equal to numpy's bytes (ml_dtypes' bfloat16)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.kernels import halo
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk

    bf16 = ml_dtypes.bfloat16
    x = np.random.default_rng(2).standard_normal((256, 384)).astype(bf16)
    d = da.from_array(x, chunks=128)
    tk.LAUNCHES = halo.LAUNCHES = sk.LAUNCHES = 0
    t, p, m = d.T.compute(), da.pad(d, 2, mode="reflect").compute(), (d * bf16(0.5)).compute()
    assert (tk.LAUNCHES, halo.LAUNCHES, sk.LAUNCHES) == (1, 1, 1)
    for got, want in ((t, x.T), (p, np.pad(x, 2, mode="reflect")), (m, x * bf16(0.5))):
        assert got.dtype == np.dtype(bf16)
        np.testing.assert_array_equal(got.view(np.uint16), np.ascontiguousarray(want).view(np.uint16))


# -- the mesh on the card: 4 slots on cuda:0 ---------------------------------------


def _card_mesh(shape=(2, 2), names=("x", "y")):
    from dask_array_tpu_torch.parallel import Mesh

    return Mesh(np.array(["cuda:0"] * 4, dtype=object).reshape(shape), names)


@pytest.mark.gpu
def test_halo_exchange_and_psum_on_the_card(cuda):
    """``halo_exchange`` and ``psum_reduce`` over 4 slots on one card: the
    shards live on the card, the values are numpy's, and the record shows
    two permutes and one psum."""
    from dask_array_tpu_torch.parallel import collectives
    from dask_array_tpu_torch.parallel._sharded import COLLECTIVES

    x = np.random.default_rng(4).standard_normal((64, 48))
    t = torch.from_numpy(x).to(cuda)
    mesh = _card_mesh((4,), ("r",))
    before = COLLECTIVES.snapshot()
    h = collectives.halo_exchange(t, mesh, "r", 0, 2, wrap=True)
    assert all(s.is_cuda for s in h.shards)
    want = np.concatenate([np.concatenate([np.roll(x, 2, 0)[16 * i:16 * i + 2], x[16 * i:16 * i + 16],
                                           np.roll(x, -2, 0)[16 * i + 14:16 * i + 16]]) for i in range(4)])
    np.testing.assert_array_equal(h.gather().cpu().numpy(), want)
    p = collectives.psum_reduce(t, mesh, "r", 0)
    np.testing.assert_allclose(p.gather().cpu().numpy(), x.sum(0), rtol=1e-12)
    assert COLLECTIVES.delta(before) == {"ppermute": 2, "psum": 1, "gather": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["reflect", "periodic", 0.5])
def test_band_stencil_under_a_mesh_launches_once_a_slot(cuda, boundary):
    """A 2-D stencil the band-stencil kernel takes, under a 2 x 2 mesh on
    the card: the kernel once a slot (4 launches), two permutes a sharded
    axis, values equal to the walk without a mesh."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.parallel import use_mesh
    from dask_array_tpu_torch.parallel._sharded import COLLECTIVES

    x = np.random.default_rng(6).standard_normal((512, 384)).astype(np.float32)
    with config.set({"device": "cuda"}):
        e = da.map_overlap(laplace, da.from_array(x, chunks=(256, 192)), depth=1, boundary=boundary)
        want = e.compute()
        stencil.LAUNCHES = 0
        before = COLLECTIVES.snapshot()
        with use_mesh(_card_mesh()):
            got = e.compute()
        assert stencil.LAUNCHES == 4
        assert COLLECTIVES.delta(before) == {"ppermute": 4, "gather": 1}
    scale = 8 * float(np.abs(x).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=scale * 2.0**-21)


@pytest.mark.gpu
def test_shard_stencil_and_lane_stencil_on_the_card(cuda):
    """``ShardStencil`` (a func the band kernel declines: the halo kernel once a slot) and
    the shard lane's stencil plan (a linear func on an irregular grid: the
    band-stencil kernel once a slot; under ``stencil-kernel: off`` never)
    on the card, equal to the walk."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import halo, stencil
    from dask_array_tpu_torch.ops._overlap import overlap, trim_internal
    from dask_array_tpu_torch.parallel import use_mesh
    from dask_array_tpu_torch.parallel.shardlane import ENGAGED

    x = np.random.default_rng(7).standard_normal((512, 256)).astype(np.float32)

    with config.set({"device": "cuda", "overlap-method": "shard"}):
        e = da.map_overlap(median3, da.from_array(x, chunks=(128, 256)), depth=1, boundary="nearest")
        assert type(e.expr).__name__ == "ShardStencil"
        want = e.compute()
        with use_mesh(_card_mesh((4,), ("r",))):
            halo.LAUNCHES = 0
            got = e.compute()
            assert halo.LAUNCHES == 4  # the whole axis padded once a slot
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    heights = (60, 37, 70, 80, 45, 90, 50, 80)  # 2 blocks on each of the 4 slots
    with config.set({"device": "cuda"}):
        # overlap -> map_blocks -> trim written out: the lane's stencil plan
        # with a func the band-stencil gate takes
        a = overlap(da.from_array(x, chunks=(heights, 256)), 1, "reflect")
        e = trim_internal(a.map_blocks(laplace), 1, "reflect")
        want = e.compute()
        before = ENGAGED["count"]
        with use_mesh(_card_mesh()):
            stencil.LAUNCHES = 0
            got = e.compute()
            assert ENGAGED["count"] == before + 1 and stencil.LAUNCHES == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=8 * float(np.abs(x).max()) * 2.0**-21)
    with config.set({"device": "cuda", "stencil-kernel": "off"}):
        e = da.map_overlap(laplace, da.from_array(x, chunks=(heights, 256)), depth=1, boundary="reflect")
        want = e.compute()
        before = ENGAGED["count"]
        with use_mesh(_card_mesh()):
            stencil.LAUNCHES = 0
            got = e.compute()
            assert ENGAGED["count"] == before + 1 and stencil.LAUNCHES == 0  # "off" stays off
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_lane_row_stencil_deeper_than_the_kernel_on_the_card(cuda):
    """A depth-9 row stencil (past the band-stencil kernel's depth 8: the
    graph keeps the per-block form) in the shard lane over 4 slots on the
    card: the lane runs it, the kernel is never asked, and the values are
    the walk's."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.parallel import use_mesh
    from dask_array_tpu_torch.parallel.shardlane import ENGAGED

    def row9(b):
        return torch.roll(b, 9, 0) - 2 * b + torch.roll(b, -9, 0)

    x = np.random.default_rng(9).standard_normal((512, 256)).astype(np.float32)
    heights = (60, 37, 70, 80, 45, 90, 50, 80)
    with config.set({"device": "cuda"}):
        e = da.map_overlap(row9, da.from_array(x, chunks=(heights, 256)), depth={0: 9, 1: 0}, boundary="reflect")
        assert type(e.expr).__name__ != "BandStencil"
        want = e.compute()
        before = ENGAGED["count"]
        with use_mesh(_card_mesh((4,), ("r",))):
            stencil.LAUNCHES = 0
            got = e.compute()
            assert ENGAGED["count"] == before + 1 and stencil.LAUNCHES == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_shard_lane_programs_on_the_card(cuda):
    """Shard-lane programs over 4 slots on the card: an irregular grid's
    sum, Blelloch cumsum, matmul and argmax, each one lane program, equal
    to the walk without a mesh; the reductions one psum, no all_gather."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.parallel import use_mesh
    from dask_array_tpu_torch.parallel._sharded import COLLECTIVES
    from dask_array_tpu_torch.parallel.shardlane import ENGAGED

    rng = np.random.default_rng(8)
    heights = (230, 70, 150, 310, 90, 120, 40, 110, 80, 100, 70)
    src = rng.standard_normal((sum(heights), 32)).astype(np.float32)
    w = rng.standard_normal((32, 32)).astype(np.float32)
    with config.set({"device": "cuda"}):
        x = da.from_array(src, chunks=(heights, 32))
        # (a float32 var() of the whole array takes the multi-statistic
        # route, which the lane does not plan; var(axis=0) is in-lane)
        progs = [(x + 1).sum(axis=0), x.var(axis=0), da.cumsum(x, axis=0), x @ w, x.argmax(axis=0)]
        want = [p.compute() for p in progs]
        for p, wv in zip(progs, want):
            before, coll = ENGAGED["count"], COLLECTIVES.snapshot()
            with use_mesh(_card_mesh()):
                dev = p.compute_device()
                got = p.compute()
            assert dev.is_cuda and ENGAGED["count"] == before + 2
            assert "all_gather" not in COLLECTIVES.delta(coll) or p is progs[2]
            if wv.dtype.kind == "i":
                np.testing.assert_array_equal(got, wv)
            else:
                np.testing.assert_allclose(got, wv, rtol=1e-4, atol=1e-3)


# -- the partitioned walk on the card: P3t, P3c, P4 and K2 on a slot's part -----------

# (shard kind, base shape, the spec the walk binds it under on a 4-slot
# ring): the last of 6 rows' parts is empty; a column part is a strided
# view; 5-row parts of 3 float32 columns start 60 bytes apart, off any
# 16-byte boundary
SHARD_KINDS = {"empty": ((6, 5), ("r", None)), "strided": ((48, 64), (None, "r")),
               "unaligned": ((20, 3), ("r", None))}


def _slot_parts(kind, cuda):
    from dask_array_tpu_torch.parallel._sharded import shard

    shape, spec = SHARD_KINDS[kind]
    base = torch.from_numpy(np.random.default_rng(18).standard_normal(shape).astype(np.float32)).to(cuda)
    st = shard(base, _card_mesh((4,), ("r",)), spec)
    nonempty = sum(s.numel() > 0 for s in st.shards)
    if kind == "empty":
        assert st.shards[3].numel() == 0
    if kind == "strided":
        assert not st.shards[1].is_contiguous()
    if kind == "unaligned":
        assert any(s.data_ptr() % 16 for s in st.shards)
    return base, st, nonempty


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(SHARD_KINDS))
@pytest.mark.parametrize("kernel", ["transpose", "scale", "multi_stat", "histogram"])
def test_kernels_on_slot_parts(cuda, kernel, kind):
    """Each kernel of the partitioned walk's path on each slot's part (an
    empty part, a strided one, one off a 16-byte boundary), equal to its
    plain version on that part; then the walk under "gspmd" on the same 4
    slots of the card launches it once a non-empty slot, with the values
    of the walk without a mesh."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import histogram as hk
    from dask_array_tpu_torch.kernels import mstat
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.parallel import use_mesh

    base, st, nonempty = _slot_parts(kind, cuda)
    edges = torch.linspace(-3, 3, 17, device=cuda)
    for s in st.shards:
        if kernel == "transpose":
            assert torch.equal(tk.transpose_last2(s), tk.transpose_last2_plain(s))
        elif kernel == "scale":
            row = torch.linspace(-2, 2, s.shape[1], device=cuda, dtype=s.dtype).reshape(1, -1)
            got, want = sk.scale(s, row), sk.scale_plain(s, row)
            assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))
        elif kernel == "multi_stat" and s.numel():  # the walk skips an empty part
            c = s.contiguous()
            torch.testing.assert_close(mstat.multi_stat_packed(c), mstat.multi_stat_packed_plain(c), rtol=1e-4,
                                       atol=1e-4)
        elif kernel == "histogram" and s.numel():
            assert torch.equal(hk.histogram_counts(s, edges), hk.histogram_counts_plain(s, edges))
    module = {"transpose": tk, "scale": sk, "multi_stat": mstat, "histogram": hk}[kernel]
    x = base.cpu().numpy()
    with config.set({"device": "cuda"}):
        a = da.from_array(x, chunks=x.shape)
        if kernel == "transpose":
            arrays = [a.T]
        elif kernel == "scale":
            arrays = [a * da.from_array(np.linspace(-2, 2, x.shape[1], dtype=np.float32), chunks=x.shape[1])]
        elif kernel == "multi_stat":
            arrays = [a.sum(axis=0), a.mean(axis=1), a.std()]
        else:
            arrays = [da.histogram(a, bins=np.linspace(-3, 3, 17))[0]]
        want = da.compute(*arrays)
        with use_mesh(st.mesh), config.set({"execution-lane": "gspmd"}):
            from dask_array_tpu_torch.parallel.partition import leaf_spec

            assert leaf_spec(x.shape, st.mesh) == st.spec
            module.LAUNCHES = 0
            got = da.compute(*arrays)
            launched = module.LAUNCHES
    assert launched == nonempty, (kernel, kind, launched)
    for g, w in zip(got, want):
        if kernel == "multi_stat":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)


# -- 1-byte data: K2's byte route, the narrow types, the streamed dtypes ---------------

BYTE_TYPES = ["int2", "uint2", "int4", "uint4", "float4_e2m1fn", "float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz",
              "float8_e8m0fnu", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"]
TORCH_FLOAT8 = {"float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"}


def _every_byte(name, copies=3, seed=0):
    """Every byte ``copies`` times, shuffled, on the card, as the port holds
    a 1-byte type (a torch float8 tensor, or a narrow type's uint8 carrier
    with its numpy dtype)."""
    import ml_dtypes

    raw = np.random.default_rng(seed).permutation(np.tile(np.arange(256, dtype=np.uint8), copies))
    t = torch.from_numpy(raw).cuda()
    if name in TORCH_FLOAT8:
        return t.view(getattr(torch, name)), None
    return t, np.dtype(getattr(ml_dtypes, name))


@pytest.mark.gpu
@pytest.mark.parametrize("name", BYTE_TYPES)
@pytest.mark.parametrize("edges_dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("nbins", [1, 16, 256])
def test_histogram_kernel_byte_route_every_pattern(cuda, name, edges_dtype, nbins):
    """Every byte as data, through the byte route, aligned and one element
    in: the counts equal the plain pattern count, the plain version of the
    values and numpy's histogram of the float64 values (NaN dropped), one
    launch a call."""
    from dask_array_tpu_torch.kernels import histogram as hk

    x, dt = _every_byte(name, seed=nbins)
    kind = dt if dt is not None else x.dtype
    e = torch.from_numpy(np.linspace(-4.0, 4.0, nbins + 1)).to(edges_dtype).cuda()
    hk.LAUNCHES = 0
    for v in (x, x[1:]):
        got = hk.histogram_counts_cuda(v, e, dtype=dt)
        torch.testing.assert_close(got, hk.histogram_bytes_plain(v, e, kind), rtol=0, atol=0)
        torch.testing.assert_close(got.cpu(), hk.histogram_counts_plain(v.cpu(), e.cpu(), None, dt), rtol=0, atol=0)
        vals = hk.byte_values(kind)[v.view(torch.uint8).cpu().to(torch.int64)].double().numpy()
        want = np.histogram(vals[~np.isnan(vals)], bins=e.double().cpu().numpy())[0]
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert hk.LAUNCHES == 2


@pytest.mark.gpu
@pytest.mark.parametrize("skew", ["one", "sixteen", "all"])
@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "int4"])
def test_histogram_kernel_byte_route_skewed_data(cuda, name, skew):
    """The byte route's private 8-bit counters on 2**25 + 3 bytes (about
    500 a thread, so every counter is flushed before it passes 255): every
    byte one pattern (the worst case of a shared atomic a byte), 16
    patterns and all 256, aligned and one element in (a byte a thread),
    equal to the plain pattern count and the plain version of the values,
    exactly."""
    import ml_dtypes

    from dask_array_tpu_torch.kernels import histogram as hk

    n = 2**25 + 3
    gen = torch.Generator(device="cuda").manual_seed(41)
    if skew == "one":
        raw = torch.full((n,), 0x35 if name != "int4" else 0x03, dtype=torch.uint8, device="cuda")
    elif skew == "sixteen":
        raw = (torch.randint(0, 16, (n,), generator=gen, device="cuda") + (0 if name == "int4" else 0x30)).to(
            torch.uint8)
    else:
        raw = torch.randint(0, 256, (n,), generator=gen, device="cuda").to(torch.uint8)
    x, dt = (raw, np.dtype(ml_dtypes.int4)) if name == "int4" else (raw.view(getattr(torch, name)), None)
    kind = dt if dt is not None else x.dtype
    e = torch.linspace(-8.0, 8.0, 257, dtype=torch.float64, device="cuda")
    for v in (x, x[1:]):
        got = hk.histogram_counts_cuda(v, e, dtype=dt)
        torch.testing.assert_close(got, hk.histogram_bytes_plain(v, e, kind), rtol=0, atol=0)
        torch.testing.assert_close(got, hk.histogram_counts_plain(v, e, None, dt), rtol=0, atol=0)
        assert int(got.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "int4", "float8_e4m3"])
def test_histogram_of_one_byte_data_through_the_api(cuda, name):
    """``da.histogram`` of float8 data raised on the card before the byte
    route (``DATA_CODES`` held no float8 type); now it computes, one K2
    launch, equal to numpy's histogram of the values; weighted, it decodes
    to float32 and takes the float32 route."""
    import ml_dtypes

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.kernels import histogram as hk

    dt = np.dtype(getattr(ml_dtypes, name))
    a = (np.random.default_rng(1).standard_normal(300_001) * 2).astype(np.float32).astype(dt)
    e = np.linspace(-4, 4, 257)
    w = np.random.default_rng(2).standard_normal(a.shape)
    hk.LAUNCHES = 0
    h, _ = da.histogram(da.from_array(a, chunks=65536), bins=e)
    np.testing.assert_array_equal(h.compute(), np.histogram(a.astype(np.float64), bins=e)[0])
    assert hk.LAUNCHES == 1
    hw, _ = da.histogram(da.from_array(a, chunks=65536), bins=e, weights=da.from_array(w, chunks=65536))
    np.testing.assert_allclose(hw.compute(), np.histogram(a.astype(np.float64), bins=e, weights=w)[0], rtol=1e-12,
                               atol=1e-12)
    assert hk.LAUNCHES == 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int2", "uint2", "int4", "uint4", "float4_e2m1fn", "float8_e3m4", "float8_e4m3",
                                  "float8_e4m3b11fnuz", "float8_e8m0fnu"])
def test_narrow_types_on_the_card_equal_the_cpu(cuda, name):
    """Each narrow type's ops on the card give the CPU's bytes: the codec
    is torch ops with one table, the same on both devices."""
    import ml_dtypes

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    dt = np.dtype(getattr(ml_dtypes, name))
    rng = np.random.default_rng(3)
    if name.startswith(("int", "uint")):
        info = ml_dtypes.iinfo(dt)
        a = rng.integers(info.min, info.max + 1, (64, 48)).astype(dt)
    elif name == "float8_e8m0fnu":  # no sign, no zero: powers of two
        a = (2.0 ** rng.integers(-6, 7, (64, 48))).astype(np.float32).astype(dt)
    else:
        a = (rng.standard_normal((64, 48)) * 2).astype(np.float32).astype(dt)
    progs = [lambda x: x * 2 + 1, lambda x: x.astype(np.float32), lambda x: x.sum(axis=0), lambda x: x.max(),
             lambda x: x.cumsum(axis=0), lambda x: da.where(x.astype(np.float32) > 0, x, x[::-1]),
             lambda x: x @ x.T, lambda x: x.T[::2]]
    for k, prog in enumerate(progs):
        got = np.asarray(prog(da.from_array(a, chunks=(16, 24))).compute())
        with config.set({"device": "cpu"}):
            want = np.asarray(prog(da.from_array(a, chunks=(16, 24))).compute())
        assert got.dtype == want.dtype and got.shape == want.shape
        if k == 6 and got.dtype == np.float32:
            # a float32 product sums in another order on each device
            mag = np.abs(a.astype(np.float32)) @ np.abs(a.astype(np.float32)).T
            assert np.all((np.abs(got - want) <= 1e-5 * mag) | (np.isnan(got) & np.isnan(want)))
        else:
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cumsum", "cumprod", "nancumsum"])
@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float4_e2m1fn", "float8_e4m3",
                                  "float8_e8m0fnu"])
def test_byte_float_scans_on_the_card_equal_the_cpu(cuda, name, kind):
    """A 1-byte float scan runs on the card (K3, ``kernels/scan.py``: its
    table is made on the CPU, so a NaN's sign is the same on both devices)
    and gives the CPU's bytes, along either axis, NaN and overflow
    included."""
    import ml_dtypes

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config

    a = (np.random.default_rng(5).standard_normal((300, 70)) * 64).astype(getattr(ml_dtypes, name))
    a[3, 2] = np.nan
    for axis in (0, 1):
        held = getattr(da, kind)(da.from_array(a, chunks=(100, 35)), axis=axis).compute_device()
        assert held.device.type == "cuda"
        with config.set({"device": "cpu"}):
            want = np.asarray(getattr(da, kind)(da.from_array(a, chunks=(100, 35)), axis=axis).compute())
        assert np.array_equal(held.cpu().view(torch.uint8).numpy(), want.view(np.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int4", "float8_e4m3", "float8_e4m3fn"])
def test_narrow_types_under_a_card_mesh_equal_the_walk(cuda, name):
    """Narrow data under 4 slots on the card, in both lanes: the shard lane
    declines it and the partitioned walk's reductions, scans and
    contractions take their dense builds, so each result is the walk's
    without a mesh, byte for byte."""
    import ml_dtypes

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.parallel import use_mesh

    a = (np.random.default_rng(6).standard_normal((64, 12)) * 3).astype(getattr(ml_dtypes, name))
    progs = [lambda x: x.max(axis=0), lambda x: x.sum(axis=0), lambda x: x.argmax(axis=0),
             lambda x: x.cumsum(axis=0), lambda x: da.tensordot(x, x, axes=([0], [0]))]
    for prog in progs:
        want = np.asarray(prog(da.from_array(a, chunks=(8, 12))).compute())
        for lane in ("gspmd", "auto"):
            with use_mesh(_card_mesh((4,), ("r",))), config.set({"execution-lane": lane}):
                got = np.asarray(prog(da.from_array(a, chunks=(8, 12))).compute())
            assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int4", "float8_e4m3", "float8_e4m3fn", "bfloat16", "datetime64[ns]"])
def test_pinned_rings_move_one_two_and_eight_byte_words(cuda, dtype):
    """Uploads and fetches of a narrow carrier, float8, bfloat16 and
    datetime ticks through the pinned rings: the same bytes both ways."""
    import ml_dtypes

    from dask_array_tpu_torch import _hostcopy
    from dask_array_tpu_torch._chunks import tensor_of

    dt = np.dtype(getattr(ml_dtypes, dtype, None) or dtype)
    raw = np.random.default_rng(4).integers(0, 256, (300, 77) + (dt.itemsize,), dtype=np.uint8)
    arr = raw.view(dt).reshape(300, 77)[:, 3:70]
    up = _hostcopy.upload(arr, cuda)
    assert up.dtype == tensor_of(arr).dtype
    back = _hostcopy.fetch(up)
    assert np.array_equal(back.view(np.uint8), np.ascontiguousarray(arr).view(np.uint8))


@pytest.mark.gpu
def test_streamed_dtypes_on_the_card(cuda):
    """The out-of-core lane on the card: a bfloat16 stencil with K1 once a
    panel, a float8 sum and a datetime min and max, each equal to in-core."""
    import ml_dtypes

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import _streaming, config
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.models.pipelines import stencil2d

    rng = np.random.default_rng(5)
    bf = rng.standard_normal((2048, 256)).astype(ml_dtypes.bfloat16)
    f8 = rng.standard_normal((4096, 128)).astype(np.float32).astype(ml_dtypes.float8_e4m3fn)
    ticks = np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**15, (4096, 64)).astype("m8[ns]")
    ticks[7, 5] = np.datetime64("NaT")
    in_core = [stencil2d(chunk=256, x_np=bf).compute(), da.from_array(f8, chunks=(512, 128)).sum(axis=0).compute(),
               da.from_array(ticks, chunks=(512, 64)).min(axis=0).compute(),
               da.from_array(ticks, chunks=(512, 64)).max(axis=0).compute()]
    stencil.LAUNCHES = 0
    before = _streaming.STREAMED["panels"]
    with config.set({"out-of-core": "force", "memory-budget": 400_000}):
        out = stencil2d(chunk=256, x_np=bf).compute()
        panels = _streaming.STREAMED["panels"] - before
        streamed = [out, da.from_array(f8, chunks=(512, 128)).sum(axis=0).compute(),
                    da.from_array(ticks, chunks=(512, 64)).min(axis=0).compute(),
                    da.from_array(ticks, chunks=(512, 64)).max(axis=0).compute()]
    assert panels >= 2 and stencil.LAUNCHES == panels
    for a, b in zip(streamed, in_core):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# K1's program kernels: a non-linear func's captured program, generated as
# CUDA and built at its first use, against the plain version on the card.
# Contract: equal bytes for programs of + - * /, neg, abs, sqrt, floor,
# ceil, sign, square, reciprocal, maximum/minimum, clamp, comparisons and
# where; within 2 ulp of the result's type where a transcendental function
# or a general power appears (the kernel and torch's CUDA kernels call the
# same CUDA math library; 2-byte types compute in float32 on both sides
# and round once).
# ---------------------------------------------------------------------------


def _r(b, dy, dx):
    return torch.roll(b, (dy, dx), (0, 1))


# one program an op (float32, depth (1, 1)), each non-linear, so no tap
# list takes it; the bool says "equal bytes"
PROGRAM_OPS = {
    "add": (lambda b: b * b + _r(b, 1, 0), True),
    "sub": (lambda b: _r(b, -1, 1) - b * _r(b, 0, 1), True),
    "mul": (lambda b: b * _r(b, 0, 1), True),
    "div": (lambda b: b / (_r(b, 1, 1).abs() + 0.5), True),
    "div_scalar": (lambda b: (b * _r(b, 1, 0)) / 3.0, True),
    "rdiv_scalar": (lambda b: 3.0 / (b.abs() + _r(b, 0, -1).abs() + 0.25), True),
    "neg": (lambda b: -(b * _r(b, 1, 0)), True),
    "abs": (lambda b: torch.abs(b - _r(b, 0, 1)), True),
    "sqrt": (lambda b: torch.sqrt(b.abs() + _r(b, 1, 0).abs()), True),
    "floor": (lambda b: torch.floor(4 * b + _r(b, 0, 1)), True),
    "ceil": (lambda b: (4 * b - _r(b, 1, 0)).ceil(), True),
    "sign": (lambda b: torch.sign(b - _r(b, 1, 0)) * _r(b, 0, 1), True),
    "square": (lambda b: torch.square(b - _r(b, 0, 1)), True),
    "reciprocal": (lambda b: torch.reciprocal(b.abs() + _r(b, -1, 0).abs() + 0.5), True),
    "pow2": (lambda b: (b + _r(b, 1, 0)) ** 2, True),
    "pow3": (lambda b: (b - _r(b, 0, 1)).pow(3), True),
    "maximum": (lambda b: torch.maximum(b, _r(b, 1, 1)), True),
    "minimum": (lambda b: b.minimum(_r(b, -1, -1)) - _r(b, 1, 0), True),
    "clamp": (lambda b: torch.clamp(b + _r(b, 0, 1), -0.5, 0.75), True),
    "clamp_min": (lambda b: b.clamp(min=0) * _r(b, 1, 0), True),
    "clip_max": (lambda b: torch.clip(b - _r(b, -1, 0), max=0.3), True),
    "where_gt": (lambda b: torch.where(b > _r(b, 1, 0), b, _r(b, -1, 0)), True),
    "where_ge": (lambda b: torch.where(b >= 0.25, 2 * b, _r(b, 0, 1)), True),
    "where_lt": (lambda b: torch.where(_r(b, 0, -1) < b, 0.0, b), True),
    "where_le": (lambda b: b.where(b <= _r(b, 1, 1), -b), True),
    "where_eq": (lambda b: torch.where(torch.floor(2 * b) == torch.floor(2 * _r(b, 1, 0)), b, -b), True),
    "where_ne": (lambda b: torch.where(torch.ceil(b) != torch.ceil(_r(b, 0, 1)), _r(b, 0, 1), 1.5), True),
    "rsqrt": (lambda b: torch.rsqrt(b * b + _r(b, 1, 0).abs() + 0.5), False),
    "exp": (lambda b: torch.exp(b - _r(b, 1, 0)), False),
    "expm1": (lambda b: torch.expm1(b * _r(b, 0, 1)), False),
    "log": (lambda b: torch.log(b.abs() + _r(b, 0, 1).abs() + 0.1), False),
    "log1p": (lambda b: torch.log1p(b.abs() * _r(b, 1, 0).abs()), False),
    "tanh": (lambda b: torch.tanh(laplace(b)), False),
    "sigmoid": (lambda b: torch.sigmoid(b + _r(b, -1, 0)), False),
    "sin": (lambda b: torch.sin(3 * b - _r(b, 0, 1)), False),
    "cos": (lambda b: b.cos() * _r(b, 1, 1), False),
    "pow_general": (lambda b: (b.abs() + _r(b, 1, 0).abs() + 0.1) ** 1.7, False),
    "pow_m2": (lambda b: (b.abs() + 0.5) ** -2, False),
    "pow_half": (lambda b: (b.abs() + _r(b, 0, 1).abs()) ** 0.5, False),
}


def exact_program(d0, d1):
    """Every exact op in one program, its taps reaching the depth."""
    def f(b):
        a, c = _r(b, d0, 0), _r(b, 0, -d1)
        w = torch.where(a > b, torch.maximum(b, c), torch.minimum(a, c)) * 0.5
        return (w - torch.clamp(_r(b, -d0, d1), -0.5, 1.0) / 3.0 + torch.abs(b).floor()
                - torch.ceil(a) * torch.sign(c) + (-b) / (torch.abs(c) + 1) + torch.square(a - c))
    return f


def transcendental_program(d0, d1):
    """The transcendental ops in one program, summed as positive terms."""
    def f(b):
        a, c = _r(b, -d0, 0), _r(b, 0, d1)
        return (torch.tanh(a - c).abs() + torch.exp(-b * b) + torch.log1p(c.abs()) + torch.sigmoid(a)
                + torch.cos(b) + 1.5 + torch.sin(c).abs() + torch.log(a.abs() + 1) + (b.abs() + 0.5) ** 1.3)
    return f


PROGRAM_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64]
PROGRAM_DEPTHS = [(1, 1), (2, 2), (8, 8), (3, 0), (0, 2)]


def _program_items():
    from dask_array_tpu_torch.kernels import stencil

    items = [stencil.program_build_item(stencil.capture_program(f, (1, 1)), (1, 1), torch.float32)
             for f, _ in PROGRAM_OPS.values()]
    for maker in (exact_program, transcendental_program):
        for dt in PROGRAM_DTYPES:
            for depth in PROGRAM_DEPTHS:
                items.append(stencil.program_build_item(stencil.capture_program(maker(*depth), depth), depth, dt))
    for func, depth in EXTREMUM_PROGRAMS.values():
        for dt in PROGRAM_DTYPES:
            items.append(stencil.program_build_item(stencil.capture_program(func, depth), depth, dt))
    return items


@pytest.fixture(scope="module")
def programs_built():
    """Every program these tests launch, built in parallel (one nvcc each)
    before the first launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dask_array_tpu_torch.kernels import _build

    return _build.build_all(_program_items())


def ulps_apart(got, want):
    """The most units in the last place between two tensors of one float
    dtype; NaN against NaN is 0."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
    nbits = 8 * got.element_size()

    def ordered(t):
        v = t.contiguous().view(bits).long()
        return torch.where(v < 0, -(v & ((1 << (nbits - 1)) - 1)), v)

    both_nan = got.isnan() & want.isnan()
    diff = (ordered(got) - ordered(want)).abs()
    return int(torch.where(both_nan, torch.zeros_like(diff), diff).max())


def _program_case(x, func, depth, bnd, exact):
    from dask_array_tpu_torch.kernels import stencil

    program = stencil.capture_program(func, depth)
    assert program is not None and stencil.capture_taps(func, depth) is None
    before = stencil.VARIANT_LAUNCHES["program"]
    got = stencil.band_stencil_call(x, func, depth, bnd, program)
    want = stencil.band_stencil_plain(x, func, depth, bnd)
    torch.cuda.synchronize()
    assert stencil.VARIANT_LAUNCHES["program"] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype == x.dtype
    if exact:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)) or ulps_apart(got, want) == 0
    else:
        assert ulps_apart(got, want) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("op", list(PROGRAM_OPS))
@pytest.mark.parametrize("shape, bnd", [((1000, 1003), ("reflect", 2.5)), ((1024, 1024), ("periodic", "nearest"))])
def test_program_kernel_each_op(cuda, programs_built, op, shape, bnd):
    """One op a program, float32 at depth (1, 1): an odd width (scalar rows,
    ``vector_ok`` false) and a 16-byte one (cp.async rows)."""
    from dask_array_tpu_torch.kernels import stencil

    func, exact = PROGRAM_OPS[op]
    x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(35), device="cuda")
    assert stencil.vector_ok(x, torch.empty_like(x)) is (shape[1] % 4 == 0)
    _program_case(x, func, (1, 1), bnd, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", PROGRAM_DTYPES, ids=str)
@pytest.mark.parametrize("depth", PROGRAM_DEPTHS, ids=str)
@pytest.mark.parametrize("kind", ["exact", "transcendental"])
def test_program_kernel_dtypes_depths_boundaries(cuda, programs_built, dtype, depth, kind):
    """Every dtype, depths to 8 and every boundary pair's corner, on an odd
    shape, a 16-byte one and a tensor one element into its storage."""
    maker = exact_program if kind == "exact" else transcendental_program
    func = maker(*depth)
    gen = torch.Generator(device="cuda").manual_seed(36)
    for shape in ((517, 301), (512, 1024)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for bnd in (("reflect", "periodic"), ("nearest", 2.5), (0.0, "reflect"), ("periodic", -1.5)):
            _program_case(x, func, depth, bnd, kind == "exact")
    x = torch.randn(300 * 257 + 1, generator=gen, device="cuda").to(dtype)[1:].view(300, 257)
    _program_case(x, func, depth, ("reflect", "nearest"), kind == "exact")


def _laplace32(x):
    """The float32 depth-1 Laplace of ``x`` in ``laplace_roll``'s order,
    dask's "reflect" being numpy's ``symmetric`` pad."""
    p = np.pad(x, 1, mode="symmetric")
    r = lambda dy, dx: np.roll(p, (dy, dx), (0, 1))  # noqa: E731
    return (r(1, 0) + r(-1, 0) + r(0, 1) + r(0, -1) - np.float32(4) * p)[1:-1, 1:-1]


@pytest.mark.gpu
def test_program_kernel_through_map_overlap(cuda, programs_built):
    """tanh(laplace) and a kwarg func through map_overlap on the card: one
    BandStencil, one program launch, no halo launch, equal to numpy's
    float32 steps (tanh in float64, rounded once) within float32 rounding.
    numpy is the reference, not the port's CPU run: one run of this test
    saw the CPU run, not the card, off numpy (scripts/check_stencil_sides.py
    holds each side on its own)."""
    import functools

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import halo, stencil
    from dask_array_tpu_torch.models.pipelines import limited_diffusion, tanh_laplace
    from dask_array_tpu_torch.ops._overlap import BandStencil

    x = np.random.default_rng(35).standard_normal((512, 384)).astype(np.float32)
    lap = _laplace32(x)
    d = np.float32(0.25) * lap
    diffused = x + np.where(np.abs(d) > np.float32(0.1), np.sign(d) * np.float32(0.1), d)
    for func, kw, want in ((tanh_laplace, {}, np.tanh(lap.astype(np.float64)).astype(np.float32)),
                           (limited_diffusion, {"rate": 0.25, "limit": 0.1}, diffused)):
        with config.set({"device": "cuda"}):
            arr = da.map_overlap(func, da.from_array(x, chunks=128), depth=1, boundary="reflect", **kw)
            assert isinstance(arr.expr, BandStencil) and stencil.is_program(arr.expr.taps)
            h0 = halo.LAUNCHES
            stencil.reset_launches()
            got = arr.compute()
            assert stencil.VARIANT_LAUNCHES == {"window": 0, "taps": 0, "program": 1}
            assert stencil.LAUNCHES == 1 and halo.LAUNCHES == h0
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    bound = functools.partial(limited_diffusion, rate=0.25, limit=0.1)
    assert stencil.capture_program(bound, (1, 1)) == arr.expr.taps


@pytest.mark.gpu
def test_program_scalars_go_by_value_on_the_card(cuda):
    """The diffusion step at several rates and limits (-0.0, inf and NaN
    among them): one library for all, each launch equal in bytes to its
    plain version with its own scalars."""
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.models.pipelines import limited_diffusion

    x = torch.randn((300, 257), generator=torch.Generator(device="cuda").manual_seed(37), device="cuda")
    sources = set()
    for rate, limit in ((0.2, 0.05), (0.3, 0.1), (1.0 / 3.0, -0.0), (0.25, float("inf")), (0.5, float("nan"))):
        func = stencil.bind_kwargs(limited_diffusion, {"rate": rate, "limit": limit})
        sources.add(stencil.program_source(stencil.capture_program(func, (1, 1)), (1, 1), torch.float32))
        _program_case(x, func, (1, 1), ("reflect", 0.5), True)
    assert len(sources) == 1


@pytest.mark.gpu
def test_program_kernel_build_failure_raises(cuda, monkeypatch):
    """A program whose build fails raises on a CUDA tensor: no fallback."""
    from dask_array_tpu_torch.kernels import stencil

    real = stencil.program_source
    monkeypatch.setattr(stencil, "program_source", lambda *a: "#error a source nvcc refuses\n" + real(*a))
    func = lambda b: torch.tanh(b * 0.987654321 + _r(b, 1, 0))  # noqa: E731 - a program no other test builds
    program = stencil.capture_program(func, (1, 1))
    x = torch.randn(64, 64, device="cuda")
    before = stencil.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        stencil.band_stencil_call(x, func, (1, 1), ("reflect", "reflect"), program)
    assert stencil.LAUNCHES == before


@pytest.mark.gpu
def test_program_kernel_refuses_what_it_does_not_take(cuda):
    from dask_array_tpu_torch.kernels import stencil

    program = stencil.capture_program(lambda b: torch.tanh(_r(b, 1, 0)), (1, 1))
    x = torch.randn(64, 64, device="cuda")
    with pytest.raises(ValueError, match="do not fit"):
        stencil.band_program_cuda(x, program, (0, 1), ("reflect", "reflect"))
    with pytest.raises(ValueError, match="contiguous"):
        stencil.band_program_cuda(x.t(), program, (1, 1), ("reflect", "reflect"))
    with pytest.raises(TypeError, match="does not take"):
        stencil.band_program_cuda(x.int(), program, (1, 1), ("reflect", "reflect"))
    with pytest.raises(ValueError, match="boundary"):
        stencil.band_program_cuda(x, program, (1, 1), ("wrap", "reflect"))


# NaN bit patterns a test plants, by dtype: quiet with a payload, negative,
# signalling, all ones
NAN_PATTERNS = {torch.float16: [0x7E01, -0x01FE, 0x7D03, 0x7FFF], torch.bfloat16: [0x7FC1, -0x003F, 0x7F83, 0x7FFF],
                torch.float32: [0x7FC00001, -0x003FFFFE, 0x7FA00003, 0x7FFFFFFF],
                torch.float64: [0x7FF8000000000001, -0x0007FFFFFFFFFFFE, 0x7FF4000000000003, 0x7FFFFFFFFFFFFFFF]}


def special_tensor(shape, dtype, seed):
    """Normals on the card with NaN of the four ``NAN_PATTERNS``, +0, -0,
    +inf and -inf each in a few percent of the places, a block of NaN and
    one of -0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    pick = rng.random(shape)
    for i, v in enumerate((np.nan, 0.0, -0.0, np.inf, -np.inf)):
        x[(pick >= 0.04 * i) & (pick < 0.04 * i + 0.03)] = v
    x[10:13, 20:23] = np.nan
    x[30:33, 40:43] = -0.0
    t = torch.from_numpy(x).to(dtype).cuda()
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    flat = t.view(bits).reshape(-1)
    at = torch.nonzero(torch.isnan(t).reshape(-1)).reshape(-1)
    flat[at] = torch.tensor(NAN_PATTERNS[dtype], dtype=bits, device="cuda")[torch.arange(len(at), device="cuda") % 4]
    return t


def _chain(which):
    ext = torch.maximum if which == "max" else torch.minimum

    def f(b):
        out = b
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    out = ext(out, _r(b, dy, dx))
        return out

    return f


EXTREMUM_PROGRAMS = {
    "max_filter": (_chain("max"), (1, 1)),
    "min_filter": (_chain("min"), (1, 1)),
    "mixed": (lambda b: torch.minimum(torch.maximum(b, _r(b, 1, 0)), _r(b, 0, -1)) + b, (1, 1)),
    "deep": (lambda b: torch.maximum(_r(b, 3, 0), torch.minimum(b, _r(b, 0, -3))), (3, 3)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", PROGRAM_DTYPES, ids=str)
@pytest.mark.parametrize("name", list(EXTREMUM_PROGRAMS))
def test_program_extremum_chains_byte_for_byte(cuda, programs_built, name, dtype):
    """maximum/minimum chains (the max and min filters, a mixed chain, a
    deep one that reads its taps from the tile) on NaN of four bit
    patterns, ±0 and ±inf: the kernel's fast pass and its NaN path equal
    the plain version byte for byte, the NaN's own bits and the zero's
    sign included; an odd shape, a 16-byte one and a reflect/constant
    corner."""
    from dask_array_tpu_torch.kernels import stencil

    func, depth = EXTREMUM_PROGRAMS[name]
    program = stencil.capture_program(func, depth)
    assert program is not None
    for shape, bnd in (((517, 301), ("reflect", 2.5)), ((512, 1024), ("nearest", "periodic"))):
        x = special_tensor(shape, dtype, 70)
        got = stencil.band_program_cuda(x, program, depth, bnd)
        want = stencil.band_stencil_plain(x, func, depth, bnd)
        torch.cuda.synchronize()
        assert torch.isnan(want).any() and (name == "mixed" or (want == 0).any())
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


# -- K3: the step-rounded scan of 2-byte and 1-byte floats ------------------------

SCAN_TYPES = ("float16", "bfloat16", "float8_e4m3fn", "float8_e5m2")


def _stage_steps(shape, axis, itemsize):
    """Steps a tile of K3 holds for chains of this shape (``launch_plan``)."""
    from dask_array_tpu_torch.kernels import scan

    p, _, q = scan.scan_plan(shape, axis)
    return scan.launch_plan(p, 10**7, q, itemsize).depth


# (shape, axis): column chains (Q > 1) and row chains (Q == 1) with ragged
# warps and tiles, rows not 16-byte aligned, a 3-D block and a 1-D one (one
# chain); then a 3-D block with P > 1, Q no multiple of the strip, L of 1
# and 2, L one more than a stage (for 2-byte and 1-byte tiles), 128 chains
# of 1e6 steps, one chain of 2^22 steps and 16384^2 along both axes
SCAN_SHAPES = [((300, 70), 0), ((300, 70), 1), ((45, 130), 1), ((5, 300, 7), 1), ((21000,), 0),
               ((6, 700, 40), 1), ((300, 200), 0), ((1, 300), 0), ((2, 300), 0), ((64, 333), 1),
               ((_stage_steps((1, 64), 0, 2) + 1, 64), 0), ((_stage_steps((1, 64), 0, 1) + 1, 64), 0),
               ((200, _stage_steps((200, 1), 1, 2) + 1), 1), ((200, _stage_steps((200, 1), 1, 1) + 1), 1),
               ((1_000_000, 128), 0), ((1 << 22,), 0), ((16384, 16384), 0), ((16384, 16384), 1)]
LONG_CHAIN = 65536  # past this many steps the plain version checks the first and the last 4096


def _scan_dtype(name):
    import ml_dtypes

    return np.dtype(np.float16) if name == "float16" else np.dtype(getattr(ml_dtypes, name))


def scan_grid(name, kind, shape, seed, scale=300, spread=True):
    """Values of ``name`` in ``shape``: normals (near 1 for products; times
    ``scale`` for sums, by default large enough to overflow float16), with
    NaNs of both signs and two payloads, ±inf, ±0 and the smallest
    subnormals planted (one element in 4000 each, or with ``spread`` false
    once each)."""
    dt = _scan_dtype(name)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape)
    v = 1 + v / 64 if kind.endswith("cumprod") else v * scale
    x = v.astype(dt)
    flat = x.reshape(-1)
    n = flat.size
    if dt.itemsize == 2:
        bits = flat.view(np.uint16)
        half = dt == np.float16
        specials = [0x7E01 if half else 0x7FC1, 0xFD55 if half else 0xFFD5, 0x7C00 if half else 0x7F80,
                    0xFC00 if half else 0xFF80, 0x0000, 0x8000, 0x0001, 0x8001]
    else:
        bits = flat.view(np.uint8)
        specials = [int(v) for v in np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], dt).view(np.uint8)]
    for k, b in enumerate(specials):
        if spread:
            bits[rng.integers(0, n, max(1, n // 4000))] = b
        bits[(k * 7919) % n] = b
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", SCAN_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
@pytest.mark.parametrize("name", SCAN_TYPES)
def test_scan_kernel_equals_its_plain_version(cuda, name, kind, shape, axis):
    """K3 against its plain version on the same card tensor, byte for byte
    (both make NaNs by the same rule, and 1-byte types share the table).
    Chains of more than ``LONG_CHAIN`` steps (values a walk of unit steps,
    each special value planted once, so most chains stay finite) are held
    to it on their first 4096 steps and on
    their last 4096 scanned from the kernel's output before them: the
    carry and the NaN bits of a chain both are its last output."""
    from dask_array_tpu_torch._chunks import tensor_of
    from dask_array_tpu_torch.kernels import scan

    dt = _scan_dtype(name)
    long = shape[axis] > LONG_CHAIN
    t = tensor_of(scan_grid(name, kind, shape, seed=len(shape) + axis, scale=1 if long else 300,
                            spread=not long)).cuda()
    before = scan.LAUNCHES
    got = scan.rounded_scan_cuda(t, kind, axis, dt)
    torch.cuda.synchronize()
    assert scan.LAUNCHES == before + 1
    assert got.dtype == t.dtype and got.shape == t.shape and got.is_contiguous()
    width = torch.int16 if t.element_size() == 2 else torch.uint8
    if not long:
        want = scan.rounded_scan_plain(t, kind, axis, dt)
        assert torch.equal(got.view(width), want.view(width))
        return
    n, m = shape[axis], shape[axis] - 4096
    head = scan.rounded_scan_plain(t.narrow(axis, 0, 4096), kind, axis, dt)
    assert torch.equal(got.narrow(axis, 0, 4096).view(width), head.view(width))
    tail_terms = torch.cat([got.narrow(axis, m - 1, 1), t.narrow(axis, m, n - m)], dim=axis)
    tail = scan.rounded_scan_plain(tail_terms, kind, axis, dt)
    assert torch.equal(got.narrow(axis, m - 1, n - m + 1).view(width), tail.view(width))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
@pytest.mark.parametrize("name", ["float16", "bfloat16"])
def test_scan_kernel_on_every_pair(cuda, name, kind):
    """Every pair (a, b) of 2-byte patterns, all 2^32 of them, as a
    two-step chain (``out[1] = step(a, b)``), in 16 slices of a (2, 2^28)
    block: K3 equals its plain version on the card byte for byte, NaN bits
    included (the rule fixes them).  This settles that the kernel's native
    op rounds as the float32 op rounded to the type does."""
    from dask_array_tpu_torch.kernels import scan

    dt = _scan_dtype(name)
    held = torch.float16 if name == "float16" else torch.bfloat16
    j = torch.arange(1 << 28, dtype=torch.int32, device="cuda")

    def bits(v):  # 0..65535 as int16 patterns
        return (v - ((v >> 15) << 16)).to(torch.int16)

    b = bits(j & 0xFFFF)
    wrong, first = 0, None
    for s in range(16):
        a = bits((j >> 16) + (s << 12))
        x = torch.stack([a, b]).view(held)
        got = scan.rounded_scan_cuda(x, kind, 0, dt).view(torch.int16)
        want = scan.rounded_scan_plain(x, kind, 0, dt).view(torch.int16)
        assert torch.equal(got[0], a)
        off = got[1] != want[1]
        n = int(off.sum())
        if n and first is None:
            first = [[hex(int(v) & 0xFFFF) for v in w[off][:8]] for w in (a, b, got[1], want[1])]
        wrong += n
        del x, got, want, off, a
    assert wrong == 0, (wrong, first)


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [(2, 0), (0, 6), (4, 4)], ids=str)
@pytest.mark.parametrize("shape,axis", [((256, 64), 0), ((64, 256), 1), ((4096,), 0)], ids=str)
@pytest.mark.parametrize("name", SCAN_TYPES)
def test_scan_kernel_on_unaligned_pointers(cuda, name, shape, axis, offsets):
    """Input and output views that start off a 16-byte boundary, with rows
    that would be aligned: K3 copies the envelope of each run and stores
    its outputs itself, and equals its plain version."""
    from dask_array_tpu_torch._chunks import tensor_of
    from dask_array_tpu_torch.kernels import scan

    dt = _scan_dtype(name)
    t = tensor_of(scan_grid(name, "cumsum", shape, seed=13)).cuda()
    n, es = t.numel(), t.element_size()
    xs = torch.zeros(n + 16, dtype=t.dtype, device="cuda")[offsets[0] // es:][:n].view(shape)
    xs.copy_(t)
    out_pad = torch.zeros(n + 16, dtype=t.dtype, device="cuda")
    assert xs.data_ptr() % 16 == offsets[0] % 16
    got = scan.rounded_scan_cuda(xs, "cumsum", axis, dt)
    want = scan.rounded_scan_plain(t, "cumsum", axis, dt)
    width = torch.int16 if es == 2 else torch.uint8
    assert torch.equal(got.view(width), want.view(width))
    # the output of a launch into a view off a boundary, through the entry point itself
    p, L, q = scan.scan_plan(shape, axis)
    out = out_pad[offsets[1] // es:][:n]
    plan = scan.launch_plan(p, L, q, es, scan._sm_count(0), xs.data_ptr(), out.data_ptr())
    assert not plan.aligned
    code = scan.scan_type(dt)
    table = scan.device_table(dt, "cumsum", xs.device) if code == 2 else None
    scan._launcher()(0, xs.data_ptr(), out.data_ptr(), None if table is None else table.data_ptr(), p, L, q, code, 0,
                     plan.fields())
    torch.cuda.synchronize()
    assert torch.equal(out.view(shape).view(width), want.view(width))
    assert not out_pad[:offsets[1] // es].view(width).any() and not out_pad[offsets[1] // es + n:].view(width).any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
@pytest.mark.parametrize("name", SCAN_TYPES)
def test_step_chain_is_the_kernels_step(cuda, name, kind):
    """``step_chain_cuda`` (the latency floor's chain) steps as the plain
    version does: n steps over eight terms in turn from the ninth."""
    from dask_array_tpu_torch._chunks import tensor_of
    from dask_array_tpu_torch.kernels import scan

    dt = _scan_dtype(name)
    rng = np.random.default_rng(17)
    v = 1 + rng.standard_normal(9) / 64 if kind == "cumprod" else rng.standard_normal(9) * 3
    x = v.astype(dt)
    n = 64
    seq = np.concatenate([x[8:9], np.tile(x[:8], n // 8)])
    want = scan.rounded_scan_plain(tensor_of(seq).cuda(), kind, 0, dt)[-1:]
    width = torch.int16 if dt.itemsize == 2 else torch.uint8
    got = scan.step_chain_cuda(tensor_of(x).cuda(), kind, dt, n)
    assert torch.equal(got.view(width), want.view(width))


@pytest.mark.gpu
@pytest.mark.parametrize("name", SCAN_TYPES)
def test_scan_on_the_card_never_runs_the_plain_version(cuda, name, monkeypatch):
    """A scan of a CUDA block launches K3 and never reaches the plain
    version: with it made to raise, the walk still computes, one launch a
    scan."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.kernels import scan

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for attr in ("rounded_scan_plain", "_float_scan_plain", "_byte_scan_plain"):
        monkeypatch.setattr(scan, attr, refuse)
    x = scan_grid(name, "cumsum", (300, 70), seed=5)
    scan.LAUNCHES = 0
    for axis in (0, 1):
        held = da.cumsum(da.from_array(x, chunks=(64, 35)), axis=axis).compute_device()
        assert held.device.type == "cuda"
    assert scan.LAUNCHES == 2


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, None])
@pytest.mark.parametrize("kind", ["cumsum", "cumprod", "nancumsum", "nancumprod"])
@pytest.mark.parametrize("name", ["float16", "bfloat16"])
def test_two_byte_scans_on_the_card_equal_numpy(cuda, name, kind, axis):
    """The walk on the card launches K3 once for the dense block and gives
    numpy's bytes (ml_dtypes' for bfloat16), NaN, ±inf, ±0 and subnormals
    included; a nan-scan replaces NaN with the identity first, bfloat16's
    too (as the JAX package's ``jnp.nancumsum`` does).  A NaN may be any
    NaN only from a step whose operands were both NaN (which survives is
    the host's choice)."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.kernels import scan

    dt = _scan_dtype(name)
    x = scan_grid(name, kind, (300, 70), seed=9)
    with np.errstate(all="ignore"):
        terms = np.where(np.isnan(x.astype(np.float32)), 0 if kind.endswith("sum") else 1, x).astype(dt) \
            if kind.startswith("nan") else x
        want = getattr(np, "cumsum" if kind.endswith("cumsum") else "cumprod")(terms, axis=axis)
    scan.LAUNCHES = 0
    held = getattr(da, kind)(da.from_array(x, chunks=(64, 35)), axis=axis).compute_device()
    assert held.device.type == "cuda" and scan.LAUNCHES == 1
    got = held.cpu().view(torch.int16).numpy().view(dt)
    if axis is None:
        got, want, terms, axis = got.ravel(), want.ravel(), terms.ravel(), 0
    nan = lambda a: np.isnan(a.astype(np.float32))  # noqa: E731
    both = np.zeros(want.shape, dtype=bool)
    prev = np.take(want, np.arange(want.shape[axis] - 1), axis=axis)
    later = np.take(terms, np.arange(1, want.shape[axis]), axis=axis)
    pad = [(0, 0)] * want.ndim
    pad[axis] = (1, 0)
    both = np.logical_or.accumulate(np.pad(nan(prev) & nan(later), pad), axis=axis)
    exact = got.view(np.uint16) == want.view(np.uint16)
    assert np.all(exact | (both & nan(got) & nan(want)))


@pytest.mark.gpu
def test_scan_kernel_build_and_launch_failures_raise(cuda, monkeypatch):
    """A failed build or launch of K3 is an error on a CUDA tensor, never a
    scan on the host."""
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch.kernels import _build, scan

    x = np.arange(64, dtype=np.float16).reshape(8, 8)
    scan._launcher.cache_clear()
    _build.load_library.cache_clear()

    def refuse(name, source=None):
        raise RuntimeError(f"nvcc failed for {name}.cu (1):\nrefused")

    monkeypatch.setattr(_build, "build_library", refuse)
    before = scan.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        da.cumsum(da.from_array(x, chunks=4), axis=0).compute()
    assert scan.LAUNCHES == before
    monkeypatch.undo()
    scan._launcher.cache_clear()
    _build.load_library.cache_clear()
    t = torch.zeros(4, dtype=torch.float16, device="cuda")
    plan = scan.launch_plan(1, 4, 1, 2, scan._sm_count(0), t.data_ptr(), t.data_ptr())
    with pytest.raises(RuntimeError, match="scan kernel launch failed"):  # a block of no rows
        scan._launcher()(t.get_device(), t.data_ptr(), t.data_ptr(), None, 0, 4, 1, 0, 0, plan.fields())
    with pytest.raises(RuntimeError, match="scan kernel launch failed"):  # a byte scan, no table
        scan._launcher()(t.get_device(), t.data_ptr(), t.data_ptr(), None, 1, 4, 1, 2, 0, plan.fields())
    with pytest.raises(RuntimeError, match="scan kernel launch failed"):  # a grid past the units
        scan._launcher()(t.get_device(), t.data_ptr(), t.data_ptr(), None, 1, 4, 1, 0, 0,
                         plan._replace(grid=2).fields())
    with pytest.raises(TypeError, match="rounded_scan takes"):
        scan.rounded_scan_cuda(t.float(), "cumsum", 0, np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("lane", ["gspmd", "auto"])
def test_bfloat16_scan_along_a_sharded_axis_on_the_card(cuda, lane):
    """A bfloat16 cumsum along the axis a 4-slot mesh on cuda:0 shards is
    gathered and scanned by one K3 launch; it equals the walk without a
    mesh byte for byte."""
    import ml_dtypes

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import scan
    from dask_array_tpu_torch.parallel import use_mesh

    a = (np.random.default_rng(12).standard_normal((64, 12)) * 30).astype(ml_dtypes.bfloat16)
    want = np.asarray(da.cumsum(da.from_array(a, chunks=(8, 12)), axis=0).compute())
    assert want.tobytes() == np.cumsum(a, axis=0).tobytes()
    scan.LAUNCHES = 0
    with use_mesh(_card_mesh((4,), ("r",))), config.set({"execution-lane": lane}):
        got = np.asarray(da.cumsum(da.from_array(a, chunks=(8, 12)), axis=0).compute())
    assert scan.LAUNCHES == 1
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
