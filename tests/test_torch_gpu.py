"""The port on a CUDA card: the band-stencil, multi-statistic and
transpose kernels against their plain versions, their input checks, and
the main paths through ``compute()`` (stencil2d, reduction_tree,
normalize_contract, rechunk_relayout).

Every test here needs a card and carries the ``gpu`` marker; without one
it skips.  The file imports neither jax nor the JAX package, so a machine
without JAX runs it with the repo's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: float32 rtol 1e-5 with atol scaled by sum|w| * max|x|, float64
1e-12 (kernel and plain version sum the taps in different orders).  The
multi-statistic kernel: colsum/rowmean rtol 1e-5 with atol 4 * sqrt(terms)
* max|x| * 2^-23, std rtol 1e-4.  The transpose kernel moves bytes: its
result must equal the plain version's byte for byte.
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
@pytest.mark.parametrize("shape", [(1000, 1003), (1, 7), (4097, 33), (64, 5000)])
def test_mstat_kernel_matches_plain(cuda, shape):
    from dask_array_tpu_torch.kernels import mstat

    gen = torch.Generator(device=cuda).manual_seed(1)
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
                    torch.complex64, torch.complex128]


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
