"""The port on a CUDA card: the band-stencil kernel against its plain
version, its input checks, and the main path through ``compute()``.

Every test here needs a card and carries the ``gpu`` marker; without one
it skips.  The file imports neither jax nor the JAX package, so a machine
without JAX runs it with the repo's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: float32 rtol 1e-5 with atol scaled by sum|w| * max|x|, float64
1e-12 (kernel and plain version sum the taps in different orders).
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
