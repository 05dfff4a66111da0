"""Tiled transpose of the last two axes, with its plain PyTorch version.

Counterpart of ``bench/probe_pallas_min.py::_transp_call`` (the Pallas
probe of the ``rechunk_relayout`` workload): block (j, i) of the input goes
to block (i, j) of the output, transposed.  ``Transpose._build`` routes
every permutation that swaps the last two axes and keeps the leading ones
in place here, so its result is a laid-out (contiguous) tensor and not a
strided view.

- ``transpose_last2_plain(x)`` copies T x T tiles (T = 512, as the probe),
  ``out[..., j0:j1, i0:i1] = x[..., i0:i1, j0:j1].mT``, ragged edge tiles
  included;
- ``transpose_last2_cuda(x)`` launches the CUDA kernel
  (``csrc/transpose.cu``) and counts ``LAUNCHES``;
- ``transpose_last2(x)`` runs the plain version for a CPU tensor and the
  kernel for a CUDA tensor, with no fallback between them.

The probe's shape conditions (square, ``N % 512 == 0``) are dropped: the
kernel masks ragged edges and takes any batch, M, N and dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dask_array_tpu_torch.kernels._build import Launcher

PLAIN_TILE = 512  # the probe's block edge

# kernel launches since the last reset; only transpose_last2_cuda adds to it
LAUNCHES = 0


def _out_shape(x: torch.Tensor):
    if x.dim() < 2:
        raise ValueError(f"transpose_last2 needs at least 2 dimensions, got {x.dim()}")
    return (*x.shape[:-2], x.shape[-1], x.shape[-2])


def transpose_last2_plain(x: torch.Tensor) -> torch.Tensor:
    """``x.mT`` laid out contiguously, copied tile by tile in torch ops."""
    out = torch.empty(_out_shape(x), dtype=x.dtype, device=x.device)
    M, N = x.shape[-2:]
    for i0 in range(0, M, PLAIN_TILE):
        i1 = min(i0 + PLAIN_TILE, M)
        for j0 in range(0, N, PLAIN_TILE):
            j1 = min(j0 + PLAIN_TILE, N)
            out[..., j0:j1, i0:i1] = x[..., i0:i1, j0:j1].mT
    return out


def transpose_last2(x: torch.Tensor) -> torch.Tensor:
    """``x.mT`` laid out contiguously: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return transpose_last2_plain(x)
    return transpose_last2_cuda(x)


def transpose_last2_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the transpose kernel on a CUDA tensor of any dtype.

    The kernel reads the source in place when its last axis has unit
    stride and its leading axes merge into one batch stride (a row- or
    column-slice view, say); any other layout is made contiguous first,
    and a lazy conjugate or negative view is resolved first (the kernel
    moves bytes).  Raises on a non-CUDA tensor or one of fewer than 2
    dimensions.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"transpose_last2_cuda needs a CUDA tensor, got one on {x.device}")
    out = torch.empty(_out_shape(x), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x = x.resolve_conj().resolve_neg()
    M, N = x.shape[-2:]
    if x.stride(-1) != 1:
        x = x.contiguous()
    x3 = x.reshape(-1, M, N)  # a view when the leading axes merge, else a copy
    size = x3.element_size()
    if x3.data_ptr() % size:
        raise ValueError("transpose_last2_cuda needs a tensor aligned to its element size")
    _launcher()(x3.get_device(), x3.data_ptr(), out.data_ptr(), x3.shape[0], M, N, x3.stride(0), x3.stride(1), size)
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return Launcher("transpose", "transpose_launch", [p, p, ll, ll, ll, ll, ll, i], "transpose")
