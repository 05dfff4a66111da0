"""K3, the step-rounded scan of 2-byte and 1-byte floats, with its plain
PyTorch version.

Counterpart of the JAX package's dense scan, ``jnp.cumsum`` /
``jnp.cumprod`` in ``CumReduction._build``
(``dask_array_tpu/ops/reductions.py:831-845``), for the result types whose
scan numpy rounds to the type after every step: float16, bfloat16 (each
step a float32 add or multiply, rounded to the type) and the 1-byte floats
(torch's float8 types and the narrow float carriers of ``_narrow``: each
step a lookup in the type's 256 x 256 table of rounded results).  A torch
scan carries float32 and rounds once, so it gives other bytes.

A block is viewed as ``(P, L, Q)`` around the scanned axis (``scan_plan``):
``P * Q`` independent chains of ``L`` steps, each
``out[0] = x[0]`` and ``out[i] = step(out[i - 1], x[i])``.  A 2-byte step
makes a NaN by numpy's rule on x86-64, not by a conversion's: a NaN term's
bits quieted where the term is NaN, else the running value's bits quieted,
else (inf - inf, 0 * inf) the negative default NaN.  float16 quiets by
setting the payload's top bit, bfloat16 by the sign and 0x7fc0 (ml_dtypes
drops the payload).

- ``rounded_scan_plain(held, kind, axis, dtype)`` is a loop over ``L`` in
  torch ops, every chain at once;
- ``rounded_scan_cuda(...)`` launches the CUDA kernel (``csrc/scan.cu``)
  and counts ``LAUNCHES``;
- ``rounded_scan(...)`` runs the plain version for a CPU tensor and the
  kernel for a CUDA tensor, with no fallback between them.

``kind`` is ``cumsum``, ``cumprod``, ``nancumsum`` or ``nancumprod``; the
nan-scans' replacement of NaN terms happens before (``CumReduction``), so
here a nan-scan steps as its scan.  ``dtype`` is the block's numpy dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from dask_array_tpu_torch.kernels._build import Launcher

# kernel launches since the last reset; only rounded_scan_cuda adds to it
LAUNCHES = 0

# the kernel's type codes, and each 2-byte type's NaN rule as int16 bits:
# (the bits a quieted NaN sets, the bits it keeps, the default NaN)
_HALF, _BFLOAT, _BYTE = 0, 1, 2
_NAN_RULES = {
    torch.float16: (0x0200, -1, -512),  # h | 0x0200; 0xfe00
    torch.bfloat16: (0x7FC0, -32768, -64),  # (h & 0x8000) | 0x7fc0; 0xffc0
}


def scan_plan(shape, axis):
    """``(P, L, Q)`` of a scan of a block of ``shape`` along ``axis``."""
    shape = tuple(shape)
    return math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])


def scan_type(dtype) -> int | None:
    """The kernel's type code of numpy dtype ``dtype`` (float16, bfloat16
    or a 1-byte float), or None when K3 does not scan it."""
    from dask_array_tpu_torch._chunks import format_of, is_narrow

    dtype = np.dtype(dtype)
    if dtype == np.float16:
        return _HALF
    if dtype.name == "bfloat16":
        return _BFLOAT
    fmt = format_of(dtype)
    if is_narrow(dtype) and (fmt is None or fmt.is_float):
        return _BYTE
    return None


def _code(held, kind, dtype) -> int:
    """The kernel's type code of ``held``; raises on a block or a scan
    neither version takes."""
    if kind not in ("cumsum", "cumprod", "nancumsum", "nancumprod"):
        raise ValueError(f"rounded_scan: unknown scan {kind!r}")
    code = scan_type(dtype)
    if code is None or held.element_size() != (1 if code == _BYTE else 2) or \
            (code != _BYTE and held.dtype not in _NAN_RULES):
        raise TypeError(f"rounded_scan takes float16, bfloat16 or a 1-byte float block, got {held.dtype} "
                        f"({np.dtype(dtype)})")
    return code


@functools.lru_cache(maxsize=None)
def step_table(dtype, kind) -> torch.Tensor:
    """The 256 x 256 table of a 1-byte float type's rounded sums (products)
    of two patterns, ``table[running * 256 + term]`` (uint8, on the CPU).
    It is made from the type's own conversions on the CPU, so a NaN's sign
    (which a CPU and a card propagate differently) is the same wherever the
    table is used."""
    from dask_array_tpu_torch._chunks import as_stored, to_compute, torch_dtype

    held = torch_dtype(dtype)
    vals = to_compute(torch.arange(256, dtype=torch.int32).to(torch.uint8).view(held), dtype)
    step = torch.add if kind.endswith("cumsum") else torch.mul
    return as_stored(step(vals[:, None], vals[None, :]), dtype).view(torch.uint8).reshape(-1).contiguous()


@functools.lru_cache(maxsize=None)
def device_table(dtype, kind, device) -> torch.Tensor:
    """``step_table`` on ``device`` (cached there)."""
    return step_table(dtype, kind).to(device)


@functools.lru_cache(maxsize=None)
def _shifted_table(dtype, kind, device) -> torch.Tensor:
    """``step_table`` as int32 patterns times 256 on ``device``: a running
    value held so is its own row of the table."""
    return device_table(dtype, kind, device).to(torch.int32) << 8


def _byte_scan_plain(held, kind, axis, dtype):
    """The table scan: a running row of patterns times 256 (its row of the
    table, int32), one add of the terms and one ``index_select`` a step."""
    table = _shifted_table(np.dtype(dtype), kind, held.device)
    codes = held.view(torch.uint8).movedim(axis, 0)
    runs = torch.empty(codes.shape, dtype=torch.int32, device=held.device)
    flat = runs.reshape(codes.shape[0], -1)
    terms = codes.reshape(codes.shape[0], -1)
    flat[0] = terms[0].to(torch.int32) << 8
    index = torch.empty_like(flat[0])
    for i in range(1, codes.shape[0]):
        torch.add(terms[i], flat[i - 1], out=index)
        torch.index_select(table, 0, index, out=flat[i])
    return (runs >> 8).to(torch.uint8).movedim(0, axis).contiguous().view(held.dtype)


def _float_scan_plain(held, kind, axis):
    """The 2-byte scan: values stepped in float32 and rounded into the
    output row by row, then every NaN's bits set by the rule at once (a NaN
    output holds the quieted bits of the last NaN term at or before it, or
    the default NaN where none is)."""
    quiet, keep, default = _NAN_RULES[held.dtype]
    step = torch.add if kind.endswith("cumsum") else torch.mul
    out = torch.empty_like(held, memory_format=torch.contiguous_format)
    terms = held.movedim(axis, 0)
    rows = out.movedim(axis, 0)
    values = terms.float()
    rows[0] = terms[0]
    prev = values[0]
    for i in range(1, terms.shape[0]):
        rows[i] = step(prev, values[i])
        prev = rows[i].float()
    bits, term_bits = rows.view(torch.int16), terms.view(torch.int16)
    index = torch.arange(terms.shape[0], device=held.device).reshape((-1,) + (1,) * (terms.ndim - 1))
    last = torch.where(torch.isnan(terms), index, -1).cummax(0).values
    source = torch.gather(term_bits, 0, last.clamp(min=0))
    nan_bits = torch.where(last >= 0, (source & keep) | quiet, default)
    fixed = torch.where(torch.isnan(rows), nan_bits, bits)
    fixed[0] = term_bits[0]  # the first element is a copy
    bits.copy_(fixed)
    return out


def rounded_scan_plain(held: torch.Tensor, kind: str, axis: int, dtype) -> torch.Tensor:
    """numpy's scan of a held block of numpy dtype ``dtype`` along ``axis``,
    rounded to the type after every step, in torch ops on its device."""
    code = _code(held, kind, dtype)
    if held.numel() == 0:
        return torch.empty_like(held, memory_format=torch.contiguous_format)
    if code == _BYTE:
        return _byte_scan_plain(held, kind, axis, dtype)
    return _float_scan_plain(held, kind, axis)


def rounded_scan(held: torch.Tensor, kind: str, axis: int, dtype) -> torch.Tensor:
    """The step-rounded scan: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if held.device.type == "cpu":
        return rounded_scan_plain(held, kind, axis, dtype)
    return rounded_scan_cuda(held, kind, axis, dtype)


def rounded_scan_cuda(held: torch.Tensor, kind: str, axis: int, dtype) -> torch.Tensor:
    """Launch K3 on a CUDA tensor (made contiguous first); the output is
    contiguous in the input's shape."""
    global LAUNCHES
    if held.device.type != "cuda":
        raise ValueError(f"rounded_scan_cuda needs a CUDA tensor, got one on {held.device}")
    code = _code(held, kind, dtype)
    out = torch.empty_like(held, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    x = held.contiguous()
    p, n, q = scan_plan(x.shape, axis)
    table = device_table(np.dtype(dtype), kind, x.device) if code == _BYTE else None
    _launcher()(x.get_device(), x.data_ptr(), out.data_ptr(), None if table is None else table.data_ptr(),
                p, n, q, code, 0 if kind.endswith("cumsum") else 1)
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return Launcher("scan", "scan_launch", [p, p, p, ll, ll, ll, i, i], "scan")
