"""Band-stencil kernel for 2-D ``map_overlap``: tap capture, the gate, the
CUDA wrapper and its plain PyTorch version.

Counterpart of ``dask_array_tpu/kernels/stencil.py`` (the Pallas band
kernel).  The Pallas kernel inlines any jnp ``func`` into its body; a
compiled CUDA kernel cannot run an arbitrary torch function, so this one
computes the class of funcs the main path uses: a linear stencil of
shifted windows, ``sum_k w_k * roll(b, (dy_k, dx_k))``.  ``capture_taps``
reads that table off ``func`` with ``torch.fx``; a func it cannot read
keeps the ``Overlap -> map_blocks -> trim`` route.

``band_stencil_call`` is what ``BandStencil._build`` calls: for a tensor
on the CPU it runs ``band_stencil_plain`` (pad, func, trim in torch); for a
CUDA tensor it launches the kernel (``csrc/band_stencil.cu``) or raises.
The kernel is compiled with ``nvcc`` at the first CUDA call
(``kernels/_build.py``).  Its tile is 24 rows by 32 lanes of 16 bytes of
columns (256 for float16 and bfloat16, 128 for float32 and float64); the
launcher counts the tiles, so nothing here depends on the width.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import struct
from numbers import Integral, Number

import numpy as np
import torch

from dask_array_tpu_torch.kernels._build import Launcher
from dask_array_tpu_torch.kernels.halo import numpy_mode, pad_axis_plain, value_key

MAX_DEPTH = 8
MAX_TAPS = (2 * MAX_DEPTH + 1) ** 2
_BOUNDARY_CODES = {"reflect": 0, "nearest": 1, "periodic": 2}
_CONSTANT_CODE = 3
_DTYPE_CODES = {torch.float16: 0, torch.float32: 1, torch.float64: 2, torch.bfloat16: 3}
_KERNEL_DTYPES = ("float16", "bfloat16", "float32", "float64")

# kernel launches since the last reset; only band_stencil_cuda adds to it
LAUNCHES = 0


# ---------------------------------------------------------------------------
# boundary padding of the plain version, in dask's boundary names
# ---------------------------------------------------------------------------


def pad_axis(t: torch.Tensor, axis: int, lo: int, hi: int, mode) -> torch.Tensor:
    """Pad ``t`` along ``axis`` by ``lo``/``hi`` elements.

    ``mode`` is "reflect" (numpy ``symmetric``: -1 -> 0, -2 -> 1),
    "nearest" (numpy ``edge``), "periodic" (numpy ``wrap``) or a scalar fill
    value (numpy ``constant``).  torch's own ``F.pad(mode="reflect")`` is
    numpy's ``reflect``, which skips the edge element, so it is not used.
    With no width the mode is not read: an axis of depth 0 may say "none".
    """
    if not (lo or hi):
        return t
    return pad_axis_plain(t, axis, lo, hi, numpy_mode(mode))


# ---------------------------------------------------------------------------
# tap capture
# ---------------------------------------------------------------------------

_LINEAR_OPS = {
    operator.add: "add",
    operator.sub: "sub",
    operator.mul: "mul",
    operator.truediv: "div",
    operator.neg: "neg",
}


def _is_scalar(v) -> bool:
    return isinstance(v, Number) and not isinstance(v, (bool, complex))


def _as_ints(v):
    if isinstance(v, Integral) and not isinstance(v, bool):
        return (int(v),)
    if isinstance(v, (tuple, list)) and all(
        isinstance(e, Integral) and not isinstance(e, bool) for e in v
    ):
        return tuple(int(e) for e in v)
    return None


def _roll(lin, shifts, dims, depth):
    """``torch.roll(b, shifts, dims)[i] == b[i - shift]``: a tap at offset
    ``dy`` moves to ``dy - shift``."""
    shifts, dims = _as_ints(shifts), _as_ints(dims)
    if not isinstance(lin, dict) or shifts is None or dims is None or len(shifts) != len(dims):
        return None
    for s, d in zip(shifts, dims):
        if d not in (0, 1, -1, -2):
            return None
        axis = d % 2
        if abs(s) > depth[axis]:
            return None
        lin = {
            ((dy - s, dx) if axis == 0 else (dy, dx - s)): w
            for (dy, dx), w in lin.items()
        }
    return lin


def _combine(op, args):
    """One +, -, unary -, or scalar * and / on linear forms; None declines
    (a product of two stencils, an added constant, anything else)."""
    if op == "neg":
        (a,) = args
        return {k: -w for k, w in a.items()} if isinstance(a, dict) else None
    a, b = args
    if op in ("add", "sub"):
        if not (isinstance(a, dict) and isinstance(b, dict)):
            return None
        sign = 1.0 if op == "add" else -1.0
        out = dict(a)
        for k, w in b.items():
            out[k] = out.get(k, 0.0) + sign * w
        return out
    if op == "mul":
        if isinstance(a, dict) and _is_scalar(b):
            return {k: w * float(b) for k, w in a.items()}
        if isinstance(b, dict) and _is_scalar(a):
            return {k: w * float(a) for k, w in b.items()}
        return None
    if op == "div" and isinstance(a, dict) and _is_scalar(b) and b != 0:
        return {k: w / float(b) for k, w in a.items()}
    return None


def capture_taps(func, depth):
    """The stencil ``func`` computes, as a tuple of ``(dy, dx, w)`` taps
    (``out[i, j] = sum w * b[i + dy, j + dx]``), or None.

    ``func`` is traced with ``torch.fx.symbolic_trace``.  Accepted: one
    input; ``torch.roll`` (or ``Tensor.roll``) with int shifts and dims,
    each ``|shift|`` at most that axis's depth; ``+``, ``-`` and unary
    ``-`` of stencils; ``*`` and ``/`` by a Python scalar.  Every tap must
    land within ``depth``, so the kernel's boundary fill and the plain
    version's padded roll read the same elements.
    """
    import torch.fx

    try:
        gm = torch.fx.symbolic_trace(func)
    except (torch.fx.proxy.TraceError, TypeError, ValueError, AttributeError,
            NotImplementedError, RuntimeError):
        # any func torch.fx cannot trace is not a capturable stencil
        return None
    env = {}
    result = None
    n_inputs = 0
    for node in gm.graph.nodes:
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
        if node.op == "placeholder":
            n_inputs += 1
            env[node] = {(0, 0): 1.0}
        elif node.op == "output":
            result = args[0]
        elif (node.op == "call_function" and node.target is torch.roll) or (
            node.op == "call_method" and node.target == "roll"
        ):
            full = dict(zip(("input", "shifts", "dims"), args), **kwargs)
            if set(full) - {"input", "shifts", "dims"}:
                return None
            env[node] = _roll(full.get("input"), full.get("shifts"), full.get("dims"), depth)
        elif node.op == "call_function" and node.target in _LINEAR_OPS and not kwargs:
            env[node] = _combine(_LINEAR_OPS[node.target], args)
        else:
            return None
        if node.op != "output" and env[node] is None:
            return None
    if n_inputs != 1 or not isinstance(result, dict):
        return None
    taps = tuple((dy, dx, float(w)) for (dy, dx), w in result.items() if w != 0.0)
    if any(abs(dy) > depth[0] or abs(dx) > depth[1] for dy, dx, _ in taps):
        return None
    return taps or ((0, 0, 0.0),)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def stencil_taps(ndim, dtype, depth, boundary, func, kwargs):
    """The taps the band-stencil kernel takes for ``func`` over blocks of
    ``ndim`` axes and ``dtype``, or None.

    ``depth`` holds one ``(lo, hi)`` pair and ``boundary`` one mode per
    axis.  Eligible: config ``stencil-kernel`` not "off"; 2-D float; no
    extra func kwargs; symmetric depth at most 8 per axis; each boundary
    with depth one of reflect, nearest, periodic or a scalar constant; and
    ``capture_taps`` reads a stencil off ``func``.  The one gate of every
    route to the kernel (``map_overlap``'s and the shard lane's).
    """
    from dask_array_tpu_torch import config

    if config.get("stencil-kernel", "auto") in ("off", False, None):
        return None
    if ndim != 2 or np.dtype(dtype).name not in _KERNEL_DTYPES or kwargs:
        return None
    dep = []
    for (lo, hi), b in zip(depth, boundary):
        if lo != hi or lo > MAX_DEPTH:
            return None
        if lo and b not in _BOUNDARY_CODES and not _is_scalar(b):
            return None
        dep.append(lo)
    return capture_taps(func, tuple(dep))


def use_band_stencil(arrays, depths, bounds, trim, func, kwargs):
    """The taps of an eligible map_overlap, or None.

    Eligible: one array of known, non-empty shape with ``trim=True``, that
    ``stencil_taps`` takes.  Decided when the graph is built, whatever the
    device.
    """
    if not trim or len(arrays) != 1:
        return None
    a = arrays[0]
    if any(not isinstance(s, Integral) or s <= 0 for s in a.shape):
        return None
    axes = range(a.ndim)
    return stencil_taps(a.ndim, a.dtype, [depths[0].get(ax, (0, 0)) for ax in axes],
                        [bounds[0].get(ax) for ax in axes], func, kwargs)


# ---------------------------------------------------------------------------
# plain version and the kernel wrapper
# ---------------------------------------------------------------------------


def band_stencil_plain(x: torch.Tensor, func, depth, boundary) -> torch.Tensor:
    """``trim(func(pad(x)))`` in torch: the kernel's reference.  bfloat16
    computes in float32 and rounds once, as the kernel does (a constant
    fill rounded to bfloat16 first, as the kernel reads it)."""
    if x.dtype == torch.bfloat16:
        boundary = tuple(float(torch.tensor(b, dtype=x.dtype)) if _is_scalar(b) else b for b in boundary)
        return band_stencil_plain(x.float(), func, depth, boundary).to(x.dtype)
    d0, d1 = depth
    p = pad_axis(x, 0, d0, d0, boundary[0])
    p = pad_axis(p, 1, d1, d1, boundary[1])
    out = func(p)
    return out[d0 : d0 + x.shape[0], d1 : d1 + x.shape[1]]


def band_stencil_call(x: torch.Tensor, func, depth, boundary, taps) -> torch.Tensor:
    """The stencil of one 2-D tensor: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return band_stencil_plain(x, func, depth, boundary)
    return band_stencil_cuda(x, taps, depth, boundary)


# csrc/band_stencil.cu's kernels: the register window of depth (1, 1) (the
# 5-point and 3x3 stencils) and the tap list (every other depth)
TAP_LIST, WINDOW_11 = 0, 1
_WINDOW_SLOTS = 9


def _boundary_arg(mode, depth, dtype):
    """(code, fill) for one axis; the fill rounded to the tensor's dtype,
    as the plain version's constant pad rounds it."""
    if isinstance(mode, str):
        if mode in _BOUNDARY_CODES:
            return _BOUNDARY_CODES[mode], 0.0
        if mode == "none" and depth == 0:
            return _BOUNDARY_CODES["nearest"], 0.0  # no tap reaches past the edge
        raise ValueError(f"band_stencil_cuda does not take boundary {mode!r}")
    if not _is_scalar(mode):
        raise ValueError(f"band_stencil_cuda does not take boundary {mode!r}")
    return _CONSTANT_CODE, float(torch.tensor(mode, dtype=dtype).item())


def kernel_variant(depth) -> int:
    """The kernel a depth takes: the register window at (1, 1), else the
    tap list."""
    return WINDOW_11 if tuple(depth) == (1, 1) else TAP_LIST


def _tap_table(taps, depth, boundary, dtype) -> bytes:
    """The launch's parameter bytes, as ``band_stencil_launch`` reads them:
    the header (depths, boundary codes, tap count, kernel variant, the
    dense window's tap mask), the two fills, the dense window's weights
    (row-major over (dy, dx), zero where no tap is), then the tap list's
    weights and offsets.  Raises on a depth above 8, a tap outside the
    depth, or an unknown boundary."""
    d0, d1 = depth
    if not (0 <= d0 <= MAX_DEPTH and 0 <= d1 <= MAX_DEPTH):
        raise ValueError(f"band_stencil_cuda takes depths 0..{MAX_DEPTH}, got {depth}")
    if not 1 <= len(taps) <= MAX_TAPS or any(abs(dy) > d0 or abs(dx) > d1 for dy, dx, _ in taps):
        raise ValueError(f"band_stencil_cuda: taps {taps} do not fit depth {depth}")
    bd0, fill0 = _boundary_arg(boundary[0], d0, dtype)
    bd1, fill1 = _boundary_arg(boundary[1], d1, dtype)
    variant = kernel_variant(depth)
    window, mask = [0.0] * _WINDOW_SLOTS, 0
    if variant:
        for dy, dx, w in taps:
            slot = (dy + d0) * (2 * d1 + 1) + dx + d1
            window[slot] += w
            mask |= 1 << slot
    n = len(taps)
    return b"".join((
        struct.pack("<8i", d0, d1, bd0, bd1, n, variant, mask, 0),
        struct.pack("<2d", fill0, fill1),
        struct.pack(f"<{_WINDOW_SLOTS}d", *window),
        struct.pack(f"<{n}d", *(w for _, _, w in taps)),
        struct.pack(f"<{2 * n}i", *(dy for dy, _, _ in taps), *(dx for _, dx, _ in taps)),
    ))


def vector_ok(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel may move rows in 16-byte vectors: a row's bytes
    and both tensors' addresses are multiples of 16.  Otherwise it takes
    scalar loads and stores (a tensor at an odd storage offset, or N*itemsize
    not a multiple of 16)."""
    return (x.shape[-1] * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def band_stencil_cuda(x: torch.Tensor, taps, depth, boundary) -> torch.Tensor:
    """Launch the band-stencil kernel on a 2-D CUDA tensor.

    Raises on anything the kernel does not take: a non-CUDA or
    non-contiguous tensor, a dtype other than float16/bfloat16/32/64, a depth above
    8, a tap outside the depth, or an unknown boundary.  The launch's
    arguments are cached by the call's own (taps, depth, boundary, dtype),
    so a repeated call only checks the tensor, allocates the output and
    launches.
    """
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"band_stencil_cuda needs a CUDA tensor, got one on {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("band_stencil_cuda needs a contiguous 2-D tensor")
    code, table = _launch_args(taps, depth, boundary, x.dtype)
    M, N = x.shape
    if M == 0 or N == 0:
        raise ValueError("band_stencil_cuda needs a non-empty tensor")
    out = torch.empty_like(x)
    _launcher()(x.get_device(), code, x.data_ptr(), out.data_ptr(), M, N, table, vector_ok(x, out))
    LAUNCHES += 1
    return out


# (dtype code, tap table) by (taps, depth, boundary key, dtype)
_TABLES: dict = {}


def _launch_args(taps, depth, boundary, dtype):
    """``(dtype code, tap table)`` of a launch, cached.  A boundary of two
    names is its own key; one with a fill keys by ``value_key`` (-0.0 and
    0.0 are equal but give other bits).  Taps or a depth given as lists
    are not cached."""
    bkey = None
    try:
        b0, b1 = boundary
        bkey = boundary if type(b0) is str and type(b1) is str else value_key(boundary)
        return _TABLES[taps, depth, bkey, dtype]
    except (KeyError, TypeError, ValueError):
        pass
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"band_stencil_cuda does not take {dtype}")
    got = (code, _tap_table(_tap_key(taps), tuple(depth), tuple(boundary), dtype))
    if len(_TABLES) >= 256:
        _TABLES.clear()
    try:
        _TABLES[taps, depth, bkey, dtype] = got
    except TypeError:  # unhashable taps or depth
        pass
    return got


def _tap_key(taps):
    """Taps as hashable ``(int, int, float)`` triples; a tuple of such
    triples (``capture_taps``'s form) passes as it is."""
    if isinstance(taps, tuple) and all(
        type(t) is tuple and type(t[0]) is int and type(t[1]) is int and type(t[2]) is float for t in taps
    ):
        return taps
    return tuple((int(dy), int(dx), float(w)) for dy, dx, w in taps)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return Launcher("band_stencil", "band_stencil_launch", [i, p, p, ll, ll, ctypes.c_char_p, i], "band_stencil")
