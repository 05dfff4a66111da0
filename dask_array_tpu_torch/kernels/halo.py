"""Halo assembly: numpy's ``pad`` in its index-map modes over all axes in
one pass, with its plain PyTorch version.

Counterpart of the Pallas probes ``bench/probe_band_bisect.py`` (:32-122)
and ``bench/probe_band_bisect2.py`` (:68), which take the band stencil's
halo assembly apart: a band of rows joined with the halo rows above and
below it through raw or clamped index maps, an edge select on
``program_id``, columns extended by flipped slices.  Here the assembly is
one gather of the whole padded array, from which ``Overlap._build`` takes
every block with its halo as a view.

``widths`` holds one ``(lo, hi)`` pair per axis; ``modes`` one entry per
axis, numpy's names: "symmetric" (dask's "reflect"), "reflect" (numpy's,
the edge element not repeated), "edge" (dask's "nearest"), "wrap" (dask's
"periodic"), or a constant: a scalar fill for both sides or a
``(lo_fill, hi_fill)`` pair.  The mode of an axis with no width is not
read.  Where constant pads of several axes meet, the highest-numbered axis
gives the value, as numpy's axis-by-axis padding does.

- ``halo_pad_plain`` chains one ``index_select`` (index-map modes) or
  ``torch.cat`` with filled bands (constant) per axis, in numpy's order;
- ``halo_pad_cuda`` launches the CUDA kernel (``csrc/halo.cu``) and counts
  ``LAUNCHES``;
- ``halo_pad`` returns the input itself when every width is 0, else runs
  the plain version for a CPU tensor and the kernel for a CUDA tensor,
  with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cast, cat, moved, numpy_dtype, uint64_bits
from dask_array_tpu_torch.kernels._build import Launcher, load_library

MAX_RANK = 8
# dask's boundary names -> numpy's pad modes
BOUNDARY_TO_NUMPY = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}
_MODE_CODES = {"symmetric": 0, "reflect": 1, "edge": 2, "wrap": 3}
_CONSTANT_CODE = 4

# kernel launches since the last reset; only halo_pad_cuda adds to it
LAUNCHES = 0


def _is_constant(mode) -> bool:
    return not isinstance(mode, str)


def numpy_mode(boundary):
    """numpy's pad mode for a dask boundary that pads: "reflect" ->
    "symmetric", "nearest" -> "edge", "periodic" -> "wrap"; a constant fill
    stays as it is.  Any other string, "none" included, raises."""
    if not isinstance(boundary, str):
        return boundary
    if boundary not in BOUNDARY_TO_NUMPY:
        raise ValueError(f"unknown boundary mode {boundary!r}")
    return BOUNDARY_TO_NUMPY[boundary]


def fill_pair(mode):
    """(lo fill, hi fill) of a constant mode: a scalar or a pair."""
    if np.ndim(mode) == 0:
        return mode, mode
    lo, hi = mode
    return lo, hi


def fill_scalar(value, dtype, device="cpu") -> torch.Tensor:
    """The fill as a 0-d tensor of ``dtype``: the one conversion both the
    plain version and the kernel's fill bytes go through.  A uint16/32/64
    fill converts as numpy's cast converts it (a negative or fractional one
    too), made on the host through the signed type of its width."""
    if isinstance(value, np.generic):
        value = value.item()
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        if isinstance(value, float):
            src = torch.tensor(value, dtype=torch.float64)
        else:
            src = torch.tensor(uint64_bits(value) if value >= 0 else value, dtype=torch.int64)
            if value >= 1 << 63:  # the bits of a uint64
                src = src.view(torch.uint64)
        return cast(src, numpy_dtype(dtype)).to(device)
    return torch.full((), value, dtype=dtype, device=device)


def _normalize(x: torch.Tensor, widths, modes):
    widths = tuple((int(lo), int(hi)) for lo, hi in widths)
    modes = tuple(modes)
    if len(widths) != x.dim() or len(modes) != x.dim():
        raise ValueError(f"halo_pad: {len(widths)} widths and {len(modes)} modes for a {x.dim()}-d tensor")
    for ax, ((lo, hi), mode) in enumerate(zip(widths, modes)):
        if lo < 0 or hi < 0:
            raise ValueError(f"halo_pad: negative width {(lo, hi)} on axis {ax}")
        if not (lo or hi) or _is_constant(mode):
            continue
        if mode not in _MODE_CODES:
            raise ValueError(f"halo_pad: unknown mode {mode!r}")
        if x.shape[ax] == 0:
            raise ValueError(f"can't extend empty axis {ax} using modes other than 'constant' or 'empty'")
    return widths, modes


def _source_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """For each position of an axis of length ``n`` padded by (lo, hi), the
    index of the element it copies: numpy's pad, also past the axis."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        m = torch.remainder(i, 2 * n - 2)
        return torch.where(m < n, m, 2 * n - 2 - m)
    # symmetric: periodic with period 2n over [x, x reversed]
    m = torch.remainder(i, 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def pad_axis_plain(t: torch.Tensor, axis: int, lo: int, hi: int, mode) -> torch.Tensor:
    """``t`` padded along one axis: one ``index_select`` for an index-map
    mode (numpy's name, already checked), a ``torch.cat`` with filled bands
    for a constant."""
    if not (lo or hi):
        return t
    if not _is_constant(mode):
        return moved(torch.index_select, t, axis, _source_index(t.shape[axis], lo, hi, mode, t.device))
    parts = []
    for width, value in ((lo, fill_pair(mode)[0]), (None, None), (hi, fill_pair(mode)[1])):
        if width is None:
            parts.append(t)
        elif width:
            shape = list(t.shape)
            shape[axis] = width
            parts.append(fill_scalar(value, t.dtype, t.device).expand(shape))
    return cat(parts, dim=axis)


def halo_pad_plain(x: torch.Tensor, widths, modes) -> torch.Tensor:
    """numpy's pad in torch, one pass per axis in numpy's axis order."""
    widths, modes = _normalize(x, widths, modes)
    for ax, ((lo, hi), mode) in enumerate(zip(widths, modes)):
        x = pad_axis_plain(x, ax, lo, hi, mode)
    return x


def halo_pad(x: torch.Tensor, widths, modes) -> torch.Tensor:
    """``x`` padded: the input itself when every width is 0, the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if not any(lo or hi for lo, hi in widths):
        return x
    if x.device.type == "cpu":
        return halo_pad_plain(x, widths, modes)
    return halo_pad_cuda(x, widths, modes)


def _merged_axes(x: torch.Tensor, widths, modes):
    """(shape, stride, widths, modes) with unpadded size-1 axes dropped and
    adjacent unpadded axes merged where their strides allow."""
    axes = [
        [n, s, w, m] for n, s, w, m in zip(x.shape, x.stride(), widths, modes)
        if n != 1 or w != (0, 0)
    ] or [[1, 1, (0, 0), "edge"]]
    merged = [axes[0]]
    for n, s, w, m in axes[1:]:
        prev = merged[-1]
        if w == (0, 0) and prev[2] == (0, 0) and prev[1] == n * s:
            merged[-1] = [prev[0] * n, s, w, m]
        else:
            merged.append([n, s, w, m])
    return merged


def _fill_bytes(value, dtype) -> bytes:
    return fill_scalar(value, dtype).reshape(1).view(torch.uint8).numpy().tobytes()


def launch_plan(shape, stride, widths, modes, dtype):
    """The arguments ``halo_pad_launch`` gets for a pad, after merging the
    unpadded axes: ``(plan, fills)``, ``plan`` the int64s ``[ndim,
    elem_bytes, in_shape, in_stride, lo, hi, mode codes]`` and ``fills``
    the bytes of each axis's (lo, hi) fill in ``dtype`` (zeros where the
    axis is not constant).  Raises on a tensor that keeps more than 8 axes
    after merging."""
    axes = _merged_axes(torch.empty_strided(shape, stride, dtype=dtype, device="meta"), widths, modes)
    if len(axes) > MAX_RANK:
        raise ValueError(f"halo_pad_cuda takes at most {MAX_RANK} axes after merging unpadded ones, got {len(axes)}")
    size = torch.empty((), dtype=dtype).element_size()
    codes, fills = [], []
    for _n, _s, width, mode in axes:
        if width == (0, 0):
            codes.append(_CONSTANT_CODE)  # never read: the axis has no pad
            fills.append(bytes(2 * size))
        elif _is_constant(mode):
            codes.append(_CONSTANT_CODE)
            fills.extend(_fill_bytes(v, dtype) for v in fill_pair(mode))
        else:
            codes.append(_MODE_CODES[mode])
            fills.append(bytes(2 * size))
    plan = np.array(
        [len(axes), size, *(a[0] for a in axes), *(a[1] for a in axes), *(a[2][0] for a in axes),
         *(a[2][1] for a in axes), *codes],
        dtype=np.int64,
    )
    return plan, b"".join(fills)


def value_key(v):
    """A cache key that tells apart what ``==`` equates: -0.0 and 0.0, 1
    and 1.0 and True (their bytes in a dtype may differ)."""
    if isinstance(v, str):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(value_key(e) for e in v)
    return type(v).__name__, repr(v)


# (output shape, plan address, fills, the plan array kept alive) by the
# call's (shape, stride, widths, modes, dtype); modes with a fill key by
# value_key (-0.0 and 0.0 are equal but give other bits)
_PLANS: dict = {}


def _launch_args(x: torch.Tensor, widths, modes):
    try:
        key = (x.shape, x.stride(), tuple(widths), tuple(modes), x.dtype)
        if not all(type(m) is str for m in key[3]):
            key = key[:3] + (value_key(key[3]),) + key[4:]
        got = _PLANS.get(key)
    except TypeError:  # a width or fill given as a list
        key, got = None, None
    if got is None:
        widths, modes = _normalize(x, widths, modes)
        out_shape = tuple(n + lo + hi for n, (lo, hi) in zip(x.shape, widths))
        if 0 in out_shape:
            got = (out_shape, None, None, None)
        else:
            plan, fills = launch_plan(tuple(x.shape), x.stride(), widths, modes, x.dtype)
            got = (out_shape, plan.ctypes.data, fills, plan)
        if key is not None:
            if len(_PLANS) >= 256:
                _PLANS.clear()
            _PLANS[key] = got
    return got


def halo_pad_cuda(x: torch.Tensor, widths, modes) -> torch.Tensor:
    """Launch the halo kernel on a CUDA tensor of any dtype.

    The kernel reads the source through its strides (a sliced view in
    place); a lazy conjugate or negative view is resolved first, since the
    kernel moves bytes.  The C launcher takes the row kernel when the last
    axis has unit stride, the strided kernel otherwise.  Raises on a
    non-CUDA tensor, a negative width, an unknown mode, an index-map mode
    on an empty axis, or a tensor that keeps more than 8 axes after
    merging the unpadded ones.  The launch's arguments are cached by the
    call's own shape, strides, widths, modes and dtype.
    """
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"halo_pad_cuda needs a CUDA tensor, got one on {x.device}")
    if x.dim() == 0:
        raise ValueError("halo_pad_cuda needs at least 1 dimension")
    out_shape, plan_ptr, fills, _ = _launch_args(x, widths, modes)
    out = x.new_empty(out_shape)
    if plan_ptr is None:
        return out
    if x.is_conj() or x.is_neg():
        x = x.resolve_conj().resolve_neg()
    if x.data_ptr() % x.element_size():
        raise ValueError("halo_pad_cuda needs a tensor aligned to its element size")
    _launcher()(x.get_device(), x.data_ptr(), out.data_ptr(), plan_ptr, fills)
    LAUNCHES += 1
    return out


def kernel_for(x: torch.Tensor, widths, modes) -> str:
    """"rows" or "strided": the kernel ``halo_pad_launch`` takes for this
    pad, as its C launcher decides (needs the built library)."""
    widths, modes = _normalize(x, widths, modes)
    plan, _ = launch_plan(tuple(x.shape), x.stride(), widths, modes, x.dtype)
    return {1: "rows", 0: "strided"}[load_library("halo").halo_pad_kernel_for(ctypes.c_void_p(plan.ctypes.data))]


@functools.lru_cache(maxsize=None)
def _launcher():
    p = ctypes.c_void_p
    return Launcher("halo", "halo_pad_launch", [p, p, p, ctypes.c_char_p], "halo")
