"""Contractions: einsum / tensordot / dot / matmul.

Port of ``dask_array_tpu/ops/linalg.py``.  The whole contraction is ONE dense ``torch.einsum`` over the
block-assembled operands, as the reference leaves it to one XLA
``dot_general``; float products go to cuBLAS on the card.  Chunk metadata
is still computed dask-style so downstream per-block consumers see the
expected grid.

Two routes, chosen from the result dtype when the graph is built:
- floating and complex results run ``torch.einsum`` on operands cast to
  the result dtype, with TF32 scoped by ``config["matmul-precision"]``
  ("highest", the default, keeps full-f32 products whatever the process's
  global torch setting; "high"/"default" allow TF32);
- integer and bool results are exact, as numpy's are: cuBLAS has no
  integer GEMM, so the operands broadcast against each other in int64 and
  the contracted labels are summed away.
"""

from __future__ import annotations

import contextlib
import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch import config
from dask_array_tpu_torch._chunks import (
    cast,
    common_blockdim,
    dtype_key,
    format_of,
    is_narrow,
    to_compute,
    torch_dtype,
    value_of,
)
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr

_EINSUM_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def parse_einsum(subscripts: str, ndims: list[int]):
    """Expand '...' and implicit outputs: returns (input_labelss, out_labels)."""
    subscripts = subscripts.replace(" ", "")
    if "->" in subscripts:
        lhs, out = subscripts.split("->")
    else:
        lhs, out = subscripts, None
    inputs = lhs.split(",")
    if len(inputs) != len(ndims):
        raise ValueError(
            f"einsum: {len(inputs)} operand subscripts but {len(ndims)} operands"
        )
    used = set(c for c in subscripts if c.isalpha())
    free = [c for c in _EINSUM_LETTERS if c not in used]
    max_ell = 0
    expanded = []
    for labels, nd in zip(inputs, ndims):
        if "..." in labels:
            explicit = labels.replace("...", "")
            n_ell = nd - len(explicit)
            if n_ell < 0:
                raise ValueError(f"einsum: operand has fewer dims than subscripts {labels!r}")
            max_ell = max(max_ell, n_ell)
        else:
            if len(labels) != nd:
                raise ValueError(
                    f"einsum: subscripts {labels!r} don't match operand ndim {nd}"
                )
    ell_labels = free[:max_ell]
    for labels, nd in zip(inputs, ndims):
        if "..." in labels:
            explicit = labels.replace("...", "")
            n_ell = nd - len(explicit)
            pos = labels.index("...")
            pre = labels[:pos]
            post = labels[pos + 3:]
            mid = "".join(ell_labels[max_ell - n_ell:])
            expanded.append(pre + mid + post)
        else:
            expanded.append(labels)
    if out is None:
        counts = {}
        for labels in expanded:
            for c in labels:
                counts[c] = counts.get(c, 0) + 1
        out_labels = "".join(ell_labels) + "".join(
            sorted(c for c, n in counts.items() if n == 1 and c not in ell_labels)
        )
    else:
        if "..." in out:
            out_labels = out.replace("...", "".join(ell_labels))
        else:
            out_labels = out
    return expanded, out_labels


_TORCH_PRECISION = {"highest": "highest", "high": "high", "default": "high"}


@contextlib.contextmanager
def matmul_precision(setting):
    """Scope torch's float32 matmul precision to ``setting`` (a
    ``config["matmul-precision"]`` value) and restore the caller's after."""
    if setting not in _TORCH_PRECISION:
        raise ValueError(f"matmul-precision must be one of {sorted(_TORCH_PRECISION)}, got {setting!r}")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_PRECISION[setting])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _diagonal_labels(t, labels):
    """Collapse labels repeated within one operand (``"ii"``) to their
    diagonal, as einsum reads them; returns (tensor, unique labels)."""
    labels = list(labels)
    while len(set(labels)) != len(labels):
        c = next(c for c in labels if labels.count(c) > 1)
        i = labels.index(c)
        j = labels.index(c, i + 1)
        t = torch.diagonal(t, dim1=i, dim2=j)  # drops dims i, j; the diagonal goes last
        labels = [lbl for k, lbl in enumerate(labels) if k not in (i, j)] + [c]
    return t, labels


def exact_einsum(spec_in, out_labels, operands):
    """An integer einsum without float rounding: each operand broadcasts
    over the union of labels, in int64, the product is taken, and the
    contracted labels are summed.  Its memory is the size of that union's
    product, so it suits the moderate integer contractions it serves."""
    order = list(out_labels) + sorted({c for labels in spec_in for c in labels} - set(out_labels))
    prod = None
    for t, labels in zip(operands, spec_in):
        t, labels = _diagonal_labels(to_compute(t, np.int64), labels)
        # put this operand's labels in ``order``, size 1 where it lacks one
        perm = sorted(range(len(labels)), key=lambda p: order.index(labels[p]))
        t = t.permute(*perm)
        ranked = [labels[p] for p in perm]
        t = t.reshape([t.shape[ranked.index(c)] if c in ranked else 1 for c in order])
        prod = t if prod is None else prod * t
    contracted = tuple(range(len(out_labels), len(order)))
    return prod.sum(dim=contracted) if contracted else prod


class Einsum(ArrayExpr):
    """General contraction, one dense ``torch.einsum`` (or the exact
    integer route) over the whole operands."""

    takes_narrow = True

    _parameters = ("subscripts", "out_labels", "input_labels", "kwargs")
    _defaults = {"kwargs": ()}

    @property
    def arrays(self):
        return self.operands[4:]

    @functools.cached_property
    def _label_chunks(self):
        out: dict = {}
        for labels, arr in zip(self.input_labels, self.arrays):
            for pos, c in enumerate(labels):
                ch = arr.chunks[pos]
                prev = out.get(c)
                if prev is None:
                    out[c] = ch
                elif prev != ch:
                    if len(ch) == 1 and sum(ch) in (0, 1):
                        continue
                    if len(prev) == 1 and sum(prev) in (0, 1):
                        out[c] = ch
                    else:
                        out[c] = common_blockdim([prev, ch])
        return out

    @functools.cached_property
    def chunks(self):
        return tuple(self._label_chunks[c] for c in self.out_labels)

    @functools.cached_property
    def _meta(self):
        kwargs = dict(self.kwargs or ())
        dtype = kwargs.get("dtype")
        if dtype is None:
            spec = ",".join(self.input_labels) + "->" + self.out_labels
            metas = [np.ones((1,) * a.ndim, dtype=a.dtype) for a in self.arrays]
            try:
                dtype = np.einsum(spec, *metas).dtype
            except TypeError:
                # numpy's einsum takes no ml_dtypes operand: its promotion
                # (bfloat16 products stay bfloat16, accumulated in float32)
                dtype = np.result_type(*[a.dtype for a in self.arrays])
        return np.empty((0,) * len(self.out_labels), dtype=np.dtype(dtype))

    @functools.cached_property
    def exact(self) -> bool:
        """Integer and bool results take the exact route (chosen from the
        metadata when the graph is built)."""
        return self.dtype.kind in "biu"

    def _accept_slice(self, index):
        """Slice pushdown through contraction free labels:
        einsum(...)[idx] == einsum(sliced operands) when the sliced output
        labels are plain (non-repeated, non-contracted) free labels."""
        from dask_array_tpu_torch._slicing import Slice, is_basic_index

        if not is_basic_index(index) or any(isinstance(i, Integral) for i in index):
            return None
        label_slice = {}
        for pos, ind in enumerate(index):
            if ind == slice(None):
                continue
            label = self.out_labels[pos]
            # decline diagonals (label repeated within an operand)
            for labels in self.input_labels:
                if labels.count(label) > 1:
                    return None
            label_slice[label] = ind
        if not label_slice:
            return None
        new_arrays = []
        for labels, arr in zip(self.input_labels, self.arrays):
            sub = tuple(label_slice.get(lbl, slice(None)) for lbl in labels)
            if any(s != slice(None) for s in sub):
                arr = Slice(arr, sub)
            new_arrays.append(arr)
        return Einsum(*self.operands[:4], *new_arrays)

    def _build(self, ctx):
        return BlockView(self.chunks, dense=self.contract([ctx.build(a).dense() for a in self.arrays]))

    def contract(self, denses):
        """The contraction of these operand tensors (the whole operands, or
        a shard lane slot's parts of them) in this node's dtype."""
        kwargs = dict(self.kwargs or ())
        if any(is_narrow(a.dtype) for a in self.arrays):
            return self._contract_narrow(denses, kwargs)
        if self.exact:
            # int64 products wrap as numpy's narrower and unsigned ones do
            dense = exact_einsum(self.input_labels, self.out_labels, denses)
        else:
            spec = ",".join(self.input_labels) + "->" + self.out_labels
            precision = kwargs.get("precision") or config.get("matmul-precision", "highest")
            with matmul_precision(precision):
                dense = torch.einsum(spec, *[cast(d, self.dtype) for d in denses])
        return cast(dense, self.dtype)

    def _contract_narrow(self, denses, kwargs):
        """Narrow operands (``_chunks.is_narrow``) decoded to their values:
        narrow integers contract in float64 (exact: their products and sums
        stay far under 2**53), floats in float32 (or the result's wider
        float) at full precision, as the JAX package leaves a plain product
        to XLA; then the result is rounded once to this node's dtype."""
        values = [value_of(d, a.dtype) for d, a in zip(denses, self.arrays)]
        spec = ",".join(self.input_labels) + "->" + self.out_labels
        fmt = format_of(self.dtype)
        integral = self.exact or (fmt is not None and not fmt.is_float)
        if integral and not all(v.dtype == torch.int32 for v in values):
            return cast(exact_einsum(self.input_labels, self.out_labels, values), self.dtype)
        if integral:
            work = torch.float64
        else:
            work = torch.float32 if is_narrow(self.dtype) else torch_dtype(self.dtype)
        precision = kwargs.get("precision") or config.get("matmul-precision", "highest")
        with matmul_precision(precision):
            dense = torch.einsum(spec, *[v.to(work) for v in values])
        return cast(dense.to(torch.int64) if integral else dense, self.dtype)


def einsum(subscripts, *operands, dtype=None, optimize=False, split_every=None,
           order="K", casting="safe", precision=None):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    if order not in ("C", "F", "A", "K"):
        raise ValueError(f"order must be one of 'C', 'F', 'A', or 'K' (got {order!r})")
    if casting not in ("no", "equiv", "safe", "same_kind", "unsafe"):
        raise ValueError(f"casting must be a numpy casting rule (got {casting!r})")
    # `order` is a host-memory-layout request (value-free for device
    # tensors); `casting` gates an explicit dtype= as numpy's einsum does
    arrays = [asarray(op) for op in operands]
    if dtype is not None and casting != "unsafe":
        natural = np.result_type(*[a.dtype for a in arrays])
        if not np.can_cast(natural, np.dtype(dtype), casting=casting):
            raise TypeError(
                f"Cannot cast from {natural} to {np.dtype(dtype)} with casting rule {casting!r}"
            )
    input_labels, out_labels = parse_einsum(subscripts, [a.ndim for a in arrays])
    kw = {}
    if dtype is not None:
        kw["dtype"] = dtype_key(np.dtype(dtype))
    if precision is not None:
        kw["precision"] = precision
    expr = Einsum(
        subscripts,
        out_labels,
        tuple(input_labels),
        tuple(sorted(kw.items())),
        *[a.expr for a in arrays],
    )
    return new_collection(expr)


def _axes_pair(axes, lhs_ndim, rhs_ndim):
    if isinstance(axes, Integral):
        n = int(axes)
        return tuple(range(lhs_ndim - n, lhs_ndim)), tuple(range(n))
    la, ra = axes
    if isinstance(la, Integral):
        la = (la,)
    if isinstance(ra, Integral):
        ra = (ra,)
    la = tuple(ax % lhs_ndim for ax in la)
    ra = tuple(ax % rhs_ndim for ax in ra)
    if len(la) != len(ra):
        raise ValueError("axes lists must have the same length")
    return la, ra


def tensordot(lhs, rhs, axes=2):
    from dask_array_tpu_torch.ops._from_array import asarray

    lhs, rhs = asarray(lhs), asarray(rhs)
    la, ra = _axes_pair(axes, lhs.ndim, rhs.ndim)
    letters = iter(_EINSUM_LETTERS)
    lhs_labels = [next(letters) for _ in range(lhs.ndim)]
    rhs_labels = [None] * rhs.ndim
    for li, ri in zip(la, ra):
        rhs_labels[ri] = lhs_labels[li]
    for i in range(rhs.ndim):
        if rhs_labels[i] is None:
            rhs_labels[i] = next(letters)
    out = "".join(lhs_labels[i] for i in range(lhs.ndim) if i not in la) + "".join(
        rhs_labels[i] for i in range(rhs.ndim) if i not in ra
    )
    spec = "".join(lhs_labels) + "," + "".join(rhs_labels) + "->" + out
    return einsum(spec, lhs, rhs)


def dot(a, b, out=None):
    from dask_array_tpu_torch.ops._from_array import asarray

    a, b = asarray(a), asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return tensordot(a, b, axes=((a.ndim - 1,), (0,)))
    return tensordot(a, b, axes=((a.ndim - 1,), (b.ndim - 2,)))


def vdot(a, b):
    from dask_array_tpu_torch.ops._from_array import asarray
    from dask_array_tpu_torch.ops.ufuncs import conj

    a, b = asarray(a), asarray(b)
    if a.dtype.kind == "c":  # numpy conjugates a complex a; a bool stays bool (vdot of bools is bool)
        a = conj(a)
    return dot(a.ravel(), b.ravel())


def outer(a, b):
    from dask_array_tpu_torch.ops._from_array import asarray

    a, b = asarray(a), asarray(b)
    return einsum("i,j->ij", a.ravel(), b.ravel())


def matmul(a, b):
    from dask_array_tpu_torch.ops._from_array import asarray

    a, b = asarray(a), asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul does not support scalars")
    kw = {}
    if is_narrow(a.dtype) or is_narrow(b.dtype):
        # numpy's matmul loop for a narrow type: int8 or float32
        kw["dtype"] = np.matmul.resolve_dtypes((a.dtype, b.dtype, None))[2]
    a_is_vec = a.ndim == 1
    b_is_vec = b.ndim == 1
    if a_is_vec and b_is_vec:
        return einsum("i,i->", a, b, **kw)
    if a_is_vec:
        return einsum("i,...ij->...j", a, b, **kw)
    if b_is_vec:
        return einsum("...ij,j->...i", a, b, **kw)
    return einsum("...ij,...jk->...ik", a, b, **kw)


__all__ = ["dot", "einsum", "matmul", "outer", "parse_einsum", "tensordot", "vdot"]
