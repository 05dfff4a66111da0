"""Matrix decompositions: qr/tsqr/sfqr, svd/svd_flip, the randomized
svd_compressed, lu, cholesky, solve/solve_triangular/inv/lstsq, norm.

Port of ``dask_array_tpu/ops/linalg_decomp.py``.  The blocked algorithms
stay as the reference has them (TSQR by CholeskyQR3, the fused tall-skinny
SVD that never forms Q, CGS2 panels for 2-D grids, the right-looking block
LU with block-local pivots, blocked triangular solves); each step is a
``torch.linalg`` call or a matmul on the device.

One algorithm per operation: the reference's defaults (CholeskyQR3 with
shifts 16/1/0, the fused TSQR-SVD, the eigh SVD of the small R).  Its other
methods (``tpu.qr-method``, ``tpu.svd-method``, ``tpu.qr-gram``,
``tpu.tsqr-svd``, ``tpu.gram-precision``) are TPU compile workarounds and
have no counterpart here.  Three more things differ from the traced
reference:

- one walk factors once.  The outputs of one factorization (TSQR's q and
  r, the fused SVD's u, s and vh, the block LU's p, l and u, a dense op's
  tuple) are separate nodes; XLA's CSE shared their program, here
  ``BuildContext.shared`` does, keyed by the input's name.
  ``FACTORIZATIONS`` counts the factorizations a walk runs;
- every product is full float32 (TF32 scoped off around the call): a
  TF32 Gram breaks CholeskyQR's orthogonality;
- failures are values, as in JAX: a Cholesky of a matrix that is not
  positive definite gives NaNs (``cholesky_ex``), and nothing syncs the
  device to raise; but CholeskyQR3 reads its R's finiteness once on the
  host and, where a pass failed, takes Householder's QR of the panel
  (``_cholqr3``), and the small SVD behind the tall-skinny one
  eigendecomposes its Gram in double precision for single-precision input
  (``_svd_fn``), so a numerically rank-deficient panel factors as numpy
  factors it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dask_array_tpu_torch._chunks import has_unknown_chunks, torch_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.ops.linalg import matmul_precision

# factorizations run (TSQR, the fused TSQR-SVD, BlockedQR, BlockedLU and
# the dense ops), each once per walk whatever number of its outputs is built
FACTORIZATIONS = 0


def _count_factorization():
    global FACTORIZATIONS
    FACTORIZATIONS += 1


def _float_dtype(dt):
    """The dtype a factorization of ``dt`` runs in: complex and float32
    stay, everything else (float16, ints, bools) is float64."""
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.complexfloating) or dt == np.float32:
        return dt
    return np.dtype("f8")


def _real(dt):
    """The real dtype of ``dt`` (singular values and residuals are real)."""
    return np.empty((0,), dtype=dt).real.dtype


def _mm(a, b):
    """``a @ b`` at full precision (no TF32)."""
    with matmul_precision("highest"):
        return a @ b


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cholesky_nan(g):
    """Lower Cholesky factor of ``g``; where ``g`` is not positive definite,
    JAX's value: NaN on and below the diagonal, 0 above
    (``torch.linalg.cholesky`` would raise, after a device sync)."""
    l, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, l, torch.tril(torch.full_like(l, float("nan"))))


def _cholqr_pass(a, shift=16.0):
    """One CholeskyQR pass: ``(q, r, w)`` with ``q = a @ w``, ``w = R^-1``.

    Factors ``G + shift*eps*||G||_F I`` (Fukaya et al. 2020), positive
    definite for any panel; the QR3 schedule passes shifts 16, 1, 0, the
    last unshifted to remove the shift's bias.  Q is applied as
    ``a @ R^-1`` (one tall matmul) with the inverse of the small factor, as
    the reference does.
    """
    g = _mm(a.mH, a)
    g = (g + g.mH) / 2
    n = a.shape[1]
    if shift:
        real = g.real.dtype if g.is_complex() else g.dtype
        eps = float(torch.finfo(real).eps)
        normf = torch.sqrt(torch.sum(torch.real(g * torch.conj(g))))
        s = shift * eps * normf + float(np.finfo(np.float64).tiny)
        l = _cholesky_nan(g + s * _eye(n, g))
    else:
        l = _cholesky_nan(g)
    linv = torch.linalg.solve_triangular(l, _eye(n, l), upper=False)
    q = _mm(a, linv.mH)
    return q, l.mH, linv.mH


def _cholqr3(a):
    """CholeskyQR3 of a tall panel: ``(q2, w3, r)`` with the final Q equal
    to ``q2 @ w3`` (never formed here) and ``r = r3 r2 r1``.

    Where a pass's Cholesky fails (its Gram not positive definite: an
    exactly rank-deficient panel, or a float32 Gram whose rounding over a
    million rows passes the second pass's shift), R comes out non-finite;
    one host read of R's finiteness (counted in
    ``ops._fancy_indexing.SYNCS``) then takes Householder's QR of the panel
    instead, its R's diagonal made non-negative as CholeskyQR's is."""
    from dask_array_tpu_torch.ops._fancy_indexing import count_sync

    q1, r1, _ = _cholqr_pass(a, shift=16.0)
    q2, r2, _ = _cholqr_pass(q1, shift=1.0)
    _q3, r3, w3 = _cholqr_pass(q2, shift=0.0)
    r = _mm(r3, _mm(r2, r1))
    count_sync()
    if bool(torch.isfinite(r).all()):
        return q2, w3, r
    q, r = torch.linalg.qr(a, mode="reduced")
    d = torch.sgn(torch.diagonal(r))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return q * d.conj()[None, :], _eye(r.shape[0], r), r * d.conj()[:, None]


class TSQR(ArrayExpr):
    """Tall-skinny QR (parity: ``tsqr``): CholeskyQR3 on the whole tall
    panel, every FLOP a matmul."""

    _parameters = ("array", "which")  # which: "q" | "r"

    @functools.cached_property
    def chunks(self):
        m_chunks, n_chunks = self.array.chunks
        n = sum(n_chunks)
        if self.which == "q":
            if has_unknown_chunks((m_chunks,)):
                # unknown row splits: q is one (unknown-height) row block
                m_chunks = (float("nan"),)
            return (m_chunks, (n,))
        return ((n,), (n,))

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=_float_dtype(self.array.dtype))

    def _factor(self, ctx):
        a = ctx.build(self.array).dense().to(torch_dtype(self.dtype))
        _count_factorization()
        q2, w3, r = _cholqr3(a)
        return _mm(q2, w3), r

    def _build(self, ctx):
        q, r = ctx.shared(("tsqr", self.array._name), lambda: self._factor(ctx))
        return BlockView(self.chunks, dense=r if self.which == "r" else q)


class TSQRSVD(ArrayExpr):
    """Fused tall-skinny SVD: CholeskyQR3 keeps only the per-pass inverse
    factors, the small R factors feed the SVD, and ``U = Q2 @ (W3 @ Ur)`` is
    one tall matmul: Q is never formed.  Its three outputs share one
    factorization per walk.

    Parity: the reference's ``tsqr(compute_svd=True)`` fused path.
    """

    _parameters = ("array", "which")  # which: "u" | "s" | "vh"

    @functools.cached_property
    def chunks(self):
        m_chunks, n_chunks = self.array.chunks
        n = sum(n_chunks)
        if self.which == "u":
            if has_unknown_chunks((m_chunks,)):
                m_chunks = (float("nan"),)  # see TSQR.chunks
            return (m_chunks, (n,))
        if self.which == "s":
            return ((n,),)
        return ((n,), (n,))

    @functools.cached_property
    def _meta(self):
        # the singular values are real, as numpy's (the JAX package
        # declares the input's complex dtype for them)
        dt = _float_dtype(self.array.dtype)
        if self.which == "s":
            return np.empty((0,), dtype=_real(dt))
        return np.empty((0, 0), dtype=dt)

    def _factor(self, ctx):
        a = ctx.build(self.array).dense().to(torch_dtype(_float_dtype(self.array.dtype)))
        _count_factorization()
        q2, w3, r = _cholqr3(a)
        ur, s, vh = _svd_fn(r, full_matrices=False)
        return q2, w3, ur, s, vh

    def _build(self, ctx):
        q2, w3, ur, s, vh = ctx.shared(("tsqr-svd", self.array._name), lambda: self._factor(ctx))
        if self.which == "s":
            return BlockView(self.chunks, dense=s)
        if self.which == "vh":
            return BlockView(self.chunks, dense=vh)
        return BlockView(self.chunks, dense=_mm(q2, _mm(w3, ur)))


def _svd_fn(a, full_matrices=False):
    """SVD of a small in-core matrix: singular triplets from the
    eigendecomposition of the Gram matrix, as the reference computes them
    (it squares the condition number, fine downstream of CholeskyQR).
    ``full_matrices=True`` is ``torch.linalg.svd``: the complete basis of
    the wide side does not come out of the small Gram matrix.

    A single-precision matrix is decomposed in double precision and the
    triplets rounded back: its squared condition number can pass 1/eps of
    float32 (a numerically rank-deficient panel, whose small eigenvalues
    are then a cluster of rounding noise about 0), where cuSOLVER's
    float32 ``syevd`` fails to converge.
    """
    if full_matrices:
        return torch.linalg.svd(a, full_matrices=full_matrices)
    m, n = a.shape
    if m < n:
        u, s, vh = _svd_fn(a.mH)
        return vh.mH.resolve_conj(), s, u.mH.resolve_conj()
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}.get(a.dtype, a.dtype)
    a_w = a.to(wide)
    g = _mm(a_w.mH, a_w)  # Hermitian Gram
    w, v = torch.linalg.eigh(g)  # ascending eigenvalues
    w = torch.clamp(w.flip(0), min=0.0)
    v = v.flip(1)
    s = torch.sqrt(w)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    u = _mm(a_w, v) / safe[None, :].to(v.dtype)
    return u.to(a.dtype), s.to(a.real.dtype), v.mH.resolve_conj().to(a.dtype)


def _pivoted_lu(a):
    """Partial-pivot LU of one in-core block in plain torch ops:
    ``(p, l, u)`` with ``a == p @ l @ u``.

    The reference's portable formulation (its TPU's LU expander took only
    float32); here ``_lu_block_fn`` uses it for a float type that
    ``torch.linalg.lu`` does not take.  Pivots are the first largest
    magnitude, as LAPACK's.
    """
    n = a.shape[0]
    A = a.clone()
    perm = torch.arange(n, device=a.device)
    idx = torch.arange(n, device=a.device)
    for k in range(n):
        mag = torch.abs(A[:, k])
        mag = torch.where(idx >= k, mag, torch.full_like(mag, -float("inf")))
        piv = int(torch.argmax(mag))
        if piv != k:
            A[[k, piv]] = A[[piv, k]]
            perm[[k, piv]] = perm[[piv, k]]
        pivot = A[k, k]
        safe = torch.where(pivot == 0, torch.ones_like(pivot), pivot)
        factors = torch.where(idx > k, A[:, k] / safe, torch.zeros_like(A[:, k]))
        right = torch.where(idx[None, :] > k, A[k][None, :], torch.zeros_like(A[k][None, :]))
        A = A - factors[:, None] * right
        A[:, k] = torch.where(idx > k, factors, A[:, k])
    l = torch.tril(A, -1) + _eye(n, A)
    u = torch.triu(A)
    # row k of LU is original row perm[k]:  a = P @ l @ u with P[perm[k], k]=1
    p = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    p[perm, idx] = 1
    return p, l, u


def _lu_block_fn(dtype):
    """The in-core block LU for this dtype: ``torch.linalg.lu`` (LAPACK on
    the CPU, cuSOLVER on the card, both partial pivoting) for the types it
    takes, which are all the factorizations make, else ``_pivoted_lu``."""
    if dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        return torch.linalg.lu
    return _pivoted_lu


def _solve_pos(a, b):
    """``a x = b`` for Hermitian positive definite ``a`` (NaN otherwise)."""
    vec = b.dim() == 1
    x = torch.cholesky_solve(b[:, None] if vec else b, _cholesky_nan(a))
    return x[:, 0] if vec else x


def _solve_triangular(a, b, lower=False, trans=0, unit_diagonal=False):
    """``a x = b``; ``trans`` is always 0 here (``solve_triangular``
    transposes ``a`` itself) and stays in the keywords for the token."""
    vec = b.dim() == 1
    x = torch.linalg.solve_triangular(a, b[:, None] if vec else b, upper=not lower, unitriangular=unit_diagonal)
    return x[:, 0] if vec else x


def _lstsq(a, b, rcond=None):
    """numpy's ``lstsq`` through the SVD, the same code on every device.

    As numpy does, single precision is computed in double and the cutoff
    is ``eps * max(m, n) * s_max`` with double's eps; returns (x,
    residuals, rank, singular values), residuals ``|b - a x|^2`` per
    column, as JAX's.  (``torch.linalg.lstsq`` on a CUDA tensor assumes
    full rank and returns neither rank nor singular values.)
    """
    wide = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    a, b = a.to(wide), b.to(wide)
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    m, n = a.shape
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    mask = s >= rcond * s[0] if s.numel() else s > 0
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None].to(wide)
    x = vh.mH @ (s_inv * (u.mH @ b2))
    resid = torch.linalg.vector_norm(b2 - a @ x, dim=0) ** 2
    return (x[:, 0] if vec else x), resid, mask.sum(), s


def _inv(a):
    return torch.linalg.inv_ex(a)[0]


def _solve(a, b):
    return torch.linalg.solve_ex(a, b)[0]


# DenseLinalg's function names are the reference's (they key the tokens)
_DENSE_FNS = {
    "svd": _svd_fn,
    "jsl.lu": lambda a: _lu_block_fn(a.dtype)(a),
    "jnp.linalg.qr": torch.linalg.qr,
    "jnp.linalg.cholesky": _cholesky_nan,
    "jnp.linalg.solve": _solve,
    "jnp.linalg.inv": _inv,
    "jnp.linalg.lstsq": _lstsq,
    "jsl.solve": lambda a, b, assume_a="pos": _solve_pos(a, b),
    "jsl.solve_triangular": _solve_triangular,
}


class DenseLinalg(ArrayExpr):
    """One whole-matrix linalg op (single logical block).  The outputs of
    one call (``which`` = 0, 1, ...) share it per walk."""

    _parameters = ("fn_name", "which", "out_chunks", "_dtype", "kwargs")
    _defaults = {"kwargs": ()}
    # operands[5:]: input exprs

    @property
    def arrays(self):
        return self.operands[5:]

    def _name_prefix(self):
        return self.fn_name.replace(".", "-")

    @property
    def chunks(self):
        return self.out_chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.out_chunks), dtype=self._dtype)

    def _call(self, ctx):
        cdt = torch_dtype(_float_dtype(np.result_type(*[a.dtype for a in self.arrays])))
        denses = [ctx.build(a).dense().to(cdt) for a in self.arrays]
        _count_factorization()
        return _DENSE_FNS[self.fn_name](*denses, **dict(self.kwargs or ()))

    def _build(self, ctx):
        key = ("dense", self.fn_name, tuple(self.kwargs or ()), tuple(a._name for a in self.arrays))
        out = ctx.shared(key, lambda: self._call(ctx))
        if self.which is not None:
            out = out[self.which]
        out = out.resolve_conj()
        want = torch_dtype(self.dtype)
        if out.dtype != want:
            out = out.to(want)
        return BlockView(self.out_chunks, dense=out)


def _single(expr, fn_name, which, out_shape, dtype, kwargs=(), extra=()):
    from dask_array_tpu_torch._collection import new_collection

    chunks = tuple((int(s),) for s in out_shape)
    return new_collection(
        DenseLinalg(fn_name, which, chunks, np.dtype(dtype), tuple(kwargs), expr, *extra)
    )


class BlockedQR(ArrayExpr):
    """QR of a 2-D-chunked matrix: block CGS2 panels + CholeskyQR3.

    For each column panel, project out all previous Q panels twice (tall
    matmuls), then factor the panel with the CholeskyQR cascade.  No
    whole-matrix factorization: every step is a column-panel matmul.
    """

    _parameters = ("array", "which")  # which: "q" | "r"

    @functools.cached_property
    def chunks(self):
        m_chunks, n_chunks = self.array.chunks
        if self.which == "q":
            return (m_chunks, n_chunks)
        return (n_chunks, n_chunks)

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=_float_dtype(self.array.dtype))

    def _factor(self, ctx):
        dt = torch_dtype(self.dtype)
        a = ctx.build(self.array).dense().to(dt)
        n_chunks = self.array.chunks[1]
        col_bounds = np.cumsum([0] + list(n_chunks))
        npanels = len(n_chunks)
        _count_factorization()
        q_panels: list = []
        r_blocks: dict = {}
        for k in range(npanels):
            v = a[:, int(col_bounds[k]):int(col_bounds[k + 1])]
            # CGS2: two projection passes against all previous panels
            for _pass in range(2):
                for m in range(k):
                    c = _mm(q_panels[m].mT, v)
                    r_blocks[(m, k)] = r_blocks.get((m, k), 0) + c
                    v = v - _mm(q_panels[m], c)
            q2, w3, r = _cholqr3(v)
            r_blocks[(k, k)] = r
            q_panels.append(_mm(q2, w3))
        q = torch.cat(q_panels, dim=1)
        rows = []
        for i in range(npanels):
            row = []
            for j in range(npanels):
                if j < i:
                    row.append(torch.zeros((n_chunks[i], n_chunks[j]), dtype=dt, device=a.device))
                else:
                    row.append(r_blocks[(i, j)])
            rows.append(torch.cat(row, dim=1))
        return q, torch.cat(rows, dim=0)

    def _build(self, ctx):
        q, r = ctx.shared(("blocked-qr", self.array._name), lambda: self._factor(ctx))
        return BlockView(self.chunks, dense=q if self.which == "q" else r)


def qr(a, mode="reduced"):
    """QR decomposition.

    Tall-skinny inputs use the blocked TSQR path; short-fat use sfqr;
    2-D-chunked grids use the blocked CGS2 panel algorithm (``BlockedQR``).
    """
    from dask_array_tpu_torch._collection import new_collection

    if a.ndim != 2:
        raise ValueError("qr requires a 2-D array")
    if mode != "reduced":
        raise NotImplementedError(
            f"qr mode={mode!r} is not supported (only 'reduced'; parity with "
            "the reference, linalg/_qr.py:560)"
        )
    m_blocks, n_blocks = len(a.chunks[0]), len(a.chunks[1])
    dt = _float_dtype(a.dtype)
    m, n = a.shape
    k = min(m, n)
    if n_blocks == 1 and m_blocks > 1:
        return tsqr(a)
    if m_blocks == 1 and n_blocks > 1:
        return sfqr(a)
    if m_blocks == 1 and n_blocks == 1:
        q = _single(a.expr, "jnp.linalg.qr", 0, (m, k), dt, kwargs=(("mode", "reduced"),))
        r = _single(a.expr, "jnp.linalg.qr", 1, (k, n), dt, kwargs=(("mode", "reduced"),))
        return q, r
    if m < n:
        raise NotImplementedError(
            "qr of a 2-D-chunked SHORT-FAT array is not supported; rechunk "
            "rows to a single block (sfqr)"
        )
    return (
        new_collection(BlockedQR(a.expr, "q")),
        new_collection(BlockedQR(a.expr, "r")),
    )


def tsqr(a, compute_svd=False, _max_vchunk_size=None):
    """Direct tall-skinny QR (parity: ``tsqr``)."""
    from dask_array_tpu_torch._collection import new_collection

    if len(a.chunks[1]) != 1:
        raise ValueError(
            "tsqr requires the array to have only one column block "
            f"(got column chunks {a.chunks[1]})"
        )
    m, n = a.shape
    if not (isinstance(m, float) and np.isnan(m)) and m < n:
        # short input: the whole array is at most (n-1, n), in-core after a
        # row collapse.  The Gram/CholeskyQR path is invalid here
        # (rank-deficient Gram).
        if len(a.chunks[0]) != 1:
            a = a.rechunk({0: -1})
        dt = _float_dtype(a.dtype)
        k = int(m)
        q = _single(a.expr, "jnp.linalg.qr", 0, (m, k), dt, kwargs=(("mode", "reduced"),))
        r = _single(a.expr, "jnp.linalg.qr", 1, (k, n), dt, kwargs=(("mode", "reduced"),))
        if not compute_svd:
            return q, r
        # reference contract: vh is the FULL (n, n) right factor for short
        # inputs; u is (m, k) (full == reduced, m < n)
        kw = (("full_matrices", True),)
        u = _single(a.expr, "svd", 0, (m, k), dt, kwargs=kw)
        s = _single(a.expr, "svd", 1, (k,), _real(dt), kwargs=kw)
        vh = _single(a.expr, "svd", 2, (n, n), dt, kwargs=kw)
        return u, s, vh

    if compute_svd:
        # the fused pipeline (never forms Q)
        return (
            new_collection(TSQRSVD(a.expr, "u")),
            new_collection(TSQRSVD(a.expr, "s")),
            new_collection(TSQRSVD(a.expr, "vh")),
        )
    return new_collection(TSQR(a.expr, "q")), new_collection(TSQR(a.expr, "r"))


def sfqr(a, name=None):
    """Short-fat QR of a single row block (parity: ``sfqr``)."""
    m, n = a.shape
    if len(a.chunks[0]) != 1:
        raise ValueError("sfqr requires a single row block")
    dt = _float_dtype(a.dtype)
    q = _single(a.expr, "jnp.linalg.qr", 0, (m, min(m, n)), dt, kwargs=(("mode", "reduced"),))
    r = _single(a.expr, "jnp.linalg.qr", 1, (min(m, n), n), dt, kwargs=(("mode", "reduced"),))
    return q, r


def svd_flip(u, v, u_based_decision=False):
    """Deterministic singular-vector signs (parity: ``svd_flip``): orient
    each singular pair so the chosen side's component sums are
    non-negative.  The three multiplies (a scalar, a row and a column)
    are the scale kernel's (``kernels/scale.py``).

    The signs are frozen: u's and v's products share them, and computed
    together (``compute(u, s, vh)``, each root optimized alone) v's
    transpose would otherwise be pushed into the scalar multiply, which
    v's root would then compute a second time, transposed."""
    if u_based_decision:
        signs_row = u.sum(axis=0, keepdims=True)  # (1, k)
    else:
        signs_row = v.sum(axis=1, keepdims=True).T  # (1, k)
    signs = (2.0 * ((signs_row >= 0).astype(u.dtype) - 0.5)).freeze_chunks()
    return u * signs, v * signs.T


def svd(a, coerce_signs=True, full_matrices=False, compute_uv=True):
    """SVD; tall/short inputs use the TSQR reduction (parity: ``svd``:
    ``compute_uv=False`` returns only the singular values,
    ``full_matrices=True`` is rejected unless uv is not computed)."""
    if a.ndim != 2:
        raise ValueError(
            f"Array must be 2D for svd, got {a.ndim}D (shape {a.shape})"
        )
    if not compute_uv:
        # full_matrices does not change the singular values
        _, s, _ = svd(a, coerce_signs=False)
        return s
    if full_matrices:
        raise NotImplementedError(
            "full_matrices=True is not supported; use full_matrices=False "
            "(thin SVD) or compute_uv=False"
        )
    m, n = a.shape
    m_blocks, n_blocks = len(a.chunks[0]), len(a.chunks[1])
    dt = _float_dtype(a.dtype)

    def _known(v):
        return not (isinstance(v, float) and np.isnan(v))

    if m_blocks > 1 and n_blocks > 1:
        raise NotImplementedError(
            "svd of an array chunked along both axes is not supported; rechunk "
            "so one axis has a single chunk, or use svd_compressed"
        )
    if m_blocks == 1 and n_blocks == 1:
        k = min(m, n)
        u = _single(a.expr, "svd", 0, (m, k), dt, kwargs=(("full_matrices", False),))
        s = _single(a.expr, "svd", 1, (k,), _real(dt), kwargs=(("full_matrices", False),))
        vh = _single(a.expr, "svd", 2, (k, n), dt, kwargs=(("full_matrices", False),))
    elif m_blocks >= n_blocks:
        # numblocks dispatch: row-chunked goes through tsqr even when the
        # SHAPE is short; trim the full factors
        u, s, vh = tsqr(a, compute_svd=True)
        if _known(m) and _known(n) and m < n:
            k = min(m, n)
            u, vh = u[:, :k], vh[:k, :]
    else:
        u_t, s, vh_t = tsqr(a.T, compute_svd=True)
        u, vh = vh_t.T, u_t.T
        if _known(m) and _known(n) and m > n:
            k = min(m, n)
            u, vh = u[:, :k], vh[:k, :]
    if coerce_signs:
        u, vh = svd_flip(u, vh)
    return u, s, vh


def compression_level(n, q, n_oversamples=10, min_subspace_size=20):
    """Compression level for svd_compressed: ``q`` plus oversamples, floored
    at ``min_subspace_size``, capped by the space size."""
    return min(max(min_subspace_size, q + n_oversamples), n)


def compression_matrix(data, q, iterator="power", n_power_iter=0, n_oversamples=10, seed=None, compute=False):
    """Orthonormal panel spanning the most active subspace: the (comp, m)
    matrix whose transpose is the sampled range basis."""
    q_mat = _range_panel(data, q, iterator, n_power_iter, n_oversamples, seed)
    return _ct(q_mat)


def _ct(x):
    """The conjugate transpose (the transpose of real data)."""
    return x.conj().T if x.dtype.kind == "c" else x.T


def _range_panel(a, k, iterator, n_power_iter, n_oversamples, seed):
    """The randomized range finder shared by compression_matrix and
    svd_compressed: sample, (power|QR)-iterate, orthonormalize by TSQR."""
    from dask_array_tpu_torch.ops.random import default_rng

    m, n = a.shape
    comp_level = compression_level(min(m, n), k, n_oversamples=n_oversamples)
    rng = default_rng(seed)
    omega = rng.standard_normal(
        size=(n, comp_level), chunks=(a.chunks[1], -1)
    ).astype(_float_dtype(a.dtype))
    mat_h = a @ omega
    if iterator == "power":
        # plain power iteration, ONE orthonormalization at the end.  Each
        # step is rescaled by its max-abs (a lazy scalar: no sync), which
        # leaves the spanned subspace as it is: singular values grow as
        # sigma^(2k+1) and CholeskyQR squares them again, so a float32
        # panel would overflow without it
        from dask_array_tpu_torch.ops.reductions import max as _max
        from dask_array_tpu_torch.ops.ufuncs import abs as _abs

        for _ in range(n_power_iter):
            mat_h = a @ (_ct(a) @ mat_h)
            mat_h = mat_h / _max(_abs(mat_h))
        q, _ = tsqr(mat_h)
    elif iterator == "QR":
        # re-orthonormalize by TSQR every half-step (stable for large
        # n_power_iter)
        q, _ = tsqr(mat_h)
        for _ in range(n_power_iter):
            q, _ = tsqr(_ct(a) @ q)
            q, _ = tsqr(a @ q)
    else:
        raise ValueError(
            f"Compression matrix iterator must be 'power' or 'QR', got {iterator!r}"
        )
    return q


def svd_compressed(a, k, iterator="power", n_power_iter=0, n_oversamples=10, seed=None, compute=False,
                   coerce_signs=True):
    """Randomized (compressed) SVD: the top ``k`` singular triplets from a
    sampled range panel, a composition of matmuls and TSQRs."""
    q = _range_panel(a, k, iterator, n_power_iter, n_oversamples, seed)
    b = _ct(q) @ a
    comp_level = q.shape[1]
    if comp_level >= b.shape[1]:
        # square-ish compressed panel: the m >= n svd path needs ONE column
        # block (b is comp x n, small either way)
        b = b.rechunk((b.shape[0], b.shape[1]))
    else:
        b = b.rechunk((b.shape[0], b.chunks[1]))
    u_inner, s, vh = svd(b, coerce_signs=False)
    u = q @ u_inner
    u, s, vh = u[:, :k], s[:k], vh[:k, :]
    if coerce_signs:
        u, vh = svd_flip(u, vh)
    return u, s, vh


def cholesky(a, lower=False):
    m, n = a.shape
    if m != n:
        raise ValueError("Dimension mismatch: cholesky requires a square array")
    dt = _float_dtype(a.dtype)
    out = _single(a.expr, "jnp.linalg.cholesky", None, (m, n), dt)
    if lower:
        return out
    from dask_array_tpu_torch.ops.manipulation import transpose
    from dask_array_tpu_torch.ops.ufuncs import conj

    return conj(transpose(out))


class BlockedLU(ArrayExpr):
    """Right-looking block LU with block-local pivoting (parity: the
    reference's blocked ``lu``).

    The permutation is block-diagonal: pivoting within each diagonal block,
    the standard blocked relaxation (``P @ L @ U == A`` holds exactly), NOT
    the pivoting of a whole-matrix LU.  Per step: factor the diagonal
    block, retroactively permute the L panel row, triangular-solve the
    row/column panels, then rank-b update the trailing submatrix.
    """

    _parameters = ("array", "which")  # which: "p" | "l" | "u"

    @functools.cached_property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=_float_dtype(self.array.dtype))

    def _factor(self, ctx):
        view = ctx.build(self.array)
        dt = torch_dtype(self.dtype)
        nb = view.numblocks[0]
        chunks0 = self.array.chunks[0]
        _count_factorization()
        if nb > _LU_MAX_BLOCKS and len(set(chunks0)) == 1:
            return self._factor_strips(view, dt, nb, int(chunks0[0]))
        A = {(i, j): view.block((i, j)).to(dt) for i in range(nb) for j in range(nb)}
        P: dict = {}
        L: dict = {}
        U: dict = {}
        lu_block = _lu_block_fn(dt)
        for k in range(nb):
            p_k, l_kk, u_kk = lu_block(A[(k, k)])
            P[k] = p_k
            L[(k, k)] = l_kk
            U[(k, k)] = u_kk
            # retroactively permute this block-row's already-computed L panel
            for m in range(k):
                L[(k, m)] = _mm(p_k.mT, L[(k, m)])
            for j in range(k + 1, nb):
                U[(k, j)] = torch.linalg.solve_triangular(
                    l_kk, _mm(p_k.mT, A[(k, j)]), upper=False, unitriangular=True
                )
            for i in range(k + 1, nb):
                # L[i,k] = A[i,k] @ inv(u_kk)
                L[(i, k)] = torch.linalg.solve_triangular(u_kk, A[(i, k)], upper=True, left=False)
            for i in range(k + 1, nb):
                for j in range(k + 1, nb):
                    A[(i, j)] = A[(i, j)] - _mm(L[(i, k)], U[(k, j)])

        def zeros(i, j):
            return torch.zeros((chunks0[i], chunks0[j]), dtype=dt, device=P[0].device)

        out = {"p": {}, "l": {}, "u": {}}
        for i in range(nb):
            for j in range(nb):
                out["p"][(i, j)] = P[i] if i == j else zeros(i, j)
                out["l"][(i, j)] = L[(i, j)] if j <= i else zeros(i, j)
                out["u"][(i, j)] = U[(i, j)] if j >= i else zeros(i, j)
        return out

    def _factor_strips(self, view, dt, nb, b):
        """The panel LU over full-width strips, the form the reference runs
        as a ``lax.fori_loop`` past ``_LU_MAX_BLOCKS`` blocks: masked
        full-width solves and updates (about 3x the exact LU's FLOPs), the
        same block-diagonal pivoting."""
        n = nb * b
        A = view.dense().to(dt).clone()
        rows = torch.arange(n, device=A.device)
        lu_block = _lu_block_fn(dt)
        P = []
        for k in range(nb):
            off = k * b
            p_k, l_kk, u_kk = lu_block(A[off:off + b, off:off + b])
            # row strip: permute it whole (retro-permutes the finished L
            # panels on the left), unit-lower solve right of the diagonal
            R = _mm(p_k.mT, A[off:off + b, :])
            S = torch.linalg.solve_triangular(l_kk, R, upper=False, unitriangular=True)
            right = rows[None, :] >= off + b
            A[off:off + b, :] = torch.where(right, S, R)
            # column strip: right-solve against u_kk below the diagonal
            C = A[:, off:off + b]
            T = torch.linalg.solve_triangular(u_kk, C, upper=True, left=False)
            below = rows[:, None] >= off + b
            A[:, off:off + b] = torch.where(below, T, C)
            A[off:off + b, off:off + b] = torch.tril(l_kk, -1) + u_kk
            # rank-b trailing update, confined to the trailing block
            zero = torch.zeros((), dtype=dt, device=A.device)
            A = A - _mm(torch.where(below, T, zero), torch.where(right, S, zero))
            P.append(p_k)
        p = torch.block_diag(*P)
        return {"p": p, "l": torch.tril(A, -1) + _eye(n, A), "u": torch.triu(A)}

    def _build(self, ctx):
        out = ctx.shared(("blocked-lu", self.array._name), lambda: self._factor(ctx))[self.which]
        if isinstance(out, dict):
            return BlockView(self.chunks, blocks=out)
        return BlockView(self.chunks, dense=out)


# block grids past this edge use the strip formulation (uniform grids) or
# the in-core factorization (non-uniform ones), as the reference does
_LU_MAX_BLOCKS = 16


def lu(a):
    """Blocked LU decomposition ``a = p @ l @ u`` of a square chunked array.

    Runs the right-looking blocked algorithm over the chunk grid: in-core
    ``lu`` on the diagonal panel, triangular solves on the row/column
    panels, Schur-complement updates on the trailing blocks.  Requires a
    square regular chunk grid.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("lu requires a square array")
    dt = _float_dtype(a.dtype)
    m_chunks, n_chunks = a.chunks
    nb = len(m_chunks)

    def _blocked_ok(chunks_axis):
        # small grids unroll exactly; large ones need the strip form, which
        # requires a uniform block size
        return len(chunks_axis) <= _LU_MAX_BLOCKS or len(set(chunks_axis)) == 1

    if nb > 1 and m_chunks == n_chunks and _blocked_ok(m_chunks):
        from dask_array_tpu_torch._collection import new_collection

        return (
            new_collection(BlockedLU(a.expr, "p")),
            new_collection(BlockedLU(a.expr, "l")),
            new_collection(BlockedLU(a.expr, "u")),
        )
    if nb > 1 and m_chunks != n_chunks:
        # square blocks required on the diagonal: align to the row grid
        a = a.rechunk((m_chunks, m_chunks))
        if _blocked_ok(m_chunks):
            return lu(a)
    p = _single(a.expr, "jsl.lu", 0, (m, m), dt)
    l = _single(a.expr, "jsl.lu", 1, (m, m), dt)
    u = _single(a.expr, "jsl.lu", 2, (m, m), dt)
    return p, l, u


class BlockedTriSolve(ArrayExpr):
    """Blocked forward/backward substitution: solve ``T x = b`` per block
    row.  Each block-row update is a panel matmul; only the diagonal-block
    solves are small in-core triangular solves."""

    _parameters = ("tmat", "rhs", "lower", "unit_diagonal")

    @functools.cached_property
    def chunks(self):
        return self.rhs.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty(
            (0,) * self.rhs.ndim,
            dtype=_float_dtype(np.promote_types(self.tmat.dtype, self.rhs.dtype)),
        )

    def _build(self, ctx):
        tview = ctx.build(self.tmat)
        bview = ctx.build(self.rhs)
        dt = torch_dtype(self.dtype)
        nb = tview.numblocks[0]
        vec = self.rhs.ndim == 1
        ncol = 1 if vec else bview.numblocks[1]

        out_blocks = {}
        for k in range(ncol):
            x: dict = {}
            order = range(nb) if self.lower else range(nb - 1, -1, -1)
            for i in order:
                acc = (bview.block((i,)) if vec else bview.block((i, k))).to(dt)
                js = range(i) if self.lower else range(i + 1, nb)
                for j in js:
                    acc = acc - _mm(tview.block((i, j)).to(dt), x[j])
                x[i] = _solve_triangular(
                    tview.block((i, i)).to(dt), acc, lower=self.lower, unit_diagonal=self.unit_diagonal
                )
            for i in range(nb):
                out_blocks[(i,) if vec else (i, k)] = x[i]
        return BlockView(self.chunks, blocks=out_blocks)


def _blocked_tri_applicable(a, b):
    m_chunks, n_chunks = a.chunks
    if m_chunks != n_chunks or len(m_chunks) <= 1 or len(m_chunks) > _LU_MAX_BLOCKS:
        return False
    if b.chunks[0] != m_chunks:
        return False
    return True


def solve(a, b, sym_pos=None, assume_a="gen"):
    dt = _float_dtype(np.promote_types(a.dtype, b.dtype))
    out_shape = b.shape
    if assume_a == "pos" or sym_pos:
        fn = "jsl.solve"
        kwargs = (("assume_a", "pos"),)
        return _single(a.expr, fn, None, out_shape, dt, kwargs=kwargs, extra=(b.expr,))
    m_chunks = a.chunks[0]
    if a.chunks[0] == a.chunks[1] and 1 < len(m_chunks) <= _LU_MAX_BLOCKS:
        # blocked path: P L U x = b
        p, l, u = lu(a)
        pb = p.T @ b
        pb = pb.rechunk((m_chunks,) + tuple(pb.chunks[1:]))
        y = solve_triangular(l, pb, lower=True, unit_diagonal=True)
        return solve_triangular(u, y, lower=False)
    return _single(a.expr, "jnp.linalg.solve", None, out_shape, dt, extra=(b.expr,))


def solve_triangular(a, b, lower=False, trans=0, unit_diagonal=False):
    """Solve ``a x = b`` for triangular ``a``, block-forward/back substitution.

    ``trans`` in ``(0, 'N') | (1, 'T') | (2, 'C')`` solves with ``a``,
    ``a.T`` or ``a.conj().T``.
    """
    from dask_array_tpu_torch._collection import new_collection

    dt = _float_dtype(np.promote_types(a.dtype, b.dtype))
    if trans in (1, "T"):
        return solve_triangular(a.T, b, lower=not lower, trans=0, unit_diagonal=unit_diagonal)
    if trans in (2, "C"):
        from dask_array_tpu_torch.ops.ufuncs import conj

        return solve_triangular(conj(a).T, b, lower=not lower, trans=0, unit_diagonal=unit_diagonal)
    if _blocked_tri_applicable(a, b):
        return new_collection(BlockedTriSolve(a.expr, b.expr, bool(lower), bool(unit_diagonal)))
    return _single(
        a.expr,
        "jsl.solve_triangular",
        None,
        b.shape,
        dt,
        kwargs=(("lower", bool(lower)), ("trans", 0), ("unit_diagonal", bool(unit_diagonal))),
        extra=(b.expr,),
    )


def inv(a):
    m, n = a.shape
    if m != n:
        raise ValueError("inv requires a square array")
    return _single(a.expr, "jnp.linalg.inv", None, (m, n), _float_dtype(a.dtype))


def lstsq(a, b):
    m, n = a.shape
    dt = _float_dtype(np.promote_types(a.dtype, b.dtype))
    # residuals and singular values are REAL even for complex systems
    real_dt = _real(dt)
    nrhs = b.shape[1] if b.ndim == 2 else None
    x_shape = (n, nrhs) if nrhs else (n,)
    kwargs = (("rcond", None),)
    x = _single(a.expr, "jnp.linalg.lstsq", 0, x_shape, dt, kwargs=kwargs, extra=(b.expr,))
    resid_shape = (nrhs,) if nrhs else (1,)
    residuals = _single(a.expr, "jnp.linalg.lstsq", 1, resid_shape, real_dt, kwargs=kwargs, extra=(b.expr,))
    rank = _single(a.expr, "jnp.linalg.lstsq", 2, (), np.dtype(np.int32), kwargs=kwargs, extra=(b.expr,))
    sv = _single(a.expr, "jnp.linalg.lstsq", 3, (min(m, n),), real_dt, kwargs=kwargs, extra=(b.expr,))
    return x, residuals, rank, sv


def norm(x, ord=None, axis=None, keepdims=False):
    """Matrix/vector norms composed from reductions (parity: ``_norm.py``)."""
    from dask_array_tpu_torch.ops import reductions as red
    from dask_array_tpu_torch.ops.manipulation import expand_dims
    from dask_array_tpu_torch.ops.ufuncs import abs as _abs, sqrt

    if x.dtype.kind not in "fc":  # numpy: integers and bool in float64, before any square or sum
        x = x.astype(np.float64)
    if axis is None:
        if ord is None:
            # numpy: default norm of an unaxed array of ANY ndim is the
            # 2-norm of the raveled values
            return sqrt(red.sum(_abs(x) ** 2, keepdims=keepdims))
        axis = tuple(range(x.ndim))
    elif isinstance(axis, (int, np.integer)):
        axis = (int(axis) % x.ndim,)
    else:
        axis = tuple(int(a) % x.ndim for a in axis)

    if len(axis) == 1:
        ax = axis[0]
        if ord is None or ord == 2:
            return sqrt(red.sum(_abs(x) ** 2, axis=ax, keepdims=keepdims))
        if ord == np.inf:
            return red.max(_abs(x), axis=ax, keepdims=keepdims)
        if ord == -np.inf:
            return red.min(_abs(x), axis=ax, keepdims=keepdims)
        if ord == 0:
            return red.sum(x != 0, axis=ax, keepdims=keepdims).astype(_float_dtype(x.dtype))
        if ord == 1:
            return red.sum(_abs(x), axis=ax, keepdims=keepdims)
        return red.sum(_abs(x) ** ord, axis=ax, keepdims=keepdims) ** (1.0 / ord)

    if len(axis) == 2:
        a1, a2 = axis

        def _restore_dims(r):
            if keepdims:
                return expand_dims(r, tuple(sorted(axis)))
            return r

        if ord in (None, "fro", "f"):
            return sqrt(red.sum(_abs(x) ** 2, axis=axis, keepdims=keepdims))
        if ord in ("nuc", 2, -2):
            if x.ndim != 2:
                raise NotImplementedError(
                    f"norm ord={ord!r} of stacked matrices is not supported"
                )
            sx = x
            if len(x.chunks[0]) > 1 and len(x.chunks[1]) > 1:
                sx = x.rechunk((x.shape[0], x.shape[1]))
            _, s_, _ = svd(sx)
            if ord == "nuc":
                r = red.sum(s_)
            elif ord == 2:
                r = red.max(s_)
            else:
                r = red.min(s_)
            return _restore_dims(r)
        # ±1 / ±inf: reduce one axis with sum(|x|), then max/min the other
        if ord in (1, -1, np.inf, -np.inf):
            sum_axis = a1 if ord in (1, -1) else a2
            sums = red.sum(_abs(x), axis=sum_axis, keepdims=True)
            pick = red.max if ord in (1, np.inf) else red.min
            # sums kept its dims, so reducing both original axes is exact
            return pick(sums, axis=(min(a1, a2), max(a1, a2)), keepdims=keepdims)
        raise ValueError(f"Invalid norm order {ord!r} for matrices")
    raise ValueError("Improper number of dimensions to norm.")


__all__ = [
    "cholesky",
    "compression_level",
    "compression_matrix",
    "inv",
    "lstsq",
    "lu",
    "norm",
    "qr",
    "sfqr",
    "solve",
    "solve_triangular",
    "svd",
    "svd_compressed",
    "svd_flip",
    "tsqr",
]
