"""Content-addressed lazy array expressions + the optimizer fixpoint engine.

Port of ``dask_array_tpu/_expr.py``: immutable singleton nodes keyed by a
deterministic token, cached ``chunks``/``_meta``/``_name`` metadata, and the
``simplify -> lower -> fuse`` pipeline with sharing-aware slice, rechunk and
transpose pushdown gates.

Physical nodes implement ``_build(ctx) -> BlockView`` (``_executor.py``);
the executor walks the lowered tree once over torch tensors on the
configured device.
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
import weakref
from collections import defaultdict

import numpy as np
import torch

from dask_array_tpu_torch._chunks import (
    grid_shape,
    has_unknown_chunks,
    num_blocks,
    numpy_dtype,
    torch_dtype,
)
from dask_array_tpu_torch._spans import span
from dask_array_tpu_torch.utils._tokenize import tokenize

# rewrite tracing hook (``_diagnostics.trace_rewrites`` and ``explain``)
_trace_hook = None  # callable(rule, before, after, phase) | None


def _record_rewrite(rule: str, before, after, phase: str) -> None:
    if _trace_hook is not None and after is not None and after._name != before._name:
        _trace_hook(rule, before, after, phase)


@functools.lru_cache(maxsize=None)
def _param_index(cls) -> dict:
    """name -> operand position for a concrete expr class."""
    return {name: i for i, name in enumerate(cls._parameters)}


class ArrayExpr:
    """Base class for all array expression nodes.

    Subclasses declare ``_parameters`` (operand names, in positional order)
    and ``_defaults`` (keyword defaults).  Instances are singletons: building
    the same node twice returns the same object.

    A node type that children may rewrite (Slice, Rechunk, Transpose) names
    the child-side gate in ``_pushdown_gate``; ``_simplify_up`` dispatches
    on it, so this module imports none of the node modules.
    """

    _parameters: tuple = ()
    _defaults: dict = {}
    _pushdown_gate: str | None = None
    # operands that are block functions a user may write in numpy: their
    # lane (``_host.py``) shows in ``pprint``
    _lane_operands: tuple = ()
    # whether the node's build takes ml_dtypes' narrow types (``_narrow``):
    # it moves a uint8 carrier's patterns as they are, or decodes and
    # encodes by its dtypes.  Any other node with a narrow operand or result
    # raises in the walk (``_executor.check_narrow``) rather than read the
    # patterns as uint8 numbers.
    takes_narrow: bool = False

    _instances: "weakref.WeakValueDictionary[str, ArrayExpr]" = weakref.WeakValueDictionary()
    _instances_lock = threading.Lock()

    operands: list

    def __new__(cls, *args, **kwargs):
        operands = list(args)
        params = list(cls._parameters)
        if kwargs:
            for name in params[len(operands):]:
                if name in kwargs:
                    operands.append(kwargs.pop(name))
                elif name in cls._defaults:
                    operands.append(cls._defaults[name])
                else:
                    raise TypeError(f"{cls.__name__} missing operand {name!r}")
            if kwargs:
                raise TypeError(f"{cls.__name__} got unexpected operands {sorted(kwargs)}")
        elif len(operands) < len(params):
            for name in params[len(operands):]:
                if name not in cls._defaults:
                    raise TypeError(f"{cls.__name__} missing operand {name!r}")
                operands.append(cls._defaults[name])

        inst = object.__new__(cls)
        inst.operands = operands
        tok = inst._name
        with ArrayExpr._instances_lock:
            existing = ArrayExpr._instances.get(tok)
            if existing is not None and type(existing) is cls:
                return existing
            ArrayExpr._instances[tok] = inst
        return inst

    # -- operand access -----------------------------------------------------

    def operand(self, name):
        return self.operands[_param_index(type(self))[name]]

    def __getattr__(self, name):
        idx = _param_index(type(self)).get(name)
        if idx is not None:
            return self.operands[idx]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    # -- identity -----------------------------------------------------------

    @functools.cached_property
    def deterministic_token(self) -> str:
        return tokenize(type(self).__qualname__, *self.operands)

    @functools.cached_property
    def _name(self) -> str:
        return f"{self._name_prefix()}-{self.deterministic_token}"

    def _name_prefix(self) -> str:
        return type(self).__name__.lower()

    def _collection_name(self) -> str:
        return self._name

    def __hash__(self):
        return hash(self._name)

    def __eq__(self, other):
        return isinstance(other, ArrayExpr) and self._name == other._name

    def __reduce__(self):
        """Pickle by (class, operands) only: caches are dropped and the
        singleton registry deduplicates again on load.  torch callables in
        operands are encoded by public attribute path
        (``utils/_pickle.py``)."""
        from dask_array_tpu_torch.utils._pickle import encode_operand, unpickle_expr

        return (unpickle_expr, (type(self), tuple(encode_operand(o) for o in self.operands)))

    def __repr__(self):
        return f"{type(self).__name__}({self._describe()})"

    def _describe(self) -> str:
        parts = []
        for name, op in zip(type(self)._parameters, self.operands):
            if isinstance(op, ArrayExpr):
                parts.append(f"{name}={type(op).__name__}(...)")
            else:
                r = repr(op)
                if len(r) > 40:
                    r = r[:37] + "..."
                parts.append(f"{name}={r}")
        return ", ".join(parts)

    # -- array metadata -----------------------------------------------------

    @functools.cached_property
    def _meta(self):
        raise NotImplementedError(f"{type(self).__name__}._meta")

    @functools.cached_property
    def chunks(self):
        raise NotImplementedError(f"{type(self).__name__}.chunks")

    @property
    def dtype(self):
        m = self._meta
        return m.dtype if hasattr(m, "dtype") else np.dtype(type(m))

    @functools.cached_property
    def shape(self):
        return tuple(
            int(sum(c)) if not any(isinstance(x, float) and math.isnan(x) for x in c) else float("nan")
            for c in self.chunks
        )

    @property
    def ndim(self):
        return len(self.chunks)

    @functools.cached_property
    def numblocks(self):
        return grid_shape(self.chunks)

    @property
    def npartitions(self):
        return num_blocks(self.chunks)

    @property
    def size(self):
        sh = self.shape
        if any(isinstance(s, float) and math.isnan(s) for s in sh):
            return float("nan")
        return int(np.prod(sh)) if sh else 1

    @property
    def nbytes(self):
        s = self.size
        if isinstance(s, float) and math.isnan(s):
            return float("nan")
        return s * self.dtype.itemsize

    @property
    def chunksize(self):
        return tuple(max(c) for c in self.chunks) if self.ndim else ()

    @property
    def known_chunks(self) -> bool:
        return not has_unknown_chunks(self.chunks)

    # -- tree walking ---------------------------------------------------------

    def dependencies(self):
        return [op for op in self.operands if isinstance(op, ArrayExpr)]

    def walk(self):
        """Yield every node in the tree exactly once (pre-order)."""
        seen = set()
        stack = [self]
        while stack:
            node = stack.pop()
            if node._name in seen:
                continue
            seen.add(node._name)
            yield node
            stack.extend(node.dependencies())

    def find(self, cls):
        return [n for n in self.walk() if isinstance(n, cls)]

    def substitute(self, old, new, _memo=None):
        """Return a copy of the tree with ``old`` (an expr) replaced by ``new``."""
        memo = _memo if _memo is not None else {}
        return self._substitute_many({old._name: new}, memo)

    def _substitute_many(self, mapping: dict, memo: dict):
        if self._name in mapping:
            return mapping[self._name]
        if self._name in memo:
            return memo[self._name]
        changed = False
        new_operands = []
        for op in self.operands:
            if isinstance(op, ArrayExpr):
                new_op = op._substitute_many(mapping, memo)
                changed = changed or new_op is not op
                new_operands.append(new_op)
            else:
                new_operands.append(op)
        out = type(self)(*new_operands) if changed else self
        memo[self._name] = out
        return out

    def rebuild(self, operands):
        return type(self)(*operands)

    # -- display --------------------------------------------------------------

    def tree_repr(self, indent=0, seen=None) -> str:
        seen = seen if seen is not None else set()
        header = " " * indent + self._pprint_line()
        if self._name in seen:
            return header + "  (shared)\n"
        seen.add(self._name)
        out = [header + "\n"]
        for dep in self.dependencies():
            out.append(dep.tree_repr(indent + 2, seen))
        return "".join(out)

    def _pprint_line(self) -> str:
        extras = []
        for name, op in zip(type(self)._parameters, self.operands):
            if isinstance(op, ArrayExpr):
                continue
            r = repr(op)
            if len(r) > 32:
                r = r[:29] + "..."
            extras.append(f"{name}={r}")
        inner = ", ".join(extras)
        note = ""
        if self._lane_operands:
            from dask_array_tpu_torch._host import lane_note

            note = lane_note(self, [(k, self.operand(k)) for k in self._lane_operands])
        return f"{type(self).__name__}({inner}){note}"

    def pprint(self):
        print(self.tree_repr(), end="")

    # ==========================================================================
    # optimizer: simplify -> lower -> fuse
    # ==========================================================================

    def optimize(self, fuse=True):
        expr = self.simplify()
        expr = expr.lower_completely()
        if fuse:
            from dask_array_tpu_torch._blockwise import optimize_blockwise_fusion

            expr = optimize_blockwise_fusion(expr)
        return expr

    # -- simplify ------------------------------------------------------------

    def _simplify_down(self):
        """Rewrite this node in isolation (constant folds, no-op removal)."""
        return None

    def _simplify_up(self, parent, dependents):
        """Offer a replacement for ``parent`` (self is one of its children):
        a parent that declares a pushdown gate is routed through it."""
        gate = type(parent)._pushdown_gate
        if gate is None:
            return None
        return getattr(self, gate)(parent, dependents)

    # -- pushdown gates (sharing-aware) ---------------------------------------

    def _slice_pushdown(self, parent, dependents):
        """Push ``parent`` (a Slice of self) into self.

        Declines when another (non-slice) consumer shares ``self`` — pushing
        would duplicate the upstream computation per consumer.  When every
        consumer is a slice, pushing is allowed (each then reads less).
        """
        for d in dependents.get(self._name, ()):
            if type(d)._pushdown_gate != "_slice_pushdown":
                return None
        out = self._accept_slice(parent.index)
        _record_rewrite(f"{type(self).__name__}._accept_slice", parent, out, "simplify")
        return out

    def _rechunk_pushdown(self, parent, dependents):
        if len(dependents.get(self._name, ())) > 1:
            return None
        out = self._accept_rechunk(parent.target_chunks)
        _record_rewrite(f"{type(self).__name__}._accept_rechunk", parent, out, "simplify")
        return out

    def _transpose_pushdown(self, parent, dependents):
        if len(dependents.get(self._name, ())) > 1:
            return None
        out = self._accept_transpose(parent.axes)
        _record_rewrite(f"{type(self).__name__}._accept_transpose", parent, out, "simplify")
        return out

    def _accept_slice(self, index):
        """Return an expression equivalent to self[index], or None to decline."""
        return None

    def _accept_rechunk(self, target_chunks):
        return None

    def _accept_transpose(self, axes):
        """Return an expression equivalent to transpose(self, axes), or None."""
        return None

    # -- fixpoint passes ---------------------------------------------------------

    def simplify(self):
        warm_metadata(self)
        expr = self
        seen = set()
        # some rules advance one level per pass (slice pushdown through an
        # elemwise chain), so the cap scales with plan size
        cap = None
        last_size = None
        shrinking = True
        for _pass in itertools.count():
            if expr._name in seen:
                break
            seen.add(expr._name)
            dependents = collect_dependents(expr)
            if cap is None:
                cap = max(200, 4 * len(dependents) + 100)
            if _pass >= cap:
                if shrinking:
                    break  # slow convergence, not divergence
                import warnings

                warnings.warn(
                    f"simplify did not converge in {cap} passes; a rewrite "
                    "rule is likely non-contracting",
                    RuntimeWarning,
                    stacklevel=2,
                )
                break
            size = len(dependents)
            shrinking = last_size is None or size < last_size
            last_size = size
            new = _simplify_pass(expr, dependents, {})
            if new._name == expr._name:
                break
            expr = new
        return expr

    def _lower(self):
        """Rewrite a logical node into (closer-to-)physical nodes, or None."""
        return None

    @property
    def _lower_cache_key(self):
        """Key for the lowering cache; nodes whose ``_lower`` decision
        depends on context beyond their own subtree fold that in."""
        return self._name

    def lower_once(self, cache):
        key = self._lower_cache_key
        hit = cache.get(key)
        if hit is not None:
            return hit
        expr = self
        out = expr._lower()
        if out is not None and out._name != expr._name:
            _record_rewrite(f"{type(expr).__name__}._lower", expr, out, "lower")
            expr = out
        new_operands = []
        changed = False
        for op in expr.operands:
            if isinstance(op, ArrayExpr):
                new_op = op.lower_once(cache)
                changed = changed or new_op._name != op._name
                new_operands.append(new_op)
            else:
                new_operands.append(op)
        if changed:
            expr = expr.rebuild(new_operands)
        cache[key] = expr
        return expr

    def lower_completely(self):
        warm_metadata(self)
        expr = self
        seen = set()
        while True:
            if expr._name in seen:
                break
            seen.add(expr._name)
            dependents = collect_dependents(expr)
            shared = frozenset(k for k, v in dependents.items() if len(v) > 1)
            _LOWERING_SHARED.append(shared)
            try:
                new = expr.lower_once(_lower_cache())
            finally:
                _LOWERING_SHARED.pop()
            if new._name == expr._name:
                break
            expr = new
        return expr

    # -- cost model -------------------------------------------------------------

    def transfer_bytes(self):
        """(min, max) bytes this node moves between blocks; block-local
        nodes move none.  Read by ``explain`` and ``expr_table``."""
        return (0, 0)

    # -- execution hooks ----------------------------------------------------------

    def _build(self, ctx):
        raise NotImplementedError(
            f"{type(self).__name__} is a logical node and cannot be built; "
            "call .optimize() / lower first"
        )

    def _leaf_buffers(self):
        """Yield (key, host buffer) pairs this leaf feeds into the executor."""
        return ()


# Context for sharing-aware lowering: ``lower_completely`` pushes the set of
# node names with >1 dependent before each pass, so a ``_lower`` that must
# not rewrite a shared child (Rechunk's absorb) can consult it.
_LOWERING_SHARED_TLS = threading.local()


class _SharedStack:
    @staticmethod
    def _stack():
        st = getattr(_LOWERING_SHARED_TLS, "stack", None)
        if st is None:
            st = _LOWERING_SHARED_TLS.stack = []
        return st

    def append(self, names):
        self._stack().append(names)

    def pop(self):
        self._stack().pop()


_LOWERING_SHARED = _SharedStack()


def lowering_shared_names() -> frozenset:
    """Names shared (>1 dependent) in the plan currently being lowered."""
    st = getattr(_LOWERING_SHARED_TLS, "stack", None)
    return st[-1] if st else frozenset()


# shared weak-value lowering cache; the config epoch guards against
# config-sensitive lowering (unify policy) serving stale lowered forms
_LOWER_CACHE_LOCK = threading.Lock()
_LOWER_CACHE: "weakref.WeakValueDictionary[str, ArrayExpr]" = weakref.WeakValueDictionary()
_LOWER_CACHE_EPOCH = [None]


def _lower_cache():
    from dask_array_tpu_torch import config

    with _LOWER_CACHE_LOCK:
        ep = config.epoch()
        if _LOWER_CACHE_EPOCH[0] != ep:
            _LOWER_CACHE.clear()
            _LOWER_CACHE_EPOCH[0] = ep
    return _LOWER_CACHE


def toposort(root: ArrayExpr):
    """Children-first (dependencies before dependents) iterative ordering."""
    order = []
    state: dict[str, int] = {}
    stack = [(root, False)]
    while stack:
        node, processed = stack.pop()
        if processed:
            order.append(node)
            continue
        if state.get(node._name, 0):
            continue
        state[node._name] = 1
        stack.append((node, True))
        for dep in node.dependencies():
            if not state.get(dep._name, 0):
                stack.append((dep, False))
    return order


def warm_metadata(root: ArrayExpr) -> None:
    """Populate chunks/_meta caches bottom-up so deep trees don't recurse.

    Errors are left for the access that needs the value to raise."""
    for node in toposort(root):
        for attr in ("chunks", "_meta"):
            try:
                getattr(node, attr)
            except (ValueError, TypeError, NotImplementedError):
                pass


def collect_dependents(root: ArrayExpr) -> dict:
    """Map node name -> list of distinct parent exprs within ``root``'s tree."""
    dependents: dict[str, list] = defaultdict(list)
    for node in root.walk():
        for dep in node.dependencies():
            lst = dependents[dep._name]
            if all(p._name != node._name for p in lst):
                lst.append(node)
    return dependents


def _simplify_pass(expr: ArrayExpr, dependents, memo) -> ArrayExpr:
    """One top-down pass of down- and up-rewrites over the tree."""
    if expr._name in memo:
        return memo[expr._name]

    out = expr
    for _ in range(100):
        new = out._simplify_down()
        if new is None or new._name == out._name:
            break
        _record_rewrite(f"{type(out).__name__}._simplify_down", out, new, "simplify")
        out = new
    if out._name != expr._name:
        memo[expr._name] = out
        return out

    for child in out.dependencies():
        new = child._simplify_up(out, dependents)
        if new is not None and new._name != out._name:
            memo[expr._name] = new
            return new

    new_operands = []
    changed = False
    for op in out.operands:
        if isinstance(op, ArrayExpr):
            new_op = _simplify_pass(op, dependents, memo)
            changed = changed or new_op._name != op._name
            new_operands.append(new_op)
        else:
            new_operands.append(op)
    if changed:
        out = out.rebuild(new_operands)
    memo[expr._name] = out
    return out


# ---------------------------------------------------------------------------
# meta helpers: result dtypes follow numpy's rules
# ---------------------------------------------------------------------------


def meta_from_array(x, ndim=None, dtype=None):
    """A 0-size numpy array carrying dtype/ndim (the `_meta` convention)."""
    if hasattr(x, "_meta"):
        x = x._meta
    if dtype is None:
        dtype = getattr(x, "dtype", None)
        if isinstance(dtype, torch.dtype):
            dtype = numpy_dtype(dtype)
        if dtype is None:
            dtype = np.dtype(type(x) if x is not None else float)
    if ndim is None:
        ndim = getattr(x, "ndim", 0)
    return np.empty((0,) * ndim, dtype=np.dtype(dtype))


# torch function names that differ from their numpy counterparts
_TORCH_TO_NUMPY_NAME = {
    "sub": "subtract",
    "mul": "multiply",
    "div": "true_divide",
    "neg": "negative",
    "pow": "power",
    "eq": "equal",
    "ne": "not_equal",
    "lt": "less",
    "le": "less_equal",
    "gt": "greater",
    "ge": "greater_equal",
    "asin": "arcsin",
    "acos": "arccos",
    "atan": "arctan",
    "atan2": "arctan2",
    "asinh": "arcsinh",
    "acosh": "arccosh",
    "atanh": "arctanh",
    "round": "rint",
    "bitwise_left_shift": "left_shift",
    "bitwise_right_shift": "right_shift",
    "conj_physical": "conjugate",
}


def _numpy_equivalent(func):
    """The numpy function matching a torch function, for dtype-rule parity.

    torch's promotion lattice differs from numpy's (int64 + a Python float
    gives float32, not float64); metadata follows numpy, and execution
    casts explicitly (see ``Elemwise._build``).
    """
    declared = getattr(func, "numpy_ufunc", None)
    if isinstance(declared, np.ufunc):
        return declared  # a port function standing in for a numpy ufunc
    mod = getattr(func, "__module__", "") or ""
    name = getattr(func, "__name__", None)
    if name and mod.startswith("torch"):
        np_fn = getattr(np, _TORCH_TO_NUMPY_NAME.get(name, name), None)
        if isinstance(np_fn, np.ufunc):
            return np_fn
    return None


def loop_dtypes(func, args):
    """numpy's ufunc loop dtypes for ``func`` applied to ``args`` — the
    dtypes each array operand is cast to before the torch call — or None
    when ``func`` has no numpy ufunc counterpart.

    Python scalars enter as weak types (numpy 2 / NEP 50), as they do in
    torch, so only array operands are cast.
    """
    np_fn = _numpy_equivalent(func)
    if np_fn is None or np_fn.nin != len(args):
        return None
    spec = []
    for a in args:
        if hasattr(a, "dtype") and hasattr(a, "ndim"):
            dt = a.dtype
            spec.append(numpy_dtype(dt) if isinstance(dt, torch.dtype) else np.dtype(dt))
        elif isinstance(a, np.generic):
            spec.append(a.dtype)
        elif isinstance(a, bool):
            spec.append(np.dtype(np.bool_))
        elif isinstance(a, (int, float, complex)):
            spec.append(type(a))
        else:
            return None
    try:
        return np_fn.resolve_dtypes(tuple(spec) + (None,) * np_fn.nout)[: np_fn.nin]
    except (TypeError, OverflowError):  # no loop for these operands
        return None


def compute_meta(func, out_ndim, *args, **kwargs):
    """Infer an output meta.

    Order: the numpy-equivalent function (a ufunc, or the numpy function a
    port function declares as ``numpy_function``; with ``numpy_strict`` its
    refusal raises) on tiny numpy inputs (numpy dtype rules, matching the
    reference API); then ``func`` on torch ``meta``
    tensors, then a real call on tiny CPU tensors.  The last two run with
    torch's default dtype at float64, so an integer meeting a Python float
    (or a true division of integers) promotes as numpy's rule says, and not
    to torch's default float32.  Returns None when nothing can evaluate
    ``func``.
    """
    with span("meta"):
        return _compute_meta(func, out_ndim, *args, **kwargs)


def _compute_meta(func, out_ndim, *args, **kwargs):
    metas = []
    for a in args:
        if hasattr(a, "dtype") and hasattr(a, "ndim"):
            dt = a.dtype if not isinstance(a.dtype, torch.dtype) else numpy_dtype(a.dtype)
            metas.append(np.ones((1,) * a.ndim, dtype=dt))
        else:
            metas.append(a)

    np_fn = _numpy_equivalent(func) or getattr(func, "numpy_function", None)
    if np_fn is not None:
        try:
            with np.errstate(all="ignore"):
                out = np_fn(*metas, **kwargs)
        except (TypeError, ValueError):
            if getattr(func, "numpy_strict", False):
                raise  # numpy refuses these operands: so does the port
            out = None  # torch-only keywords or operands: ask torch below
        if isinstance(out, tuple):  # a ufunc of several outputs: this one's
            out = out[getattr(func, "numpy_output", 0)]
        if out is not None:
            nd = out_ndim if out_ndim is not None else getattr(out, "ndim", 0)
            return meta_from_array(out, ndim=nd)

    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for device in ("meta", "cpu"):
            tensors = [
                torch.ones(m.shape, dtype=torch_dtype(m.dtype), device=device)
                if isinstance(m, np.ndarray) else m
                for m in metas
            ]
            try:
                out = func(*tensors, **kwargs)
            except (TypeError, ValueError, RuntimeError, NotImplementedError, IndexError):
                # meta tensors reject data-dependent ops; the CPU call is last
                continue
            if isinstance(out, (tuple, list)):
                return tuple(meta_from_array(o) for o in out)
            if not isinstance(out, torch.Tensor):
                out = torch.as_tensor(out)
            nd = out_ndim if out_ndim is not None else out.ndim
            return np.empty((0,) * nd, dtype=numpy_dtype(out.dtype))
    finally:
        torch.set_default_dtype(saved)
    return None
