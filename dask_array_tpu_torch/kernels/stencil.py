"""Band-stencil kernel for 2-D ``map_overlap``: the func's capture, the
gate, the CUDA wrappers and their plain PyTorch version.

Counterpart of ``dask_array_tpu/kernels/stencil.py`` (the Pallas band
kernel), which inlines any shape-preserving jnp ``func`` into its body.  A
compiled CUDA kernel cannot run an arbitrary torch function, so ``func`` is
read with ``torch.fx`` into one of two specs:

- taps (``capture_taps``): a linear stencil of shifted windows,
  ``sum_k w_k * roll(b, (dy_k, dx_k))``, run by the hand kernels of
  ``csrc/band_stencil.cu`` (a register window at depth (1, 1), a tap list
  at every other depth), their weights passed by value;
- a program (``capture_program``): a straight-line program of pointwise
  ops (arithmetic, transcendental functions, ``maximum``/``minimum``,
  ``clamp``, comparisons, ``where``) over shifted windows, which
  ``emit_program`` writes as CUDA C++ and ``kernels/_build.py`` compiles
  into a kernel of its own (``csrc/band_program.cuh`` holds its hand
  skeleton).

A func neither reads keeps the ``Overlap -> map_blocks -> trim`` route.

``band_stencil_call`` is what ``BandStencil._build`` calls: for a tensor
on the CPU it runs ``band_stencil_plain`` (pad, func, trim in torch); for a
CUDA tensor it launches the kernel of its spec or raises.  Kernels are
compiled with ``nvcc`` at their first CUDA call.  Their tile is 24 rows by
32 lanes of 16 bytes of columns (256 for float16 and bfloat16, 128 for
float32 and float64); the launcher counts the tiles, so nothing here
depends on the width.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
import struct
from numbers import Integral, Number

import numpy as np
import torch

from dask_array_tpu_torch._spans import COUNTS, call
from dask_array_tpu_torch.kernels._build import Launcher
from dask_array_tpu_torch.kernels.halo import numpy_mode, pad_axis_plain, value_key

MAX_DEPTH = 8
MAX_TAPS = (2 * MAX_DEPTH + 1) ** 2
_BOUNDARY_CODES = {"reflect": 0, "nearest": 1, "periodic": 2}
_CONSTANT_CODE = 3
_DTYPE_CODES = {torch.float16: 0, torch.float32: 1, torch.float64: 2, torch.bfloat16: 3}
_KERNEL_DTYPES = ("float16", "bfloat16", "float32", "float64")

# kernel launches since the last reset (band_stencil_cuda and
# band_program_cuda add to it), and the same launches by kernel variant
LAUNCHES = 0
VARIANT_LAUNCHES = {"window": 0, "taps": 0, "program": 0}


def reset_launches() -> None:
    """Set ``LAUNCHES`` and every per-variant count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    VARIANT_LAUNCHES.update(dict.fromkeys(VARIANT_LAUNCHES, 0))


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


def _one_input(func):
    """``func`` as a function of the block alone, for the trace: fx reads
    the signature of what it traces, so a partial or a func with defaults
    is traced through this wrapper and keeps its bound values."""

    def one_input(b):
        return func(b)

    return one_input


def capture_taps(func, depth):
    """The stencil ``func`` computes, as a tuple of ``(dy, dx, w)`` taps
    (``out[i, j] = sum w * b[i + dy, j + dx]``), or None.

    ``func`` is traced with ``torch.fx.symbolic_trace`` as a function of
    the block alone (``_one_input``).  Accepted: ``torch.roll`` (or ``Tensor.roll``) with int shifts and dims,
    each ``|shift|`` at most that axis's depth; ``+``, ``-`` and unary
    ``-`` of stencils; ``*`` and ``/`` by a Python scalar.  Every tap must
    land within ``depth``, so the kernel's boundary fill and the plain
    version's padded roll read the same elements.
    """
    import torch.fx

    try:
        gm = torch.fx.symbolic_trace(_one_input(func))
    except Exception:  # noqa: BLE001 - any func torch.fx cannot trace is not a capturable stencil
        return None
    env = {}
    result = None
    for node in gm.graph.nodes:
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
        if node.op == "placeholder":  # the one input of _one_input
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
    if not isinstance(result, dict):
        return None
    taps = tuple((dy, dx, float(w)) for (dy, dx), w in result.items() if w != 0.0)
    if any(abs(dy) > depth[0] or abs(dx) > depth[1] for dy, dx, _ in taps):
        return None
    return taps or ((0, 0, 0.0),)


# ---------------------------------------------------------------------------
# program capture: any func of pointwise ops over shifted windows
# ---------------------------------------------------------------------------

# the most nodes a captured program may hold (taps and constants included),
# and the most fx nodes a func's trace may have before the capture gives up
MAX_NODES = 64
_MAX_TRACE = 4 * MAX_NODES

_UNARY = ("neg", "abs", "sqrt", "rsqrt", "exp", "expm1", "log", "log1p", "tanh", "sigmoid", "sin", "cos",
          "floor", "ceil", "sign", "square", "reciprocal")
_ARITH = ("add", "sub", "mul", "div")
_COMPARE = ("gt", "ge", "lt", "le", "eq", "ne")

# fx call_function targets by the program op they compute
_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul", operator.truediv: "div",
    operator.neg: "neg", operator.abs: "abs", operator.pow: "pow",
    operator.gt: "gt", operator.ge: "ge", operator.lt: "lt", operator.le: "le", operator.eq: "eq",
    operator.ne: "ne",
    torch.add: "add", torch.sub: "sub", torch.subtract: "sub", torch.mul: "mul", torch.multiply: "mul",
    torch.div: "div", torch.divide: "div", torch.true_divide: "div", torch.negative: "neg",
    torch.absolute: "abs", torch.pow: "pow", torch.maximum: "maximum", torch.minimum: "minimum",
    torch.clamp: "clamp", torch.clip: "clamp", torch.where: "where", torch.greater: "gt",
    torch.greater_equal: "ge", torch.less: "lt", torch.less_equal: "le", torch.not_equal: "ne",
    **{getattr(torch, name): name for name in _UNARY + _COMPARE},
}
# fx call_method names (``b.tanh()``) by program op
_METHODS = {
    **{name: name for name in _UNARY + _ARITH + _COMPARE + ("pow", "maximum", "minimum", "clamp")},
    "subtract": "sub", "multiply": "mul", "divide": "div", "true_divide": "div", "negative": "neg",
    "absolute": "abs", "clip": "clamp", "where": "where",
}


class _Decline(Exception):
    """The func is not a program the kernel takes."""


class _Sym:
    """One fx value of the func: a float tensor (``"value"``) or a bool one
    (``"bool"``, a comparison), as a function of the offset it is read at.
    ``node(dy, dx)`` interns the program node computing it there: a roll
    only moves the offset, so the program holds taps and pointwise ops."""

    def __init__(self, kind, build):
        self.kind = kind
        self._build = build
        self._at = {}

    def node(self, dy, dx):
        got = self._at.get((dy, dx))
        if got is None:
            got = self._at[dy, dx] = self._build(dy, dx)
        return got


class _Program:
    """The nodes being captured, each once (equal nodes are shared)."""

    def __init__(self, depth):
        self.depth = depth
        self.nodes = []
        self._index = {}

    def intern(self, node):
        key = repr(node)  # repr keeps -0.0 apart from 0.0, and 2 from 2.0
        got = self._index.get(key)
        if got is None:
            if len(self.nodes) >= MAX_NODES:
                raise _Decline("too many nodes")
            got = self._index[key] = len(self.nodes)
            self.nodes.append(node)
        return got

    def tap(self, dy, dx):
        if abs(dy) > self.depth[0] or abs(dx) > self.depth[1]:
            raise _Decline("a tap outside the depth")
        return self.intern(("tap", dy, dx))


def _scalar_arg(v):
    """A Python scalar operand: int (exactly a float) or float, not bool."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _Decline(f"operand {v!r}")
    if isinstance(v, int) and abs(v) > 2**53:
        raise _Decline("an int scalar a float does not hold")
    return v


def _op_args(op, args, kwargs):
    """A call's operands in the program op's order, or _Decline: the
    arithmetic, unary, comparison and ``maximum``/``minimum`` ops take no
    keywords; ``clamp`` takes ``min``/``max``; ``where`` its three."""
    if op == "clamp":
        full = dict(zip(("input", "min", "max"), args), **kwargs)
        if set(full) - {"input", "min", "max"} or len(args) > 3:
            raise _Decline("clamp arguments")
        return (full.get("input"), full.get("min"), full.get("max"))
    if kwargs:
        raise _Decline(f"{op} with keywords")
    want = 1 if op in _UNARY else 3 if op == "where" else 2
    if len(args) != want:
        raise _Decline(f"{op} with {len(args)} operands")
    return tuple(args)


def _apply(prog, op, args):
    """The ``_Sym`` of ``op`` on ``args`` (``_Sym``s and Python scalars)."""
    if op == "clamp":
        x, lo, hi = args
        if not isinstance(x, _Sym) or x.kind != "value" or (lo is None and hi is None):
            raise _Decline("clamp of a non-value or with no bounds")
        bounds = [None if b is None else _scalar_arg(b) for b in (lo, hi)]

        def build_clamp(dy, dx):
            return prog.intern(("clamp", x.node(dy, dx),
                                *(None if b is None else prog.intern(("const", b)) for b in bounds)))

        return _Sym("value", build_clamp)
    if op == "where" and not (isinstance(args[0], _Sym) and any(isinstance(v, _Sym) for v in args[1:])):
        raise _Decline("where needs a comparison and a tensor branch")
    if op == "pow" and (not isinstance(args[0], _Sym) or isinstance(args[1], _Sym)):
        raise _Decline("pow needs a tensor base and a scalar exponent")
    if op in ("maximum", "minimum") and not all(isinstance(a, _Sym) for a in args):
        raise _Decline(f"{op} of a scalar")
    for i, a in enumerate(args):
        if not isinstance(a, _Sym):
            _scalar_arg(a)
        elif a.kind != ("bool" if op == "where" and i == 0 else "value"):
            raise _Decline(f"{op} of a {a.kind} operand")

    def build(dy, dx):
        return prog.intern((op, *(a.node(dy, dx) if isinstance(a, _Sym) else prog.intern(("const", a)) for a in args)))

    return _Sym("bool" if op in _COMPARE else "value", build)


def _roll_sym(sym, shifts, dims, depth):
    """``torch.roll(sym, shifts, dims)``: its value at an offset is ``sym``'s
    at the offset less the shift; each ``|shift|`` at most that axis's
    depth, as ``capture_taps`` takes them."""
    shifts, dims = _as_ints(shifts), _as_ints(dims)
    if not isinstance(sym, _Sym) or shifts is None or dims is None or len(shifts) != len(dims):
        raise _Decline("roll arguments")
    sy = sx = 0
    for s, d in zip(shifts, dims):
        if d not in (0, 1, -1, -2):
            raise _Decline("roll of an axis the block lacks")
        axis = d % 2
        if abs(s) > depth[axis]:
            raise _Decline("a roll past the depth")
        sy, sx = (sy + s, sx) if axis == 0 else (sy, sx + s)
    return _Sym(sym.kind, lambda dy, dx: sym.node(dy - sy, dx - sx))


def capture_program(func, depth):
    """The straight-line program ``func`` computes, or None.

    ``func`` is traced with ``torch.fx.symbolic_trace``; its rolls become
    offsets, so the program is a tuple of nodes, each a tuple
    ``(op, *operands)`` whose operands are indices of earlier nodes (the
    last node is the result):

    - ``("tap", dy, dx)``: the padded block at ``[i + dy, j + dx]``;
    - ``("const", v)``: a Python scalar;
    - ``add sub mul div``, ``pow`` (a scalar exponent), ``neg abs sqrt
      rsqrt exp expm1 log log1p tanh sigmoid sin cos floor ceil sign
      square reciprocal``, ``maximum minimum``, ``("clamp", x, lo, hi)``
      (``lo``/``hi`` a const or None), the comparisons ``gt ge lt le eq
      ne`` and ``("where", cond, a, b)``.

    Each op is accepted in its function form (``torch.tanh(b)``, ``b +
    c``) and its method form (``b.tanh()``).  Declined (None): anything
    else (reductions, ``stack``, ``cat``, indexing, tensor constants,
    casts, control flow on values), a roll past the depth or a tap the
    rolls carry past it, a comparison used as a number, and a program of
    more than ``MAX_NODES`` nodes.  Every tap lies within ``depth``, so
    ``program_plain`` on the padded block equals ``func`` on it.
    """
    import torch.fx

    try:
        gm = torch.fx.symbolic_trace(_one_input(func))
    except Exception:  # noqa: BLE001 - any func torch.fx cannot trace is no program
        return None
    if len(gm.graph.nodes) > _MAX_TRACE:
        return None
    prog = _Program(tuple(depth))
    env = {}
    try:
        for node in gm.graph.nodes:
            args = torch.fx.node.map_arg(node.args, lambda n: env[n])
            kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
            if node.op == "placeholder":
                env[node] = _Sym("value", prog.tap)
            elif node.op == "output":
                (result,) = args
                if not isinstance(result, _Sym) or result.kind != "value":
                    return None
                if result.node(0, 0) != len(prog.nodes) - 1:  # the result is built last
                    return None
            elif (node.op == "call_function" and node.target is torch.roll) or (
                node.op == "call_method" and node.target == "roll"
            ):
                full = dict(zip(("input", "shifts", "dims"), args), **kwargs)
                if set(full) - {"input", "shifts", "dims"}:
                    return None
                env[node] = _roll_sym(full.get("input"), full.get("shifts"), full.get("dims"), depth)
            else:
                table = _FUNCTIONS if node.op == "call_function" else _METHODS if node.op == "call_method" else {}
                try:
                    op = table.get(node.target)
                except TypeError:  # an unhashable target
                    op = None
                if op is None:
                    return None
                if node.op == "call_method" and op == "where":
                    # self.where(cond, other) is where(cond, self, other)
                    if kwargs or len(args) != 3:
                        return None
                    args = (args[1], args[0], args[2])
                env[node] = _apply(prog, op, _op_args(op, args, kwargs))
    except _Decline:
        return None
    return tuple(prog.nodes)


def is_program(spec) -> bool:
    """Whether a stencil spec is a program (its nodes start with an op
    name) rather than taps (which start with an int offset)."""
    return bool(spec) and isinstance(spec[0][0], str)


def stencil_spec(func, depth):
    """What the band-stencil kernels take for ``func`` within ``depth``:
    its taps where it is linear, else its program, else None."""
    COUNTS["captures"] += 1
    return call("capture", _capture, func, depth)


def _capture(func, depth):
    taps = capture_taps(func, depth)
    return taps if taps is not None else capture_program(func, depth)


def bind_kwargs(func, kwargs):
    """``func`` with its extra keyword arguments bound, as the JAX
    package's ``BandStencil._build`` binds them."""
    return functools.partial(func, **kwargs) if kwargs else func


# ---------------------------------------------------------------------------
# the program's plain version and its CUDA source
# ---------------------------------------------------------------------------

_PLAIN_OPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul, "div": operator.truediv,
    "neg": operator.neg, "pow": operator.pow, "gt": operator.gt, "ge": operator.ge, "lt": operator.lt,
    "le": operator.le, "eq": operator.eq, "ne": operator.ne, "maximum": torch.maximum,
    "minimum": torch.minimum, "where": torch.where,
    **{name: getattr(torch, name) for name in _UNARY if name != "neg"},
}


def program_plain(program, padded: torch.Tensor) -> torch.Tensor:
    """``program`` evaluated in torch over a whole padded block: each tap a
    roll of ``padded``, each op the torch call ``func`` made, with its
    operands in ``func``'s order.  A roll commutes with every pointwise op,
    so this is ``func(padded)`` bit for bit; the tests hold the capture to
    that.  Nothing on the main path calls it."""
    vals = []
    for op, *args in program:
        if op == "tap":
            dy, dx = args
            v = torch.roll(padded, (-dy, -dx), (0, 1)) if dy or dx else padded
        elif op == "const":
            (v,) = args
        elif op == "clamp":
            x, lo, hi = args
            v = torch.clamp(vals[x], min=None if lo is None else vals[lo], max=None if hi is None else vals[hi])
        else:
            v = _PLAIN_OPS[op](*(vals[a] for a in args))
        vals.append(v)
    return vals[-1]


_CUDA_TYPES = {torch.float16: "__half", torch.bfloat16: "__nv_bfloat16", torch.float32: "float",
               torch.float64: "double"}
# what a float and a double program calls: the _rn intrinsics for the
# IEEE operations (never contracted into an FMA), the CUDA math library
# (as torch's own CUDA kernels call it) for the rest
_INTRINSICS = {
    False: {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn", "div": "__fdiv_rn", "sqrt": "__fsqrt_rn",
            "abs": "fabsf", "rsqrt": "rsqrtf", "exp": "expf", "expm1": "expm1f", "log": "logf",
            "log1p": "log1pf", "tanh": "tanhf", "sin": "sinf", "cos": "cosf", "floor": "floorf",
            "ceil": "ceilf", "pow": "powf", "maximum": "fmaxf", "minimum": "fminf"},
    True: {"add": "__dadd_rn", "sub": "__dsub_rn", "mul": "__dmul_rn", "div": "__ddiv_rn", "sqrt": "__dsqrt_rn",
           "abs": "fabs", "rsqrt": "rsqrt", "exp": "exp", "expm1": "expm1", "log": "log", "log1p": "log1p",
           "tanh": "tanh", "sin": "sin", "cos": "cos", "floor": "floor", "ceil": "ceil", "pow": "pow",
           "maximum": "fmax", "minimum": "fmin"},
}
_COMPARE_SIGNS = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}


def _literal(v, double: bool) -> str:
    """A scalar that is code (a ``pow`` exponent) as the compute type's
    exact literal: rounded to float32 for a float program, bit patterns
    for the non-finite values."""
    if double:
        v = float(v)
        if math.isfinite(v):
            return f"({v.hex()})"
        return f"__longlong_as_double({struct.unpack('<q', struct.pack('<d', v))[0]}LL)"
    with np.errstate(over="ignore"):
        f = np.float32(v)
    if np.isfinite(f):
        return f"({float(f).hex()}f)"
    return f"__int_as_float({struct.unpack('<i', f.tobytes())[0]})"


def _inverse(v, double: bool) -> float:
    """``1 / v`` as torch's CUDA division by a scalar takes it (it multiplies
    by the inverse, computed in the compute type)."""
    with np.errstate(divide="ignore", over="ignore"):
        return float(np.float64(1.0) / np.float64(v)) if double else float(np.float32(1.0) / np.float32(v))


def _emit_node(node, a, inv, consts, f, one, double):
    """The C++ expression of one program node: ``a`` holds its operands'
    names (None for a missing clamp bound), ``inv(i)`` names the parameter
    slot of const node ``i``'s inverse."""
    op, *args = node
    if op in ("add", "sub", "mul"):
        return f"{f[op]}({a[0]}, {a[1]})"
    if op == "div":
        num, den = args
        if den in consts and num not in consts:  # x / c is x * (1 / c)
            return f"{f['mul']}({a[0]}, {inv(den)})"
        if num in consts and den not in consts:  # c / x is reciprocal(x) * c
            return f"{f['mul']}({f['div']}({one}, {a[1]}), {a[0]})"
        return f"{f['div']}({a[0]}, {a[1]})"
    if op == "neg":
        return f"(-{a[0]})"
    if op == "sigmoid":
        return f"{f['div']}({one}, {f['add']}({one}, {f['exp']}(-{a[0]})))"
    if op == "sign":
        return f"static_cast<A>(static_cast<int>(A(0) < {a[0]}) - static_cast<int>({a[0]} < A(0)))"
    if op == "square":
        return f"{f['mul']}({a[0]}, {a[0]})"
    if op == "reciprocal":
        return f"{f['div']}({one}, {a[0]})"
    if op == "pow":
        x, e = a[0], float(consts[args[1]])
        special = {0.0: one, 1.0: x, 0.5: f"{f['sqrt']}({x})", -0.5: f"{f['rsqrt']}({x})",
                   -1.0: f"{f['div']}({one}, {x})", 2.0: f"{f['mul']}({x}, {x})",
                   3.0: f"{f['mul']}({f['mul']}({x}, {x}), {x})",
                   -2.0: (f"__ddiv_rn(1.0, __dmul_rn({x}, {x}))" if double
                          else f"static_cast<float>(1.0 / static_cast<double>(__fmul_rn({x}, {x})))")}
        return special.get(e, f"{f['pow']}({x}, {_literal(e, double)})")
    if op == "clamp":
        x, lo, hi = a
        inner = x if lo is None else f"{f['maximum']}({x}, {lo})"
        inner = inner if hi is None else f"{f['minimum']}({inner}, {hi})"
        return f"({x} != {x}) ? {x} : {inner}"
    if op in _COMPARE_SIGNS:
        return f"({a[0]} {_COMPARE_SIGNS[op]} {a[1]})"
    if op == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    return f"{f[op]}({a[0]})"


_EXTREMA = {"maximum": "max", "minimum": "min"}


def _chains(program):
    """The ``maximum``/``minimum`` nodes that lie inside a chain of them:
    used once, as an operand of another such node.  Every other such node
    is a chain's root."""
    uses = [0] * len(program)
    user = {}
    for i, (op, *args) in enumerate(program):
        if op in ("tap", "const"):
            continue
        for j in args:
            if j is not None:
                uses[j] += 1
                user[j] = op
    return {i for i, node in enumerate(program)
            if node[0] in _EXTREMA and uses[i] == 1 and user[i] in _EXTREMA}


def _emit(program, dtype):
    """(the C++ functor of ``program``, its scalar slots): each slot a
    ``(const node, inverse)`` pair, in the order of the parameter block.
    The text depends on the program's ops, its taps and ``pow``'s
    exponents, never on another scalar's value.  A chain of ``maximum``
    and ``minimum`` nodes is one fast pass (``max_any_nan``: the canonical
    NaN if any operand is NaN), then, only where the chain's result is NaN
    or a zero, the chain again in the plain order (``max_first_nan``, as
    torch's CUDA kernels: the first NaN operand's own bits, and the sign of
    a zero as that order gives it)."""
    double = dtype == torch.float64
    f = _INTRINSICS[double]
    one = "1.0" if double else "1.0f"
    consts = {i: node[1] for i, node in enumerate(program) if node[0] == "const"}
    inside = _chains(program)
    slots = {}

    def slot(i, inverse=False):
        k = slots.setdefault((i, inverse), len(slots))
        return f"c[{k}]"

    def chain(root):
        """The chain's nodes below ``root`` and ``root``, in program order."""
        nodes, todo = {root}, [root]
        while todo:
            for j in program[todo.pop()][1:]:
                if j in inside and j not in nodes:
                    nodes.add(j)
                    todo.append(j)
        return sorted(nodes)

    lines = []
    for i, node in enumerate(program):
        op = node[0]
        if op == "const":
            continue
        if op == "tap":
            dy, dx = node[1:]
            lines.append(f"    const A v{i} = w.template at<{dy}, {dx}>();")
            continue
        if op in _EXTREMA:
            fast = f"{_EXTREMA[op]}_any_nan(v{node[1]}, v{node[2]})"
            if i in inside:
                lines.append(f"    const A v{i} = {fast};")
                continue
            lines.append(f"    A v{i} = {fast};")
            lines.append(f"    if (nan_or_zero(v{i})) {{")
            for k in chain(i):
                a = [f"s{j}" if j in inside else f"v{j}" for j in program[k][1:]]
                lines.append(f"      const A s{k} = {_EXTREMA[program[k][0]]}_first_nan({a[0]}, {a[1]});")
            lines.append(f"      v{i} = s{i};")
            lines.append("    }")
            continue
        read = node[1:]
        if op == "pow" or (op == "div" and node[2] in consts and node[1] not in consts):
            read = node[1:2]  # an exponent is code; a divisor is read as its inverse
        a = [None if j is None else slot(j) if j in consts and j in read else f"v{j}" for j in node[1:]]
        expr = _emit_node(node, a, lambda j: slot(j, True), consts, f, one, double)
        kind = "bool" if op in _COMPARE_SIGNS else "A"
        lines.append(f"    const {kind} v{i} = {expr};")
    text = "\n".join([
        "struct Program {",
        f"  static constexpr int kSlots = {len(slots)};",
        "  template <typename W>",
        "  __device__ __forceinline__ static Acc<T>::type eval(const W& w, const Acc<T>::type* __restrict__ c) {",
        "    using A = Acc<T>::type;",
        *lines,
        f"    return v{len(program) - 1};",
        "  }",
        "};",
    ])
    return text, tuple(slots)


def emit_program(program, dtype) -> str:
    """``program`` as the C++ functor ``Program``: ``eval(w, c)`` computes
    one output in ``Acc<T>`` from its taps ``w`` (a tap ``(dy, dx)`` is
    ``w.template at<dy, dx>()``: a register of the thread's window, or the
    staged tile, csrc/band_program.cuh) and the scalars ``c``
    (``program_scalars``).  Every node but a scalar is a named value.  The
    source of one program is always the same text, whatever its scalars'
    values (``pow``'s exponents aside)."""
    return _emit(program, dtype)[0]


def program_scalars(program, slots, dtype) -> bytes:
    """The parameter block's scalars of ``program``: each slot's const in
    the compute type (float32, as torch's CUDA kernels convert a scalar
    operand, for every type but float64), or its inverse where the
    program divides by it."""
    double = dtype == torch.float64
    vals = [_inverse(program[i][1], double) if inverse else float(program[i][1]) for i, inverse in slots]
    if double:
        return struct.pack(f"<{len(vals)}d", *vals)
    with np.errstate(over="ignore"):
        return np.array(vals, dtype=np.float64).astype(np.float32).tobytes()


def program_source(program, depth, dtype: torch.dtype) -> str:
    """The whole generated CUDA source of ``program`` over ``dtype`` blocks
    at ``depth`` (fixed at compile time): ``csrc/band_program.cuh``, the
    functor of ``emit_program`` and the C entry point
    ``band_program_launch``.  Programs that differ only in their scalars'
    values (``pow``'s exponents aside) have one source."""
    d0, d1 = depth
    exponents = {node[2] for node in program if node[0] == "pow"}
    listing = "\n".join(
        f"//   {i}: {' '.join(map(repr, node)) if node[0] != 'const' or i in exponents else 'const (a parameter)'}"
        for i, node in enumerate(program))
    return f"""// Generated by dask_array_tpu_torch/kernels/stencil.py::program_source from
// the program below (kernels/stencil.py::capture_program); not edited by hand.
{listing}
#include "band_program.cuh"

namespace {{

using T = {_CUDA_TYPES[dtype]};
constexpr int D0 = {int(d0)}, D1 = {int(d1)};

{emit_program(program, dtype)}

}}  // namespace

extern "C" {{

int band_program_launch(const void* x, void* out, long long M, long long N, int d0, int d1, int bd0, int bd1,
                        double fill0, double fill1, int vec, const void* scalars, int nscalars, void* stream) {{
  return launch_program<T, D0, D1, Program>(x, out, M, N, d0, d1, bd0, bd1, fill0, fill1, vec, scalars, nscalars,
                                            stream);
}}

const char* band_program_error_string(int code) {{ return cudaGetErrorString(static_cast<cudaError_t>(code)); }}

}}  // extern "C"
"""


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def stencil_taps(ndim, dtype, depth, boundary, func, kwargs):
    """The stencil spec the band-stencil kernels take for ``func`` over
    blocks of ``ndim`` axes and ``dtype``: its taps or its program
    (``stencil_spec``), or None.

    ``depth`` holds one ``(lo, hi)`` pair and ``boundary`` one mode per
    axis.  Eligible: config ``stencil-kernel`` not "off"; 2-D float;
    symmetric depth at most 8 per axis; each boundary with depth one of
    reflect, nearest, periodic or a scalar constant; and ``func``, with
    ``kwargs`` bound (``bind_kwargs``), is a stencil or a program.  The one
    gate of every route to the kernels (``map_overlap``'s and the shard
    lane's); each route runs the bound func.
    """
    from dask_array_tpu_torch import config

    if config.get("stencil-kernel", "auto") in ("off", False, None):
        return None
    if ndim != 2 or np.dtype(dtype).name not in _KERNEL_DTYPES:
        return None
    dep = []
    for (lo, hi), b in zip(depth, boundary):
        if lo != hi or lo > MAX_DEPTH:
            return None
        if lo and b not in _BOUNDARY_CODES and not _is_scalar(b):
            return None
        dep.append(lo)
    return stencil_spec(bind_kwargs(func, kwargs), tuple(dep))


# map_blocks keywords of map_overlap, which the func never sees
_BLOCK_KEYWORDS = ("chunks", "new_axis", "drop_axis", "meta")


def use_band_stencil(arrays, depths, bounds, trim, func, kwargs):
    """The stencil spec of an eligible map_overlap, or None.

    Eligible: one array of known, non-empty shape with ``trim=True``, no
    map_blocks keyword that reshapes the blocks, that ``stencil_taps``
    takes.  Decided when the graph is built, whatever the device.
    """
    if not trim or len(arrays) != 1 or any(k in kwargs for k in _BLOCK_KEYWORDS):
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
    """``trim(func(pad(x)))`` in torch: the kernels' reference.  bfloat16
    and float16 compute in float32 and round once, as the kernels do (a
    constant fill rounded to the 2-byte type first, as the kernels read
    it)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        boundary = tuple(float(torch.tensor(b, dtype=x.dtype)) if _is_scalar(b) else b for b in boundary)
        return band_stencil_plain(x.float(), func, depth, boundary).to(x.dtype)
    d0, d1 = depth
    p = pad_axis(x, 0, d0, d0, boundary[0])
    p = pad_axis(p, 1, d1, d1, boundary[1])
    out = func(p)
    return out[d0 : d0 + x.shape[0], d1 : d1 + x.shape[1]]


def band_stencil_call(x: torch.Tensor, func, depth, boundary, spec) -> torch.Tensor:
    """The stencil of one 2-D tensor: the plain version for a CPU tensor;
    for a CUDA tensor the kernel of ``spec``, the program's
    (``band_program_cuda``) or the taps' (``band_stencil_cuda``)."""
    if x.device.type == "cpu":
        return band_stencil_plain(x, func, depth, boundary)
    if is_program(spec):
        return band_program_cuda(x, spec, depth, boundary)
    return band_stencil_cuda(x, spec, depth, boundary)


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
    VARIANT_LAUNCHES["window" if kernel_variant(depth) == WINDOW_11 else "taps"] += 1
    return out


def band_program_cuda(x: torch.Tensor, program, depth, boundary) -> torch.Tensor:
    """Launch the kernel generated from ``program`` on a 2-D CUDA tensor.

    The source (``program_source``) is built with nvcc at its first use
    and the library kept (``_program_kernel``, ``kernels/_build.py``); the
    program's scalars go by value (``program_scalars``);
    a failed build raises, as does anything the kernel does not take: a
    non-CUDA or non-contiguous tensor, a dtype other than
    float16/bfloat16/32/64, a depth above 8, a tap outside the depth, or
    an unknown boundary.
    """
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"band_program_cuda needs a CUDA tensor, got one on {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("band_program_cuda needs a contiguous 2-D tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"band_program_cuda does not take {x.dtype}")
    d0, d1 = (int(d) for d in depth)
    if not (0 <= d0 <= MAX_DEPTH and 0 <= d1 <= MAX_DEPTH):
        raise ValueError(f"band_program_cuda takes depths 0..{MAX_DEPTH}, got {depth}")
    if any(node[0] == "tap" and (abs(node[1]) > d0 or abs(node[2]) > d1) for node in program):
        raise ValueError(f"band_program_cuda: the program's taps do not fit depth {depth}")
    M, N = x.shape
    if M == 0 or N == 0:
        raise ValueError("band_program_cuda needs a non-empty tensor")
    bd0, fill0 = _boundary_arg(boundary[0], d0, x.dtype)
    bd1, fill1 = _boundary_arg(boundary[1], d1, x.dtype)
    if not isinstance(program, tuple):
        program = tuple(map(tuple, program))
    launch, slots = _program_kernel(program, (d0, d1), x.dtype)
    out = torch.empty_like(x)
    launch(x.get_device(), x.data_ptr(), out.data_ptr(), M, N, d0, d1, bd0, bd1, fill0, fill1,
           int(vector_ok(x, out)), program_scalars(program, slots, x.dtype), len(slots))
    LAUNCHES += 1
    VARIANT_LAUNCHES["program"] += 1
    return out


def program_build_item(program, depth, dtype):
    """``(name, source)`` of a program's library, for ``_build.build_all``
    (several programs built in parallel before their first launch)."""
    return "band_program", program_source(program, tuple(depth), dtype)


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


@functools.lru_cache(maxsize=64)
def _program_kernel(program, depth, dtype):
    """(the bound entry point of ``program``'s library at ``depth`` over
    ``dtype``, its scalar slots): the source generated, its library built
    if missing (``kernels/_build.py``, keyed by the source, so programs
    that differ only in their scalars share one) and loaded.  The 64 most
    recently used stay bound.  Programs equal as tuples (a scalar 0.0 and
    -0.0, or 2 and 2.0) share an entry: the slots name nodes, and each
    launch reads the values from its own program."""
    from dask_array_tpu_torch.kernels._build import build_library, load

    _, slots = _emit(program, dtype)
    path, _ = build_library("band_program", program_source(program, depth, dtype))
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    launch = Launcher(load(path), "band_program_launch",
                      [p, p, ll, ll, i, i, i, i, d, d, i, ctypes.c_char_p, i], "band-stencil program")
    return launch, slots
