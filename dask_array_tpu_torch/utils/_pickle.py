"""Pickle support for expression trees.

Port of ``dask_array_tpu/utils/_pickle.py``.  An expression pickles as its
class and operands (``ArrayExpr.__reduce__``).  Many operands are torch
callables: builtins such as ``torch.add`` whose ``__qualname__`` names no
importable path (``_VariableFunctionsClass.add``), and the port's own
ufunc functions, renamed after numpy's ufunc (``floor_divide``) while that
name in ``ops/ufuncs`` is the lazy ``ufunc`` wrapper.  Stock pickle refuses
both.  This module encodes such callables *by attribute path*,
identity-matched against the live namespaces of ``torch``,
``torch.special``, ``torch.linalg``, ``torch.fft``,
``torch.nn.functional`` and the port's ``ops/ufuncs`` (whose functions
``floor_divide_``, ``clip_``, ... carry numpy's names), and restores them
with ``getattr`` on load.

Encoding is recursive over tuples, lists, dicts, frozensets and
``functools.partial``, so callables buried in keyword tuples are found.
Anything not in the registry is passed to stock pickle untouched (a
lambda is still refused, as dask without cloudpickle refuses it).
"""

from __future__ import annotations

import functools
import importlib

_REGISTRY = None  # id(obj) -> (obj, module path, attribute); the strong
# reference keeps the id stable: a module whose __getattr__ makes a new
# object per access could otherwise recycle an id onto another callable.

_TORCH_MODULES = ("torch", "torch.special", "torch.linalg", "torch.fft", "torch.nn.functional")
_UFUNCS = "dask_array_tpu_torch.ops.ufuncs"


def _registry():
    global _REGISTRY
    if _REGISTRY is None:
        reg = {}
        for modname in _TORCH_MODULES:
            mod = importlib.import_module(modname)
            for attr in dir(mod):
                if attr.startswith("_"):
                    continue
                try:
                    obj = getattr(mod, attr)
                except Exception:
                    continue
                if callable(obj) and not isinstance(obj, type):
                    # the first (shortest) path wins for aliased objects
                    reg.setdefault(id(obj), (obj, modname, attr))
        # the functions an Elemwise node of the port's ufunc table holds,
        # by their attribute in ops/ufuncs (their names are numpy's)
        for attr, obj in vars(importlib.import_module(_UFUNCS)).items():
            if callable(obj) and not isinstance(obj, type) and not attr.startswith("__"):
                reg.setdefault(id(obj), (obj, _UFUNCS, attr))
        _REGISTRY = reg
    return _REGISTRY


class _ByName:
    """Pickle payload: a callable identified by its attribute path."""

    __slots__ = ("mod", "attr")

    def __init__(self, mod, attr):
        self.mod = mod
        self.attr = attr

    def __reduce__(self):
        return (_ByName, (self.mod, self.attr))

    def resolve(self):
        return getattr(importlib.import_module(self.mod), self.attr)

    def __call__(self, *args, **kwargs):
        # callable, so functools.partial accepts an encoded func
        return self.resolve()(*args, **kwargs)


def encode_operand(op):
    """Swap registry callables for by-name markers, recursively."""
    if callable(op) and not isinstance(op, type):
        hit = _registry().get(id(op))
        if hit is not None and hit[0] is op:
            return _ByName(*hit[1:])
        if isinstance(op, functools.partial):
            return functools.partial(
                encode_operand(op.func),
                *[encode_operand(a) for a in op.args],
                **{k: encode_operand(v) for k, v in op.keywords.items()},
            )
        return op
    if type(op) is tuple:
        return tuple(encode_operand(o) for o in op)
    if type(op) is list:
        return [encode_operand(o) for o in op]
    if type(op) is dict:
        return {k: encode_operand(v) for k, v in op.items()}
    if type(op) is frozenset:
        return frozenset(encode_operand(o) for o in op)
    return op


def decode_operand(op):
    if isinstance(op, _ByName):
        return op.resolve()
    if isinstance(op, functools.partial):
        return functools.partial(
            decode_operand(op.func),
            *[decode_operand(a) for a in op.args],
            **{k: decode_operand(v) for k, v in op.keywords.items()},
        )
    if type(op) is tuple:
        return tuple(decode_operand(o) for o in op)
    if type(op) is list:
        return [decode_operand(o) for o in op]
    if type(op) is dict:
        return {k: decode_operand(v) for k, v in op.items()}
    if type(op) is frozenset:
        return frozenset(decode_operand(o) for o in op)
    return op


def unpickle_expr(cls, operands):
    """Rebuild an expression node from decoded operands.

    Goes through ``cls(*operands)`` so the singleton registry deduplicates
    the node again (and pickle's own memo keeps a shared subtree shared)."""
    return cls(*[decode_operand(o) for o in operands])
