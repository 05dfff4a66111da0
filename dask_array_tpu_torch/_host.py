"""The host lane: block functions written in numpy.

A user's block function (``map_blocks``, ``blockwise``, ``elemwise``,
``apply_gufunc``, the chunk/combine/aggregate of ``reduction()``, the
func/binop of ``cumreduction``) may be torch code or host code.  Each node
decides once per function which it is, by a test that does not depend on
the device:

- a function of numpy, or a numpy ufunc or one of its methods, is host
  code; a function of torch or of this package is torch code; these are
  known from the function itself, at construction;
- any other function is tried at the node's first block with its tensors
  wrapped so that they refuse a host copy (``__array__`` raises, on the
  CPU as on the card).  A function that computes tensors from them is
  torch code; one that returns numpy is host code (its result is kept).
  One that refuses them but computes on the block's numpy copy is host
  code.  One that refuses both runs as it is (a torch function that
  reaches numpy on purpose, or one that raises as it always did).

A host call copies its blocks to numpy (held dtypes as numpy's own, so a
uint64 block arrives as uint64), passes numpy dtypes for torch ones,
calls the function, and uploads each numeric result to the node's device;
other results (object payloads, dicts of them) stay on the host.
``HOST_CALLS`` counts host calls.  The lane is shown in ``pprint()``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dask_array_tpu_torch._chunks import numpy_dtype, torch_dtype

HOST_CALLS = 0

_PACKAGE = __name__.split(".")[0]


class _NoHostCopy(torch.Tensor):
    """A tensor whose host copy through ``__array__`` is refused: numpy
    cannot read it, as it cannot read a tensor on the card."""

    def __array__(self, *args, **kwargs):
        raise TypeError("a block function's probe tensor refuses a host copy")


def _port_owned(func) -> bool:
    return (getattr(func, "__module__", None) or "").split(".")[0] == _PACKAGE


def user_function(func):
    """The callable a user wrote, inside the port's own partials (which
    carry it as their first argument) and plain partials."""
    while isinstance(func, functools.partial):
        if _port_owned(func.func) and func.args and callable(func.args[0]):
            func = func.args[0]
        else:
            func = func.func
    return func


def fixed_lane(func):
    """True for numpy's functions, False for torch's and the port's, None
    where the function itself does not say (decided at the first block)."""
    base = user_function(func)
    if isinstance(base, np.ufunc) or isinstance(getattr(base, "__self__", None), np.ufunc):
        return True
    owner = getattr(base, "__module__", None) or ""
    objclass = getattr(base, "__objclass__", None)
    if objclass is not None:
        owner = getattr(objclass, "__module__", "") or owner
    root = owner.split(".")[0]
    if root in ("numpy", "scipy"):
        return True
    if root in ("torch", _PACKAGE):
        return False
    return None


def tree_map(fn, x):
    """``fn`` on every leaf of nested lists, tuples and dicts."""
    if isinstance(x, list):
        return [tree_map(fn, v) for v in x]
    if isinstance(x, tuple):
        return tuple(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    return [x]


def _is_host_value(v):
    return isinstance(v, (np.ndarray, np.generic))


def _probe(v):
    return v.as_subclass(_NoHostCopy) if isinstance(v, torch.Tensor) else v


def _plain(v):
    return v.as_subclass(torch.Tensor) if isinstance(v, _NoHostCopy) else v


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, torch.dtype):
        return numpy_dtype(v)
    if isinstance(v, functools.partial):
        return functools.partial(_to_host(v.func), *tree_map(_to_host, v.args), **tree_map(_to_host, v.keywords))
    return v


def _upload(device):
    def up(v):
        if isinstance(v, (bool, int, float, complex)):
            v = np.asarray(v)
        if isinstance(v, (np.ndarray, np.generic)) and v.dtype.names is None:
            try:
                torch_dtype(v.dtype)
            except TypeError:
                return v  # object and other host-only payloads stay on the host
            arr = np.require(np.asarray(v), requirements=("C", "W"))
            return torch.from_numpy(arr).to(device)
        return v

    return up


def _hosted(out, device):
    """A host call's result, counted, its numeric arrays on ``device``."""
    global HOST_CALLS
    HOST_CALLS += 1
    return tree_map(_upload(device), out)


def host_call(func, args, kwargs, device):
    """``func`` on the numpy copies of ``args``; numeric results on ``device``."""
    return _hosted(_to_host(func)(*tree_map(_to_host, args), **tree_map(_to_host, kwargs)), device)


def lane_of(node, key, func):
    """True (host), False (torch) or None (not decided yet)."""
    lanes = node.__dict__.get("_lanes") or {}
    if key in lanes:
        return lanes[key]
    return fixed_lane(func)


def call(node, key, func, args, kwargs, device, torch_args=None):
    """``func(*args, **kwargs)`` for one block of ``node``, in the lane
    decided for ``func`` (under ``key``).  ``args`` hold held blocks (what
    a host call reads); ``torch_args``, where given, are the same in the
    form a torch function takes (``_chunks.computable``)."""
    targs = args if torch_args is None else torch_args
    host = lane_of(node, key, func)
    if host is True:
        return host_call(func, args, kwargs, device)
    if host is False:
        return func(*targs, **kwargs)
    # a user's function may raise anything on a lane it is not written for:
    # each try below is one probe of the first block, never of the others
    lanes = node.__dict__.setdefault("_lanes", {})
    try:
        out = tree_map(_plain, func(*tree_map(_probe, targs), **tree_map(_probe, kwargs)))
    except Exception:
        pass
    else:
        # numpy back for tensors in is host code that read no block data
        lanes[key] = any(_is_host_value(v) for v in _leaves(out))
        return _hosted(out, device) if lanes[key] else out
    try:
        out = host_call(func, args, kwargs, device)
        lanes[key] = True
        return out
    except Exception:
        pass
    out = func(*targs, **kwargs)  # as it always ran: raises where it did
    lanes[key] = False
    return out


def lane_note(node, functions) -> str:
    """`` [host lane: func]`` for ``pprint``, naming the functions of
    ``node`` that run on the host ("?" where the first block decides)."""
    host = []
    for key, func in functions:
        if func is None:
            continue
        lane = lane_of(node, key, func)
        if lane is None:
            host.append(f"{key}?")
        elif lane:
            host.append(key)
    return f" [host lane: {', '.join(host)}]" if host else ""
