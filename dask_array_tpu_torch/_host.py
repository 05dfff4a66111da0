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

Blocks with no device form ride this lane too, decided by the block's type
and dtype, never by the device: masked arrays (``np.ma``), blocks of a
registered duck type (``_dispatch.register_chunk_type``) and records,
strings and objects (``_chunks.host_only_dtype``).  They are never
uploaded; each node that meets one runs numpy's counterpart of its torch
code (``host_kernel``: by the numpy function the port's function stands
for), which keeps the mask (and numpy.ma's domain masking) or the duck
type.  Where no mask-safe counterpart exists the node raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dask_array_tpu_torch._chunks import array_of, host_only_dtype, numpy_dtype, tensor_of, torch_dtype
from dask_array_tpu_torch._dispatch import is_duck_chunk

HOST_CALLS = 0


def is_host_block(x) -> bool:
    """A block with no device form: masked, of a registered duck type, or
    of a host-only dtype (records, strings, objects)."""
    if isinstance(x, torch.Tensor):
        return False
    if isinstance(x, np.ma.MaskedArray) or is_duck_chunk(x):
        return True
    dt = getattr(x, "dtype", None)
    return isinstance(dt, np.dtype) and host_only_dtype(dt)


def any_host_block(args) -> bool:
    return any(is_host_block(v) for v in _leaves(args))


def host_array(v):
    """A tensor operand of a host-lane call as numpy (blocks and numbers
    pass as they are)."""
    return array_of(v.detach().cpu()) if isinstance(v, torch.Tensor) else v


# torch functions of the port's own use whose numpy counterpart is not
# named alike (``_expr._TORCH_TO_NUMPY_NAME`` holds the ufunc names)
_NUMPY_OF = {torch.clamp_min: np.maximum, torch.clamp_max: np.minimum, torch.nan_to_num: np.nan_to_num,
             torch.real: np.real, torch.conj: np.conjugate}


def host_kernel(func, masked: bool):
    """numpy's counterpart of a node's function, for host blocks.

    The numpy ufunc a torch or port function stands for (numpy.ma's
    ufuncs mask domain errors: ``sqrt`` of a negative comes back masked);
    the numpy function a port function declares (``numpy_function``; its
    ``np.ma`` form for masked blocks); a port function written for host
    blocks (``host_safe``) or a user's function as it is.  None where there
    is no such counterpart: the caller raises rather than drop a mask."""
    from dask_array_tpu_torch._expr import _numpy_equivalent

    np_fn = _numpy_equivalent(func) or _NUMPY_OF.get(func)
    if np_fn is not None:
        return np_fn
    declared = getattr(func, "numpy_function", None)
    if declared is not None:
        return getattr(np.ma, declared.__name__, declared) if masked else declared
    if getattr(func, "host_safe", False) or fixed_lane(func) is not False:
        return func
    return None


def concatenate(parts, axis=0):
    """Host blocks (and tensors beside them) concatenated as numpy does: a
    duck block dispatches ``np.concatenate`` to its type (NEP-18), else a
    masked one takes ``np.ma.concatenate`` (``np.concatenate`` drops the
    mask)."""
    parts = [host_array(p) for p in parts]
    if any(is_duck_chunk(p) for p in parts):
        return np.concatenate(parts, axis=axis)
    if any(isinstance(p, np.ma.MaskedArray) for p in parts):
        return np.ma.concatenate(parts, axis=axis)
    return np.concatenate(parts, axis=axis)


def call_on_host(func, args, kwargs):
    """``func`` (a node's function) on host blocks, with every tensor
    operand copied to numpy.  Raises for a function with no numpy
    counterpart."""
    masked = any(isinstance(v, np.ma.MaskedArray) for v in _leaves(args))
    fn = host_kernel(func, masked)
    if fn is None:
        what = "mask-preserving host kernel; call x.filled(...) first" if masked else "numpy host kernel"
        raise NotImplementedError(f"{getattr(func, '__name__', func)!r} has no {what}")
    with np.errstate(all="ignore"):
        out = fn(*tree_map(host_array, args), **tree_map(host_array, kwargs))
    # a ufunc of several outputs stands behind one node an output
    return out[func.numpy_output] if isinstance(out, tuple) and hasattr(func, "numpy_output") else out


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
        return array_of(v.detach().cpu())
    if isinstance(v, torch.dtype):
        return numpy_dtype(v)
    if isinstance(v, functools.partial):
        return functools.partial(_to_host(v.func), *tree_map(_to_host, v.args), **tree_map(_to_host, v.keywords))
    return v


def _upload(device):
    def up(v):
        if isinstance(v, (bool, int, float, complex)):
            v = np.asarray(v)
        if isinstance(v, (np.ndarray, np.generic)) and not is_host_block(v):
            try:
                torch_dtype(v.dtype)
            except TypeError:
                return v  # other host-only payloads stay on the host
            arr = np.require(np.asarray(v), requirements=("C", "W"))
            return tensor_of(arr).to(device)
        return v

    return up


def settle(out, device):
    """A host-lane result where it belongs: host blocks stay on the host,
    numeric numpy arrays (a masked array's plain sum, say) go to
    ``device`` as tensors."""
    return tree_map(_upload(device), out)


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
    if any_host_block(args):
        # blocks with no device form: numpy's counterpart on them, its
        # result kept on the host where it has no device form either
        return _hosted(call_on_host(func, args, kwargs), device)
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
