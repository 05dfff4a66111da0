"""Deterministic content-addressed tokenization.

The expression system is content-addressed: every ``ArrayExpr`` node's
identity (its ``_name``) is a stable hash of its type and operands, so
structurally identical expressions are the *same* singleton object and
optimizer tests can compare rewritten trees by name equality.

Port of ``dask_array_tpu/utils/_tokenize.py``.  torch functions tokenize
by their public attribute path (``torch.add`` -> ``fn:torch...add``), CPU
tensors up to 64 KiB by content, and larger or device tensors by the
identity of their storage (hashing them would copy them to the host).
"""

from __future__ import annotations

import functools
import hashlib
import threading
import uuid
import weakref
from numbers import Number

import numpy as np
import torch

from dask_array_tpu_torch._chunks import array_of, dtype_key

# Arrays at or below this many bytes are tokenized by content; larger ones by
# a sampled digest (numpy) or a per-object identity uuid (tensors).
_CONTENT_HASH_LIMIT = 65536

_object_tokens: "weakref.WeakValueDictionary[int, object]" = weakref.WeakValueDictionary()
_token_registry: dict[int, str] = {}
_registry_lock = threading.Lock()

# bumped every time an identity token is consulted: the plan flattener
# (``_planrec.py``) reads it to tell a plan that is stable in this process
# only from one that is stable across processes
_identity_uses = 0


def identity_epoch() -> int:
    return _identity_uses


def _identity_token(obj) -> str:
    """Stable-per-object random token (objects too big/opaque to hash)."""
    global _identity_uses
    _identity_uses += 1
    key = id(obj)
    with _registry_lock:
        existing = _object_tokens.get(key)
        if existing is obj:
            return _token_registry[key]
        tok = uuid.uuid4().hex
        try:
            _object_tokens[key] = obj
            _token_registry[key] = tok
            weakref.finalize(obj, _token_registry.pop, key, None)
        except TypeError:
            pass  # not weakref-able: a one-shot token
        return tok


# Two coprime residue-class widths for the positional full-coverage digest
# of large numpy leaves (see dask_array_tpu/utils/_tokenize.py).
_CLASS_PRIMES = (99991, 99989)


def _positional_class_digest(obj, h) -> None:
    """Position-salted full-coverage digest of a contiguous array: every
    byte is read, and a permutation or compensating edit confined to a span
    shorter than K1*K2 words changes at least one class sum."""
    b = np.ascontiguousarray(obj).view(np.uint8).reshape(-1)
    n8 = (b.size // 8) * 8
    words = b[:n8].view(np.uint64)
    with np.errstate(over="ignore"):
        for K in _CLASS_PRIMES:
            n = (words.size // K) * K
            if n:
                h.update(words[:n].reshape(-1, K).sum(axis=0, dtype=np.uint64).tobytes())
            h.update(words[n:].tobytes())
    h.update(b[n8:].tobytes())


def _normalize_ndarray(obj: np.ndarray, out: list) -> None:
    if obj.nbytes <= _CONTENT_HASH_LIMIT:
        arr = np.ascontiguousarray(obj)
        out.append(f"nd:{dtype_key(arr.dtype)}:{arr.shape}:")
        out.append(hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest())
        return
    if obj.dtype.hasobject:
        owner = obj.base if obj.base is not None else obj
        out.append(f"ndbig:{dtype_key(obj.dtype)}:{obj.shape}:{_identity_token(owner)}")
        return
    # process-stable digest: head + tail + strided samples, plus the
    # position-salted full-coverage class sums
    h = hashlib.blake2b(digest_size=16)
    flat = np.ascontiguousarray(obj).reshape(-1)
    step = max(1, flat.shape[0] // 4096)
    h.update(flat[:8192].tobytes())
    h.update(flat[-8192:].tobytes())
    h.update(np.ascontiguousarray(flat[::step][:8192]).tobytes())
    _positional_class_digest(flat, h)
    out.append(f"nds:{dtype_key(obj.dtype)}:{obj.shape}:{h.hexdigest()}")


def _normalize_tensor(obj: torch.Tensor, out: list) -> None:
    nbytes = obj.numel() * obj.element_size()
    if obj.device.type == "cpu" and nbytes <= _CONTENT_HASH_LIMIT and not obj.requires_grad:
        arr = array_of(obj.detach().contiguous())
        out.append(f"tensor:{obj.dtype}:{tuple(obj.shape)}:")
        out.append(hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest())
        return
    # identity of the storage plus this view's window: sibling views of one
    # storage must not collide, and device memory is never pulled to host
    storage = obj.untyped_storage()
    out.append(
        f"tensorbig:{obj.dtype}:{obj.device}:{tuple(obj.shape)}:{obj.stride()}:"
        f"{obj.storage_offset()}:{storage.data_ptr()}:{_identity_token(obj)}"
    )


def _normalize(obj, out: list) -> None:
    """Append a canonical byte-representation of ``obj`` to ``out``."""
    typ = type(obj)
    if obj is None or typ in (bool, int, str, bytes):
        out.append(repr(obj))
    elif typ is float:
        out.append(f"f:{obj!r}")
    elif typ is complex:
        out.append(f"c:{obj!r}")
    elif isinstance(obj, np.dtype):
        out.append(f"dtype:{dtype_key(obj)}")
    elif isinstance(obj, torch.dtype):
        out.append(f"tdtype:{obj}")
    elif isinstance(obj, torch.device):
        out.append(f"tdevice:{obj}")
    elif isinstance(obj, np.generic):
        out.append(f"npscalar:{dtype_key(obj.dtype)}:{obj.item()!r}")
    elif typ in (tuple, list):
        out.append("(" if typ is tuple else "[")
        for item in obj:
            _normalize(item, out)
        out.append(")" if typ is tuple else "]")
    elif typ is dict:
        out.append("{")
        try:
            items = sorted(obj.items())
        except TypeError:
            items = sorted(obj.items(), key=lambda kv: str(kv[0]))
        for k, v in items:
            _normalize(k, out)
            _normalize(v, out)
        out.append("}")
    elif typ in (set, frozenset):
        out.append("s{")
        for item in sorted(map(_token_of_single, obj)):
            out.append(item)
        out.append("}")
    elif isinstance(obj, slice):
        out.append(f"slice:{obj.start!r}:{obj.stop!r}:{obj.step!r}")
    elif isinstance(obj, np.ma.MaskedArray):
        # the mask is part of the identity; the bytes under it (any memory)
        # are not: filled first
        out.append("ma:")
        _normalize_ndarray(np.ascontiguousarray(obj.filled()), out)
        _normalize_ndarray(np.ascontiguousarray(np.ma.getmaskarray(obj)), out)
        _normalize(obj.fill_value, out)
    elif isinstance(obj, np.ndarray):
        _normalize_ndarray(obj, out)
    elif isinstance(obj, torch.Tensor):
        _normalize_tensor(obj, out)
    elif hasattr(obj, "_name") and hasattr(obj, "operands"):
        # an expression node: content-addressed by its deterministic token
        out.append(f"expr:{type(obj).__qualname__}:{obj.deterministic_token}")
    elif callable(obj):
        out.append(_normalize_callable(obj))
    elif isinstance(obj, Number):
        out.append(f"num:{typ.__name__}:{obj!r}")
    else:
        out.append(f"idobj:{_identity_token(obj)}")


_code_digests: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _code_digest(code) -> bytes:
    """Digest of a code object's static identity (bytecode + consts +
    names); code objects are immutable, so caching is exact."""
    hit = _code_digests.get(code)
    if hit is not None:
        return hit
    h = hashlib.blake2b(digest_size=16)
    h.update(code.co_code)
    h.update(repr(code.co_consts).encode())
    # co_names tells `torch.roll(b, 1, 0)` from `torch.flip(b, 1, 0)`
    h.update(repr(code.co_names).encode())
    out = h.digest()
    _code_digests[code] = out
    return out


def _normalize_callable(fn) -> str:
    if isinstance(fn, np.ufunc):
        return f"ufunc:{fn.__name__}"
    if isinstance(fn, functools.partial):
        parts: list = ["partial:", _normalize_callable(fn.func)]
        _normalize(fn.args, parts)
        _normalize(fn.keywords or {}, parts)
        return "\x00".join(parts)
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if mod and qual and "<locals>" not in qual and "<lambda>" not in qual:
        bound = getattr(fn, "__self__", None)
        if bound is not None and not isinstance(bound, type) and not mod.startswith("torch"):
            # the same method on two instances is two different kernels
            return f"fn:{mod}.{qual}@{_token_of_single(bound)}"
        return f"fn:{mod}.{qual}"
    code = getattr(fn, "__code__", None)
    if code is None:
        return f"callable:{_identity_token(fn)}"
    # structurally identical lambdas match: bytecode + closure + defaults
    cells: list = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            contents = cell.cell_contents
        except ValueError:  # empty cell
            cells.append("<empty>")
            continue
        _normalize(contents, cells)
    h = hashlib.blake2b(digest_size=16)
    h.update(_code_digest(code))
    h.update("\x00".join(cells).encode())
    defaults: list = []
    for d in fn.__defaults__ or ():
        _normalize(d, defaults)
    for k, v in sorted((fn.__kwdefaults__ or {}).items()):
        defaults.append(k)
        _normalize(v, defaults)
    h.update("\x00".join(defaults).encode())
    return f"lambda:{h.hexdigest()}"


def _token_of_single(obj) -> str:
    parts: list = []
    _normalize(obj, parts)
    return "\x00".join(parts)


def tokenize(*args) -> str:
    """Deterministic 16-byte hex token of the arguments."""
    parts: list = []
    for a in args:
        _normalize(a, parts)
    h = hashlib.blake2b("\x00".join(parts).encode(), digest_size=16)
    return h.hexdigest()
