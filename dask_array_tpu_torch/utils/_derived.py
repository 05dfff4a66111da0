"""Derive public docstrings from numpy.

Port of ``dask_array_tpu/utils/_derived.py``: once at import, every
exported callable that has no docstring of its own and shadows a numpy
name inherits numpy's docstring plus a note.  Hand-written docstrings
always win: the deriver never overwrites a non-empty ``__doc__``.
"""

from __future__ import annotations

import inspect

_NOTE = """

This docstring was copied from ``numpy.{qual}`` (dask_array_tpu_torch
provides a chunked, lazy version of the numpy API that computes with
PyTorch on the configured device).  Differences from numpy: arrays are
lazy expressions evaluated by ``.compute()``; operations run block-wise;
``order=``/``subok=`` style memory-layout keywords are generally not
supported; some functions accept an extra ``chunks=`` / ``split_every=``
argument controlling the block layout.
"""


def derive_docstrings(namespace: dict, names, sources) -> list[str]:
    """Attach numpy docstrings to undocumented callables in ``namespace``.

    ``sources`` is a sequence of ``(qualprefix, module)`` pairs searched in
    order (e.g. ``[("", numpy), ("linalg.", numpy.linalg)]``).  Returns the
    names that remain undocumented.
    """
    remaining = []
    for name in names:
        fn = namespace.get(name) if isinstance(namespace, dict) else getattr(namespace, name, None)
        if fn is None or not callable(fn) or inspect.isclass(fn):
            continue
        if (getattr(fn, "__doc__", None) or "").strip():
            continue
        doc = None
        qual = None
        for prefix, src in sources:
            obj = getattr(src, name, None)
            if obj is None:
                continue
            d = inspect.getdoc(obj)
            if d:
                doc, qual = d, f"{prefix}{name}"
                break
        if doc is None:
            remaining.append(name)
            continue
        try:
            fn.__doc__ = doc + _NOTE.format(qual=qual)
        except (AttributeError, TypeError):
            remaining.append(name)
    return remaining
