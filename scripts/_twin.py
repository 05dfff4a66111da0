"""A second checkout of ``dask_array_tpu_torch`` in the same process.

The timing scripts compare two checkouts of the port (a parent and its
change) inside one process on one card.  Both packages carry one name, so
``load(root, alias)`` copies ``root``'s package to
``build/twins/<alias>/<alias>/`` beside this checkout (gitignored), with
every ``dask_array_tpu_torch`` in its Python files renamed to ``alias``,
and imports it.  The copy builds its kernels into its own ``build/``
(``kernels/_build.py`` keys them by source), so the two never share a
library.
"""

from __future__ import annotations

import importlib
import pathlib
import re
import shutil
import sys

PACKAGE = "dask_array_tpu_torch"
HERE = pathlib.Path(__file__).resolve().parents[1]


def load(root, alias: str):
    """The ``dask_array_tpu_torch`` package of checkout ``root`` imported
    as the package ``alias``."""
    if not alias.isidentifier() or alias == PACKAGE:
        raise ValueError(f"{alias!r} cannot name a second copy of the package")
    src = pathlib.Path(root).resolve() / PACKAGE
    if not src.is_dir():
        raise FileNotFoundError(f"{src} holds no {PACKAGE} package")
    top = HERE / "build" / "twins" / alias
    shutil.rmtree(top, ignore_errors=True)
    shutil.copytree(src, top / alias, ignore=shutil.ignore_patterns("__pycache__"))
    word = re.compile(rf"\b{PACKAGE}\b")
    for py in (top / alias).rglob("*.py"):
        py.write_text(word.sub(alias, py.read_text()))
    sys.path.insert(0, str(top))
    return importlib.import_module(alias)
