"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the port.  Each check runs in a fresh process
and compares top-level module names (before the first dot) whole: the
port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import core

FIND_ALL = r"""
import json, sys
sys.path.insert(0, {root!r})
from portbench import core, check, readings, sets, trace, traffic, yardstick, funcs
import portbench.run
bench = core.load_json(core.CHECKOUT / "BENCHMARK.json")
for w in bench["workloads"]:
    c = core.Cell(w["name"])
    for m in c.end_to_end:
        c.reader(m, "end_to_end")
    for m in c.per_layer:
        c.reader(m, "metrics")
import dask_array_tpu_torch
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCES_ONLY = r"""
import json, sys
sys.path.insert(0, {root!r})
import importlib.util, pathlib
for path in sorted(pathlib.Path({root!r}, "portbench", "reference").glob("*.py")):
    spec = importlib.util.spec_from_file_location("ref_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(core.CHECKOUT))],
                         capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    names = top_level_names(FIND_ALL)
    assert "dask_array_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "dask_array_tpu"}


def test_the_references_load_nothing_of_the_port():
    names = top_level_names(REFERENCES_ONLY)
    assert "torch" in names
    assert not names & {"dask_array_tpu_torch", "dask_array_tpu", "jax", "jaxlib", "flax", "portbench"}


@pytest.mark.parametrize("path", sorted((core.PORTBENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_and_numpy(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"torch", "numpy", "__future__"}
