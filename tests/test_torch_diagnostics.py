"""The diagnostics through the port on the CPU, beside the JAX package.

Every case of the JAX package's ``tests/test_diagnostics.py`` and
``tests/test_diagnostics_spine2.py`` runs through both packages (the
``pkg`` fixture).  Then the differential checks over a set of programs:
``explain``'s node counts (raw, simplified, lowered, fused), leaf read bytes
and transfer bytes, the block counts, ``expr_table``'s rows, the dataflow
nodes of ``expr_flow`` (shape, column, operations) and ``chunk_report``'s
figures equal the JAX package's; ``KNOWN_DIFFERENCES`` lists where they do
not, with the reason, each checked to differ.  And the port's own:
``tier_report``'s lanes, ``plan_table`` beside ``structural_key``, and
``xla_profile``'s trace.

Tolerance: exact (counts, bytes, text).
"""

import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


class Pkg:
    def __init__(self, which):
        self.which = which
        self.root = ROOTS[which]
        self.da = importlib.import_module(self.root)

    def mod(self, path):
        return importlib.import_module(f"{self.root}.{path}")

    # the tier of a node whose size depends on the data: the JAX package
    # runs it in its eager lane, the port's walk syncs once to read it
    @property
    def data_dependent_tier(self):
        return "sync" if self.which == "port" else "eager"


@pytest.fixture(params=sorted(ROOTS))
def pkg(request):
    return Pkg(request.param)


# ---------------------------------------------------------------------------
# tests/test_diagnostics.py
# ---------------------------------------------------------------------------


def test_trace_rewrites_records(pkg):
    da = pkg.da
    x = da.ones((100, 100), chunks=10)
    y = (x + x.T)[:20, :20]
    with da.trace_rewrites() as tr:
        y.optimize()
    rules = tr.counter()
    assert any("_accept_slice" in r for r in rules), rules
    rec = tr.records[0]
    assert rec.phase in ("simplify", "lower")
    assert rec.before != rec.after


def test_explain_report_shape(pkg):
    da = pkg.da
    buf = io.StringIO()
    x = da.ones((100, 100), chunks=25)
    info = da.explain((x.rechunk(50) * 2).sum(axis=0), file=buf)
    text = buf.getvalue()
    assert "simplify:" in text and "fuse:" in text and "transfer bytes" in text
    assert set(info) >= {"simplified", "lowered", "fused", "times_ms", "transfer_bytes"}


def test_tier_report_modes(pkg):
    da = pkg.da
    x = da.ones((20, 20), chunks=10)
    r1 = da.tier_report((x + 1).sum(), file=io.StringIO())
    assert r1["counts"].get(pkg.data_dependent_tier, 0) == 0
    r2 = da.tier_report(x[x.sum(axis=1) > 0], file=io.StringIO())
    assert r2["counts"][pkg.data_dependent_tier] >= 1


def test_expr_flow_and_svg(pkg):
    da = pkg.da
    x = da.ones((50, 50), chunks=10)
    flow = da.expr_flow((x + x.T).sum(axis=0))
    assert "<svg" in flow.svg and "Reduction" in flow.svg
    html = x._repr_html_()
    assert "<svg" in html and "Chunk shape" in html
    text = da.expr_table(x + 1, file=io.StringIO())
    assert "Elemwise" in text or "add" in text


def test_chunk_report_warnings(pkg):
    txt = pkg.da.chunk_report(pkg.da.ones((10, 10), chunks=5), file=io.StringIO())
    assert "blocks" in txt


def test_simplify_convergence_valve(pkg):
    import warnings

    x = pkg.da.ones((64,), chunks=8)
    for _ in range(20):
        x = (x + 1)[: len(x)]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        x.expr.simplify()


# ---------------------------------------------------------------------------
# tests/test_diagnostics_spine2.py
# ---------------------------------------------------------------------------


def _flow(pkg):
    return pkg.mod("_expr_flow")


def test_linear_chain_single_node(pkg):
    x = pkg.da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, edges = _flow(pkg).build_flow_graph((((x + 1) * 2) - 0.5).expr)
    assert len(nodes) == 1 and len(edges) == 0
    assert nodes[0].shape == (100, 100)
    assert len(nodes[0].operations) == 4
    assert nodes[0].operations[0] == "Load"


def test_reduction_creates_nodes(pkg):
    x = pkg.da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, edges = _flow(pkg).build_flow_graph((x + 1).sum().expr)
    assert len(nodes) >= 2 and len(edges) >= 1
    shapes = {n.shape for n in nodes}
    assert (100, 100) in shapes and () in shapes


def test_axis_reduction_shows_shape_change(pkg):
    x = pkg.da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, _ = _flow(pkg).build_flow_graph(x.sum(axis=0).expr)
    shapes = {n.shape for n in nodes}
    assert (100, 100) in shapes and (100,) in shapes


def test_multi_input_separate_nodes(pkg):
    a = pkg.da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    b = pkg.da.from_array(np.random.random((100, 100)) + 1, chunks=(50, 50))
    nodes, edges = _flow(pkg).build_flow_graph((a + b).expr)
    assert len(nodes) == 3 and len(edges) == 2


def test_layout_assignment(pkg):
    x = pkg.da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, _ = _flow(pkg).build_flow_graph(x.sum().expr)
    cols = {n.shape: n.col for n in nodes}
    assert cols[(100, 100)] == 0 and cols[()] >= 1


def test_count_operations(pkg):
    x = pkg.da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    assert _flow(pkg).count_operations((x + 1).sum().expr) >= 2


def test_expr_flow_accepts_array_and_expr(pkg):
    x = pkg.da.ones((10, 10), chunks=5)
    f = _flow(pkg)
    assert isinstance(f.expr_flow(x), f.FlowDiagram)
    assert isinstance(f.expr_flow(x.expr), f.FlowDiagram)


def test_flow_diagram_repr_and_html(pkg):
    flow = _flow(pkg).expr_flow(pkg.da.ones((10, 10), chunks=5))
    text = repr(flow)
    assert "Expression:" in text and "operations" in text
    html = flow._repr_html_()
    assert "<div" in html and "svg" in html


def test_render_flow_svg_returns_div(pkg):
    assert "<div" in _flow(pkg).render_flow_svg(pkg.da.ones((10, 10), chunks=5).expr)


def test_flow_node_edge_reprs(pkg):
    f = _flow(pkg)
    n = f.FlowNode((3, 4), (2, 2), ["Load", "Add"], col=1, key="k")
    assert "Load" in repr(n) and "col=1" in repr(n)
    assert "a -> b" in repr(f.FlowEdge("a", "b"))


def _table_text(pkg):
    x = pkg.da.ones((100, 50), chunks=(10, 25)) + 1
    buf = io.StringIO()
    pkg.mod("_diagnostics").expr_table(x, file=buf)
    return buf.getvalue()


def test_expr_table_contains_shapes(pkg):
    assert "(100, 50)" in _table_text(pkg)


def test_expr_table_contains_bytes(pkg):
    text = _table_text(pkg)
    assert "B" in text or "bytes" in text.lower()


def test_expr_table_contains_operation_names(pkg):
    text = _table_text(pkg)
    assert "Ones" in text or "ones" in text


def test_expr_repr_html_card(pkg):
    html = pkg.da.ones((100, 50), chunks=(10, 25))._repr_html_()
    assert ("table" in html or "svg" in html) and "100" in html


def test_trace_unpatches_on_exit(pkg):
    Slice = pkg.mod("_slicing").Slice
    before = Slice._simplify_down
    with pkg.mod("_diagnostics").trace_rewrites() as rec:
        (pkg.da.ones((10,), chunks=5) + 1)[:3].expr.simplify()
    assert Slice._simplify_down is before
    assert rec.records
    assert pkg.mod("_expr")._trace_hook is None


def test_trace_repr_aggregates(pkg):
    with pkg.mod("_diagnostics").trace_rewrites() as rec:
        ((pkg.da.ones((10,), chunks=5) + 1)[:3] + 2)[:2].expr.simplify()
    assert any(ch.isdigit() for ch in repr(rec))
    assert any(ch.isdigit() for ch in rec.summary())


def test_explain_accepts_expr_or_collection(pkg):
    explain = pkg.mod("_diagnostics").explain
    x = (pkg.da.ones((10, 10), chunks=5) + 1).sum()
    r1 = explain(x, file=io.StringIO())
    r2 = explain(x.expr, file=io.StringIO())
    assert repr(r1) and repr(r2)


def test_explain_trivial_expr(pkg):
    assert repr(pkg.mod("_diagnostics").explain(pkg.da.ones((4,), chunks=2), file=io.StringIO()))


def test_top_level_compatibility_exports(pkg):
    names = ["sliding_window_view", "PerformanceWarning", "from_delayed", "map_blocks", "map_overlap",
             "register_chunk_type"]
    missing = [n for n in names if not hasattr(pkg.da, n)]
    # S9 brought register_chunk_type to the port
    assert missing == []


def test_random_star_exports_legacy_wrappers(pkg):
    for name in ["random", "normal", "poisson", "randint", "random_sample", "RandomState", "default_rng"]:
        assert hasattr(pkg.da.random, name), name


def test_plain_import_does_not_load_xarray_or_pandas(pkg):
    code = (
        f"import sys\nimport {pkg.root}\n"
        "bad = [m for m in ('xarray', 'pandas', 'tiledb', 'zarr') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=root)
    assert r.returncode == 0, r.stderr[-500:]


@pytest.fixture
def sliced_pipeline(pkg):
    da = pkg.da
    x = da.from_array(np.ones((100, 100)), chunks=(10, 10))
    y = da.from_array(np.ones((100, 100)), chunks=(10, 10))
    return ((x + y) * 2).sum(axis=0)[:50]


def test_trace_records_slice_pushdown(pkg, sliced_pipeline):
    with pkg.da.trace_rewrites() as t:
        sliced_pipeline.expr.simplify()
    assert t.records
    assert any(r.before_type == "Slice" for r in t.records), t.summary()
    for r in t.records:
        assert r.rule and r.after_type
        assert r.phase in ("simplify", "lower")


def test_trace_records_lowering(pkg):
    x = pkg.da.from_array(np.ones((54, 8)), chunks=(9, 4))
    r = x.reshape(27, 16)
    with pkg.da.trace_rewrites() as t:
        r.expr.simplify().lower_completely()
    lower_rules = {rec.rule for rec in t.records if rec.phase == "lower"}
    assert any(rule.endswith("._lower") for rule in lower_rules), (lower_rules, t.summary())


def test_explain_phases(pkg, sliced_pipeline):
    report = pkg.da.explain(sliced_pipeline, file=io.StringIO())
    nodes, reads = report["nodes"], report["read_bytes"]
    assert reads["simplified"] < reads["raw"]
    assert reads["fused"] == reads["simplified"]
    assert nodes["fused"] >= 1 and nodes["lowered"] >= 1
    assert report["rewrites"]["simplify"]


def test_explain_repr_mentions_phases(pkg, sliced_pipeline):
    buf = io.StringIO()
    pkg.da.explain(sliced_pipeline, file=buf)
    for token in ("raw", "simplify", "lower", "fuse", "leaf reads"):
        assert token in buf.getvalue()


# ---------------------------------------------------------------------------
# differential: the same program through both packages
# ---------------------------------------------------------------------------


def _programs(da):
    x = da.ones((100, 100), chunks=25)
    a = da.from_array(np.ones((100, 100)), chunks=(10, 10))
    b = da.from_array(np.ones((100, 100)), chunks=(10, 10))
    y = da.from_array(np.arange(144.0).reshape(12, 12), chunks=4)
    return {
        "rechunk_sum": (x.rechunk(50) * 2).sum(axis=0),
        "readme": (x + x.T)[:20, :20],
        "sliced_pipeline": ((a + b) * 2).sum(axis=0)[:50],
        "trivial": da.ones((4,), chunks=2),
        "sum": (da.ones((10, 10), chunks=5) + 1).sum(),
        "reshape": da.from_array(np.ones((54, 8)), chunks=(9, 4)).reshape(27, 16),
        "matmul": y @ y.T,
        "stack": da.stack([y, y + 1], axis=0),
        "slice_step": x[::2, 1:50:3],
        "take": x[[1, 5, 7]],
        "take_of_data": a[:, [1, 5, 7, 8]],
        "vindex": a.vindex[[1, 5, 7], [2, 3, 4]],
        "mean_rechunk": x.rechunk((50, 20)).mean(axis=1),
        "concat": da.concatenate([y, y], axis=1)[:, 3:9],
        "chain": (((a + 1) * 2) - 0.5).T,
        "overlap_slice": da.overlap(a, depth=1, boundary="reflect")[:24],
    }


# program -> why the packages' explain figures differ there
KNOWN_DIFFERENCES = {
    "take": "the JAX package folds a take of a constant into the constant (a Ones of the taken shape); the "
            "port keeps Take over the culled Ones: 2 nodes and 20000 leaf bytes against 1 and 2400",
}


def _explain_figures(da, x):
    r = da.explain(x, file=io.StringIO())
    return {
        "nodes": r["nodes"],
        "read_bytes": r["read_bytes"],
        "transfer_bytes": tuple(r["transfer_bytes"]),
        "blocks": (x.npartitions, r["fused"].npartitions),
    }


def _both(name):
    port = importlib.import_module(ROOTS["port"])
    jax_pkg = importlib.import_module(ROOTS["jax"])
    return _programs(port)[name], _programs(jax_pkg)[name], port, jax_pkg


@pytest.mark.parametrize("name", sorted(set(_programs(importlib.import_module(ROOTS["port"]))) - set(KNOWN_DIFFERENCES)))
def test_explain_figures_equal_the_jax_packages(name):
    t, j, tda, jda = _both(name)
    assert _explain_figures(tda, t) == _explain_figures(jda, j)


@pytest.mark.parametrize("name", sorted(KNOWN_DIFFERENCES))
def test_known_differences_are_real(name):
    t, j, tda, jda = _both(name)
    assert _explain_figures(tda, t) != _explain_figures(jda, j)
    assert t.compute().tolist() == j.compute().tolist()


@pytest.mark.parametrize("name", sorted(_programs(importlib.import_module(ROOTS["port"]))))
def test_table_flow_and_chunk_report_equal_the_jax_packages(name):
    t, j, tda, jda = _both(name)
    assert tda.expr_table(t, file=io.StringIO()) == jda.expr_table(j, file=io.StringIO())

    def flow(da, x):
        f = da.expr_flow(x)
        return sorted((n.shape, n.col, tuple(n.operations)) for n in f.nodes), len(f.edges)

    assert flow(tda, t) == flow(jda, j)

    def report(da, x):  # the array's name differs: compare what follows it
        return da.chunk_report(x, file=io.StringIO()).split(":", 1)[1]

    assert report(tda, t) == report(jda, j)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_tier_report_names_the_ports_lanes():
    import dask_array_tpu_torch as da

    x = da.from_array(np.arange(40.0).reshape(8, 5), chunks=4)
    r = da.tier_report(da.map_blocks(np.sin, x, dtype="f8") + 1, file=io.StringIO())
    assert r["counts"] == {"device": len(r["nodes"]) - 1, "host": 1}
    buf = io.StringIO()
    da.tier_report(x + 1, file=buf)
    text = buf.getvalue()
    assert "eager torch walk on cpu" in text and "host lane (_host.py): 0" in text
    assert "native plankit: engaged" in text and "band-stencil kernel (K1" in text


def test_plan_table_shows_the_structural_keys_plan():
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch._executor import structural_key
    from dask_array_tpu_torch._planrec import plan_fingerprint

    x = da.from_array(np.ones((40, 40)), chunks=20)
    y = (x @ x.T)[:20]
    buf = io.StringIO()
    decoded = da.plan_table(y, file=buf)
    assert buf.getvalue().startswith(f"plan record: {len(decoded['nodes'])} nodes")
    assert "leaf#0" in buf.getvalue()
    opt = y.expr.optimize()
    assert structural_key(opt) == "plan:" + plan_fingerprint(opt)[0]


def test_array_methods():
    import dask_array_tpu_torch as da

    x = da.ones((30, 20), chunks=10)
    assert x.to_svg().startswith("<svg") and x.to_svg() == importlib.import_module("dask_array_tpu").ones(
        (30, 20), chunks=10).to_svg()
    assert "Elemwise" in (x + 1).visualize()
    assert set(x.explain(file=io.StringIO())) >= {"nodes", "read_bytes"}
    assert "PyTorch (cpu)" in x._repr_html_()


def test_xla_profile_writes_a_chrome_trace(tmp_path):
    import dask_array_tpu_torch as da

    x = da.from_array(np.ones((64, 64)), chunks=32)
    with da.xla_profile(str(tmp_path)) as logdir:
        (x + 1).sum().compute()
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        trace = json.load(f)
    assert any("aten::" in ev.get("name", "") for ev in trace["traceEvents"])
