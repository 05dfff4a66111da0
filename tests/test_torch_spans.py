"""The port's spans and counters (``dask_array_tpu_torch._spans``).

With no profiler recording, a compute enters no ``record_function`` and
still counts.  Under a CPU ``torch.profiler`` each kind of request gives
its named spans, nested as ``_spans``' docstring lists them, under one
root ``compute:<id>`` a request.  The spans that need a card (a kernel
launch, the free-memory query, the fetch through the pinned ring, the
upload) are checked on the card (``gpu`` marker), where the spans' device
mirrors must not read as device operations.  The file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py -q
"""

import ctypes.util
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

import dask_array_tpu_torch as da
from dask_array_tpu_torch import _spans, _streaming, config
from dask_array_tpu_torch._spans import COUNTS, PREFIX
from dask_array_tpu_torch.kernels import _build


@pytest.fixture
def cpu():
    with config.set({"device": "cpu"}):
        yield torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launch, the free-memory query and the pinned ring run only there")
    with config.set({"device": "cuda"}):
        yield torch.device("cuda")


def roll_laplace(b):
    return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b


def field(device="cpu"):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((120, 90)).astype(np.float32)).to(device)
    return da.from_delayed(lambda: x, (120, 90), dtype=np.float32).rechunk((12, 9)).persist()


class Span:
    def __init__(self, e):
        self.name = e.name[len(PREFIX):]
        self.t0, self.t1, self.thread = e.time_range.start, e.time_range.end, e.thread

    def inside(self, other) -> bool:
        """Whether this span lies in ``other``: on its thread, shorter, and
        its middle within ``other``.  Not its ends: the profiler's host
        timestamps are approximate, and a span that closes just before its
        parent has read as closing after it under a loaded host."""
        mid = (self.t0 + self.t1) / 2
        return (self is not other and self.thread == other.thread and other.t0 <= mid <= other.t1
                and self.t1 - self.t0 < other.t1 - other.t0)

    @property
    def kind(self) -> str:
        return "compute" if self.name.startswith("compute:") else self.name


def spans_of(prof) -> list:
    """The port's spans on the host (a span's mirror on the card's timeline
    left out)."""
    return sorted((Span(e) for e in prof.events() if e.name.startswith(PREFIX) and e.device_type == DeviceType.CPU),
                  key=lambda s: (s.t0, -s.t1))


def parent(span, spans):
    """The innermost span around ``span``."""
    around = [s for s in spans if span.inside(s)]
    return min(around, key=lambda s: s.t1 - s.t0) if around else None


def roots(spans) -> list:
    return [s for s in spans if s.kind == "compute" and parent(s, spans) is None]


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans_of(prof)


def test_no_profiler_enters_no_record_function_and_still_counts(cpu, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    x = field()
    before = dict(COUNTS)
    x.map_overlap(roll_laplace, depth=1, boundary="reflect").compute_device()
    x.std().compute()
    da.compute(x.sum(0), x.mean(1), x.std())
    assert COUNTS["computes"] - before["computes"] == 3
    assert COUNTS["optimize_runs"] - before["optimize_runs"] >= 5
    assert COUNTS["captures"] - before["captures"] == 1
    assert _spans.span("x") is _spans._OFF


def test_a_roll_stencil_names_its_layers(cpu):
    x = field()
    _, spans = traced(lambda: x.map_overlap(roll_laplace, depth=1, boundary="reflect").compute_device())
    (root,) = roots(spans)
    kinds = {s.kind: s for s in spans}
    assert parent(kinds["capture"], spans) is None  # the capture runs while the graph is built
    assert kinds["capture"].t1 <= root.t0
    for name in ("stream_check", "optimize", "execute"):
        assert parent(kinds[name], spans) is root, name
    assert parent(kinds["bind"], spans) is kinds["execute"]
    assert parent(kinds["node:BandStencil"], spans) is kinds["execute"]


def test_a_lone_std_names_its_layers(cpu):
    x = field()
    _, spans = traced(lambda: x.std().compute())
    (root,) = roots(spans)
    kinds = {s.kind: s for s in spans}
    assert parent(kinds["stream_check"], spans) is root
    assert parent(kinds["optimize"], spans) is root
    assert parent(kinds["fuse_multistat"], spans) is kinds["optimize"]
    nodes = [s for s in spans if s.name.startswith("node:")]
    assert "node:MultiStat" in {s.name for s in nodes}
    assert all(s.inside(kinds["execute"]) for s in nodes)
    assert all(parent(s, spans).name.startswith(("node:", "execute")) for s in nodes)


def test_three_statistics_in_one_compute_name_their_layers(cpu):
    x = field()
    _, spans = traced(lambda: da.compute(x.sum(0), x.mean(1), x.std()))
    (root,) = roots(spans)
    assert not [s for s in spans if s.kind == "stream_check"]  # several arrays skip the out-of-core check
    fusions = [s for s in spans if s.kind == "fuse_multistat"]
    assert parent(fusions[0], spans) is root  # across the three arrays, before the optimizer
    optimizes = [s for s in spans if s.kind == "optimize"]
    assert len(optimizes) == 3 and all(parent(s, spans) is root for s in optimizes)
    (execute,) = [s for s in spans if s.kind == "execute"]
    assert parent(execute, spans) is root
    assert {"node:MultiStat", "node:MultiStatPart"} <= {s.name for s in spans if s.inside(execute)}


def test_each_request_has_one_id_and_its_spans_lie_under_it(cpu):
    x = field()
    std, colsum, rowmean = x.std(), x.sum(0), x.mean(1)  # built outside the window: no build-time span in it

    def requests():
        std.compute()
        colsum.compute_device()
        da.compute(colsum, rowmean)

    first = COUNTS["computes"] + 1
    _, spans = traced(requests)
    rs = roots(spans)
    assert [r.name for r in rs] == [f"compute:{first + k}" for k in range(3)]
    for s in spans:
        if s.kind != "compute":
            assert sum(s.inside(r) for r in rs) == 1, s.name


def test_a_barrier_opens_a_child_compute_with_the_outer_id(cpu):
    x = field()
    before = COUNTS["computes"]
    out, spans = traced(lambda: da.barrier(x + 1).sum().compute())
    counted = COUNTS["computes"] - before
    np.testing.assert_allclose(out, (x + 1).sum().compute(), rtol=1e-5)
    computes = [s for s in spans if s.kind == "compute"]
    (outer,) = roots(spans)
    inner = [s for s in computes if s is not outer]
    assert inner and all(s.inside(outer) for s in inner)
    assert {s.name for s in computes} == {f"compute:{before + 1}"}
    assert counted == len(computes)


def test_the_budget_query_nests_in_the_stream_check(cpu, monkeypatch):
    """``_budget`` asks CUDA for free memory only for a CUDA device:
    here one is named, and CUDA's answers are a card's with room."""
    monkeypatch.setattr(_streaming, "_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (80 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    x = field()
    before = COUNTS["mem_get_info"]
    out, spans = traced(lambda: _spans.compute(_streaming.maybe_stream, x.std().expr))
    assert out is None  # it fits: the in-core walk answers
    assert COUNTS["mem_get_info"] - before == 1
    kinds = {s.kind: s for s in spans}
    assert parent(kinds["mem_get_info"], spans) is kinds["stream_check"]
    assert parent(kinds["stream_check"], spans).kind == "compute"


def test_call_passes_results_and_errors_through_either_way():
    def boom():
        raise KeyError("x")

    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) if on else _spans.span("off"):
            assert autograd_profiler._is_profiler_enabled is on
            assert _spans.call("t", lambda a, b: a + b, 2, 3) == 5
            with pytest.raises(KeyError):
                _spans.call("t", boom)
            with pytest.raises(KeyError):
                _spans.compute(boom)
    assert _spans._request.__dict__.get("id") is None


def test_a_kernel_build_and_a_library_load_are_counted_and_named(tmp_path, monkeypatch):
    def fake_nvcc(cmd, **kwargs):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    libc = ctypes.util.find_library("c")
    before = dict(COUNTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path, _ = _build.build_library("halo")
        _build.build_library("halo")  # built already: no second nvcc
        _build.load(Path(libc))
    assert path.exists() and path.parent == tmp_path
    assert COUNTS["library_builds"] - before["library_builds"] == 1
    assert COUNTS["library_loads"] - before["library_loads"] == 1
    assert [s.name for s in spans_of(prof)] == ["kernel_build:halo", f"library_load:{Path(libc).name}"]


# -- on the card --------------------------------------------------------------


def window_trace(fn):
    """``fn()`` under a CPU and CUDA profile, inside the benchmark's window
    span, read by the benchmark's own trace reader."""
    from portbench.trace import WINDOW, Trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, Trace(prof), spans_of(prof)


@pytest.mark.gpu
def test_on_the_card_the_reductions_name_launch_fetch_and_budget(cuda):
    x = field("cuda")
    da.compute(x.sum(0), x.mean(1), x.std())  # loads the kernel
    _, trace, spans = window_trace(lambda: (da.compute(x.sum(0), x.mean(1), x.std()), x.std().compute()))
    assert not [n for n, _, _ in trace.device if n.startswith(PREFIX)]
    assert trace.launches("mstat_main") == 2
    kinds = {}
    for s in spans:
        kinds.setdefault(s.kind, []).append(s)
    (launch, second) = kinds["launch:mstat"]
    assert parent(launch, spans).name.startswith("node:")
    for f in kinds["fetch"]:
        assert parent(f, spans).kind == "compute"
    for child in kinds["fetch.wait"] + kinds["fetch.piece"]:
        assert parent(child, spans).kind == "fetch"
    (check,) = kinds["stream_check"]
    assert [parent(m, spans) for m in kinds["mem_get_info"]] == [check]
    assert {n for n, _, _ in trace.host if n.startswith(PREFIX)} >= {PREFIX + k for k in ("fetch", "fetch.wait")}


@pytest.mark.gpu
def test_on_the_card_a_stencil_and_an_upload_are_named(cuda):
    from dask_array_tpu_torch import _hostcopy

    x = field("cuda")
    x.map_overlap(roll_laplace, depth=1, boundary="reflect").compute_device()
    arr = np.arange(1 << 16, dtype=np.float32)
    _, trace, spans = window_trace(lambda: (
        x.map_overlap(roll_laplace, depth=1, boundary="reflect").compute_device(), _hostcopy.upload(arr, cuda)))
    assert not [n for n, _, _ in trace.device if n.startswith(PREFIX)]
    names = [s.name for s in spans]
    assert "launch:band_stencil" in names and "upload" in names
    (launch,) = [s for s in spans if s.name == "launch:band_stencil"]
    assert parent(launch, spans).name == "node:BandStencil"
