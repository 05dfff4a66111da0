"""The benchmark's readers of the port's own spans
(``portbench/metrics/{stream_check_ms,capture_ms,fuse_ms,fetch_ms,
idle_unnamed_pct}.py``), each run on a traced window built by hand: the
host spans (name, start, end in microseconds) and the device's operations
of a ``portbench.trace.Trace``, with known answers."""

import json
from pathlib import Path

import pytest

from portbench.metrics import capture_ms, fetch_ms, fuse_ms, idle_unnamed_pct, stream_check_ms
from portbench.trace import Trace

P = "dask_array_tpu_torch."
READERS = {"stream_check_ms": stream_check_ms, "capture_ms": capture_ms, "fuse_ms": fuse_ms,
           "fetch_ms": fetch_ms, "idle_unnamed_pct": idle_unnamed_pct}


class Reading:
    def __init__(self, host, device=(), requests=2, window=(0.0, 10_000.0)):
        trace = Trace.__new__(Trace)
        trace.w0, trace.w1 = window
        trace.host = [(P + n if not n.startswith(("portbench.", "aten::", "cuda")) else n, t0, t1)
                      for n, t0, t1 in host]
        trace.device = sorted(device, key=lambda d: d[1])
        self.trace = trace
        self.requests = requests


def test_fetch_is_its_self_time_less_the_nested_waits():
    r = Reading([
        ("compute:1", 0, 4000), ("fetch", 1000, 2000), ("fetch.wait", 1100, 1700), ("fetch.piece", 1700, 1900),
        ("compute:2", 5000, 9000), ("fetch", 6000, 6500), ("fetch.wait", 6000, 6400),
        ("fetch.wait", 7000, 7100),  # a ring slot's wait outside any fetch takes nothing off
    ])
    assert fetch_ms.read(r) == pytest.approx(((1000 - 600) + (500 - 400)) * 1e-3 / 2)


@pytest.mark.parametrize("name, reader", [("capture", capture_ms), ("fuse_multistat", fuse_ms)])
def test_a_span_summed_over_the_requests(name, reader):
    r = Reading([(name, 100, 400), ("optimize", 500, 900), (name, 600, 700), (name, 3000, 3500)], requests=4)
    assert reader.read(r) == pytest.approx((300 + 100 + 500) * 1e-3 / 4)


def test_the_stream_check_counts_its_stalls_but_not_a_streamed_run():
    r = Reading([
        ("stream_check", 0, 2000), ("mem_get_info", 100, 1900),
        ("stream_check", 3000, 9000), ("stream_run", 3500, 8500), ("cudaMemGetInfo", 120, 1880),
    ], requests=2)
    assert stream_check_ms.read(r) == pytest.approx((2000 + 6000 - 5000) * 1e-3 / 2)


def test_idle_unnamed_counts_spans_of_every_thread_but_the_requests_roots():
    # idle: [0, 1000), [2000, 6000), [8000, 10000): 7000 us
    device = [("k", 1000, 2000), ("k", 1500, 2000), ("copy", 6000, 8000)]
    host = [
        ("compute:1", 0, 10_000),  # the root names nothing
        ("optimize", 200, 700),  # names 500 of the first gap
        ("fetch.wait", 2000, 3000),  # on the main thread
        ("fetch.piece", 2500, 3500),  # on a copy thread, overlapping: 1500 named in all
        ("node:Elemwise", 5500, 7000),  # 500 idle named, the rest while the card runs
        ("portbench.optimize", 8000, 10_000),  # the benchmark's own span names nothing
        ("aten::sum", 9000, 9500),
    ]
    r = Reading(host, device)
    named = 500 + 1500 + 500
    assert idle_unnamed_pct.read(r) == pytest.approx(100.0 * (7000 - named) / 7000)


def test_idle_unnamed_is_zero_where_spans_cover_every_gap():
    r = Reading([("execute", 0, 10_000)], [("k", 2000, 3000)])
    assert idle_unnamed_pct.read(r) == 0.0


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_where_the_window_holds_none_of_the_spans(name):
    """The parent program has no spans: each reader reads nothing there,
    and so on a window whose spans are only the roots or the benchmark's."""
    host = [("compute:3", 0, 9000), ("portbench.walk", 100, 200), ("cudaMemGetInfo", 300, 400)]
    assert READERS[name].read(Reading(host, [("k", 0, 5000)])) is None
    assert READERS[name].read(Reading([], [("k", 0, 5000)])) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_without_a_trace(name):
    r = Reading([])
    r.trace = None
    assert READERS[name].read(r) is None


def test_each_reader_has_its_entry():
    bench = json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "device_trace" and m["moves"] == "eff_gbps"
        assert set(m["workloads"]) <= cells
    assert set(entries["idle_unnamed_pct"]["workloads"]) == cells
    assert "reduction_tree.multi" not in entries["stream_check_ms"]["workloads"]
