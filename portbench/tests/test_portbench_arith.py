"""The must-move bytes, the rooflines and the percentiles against hand
counts."""

import statistics

import numpy as np
import pytest

from portbench import core, yardstick
from portbench.traffic import Traffic


def traffic_of(cell):
    c = core.Cell(cell)
    return c, Traffic(c.mix, c.cfg)


def test_must_move_bytes_by_hand():
    _, roll = traffic_of("stencil2d.roll")
    assert roll.must_move_bytes() == 2 * 65536 * 65536 * 4
    _, slices = traffic_of("stencil2d.slices")
    assert slices.must_move_bytes() == 2 * 32768 * 32768 * 4
    _, multi = traffic_of("reduction_tree.multi")
    assert multi.must_move_bytes() == 60000 * 60000 * 4 + (60000 + 60000 + 1) * 4
    _, single = traffic_of("reduction_tree.single")
    assert single.must_move_bytes() == multi.must_move_bytes()


class FakeTrace:
    def __init__(self, seconds, launches=None):
        self._seconds = seconds
        self._launches = launches or {}
        self.window_s = 1.0
        self.busy_s = 0.25
        self.device = [("k", 0.0, 1.0)]

    def seconds(self, key=None, other=False):
        return self._seconds.get("other" if other else key, 0.0)

    def launches(self, name):
        return self._launches.get(name, 0)


def reading(cell, requests, seconds, spans=None, launches=None):
    c, traffic = traffic_of(cell)
    return c, core.Reading(c.cfg, traffic, requests, spans or {}, FakeTrace(seconds, launches))


def test_k1_roofline_by_hand():
    c, r = reading("stencil2d.roll", 10, {"k1": 10 * 0.030})
    value = c.reader({"name": "k1_roofline"}, "metrics").read(r)
    least = 2 * 65536**2 * 4 / 3.35e12
    assert value == pytest.approx(100 * least / 0.030)
    c, r = reading("stencil2d.roll", 10, {})
    assert c.reader({"name": "k1_roofline"}, "metrics").read(r) is None


def test_halo_roofline_by_hand():
    c, r = reading("stencil2d.slices", 4, {"halo": 4 * 0.005})
    value = c.reader({"name": "halo_roofline"}, "metrics").read(r)
    least = (32768**2 + 32770**2) * 4 / 3.35e12
    assert value == pytest.approx(100 * least / 0.005)


@pytest.mark.parametrize("cell", ["reduction_tree.multi", "reduction_tree.single"])
def test_p4_roofline_by_hand(cell):
    """One launch a request in either cell (the three statistics together,
    or the lone std): the field read once, 60000 + 60000 + 3 values
    written."""
    c, r = reading(cell, 3, {"p4": 3 * 0.005}, launches={"mstat_main": 3})
    value = c.reader({"name": "p4_roofline"}, "metrics").read(r)
    least = (60000**2 + 120003) * 4 / 3.35e12
    assert value == pytest.approx(100 * least / 0.005)
    c, r = reading(cell, 3, {})
    assert c.reader({"name": "p4_roofline"}, "metrics").read(r) is None


def test_trace_counts_launches_by_whole_name():
    from portbench.trace import Trace

    t = Trace.__new__(Trace)
    t.device = [("void mstat_main<256>(float const*)", 0, 1), ("mstat_finish", 1, 2),
                ("mstat_main_other", 2, 3), ("mstat_main", 3, 4)]
    assert t.launches("mstat_main") == 2 and t.launches("mstat_finish") == 1


def test_idle_and_aten_by_hand():
    c, r = reading("reduction_tree.multi", 4, {"other": 0.002})
    assert c.reader({"name": "idle_pct"}, "metrics").read(r) == pytest.approx(75.0)
    assert c.reader({"name": "aten_ms"}, "metrics").read(r) == pytest.approx(0.5)


def test_span_medians():
    c, r = reading("reduction_tree.multi", 3, {}, {"build": [0.001, 0.003, 0.002], "optimize": [], "walk": [0.004]})
    assert c.reader({"name": "build_ms"}, "metrics").read(r) == pytest.approx(2.0)
    assert c.reader({"name": "optimize_ms"}, "metrics").read(r) is None
    assert c.reader({"name": "walk_ms"}, "metrics").read(r) == pytest.approx(4.0)


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert yardstick.roofline_pct(0, 1.0) is None and yardstick.roofline_pct(1.0, 0) is None


@pytest.mark.parametrize("q", [5, 50, 95, 99])
def test_percentile_is_numpy_linear(q):
    xs = list(np.random.default_rng(q).exponential(size=357))
    assert yardstick.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_spread_is_statistics_quartiles():
    xs = [10.0, 11.0, 9.0, 12.0, 10.5, 9.5]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_end_to_end_readers_by_hand():
    c = core.Cell("reduction_tree.multi")
    w = core.Window([0.010, 0.020, 0.030, 0.040], 0.1, 10**9, 3 * 2**30, 7.5)
    read = {m["name"]: c.reader(m, "end_to_end").read(w) for m in c.end_to_end}
    assert read["eff_gbps"] == pytest.approx(4 * 1e9 / 0.1 / 1e9)
    assert read["peak_gib"] == pytest.approx(3.0)
    assert read["setup_s"] == 7.5
    if "p95_ms" in read:
        assert read["p95_ms"] == pytest.approx(np.percentile([10, 20, 30, 40], 95))
