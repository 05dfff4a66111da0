"""One run of one cell: set-up, the measured window, the traced readings
and the comparison with the plain reference.

``run.py`` calls ``run_cell`` after it has found the card; a test calls it
with ``device="cpu"`` (the port's plain versions) at a small size.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent
CHECKOUT = PORTBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dask_array_tpu")
WARM_REQUESTS = 2  # the first loads (or builds) the kernels, the second runs as the window's will


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """The module in ``path``, loaded under a name of its own."""
    name = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """Everything ``BENCHMARK.json`` names for one workload, found by name."""

    def __init__(self, name: str):
        bench = load_json(CHECKOUT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.cfg = load_json(CHECKOUT / self.config_entry["file"])
        self.mix = load_json(PORTBENCH / "mixes" / f"{self.entry['traffic']}.json")
        self.limits = load_json(PORTBENCH / "limits" / f"{name}.json")
        reference = self.cfg.get("reference", self.entry["config"])
        self.reference = load_module(PORTBENCH / "reference" / f"{reference}.py", "reference")

        def mine(metric):
            return name in metric.get("workloads", (name,))

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric: dict, kind: str):
        return load_module(PORTBENCH / kind / f"{metric['name']}.py", kind)


class Window:
    """What the measured window left: the latency of every request that
    completed, the window's seconds, the peak, the set-up time."""

    def __init__(self, latencies, seconds, must_move_bytes, peak_bytes, setup_s):
        self.latencies = latencies
        self.seconds = seconds
        self.must_move_bytes = must_move_bytes
        self.peak_bytes = peak_bytes
        self.setup_s = setup_s


class Reading:
    """What a per-layer reader reads: the traced window's requests, their
    host spans (seconds a request, by layer) and the device trace."""

    def __init__(self, cfg, traffic, requests, spans, trace):
        self.cfg = cfg
        self.traffic = traffic
        self.requests = requests
        self.spans = spans
        self.trace = trace


def make_field(cfg: dict, seed: int, device: str):
    """The field, standard normal in the configuration's dtype, made on
    ``device`` from ``seed`` with a generator there, in one call."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    return torch.randn(tuple(cfg["shape"]), generator=gen, device=device, dtype=getattr(torch, cfg["dtype"]))


def hold(da, field, cfg: dict):
    """The field handed to the port and held on its device: one block
    made by a loader, cut into the configuration's chunks, persisted.
    ``from_array`` takes no CUDA tensor (it reads its source through numpy),
    so the loader hands it over as it is; afterwards only the port holds
    it."""
    import numpy as np

    box = [field]
    x = da.from_delayed(lambda: box[0], tuple(cfg["shape"]), dtype=np.dtype(cfg["dtype"]))
    x = x.rechunk(tuple(cfg["chunks"])).persist()
    box.clear()
    return x


@contextlib.contextmanager
def layer_spans(current: dict, on: bool):
    """Wrap the optimizer and the executor as ``_materialize`` calls them,
    each call adding its host seconds to ``current["spans"]`` and showing
    in a trace as ``portbench.optimize`` / ``portbench.walk``."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    from dask_array_tpu_torch import _materialize

    def wrap(fn, layer):
        def timed(*args, **kwargs):
            with record_function(f"portbench.{layer}"):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    current["spans"][layer] += time.perf_counter() - t0

        return timed

    saved = {n: getattr(_materialize, n) for n in ("optimize_expr", "execute_views", "execute_many")}
    _materialize.optimize_expr = wrap(saved["optimize_expr"], "optimize")
    _materialize.execute_views = wrap(saved["execute_views"], "walk")
    _materialize.execute_many = wrap(saved["execute_many"], "walk")
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(_materialize, n, fn)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, cfg_override: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``cfg_override`` replaces configuration keys (a test's small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name)
    cfg = dict(cell.cfg, **(cfg_override or {}))

    import torch

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import _hostcopy, _streaming, config

    from portbench import check
    from portbench.traffic import Traffic
    from portbench.trace import WINDOW, Trace

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    traffic = Traffic(cell.mix, cfg)
    plan = check.Plan(seed, cfg["shape"], cfg["chunks"])
    current = {"spans": {"build": 0.0, "optimize": 0.0, "walk": 0.0}}
    marks = [("imports", time.perf_counter())]
    with config.set({"device": device}):
        field = make_field(cfg, seed, device)
        sync()
        marks.append(("field", time.perf_counter()))
        field_nbytes = field.numel() * field.element_size()
        x = hold(da, field, cfg)
        del field
        sync()
        marks.append(("hold", time.perf_counter()))
        for _ in range(WARM_REQUESTS):
            outs = traffic.request(da, x, sync, current["spans"])
            check.keep(plan, min(plan.requests), False, traffic.ops, outs)  # warms the sampled rows' gather
            del outs
            sync()
            marks.append(("warm request", time.perf_counter()))
        gc.collect()
        prev = t_start
        phases = []
        for what, t in marks:
            phases.append(f"{what} {t - prev:.3f}")
            prev = t
        log("set-up s: " + ", ".join(phases))

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=activities)
            prof.start()
        copies0 = dict(_hostcopy.COPIES)
        streamed0 = dict(_streaming.STREAMED)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        latencies, spans, kept = [], [], []
        attempted = failed = 0
        window = record_function(WINDOW) if trace else contextlib.nullcontext()
        with layer_spans(current, trace), window:
            t_w0 = time.perf_counter()
            while True:
                attempted += 1
                current["spans"] = {"build": 0.0, "optimize": 0.0, "walk": 0.0}
                t0 = time.perf_counter()
                try:
                    outs = traffic.request(da, x, sync, current["spans"])
                except Exception as exc:  # noqa: BLE001 - a failed request is counted, and the run goes on
                    log(f"request {attempted - 1} failed: {type(exc).__name__}: {exc}")
                    failed += 1
                    outs = None
                t1 = time.perf_counter()
                last = t1 - t_w0 >= seconds
                if outs is not None:
                    latencies.append(t1 - t0)
                    spans.append(current["spans"])
                    kept += check.keep(plan, attempted - 1, last, traffic.ops, outs)
                del outs
                if last or failed >= 3:
                    break
            window_s = time.perf_counter() - t_w0
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if latencies:
            from portbench.yardstick import percentile

            ms = [t * 1e3 for t in latencies]
            log(f"window: {len(ms)} requests in {window_s!r} s; latency ms p5 {percentile(ms, 5)!r} "
                f"p50 {percentile(ms, 50)!r} p95 {percentile(ms, 95)!r} max {max(ms)!r}")
        h2d = _hostcopy.COPIES["h2d_bytes"] - copies0["h2d_bytes"]
        streamed = _streaming.STREAMED["count"] - streamed0["count"]
        untouched = h2d < field_nbytes and streamed == 0
        log(f"field check: {h2d} bytes copied to the card and {streamed} streamed computes in the window "
            f"(the field is {field_nbytes} bytes): {'held on the card' if untouched else 'NOT held on the card'}")

        forbidden = forbidden_modules()
        if forbidden:
            raise ForbiddenImport(forbidden)

        result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}, "device": {}}
        if cuda:
            result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": cell.entry["chips"], "memory_peak_bytes": peak}
        else:
            result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}

        if trace:
            tr = Trace(prof) if cuda else None
            del prof
            totals = {k: [s[k] for s in spans] for k in ("build", "optimize", "walk")}
            reading = Reading(cfg, traffic, len(latencies), totals, tr)
            for metric in cell.per_layer:
                value = cell.reader(metric, "metrics").read(reading)
                if value is not None:
                    result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
            if tr is not None:
                result["device"]["busy_s"] = tr.busy_s
                result["device"]["window_s"] = tr.window_s
                result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        elif latencies:
            w = Window(latencies, window_s, traffic.must_move_bytes(), peak, setup_s)
            for metric in cell.end_to_end:
                value = cell.reader(metric, "end_to_end").read(w)
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}

        # the program's state goes before the reference runs
        del x
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        field = make_field(cfg, seed, device)
        found = check.gaps(kept, field, cfg, cell.reference)
        del kept, field
        expected = list(dict.fromkeys(f"{op['name']}_gap" for op in traffic.ops))
        correct, lines = check.verdict(found, cell.limits, expected, failed)
        lines.append(("failed_requests", failed, 0))
        result["correct"] = correct
        # a gap that is no number (an answer missing, or NaN where the
        # reference has none) goes out as null
        result["checks"] = {n: {"value": v if v != float("inf") else None, "limit": lim} for n, v, lim in lines}
        for n, v, lim in lines:
            log(f"check {n}: {v!r} limit {lim!r} {'ok' if v <= lim else 'OVER'}")
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package are loaded: " + ", ".join(names))
        self.names = names

