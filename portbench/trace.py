"""Reading the ``torch.profiler`` trace of a traced run.

The traced window is one ``record_function`` span on the host
(``WINDOW``); the device's operations (kernels, copies, sets) are the
trace's events whose device type is CUDA, on the same microsecond clock.
The port's hand kernels are known by the names of their ``__global__``
functions in ``dask_array_tpu_torch/csrc/``.
"""

from __future__ import annotations

import re

WINDOW = "portbench.window"

# the port's hand kernels, by the ``__global__`` names of csrc/*.cu(h)
HAND_KERNELS = {
    "k1": ("band_stencil_window16", "band_stencil_window", "band_stencil_taps", "band_stencil_program"),
    "halo": ("halo_pad_strided", "halo_pad_rows"),
    "p4": ("mstat_main", "mstat_finish"),
    "p3t": ("transpose_tiles",),
    "p3c": ("scale_flat",),
    "k2": ("hist_main", "hist_finish", "hist_patterns", "pattern_finish", "hist_bytes", "bytes_finish"),
    "k3": ("scan_ring", "scan_row_batches", "step_chain"),
}
_PATTERNS = {
    key: re.compile(r"(?<![\w])(" + "|".join(names) + r")(?![\w])") for key, names in HAND_KERNELS.items()
}


def hand_kernel(name: str):
    """The key of the port's hand kernel ``name`` is, or None."""
    for key, pattern in _PATTERNS.items():
        if pattern.search(name):
            return key
    return None


class Trace:
    """The device's operations and the host's spans inside the window, in
    microseconds."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = list(prof.events())
        windows = [e for e in events if e.name == WINDOW]
        if not windows:
            raise RuntimeError("the traced window's span is missing from the trace")
        self.w0 = min(e.time_range.start for e in windows)
        self.w1 = max(e.time_range.end for e in windows)
        self.device = []
        self.host = []
        for e in events:
            t0, t1 = e.time_range.start, e.time_range.end
            if t1 <= self.w0 or t0 >= self.w1:
                continue
            t0, t1 = max(t0, self.w0), min(t1, self.w1)
            if e.device_type == DeviceType.CUDA:
                # a host span also shows on the device's timeline as an
                # annotation: it is no operation
                if not (getattr(e, "is_user_annotation", False) or e.name.startswith("portbench.")):
                    self.device.append((e.name, t0, t1))
            elif e.device_type == DeviceType.CPU and e.name != WINDOW:
                self.host.append((e.name, t0, t1))
        self.device.sort(key=lambda d: d[1])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device's operations, as sorted (t0, t1)."""
        merged = []
        for _, t0, t1 in self.device:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals()) * 1e-6

    def seconds(self, key=None, other=False) -> float:
        """Device seconds of hand kernel ``key``, or with ``other`` of every
        operation that is none of the port's hand kernels."""
        total = 0.0
        for name, t0, t1 in self.device:
            k = hand_kernel(name)
            if (other and k is None) or (not other and k == key):
                total += t1 - t0
        return total * 1e-6

    def launches(self, name: str) -> int:
        """How many device operations in the window are the kernel
        ``name`` (a ``__global__`` name, matched whole)."""
        pattern = re.compile(r"(?<![\w])" + re.escape(name) + r"(?![\w])")
        return sum(1 for n, _, _ in self.device if pattern.search(n))

    def top_ops(self, n=10) -> list:
        by = {}
        for name, t0, t1 in self.device:
            by[name] = by.get(name, 0.0) + (t1 - t0) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10) -> list:
        """The longest gaps in the device's work, each named by the
        innermost host span around its middle ("host idle" where none)."""
        gaps = []
        prev = self.w0
        for t0, t1 in self.busy_intervals():
            if t0 > prev:
                gaps.append((prev, t0))
            prev = max(prev, t1)
        if self.w1 > prev:
            gaps.append((prev, self.w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:n]:
            mid = (g0 + g1) / 2
            around = sorted((t1 - t0, name) for name, t0, t1 in self.host if t0 <= mid <= t1)
            layer = next((name for _, name in around if name.startswith("portbench.")), "portbench.other")
            op = next((name for _, name in around if not name.startswith("portbench.")), None)
            out.append([f"{layer}: {op}" if op else layer, (g1 - g0) * 1e-6])
        return out
