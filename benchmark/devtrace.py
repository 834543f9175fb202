"""Reading a `torch.profiler` trace of the measured window: device operation
intervals, the device's busy time (the union of its intervals), kernel
classes, and the breakdown of device time and idle gaps.

`classify` and `busy_s` are frozen copies of the port's
`utils/profile_step.py` `classify` / `busy_us` arithmetic (matrix-product
names extended by cuBLAS's Hopper kernels, `nvjet`, and its split-K and
matrix-vector kernels).
"""

import heapq
from dataclasses import dataclass, field

import torch

WINDOW = "benchmark.window"  # the record_function around the measured window

CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("port: dtab", ("dtab_scatter", "slice_", "tile_agg")),
    ("port: field_eval", ("field_eval",)),
    ("sort", ("radix", "Sort", "sort")),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "Gemm", "nvjet", "gemv",
                "splitK")),
    ("index / scatter / gather", ("index", "scatter", "gather", "Index")),
    ("reduce", ("reduce", "Reduce", "scan", "Scan")),
)


def classify(name):
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise and other"


def busy_s(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclass
class Trace:
    """The window's device operations and host operations, in seconds on
    the profiler's clock: (name, start, end) each."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def busy_s(self):
        return busy_s([(s, e) for _, s, e in self.device])

    def device_s(self, keep):
        """Device seconds of the operations whose name `keep` accepts."""
        return sum(e - s for n, s, e in self.device if keep(n))


def _events(prof):
    """(name, is_device, start_s, end_s) of every recorded event."""
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            start = e.start_ns() * 1e-9
            yield (e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
                   start, start + e.duration_ns() * 1e-9)
        return
    for e in prof.events():
        yield (e.name, e.device_type == torch.autograd.DeviceType.CUDA,
               e.time_range.start * 1e-6, e.time_range.end * 1e-6)


def read(prof):
    """The Trace of a finished profile whose window is a WINDOW record."""
    tr = Trace()
    for name, on_device, s, e in _events(prof):
        if name == WINDOW:
            if not on_device:
                tr.window = (s, e)
        elif on_device:
            tr.device.append((name, s, e))
        else:
            tr.host.append((name, s, e))
    return tr


def gaps(trace):
    """Idle stretches of the device in the window: (start, length)."""
    w0, w1 = trace.window
    out, cur = [], w0
    for s, e in sorted((s, e) for _, s, e in trace.device):
        if s > cur:
            out.append((cur, s - cur))
        cur = max(cur, e)
    if w1 > cur:
        out.append((cur, w1 - cur))
    return out


def idle_by_host_op(trace):
    """Idle seconds by the innermost host operation running when each gap
    began (the latest-started one still open); "host python" where only the
    window's own record was open."""
    events = sorted((s, e, n) for n, s, e in trace.host)
    open_, i, total = [], 0, {}
    for start, length in sorted(gaps(trace)):
        while i < len(events) and events[i][0] <= start:
            s, e, n = events[i]
            heapq.heappush(open_, (-s, e, n))
            i += 1
        while open_ and open_[0][1] < start:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else "host python"
        total[name] = total.get(name, 0.0) + length
    return total


def breakdown(trace, top=10):
    """The device operations that took most time, and the idle seconds by
    host operation, `top` of each, as [name, seconds] pairs."""
    by_op = {}
    for n, s, e in trace.device:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(idle_by_host_op(trace).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], t] for n, t in ops],
            "idle_gaps": [[n[:160], t] for n, t in idle]}
