"""Named spans of the port's work, read while a `torch.profiler` session
records:

    with span("render.chunk"):
        ...

With no profiler recording, `span` returns one shared no-op context: the
check of the profiler's state is all it costs (a few hundred ns), and it
records nothing, allocates nothing and calls nothing on the device.

While a profiler records (any `torch.profiler.profile` session), a span

- opens a host record of its name (`_RecordFunctionFast`): a CPU operation
  in the trace, on the trace's own clock. Unlike `record_function`'s user
  annotations, which kineto mirrors onto the device timeline as
  `gpu_user_annotation` events from the first to the last kernel launched
  inside them, it has no device copy, so no device operation of the trace
  carries a span's name;
- where CUDA is initialised, records a timing event on the current stream
  at entry and another at exit, without synchronising;
- is kept, with the name of the span it opened inside, until `reset()`.

`totals()`, once the caller has synchronised the device, gives each name's
count, device seconds and host seconds. A span's device seconds are the
stream's time from its entry event to its exit event: the work the stream
ran in between, and any stretch in which it waited for the host inside the
span, count. Nested spans' times overlap their parent's. The device's idle
time is measured from the trace, not from spans.

The spans, each read by a per-layer metric of the benchmark:
`train.forward`, `train.backward`, `train.optimizer` (`Trainer`),
`render.chunk` (`render_image`), `render.solar` (`render_rays`'s solar
passes), `field.inputs` (`FusedField.inputs`), `hash.encode`
(`HashGridEncoding.forward`).
"""

import threading
import time
from contextlib import nullcontext

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = nullcontext()  # the span of every name while no profiler records
# process-wide, as the profiler's own record is: the benchmark reads the
# spans of the program it drives without a handle into it
_kept = []  # [name, parent, host s, (entry, exit) events or device s]


class _Thread(threading.local):
    def __init__(self):
        self.open = []  # this thread's open span names, innermost last


_thread = _Thread()


class _Span:
    __slots__ = ("name", "parent", "record", "events", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.record = _RecordFunctionFast(self.name)
        self.record.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack = _thread.open
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record()
        _thread.open.pop()
        _kept.append([self.name, self.parent, host_s, self.events])
        self.record.__exit__(*exc)
        return False


def span(name):
    """A context manager around the work of span `name`: see the module's
    doc."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def totals():
    """{name: {"n": spans, "device_s": summed entry-to-exit stream seconds
    (None where no span of the name was timed on a device), "host_s":
    summed host seconds, "parents": the names of the spans they opened
    inside (None at the top)}} of the spans kept since the last `reset()`.
    Call it once the device is synchronised; it clears nothing."""
    out = {}
    for kept in _kept:
        name, parent, host_s, device = kept
        if isinstance(device, tuple):
            device[1].synchronize()
            device = kept[3] = device[0].elapsed_time(device[1]) * 1e-3
        t = out.setdefault(name, {"n": 0, "device_s": None, "host_s": 0.0,
                                  "parents": []})
        t["n"] += 1
        t["host_s"] += host_s
        if device is not None:
            t["device_s"] = (t["device_s"] or 0.0) + device
        if parent not in t["parents"]:
            t["parents"].append(parent)
    return out


def reset():
    """Forget the kept spans."""
    _kept.clear()
