"""The port's own spans (`spnerf_torch.spans`), as the per-layer metrics
read them. The port keeps spans only while a profiler records, so in a
`--trace 1` run they are the measured window's.

Nothing here imports the port: `totals` reads the span module the program
under test loaded, and finds nothing where it has none (a checkout older
than its spans), so each reader returns None there.
"""

import sys

MODULE = "spnerf_torch.spans"


def totals():
    """The port's `spans.totals()`: {name: {"n", "device_s", "host_s",
    ...}}; {} where the program loaded no span module."""
    module = sys.modules.get(MODULE)
    return {} if module is None else module.totals()


def device_ms_per_unit(ctx, kind, name):
    """1e3 x the device seconds of the spans `name` over the window's steps
    or views, in a run of traffic kind `kind`; None where no such span was
    timed on the device."""
    if ctx.kind != kind or not ctx.units:
        return None
    t = totals().get(name)
    if not t or t["device_s"] is None:
        return None
    return 1e3 * t["device_s"] / ctx.units
