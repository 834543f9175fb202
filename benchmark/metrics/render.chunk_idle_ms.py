"""render.chunk_idle_ms: idle device time a view that began while the host
was inside one of the port's `render.chunk` spans (a chunk's
`render_rays` and its lean outputs): the trace's idle gaps whose start
falls inside a host `render.chunk` record, over the window's views. The
rest of the view's idle time began outside the chunk loop."""

import bisect

from benchmark import devtrace

SPAN = "render.chunk"


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "render" or tr is None or not ctx.units:
        return None
    chunks = sorted((s, e) for n, s, e in tr.host if n == SPAN)
    if not chunks:
        return None
    starts = [s for s, _ in chunks]
    idle = 0.0
    for start, length in devtrace.gaps(tr):
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start <= chunks[i][1]:
            idle += length
    return 1e3 * idle / ctx.units
