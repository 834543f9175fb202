"""hash.encode_device_ms: device time a step or view inside the port's
`hash.encode` spans: the hash-grid encoding's lookup and interpolation at
every field call (the corner ids, the table gathers, the lerps, the levels'
concatenation), entry to exit on the stream, over the run's own kind of
unit."""

from benchmark import port_spans


def read(ctx):
    return port_spans.device_ms_per_unit(ctx, ctx.kind, "hash.encode")
