"""render.field_inputs_device_ms: device time a view inside the port's
`field.inputs` spans: the fused field's inputs at every call (the
positional mapping, the semantic embedding, the float casts), entry to
exit on the stream."""

from benchmark import port_spans


def read(ctx):
    return port_spans.device_ms_per_unit(ctx, "render", "field.inputs")
