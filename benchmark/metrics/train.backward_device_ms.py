"""train.backward_device_ms: device time a step inside the port's
`train.backward` span: `zero_grad` and `loss.backward()`, every backward
kernel on the step's stream, entry to exit."""

from benchmark import port_spans


def read(ctx):
    return port_spans.device_ms_per_unit(ctx, "train", "train.backward")
