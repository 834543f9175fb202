"""train.optimizer_device_ms: device time a step inside the port's
`train.optimizer` span: the learning rate set and `optimizer.step()`
(Adam, or `AdamChain` where configured), entry to exit on the stream."""

from benchmark import port_spans


def read(ctx):
    return port_spans.device_ms_per_unit(ctx, "train", "train.optimizer")
