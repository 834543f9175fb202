"""train.forward_device_ms: device time a step inside the port's
`train.forward` span: the forward render of the batch and the losses
(`Trainer.loss_fn`), entry to exit on the stream."""

from benchmark import port_spans


def read(ctx):
    return port_spans.device_ms_per_unit(ctx, "train", "train.forward")
