"""train.nonmatmul_device_ms: device time a step in operations outside the
matrix products (activations, casts, losses, Adam), by the frozen kernel
classes of benchmark/devtrace.py."""

from benchmark import devtrace


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "train" or tr is None or not tr.device or not ctx.units:
        return None
    s = ctx.trace.device_s(lambda n: devtrace.classify(n) != "matmul")
    return 1e3 * s / ctx.units
