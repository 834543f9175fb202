"""render.outside_b1_device_ms: device time a view in operations other than
the field kernel B1 (whose kernels are named field_eval*): sampling,
sorting, compositing, the per-ray outputs and their copies."""


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "render" or tr is None or not tr.device or not ctx.units:
        return None
    s = ctx.trace.device_s(lambda n: "field_eval" not in n)
    return 1e3 * s / ctx.units
