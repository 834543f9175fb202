"""b1.roofline_pct: the field kernel B1's share of its roofline: the least
time the H100 could take for the field calls it was handed (the larger of
their products at the bf16 peak and their inputs, outputs and weights moved
once at the HBM peak), over the device time of kernels named field_eval*.
The points come from the window's field calls by head set, where the
cell's model family counts them, and the work from the family's count."""

from benchmark import flops


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "render" or tr is None or not ctx.field_points:
        return None
    kernel_s = tr.device_s(lambda n: "field_eval" in n)
    if kernel_s <= 0:
        return None
    model = ctx.config["model"]
    dtype = ctx.config["render"]["compute_dtype"]
    least = 0.0
    for heads, points in ctx.field_points.items():
        ops, nbytes = ctx.family.field_call_work(model, points, heads, dtype)
        least += max(ops / flops.PEAK_BF16_FLOPS,
                     nbytes / flops.PEAK_HBM_BYTES)
    return 100.0 * least / kernel_s
