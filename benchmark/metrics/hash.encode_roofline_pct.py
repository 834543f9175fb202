"""hash.encode_roofline_pct: the hash-grid encoding's share of its
roofline: the least time the H100 could take for the points it encoded in
the window (the larger of its interpolation's operations at the float32
peak and each point's position read and features written once at the HBM
peak, as the cell's model family counts them), over the device time of the
port's `hash.encode` spans. The points come from the port's counter, where
the family counts them; no table read is counted."""

from benchmark import flops, port_spans

SPAN = "hash.encode"
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def read(ctx):
    points = (ctx.field_points or {}).get(SPAN)
    work = getattr(ctx.family, "encode_work", None)
    spans = port_spans.totals().get(SPAN)
    if not points or work is None or not spans or not spans["device_s"]:
        return None
    ops, nbytes = work(ctx.config["model"], points,
                       ctx.config["render"]["compute_dtype"])
    least = max(ops / PEAK_F32_FLOPS,
                nbytes / flops.PEAK_HBM_BYTES)
    return 100.0 * least / spans["device_s"]
