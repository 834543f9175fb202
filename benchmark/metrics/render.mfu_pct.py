"""render.mfu_pct: the eval render's share of the card's bf16 peak: the
products the window's views need for their outputs (the view pass with
every head, real rays only, as the cell's model family counts them), over
the window."""

from benchmark import flops


def read(ctx):
    if ctx.kind != "render" or ctx.window_s <= 0:
        return None
    work = ctx.rays * ctx.family.render_flops_per_ray(ctx.config)
    return 100.0 * work / (ctx.window_s * flops.PEAK_BF16_FLOPS)
