"""train.mfu_pct: the train step's share of the card's bf16 peak: three
times the forward products of every ray the window trained (the view pass
with every head, the solar pass with the sun head, as the cell's model
family counts them), over the window."""

from benchmark import flops


def read(ctx):
    if ctx.kind != "train" or ctx.window_s <= 0:
        return None
    work = ctx.rays * ctx.family.train_flops_per_ray(ctx.config)
    return 100.0 * work / (ctx.window_s * flops.PEAK_BF16_FLOPS)
