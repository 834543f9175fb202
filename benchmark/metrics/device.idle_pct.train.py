"""device.idle_pct.train: the share of the traced window in which no
operation ran on the device (one minus the union of the device's operation
intervals over the window), in train cells."""


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "train" or tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
