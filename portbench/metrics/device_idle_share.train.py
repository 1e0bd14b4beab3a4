"""Percent of the traced window (between its marker kernels, on the
card's clock) in which no device operation ran: 1 minus the union of the
operations' intervals over the window."""


def read(ctx):
    w = ctx.window
    if w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
