"""Seconds a round the card is busy routing tokens to the experts: the
union of the device operations put down to the program's ``moe.route``
(router, top-k, aux losses, slot ranks) and ``moe.dispatch`` (the gather
into the (E, C, d) slot table) spans, forward, recompute and backward,
in the unfenced span rounds, their mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.busy_per_round(
        "moe.route", "moe.dispatch")
