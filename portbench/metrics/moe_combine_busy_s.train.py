"""Seconds a round the card is busy combining the experts' outputs: the
union of the device operations put down to the program's ``moe.combine``
span (the gather back out of the slot table and the gate weighting),
forward, recompute and backward, in the unfenced span rounds, their
mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.busy_per_round("moe.combine")
