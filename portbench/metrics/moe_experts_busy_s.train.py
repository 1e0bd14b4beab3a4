"""Seconds a round the card is busy with the expert products: the union
of the device operations put down to the program's ``moe.experts`` span
(the three ``ExpertMatmul`` products and the SiLU), forward, recompute
and backward, in the unfenced span rounds, their mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.busy_per_round("moe.experts")
