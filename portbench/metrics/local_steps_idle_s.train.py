"""Seconds a round the card idles while the host is inside the tau local
steps: the window's idle gaps whose midpoint falls inside the program's
``round.local_steps`` span in the unfenced span rounds, their mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.idle_per_round("round.local_steps")
