"""Seconds a round the card idles at the round's seam on the host: the
idle gaps whose midpoint falls inside the program's ``round.stage`` (the
next batch and its copy to the card) or ``round.readback`` (the metrics
read back, the Judge scores recorded) spans in the unfenced span rounds,
their mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.idle_per_round(
        "round.stage", "round.readback")
