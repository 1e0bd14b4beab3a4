"""Seconds a round the card is busy with the aggregate: the union of the
device operations put down to the program's ``round.aggregate`` span
(theta, every leaf's encode, the Eq. 10 kernel, the state's assembly) in
the unfenced span rounds, their mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.busy_per_round("round.aggregate")
