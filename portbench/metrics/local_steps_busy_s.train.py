"""Seconds a round the card is busy with the tau local steps: the union
of the device operations put down to the program's ``round.local_steps``
span (forward, remat's recompute, backward, update, energies) in the
unfenced span rounds (``yardstick/spans.py``), their mean."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.busy_per_round("round.local_steps")
