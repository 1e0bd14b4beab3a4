"""Seconds of a round's tau local steps (gradients, update, energies):
the program's ``RoundTrace.phases["local_steps"]`` of the phase-fenced
rounds, their mean."""


def read(ctx):
    vals = [p["local_steps"] for p in ctx.phases if "local_steps" in p]
    return sum(vals) / len(vals) if vals else None
