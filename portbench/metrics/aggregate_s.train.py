"""Seconds of a round's aggregation: the judge (energies to theta), the
reduce and the finalize phases of the program's ``RoundTrace``, summed a
round, their mean over the phase-fenced rounds."""

PHASES = ("judge", "reduce", "reduce_scatter", "all_gather", "finalize")


def read(ctx):
    vals = [sum(p.get(k, 0.0) for k in PHASES) for p in ctx.phases
            if "judge" in p]
    return sum(vals) / len(vals) if vals else None
