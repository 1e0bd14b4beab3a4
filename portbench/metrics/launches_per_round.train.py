"""Device kernels (copies and fills left out) a round, from the profiled
rounds of the trace."""


def read(ctx):
    n = len(ctx.window.kernels())
    return n / ctx.rounds if n else None
