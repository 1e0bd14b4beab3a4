"""``rmsnorm_kernel``'s share of its roofline in the traced rounds, both
entries: each launch (``rmsnorm_fwd.launches`` counts them all) reads x
and writes y, each fused one (``add_rmsnorm_fwd.launches``) also reads
the residual and writes the sum; every worker's rows in one launch (bf16, a scale row
a worker); at the data-sheet bandwidth, over the kernel's device time."""
from portbench.yardstick.peaks import bound_s
from portbench.yardstick.work import norm_bytes


def read(ctx):
    n, secs = ctx.window.kernel_time("rmsnorm_kernel")
    fused = ctx.counters["rmsnorm_fused"]
    plain = ctx.counters["rmsnorm"] - fused
    if n == 0 or secs <= 0 or plain + fused == 0:
        return None
    t, d = ctx.traffic, ctx.model["d_model"]
    rows = t["p"] * t["b_local"] * t["seq_len"]
    total = (plain * norm_bytes(rows, d, 2, t["p"])
             + fused * norm_bytes(rows, d, 2, t["p"], fused=True))
    return 100.0 * bound_s(total) / secs
