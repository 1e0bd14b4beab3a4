"""``fused_ce_kernel``'s share of its roofline in the traced rounds: each
launch (the program's ``fused_ce_fwd.launches``) reads the float32 logits
of every worker's tokens once, (p b_local seq, padded vocab), writes nll
and lse; at the data-sheet bandwidth, over the kernel's device time."""
from portbench.yardstick.peaks import bound_s
from portbench.yardstick.work import ce_bytes, padded_vocab


def read(ctx):
    n, secs = ctx.window.kernel_time("fused_ce_kernel")
    launches = ctx.counters["fused_ce"]
    if n == 0 or secs <= 0 or launches == 0:
        return None
    t = ctx.traffic
    rows = t["p"] * t["b_local"] * t["seq_len"]
    return 100.0 * bound_s(launches * ce_bytes(rows, padded_vocab(
        ctx.model))) / secs
