"""Model FLOP utilization of the traced rounds: the model operations of
their sequences (``yardstick.work.train_flops_per_sequence``: 6 per active
matrix parameter and token, top_k of n_experts and the LM head counted,
plus the causal attention products; recompute not counted) over the
traced window's time, as a percent of the bf16 data-sheet peak."""
from portbench.yardstick.peaks import BF16_FLOP_PER_S
from portbench.yardstick.work import train_flops_per_sequence


def read(ctx):
    t = ctx.traffic
    seqs = ctx.rounds * t["p"] * t["tau"] * t["b_local"]
    flops = seqs * train_flops_per_sequence(ctx.model, t["seq_len"])
    if ctx.window.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.window.window_s * BF16_FLOP_PER_S)
