"""``wagg_fused_kernel``'s share of its roofline in the traced rounds: the
bytes of every round's Eq. 10 aggregate (each worker leaf's x read once
and written once, the codec's payload read once) at the data-sheet
bandwidth, over the kernel's device time."""
from portbench.yardstick.peaks import bound_s
from portbench.yardstick.work import wagg_bytes

PAYLOAD_BYTES = {"f32": 0, "bf16": 2, "int8": 1, "int4": 1}


def read(ctx):
    n, secs = ctx.window.kernel_time("wagg_fused_kernel")
    if n == 0 or secs <= 0:
        return None
    t = ctx.traffic
    q = PAYLOAD_BYTES[t["backend"].split(":")[1]]
    per_round = sum(wagg_bytes(t["p"], size, 4, q)
                    for size in ctx.worker_leaf_sizes)
    return 100.0 * bound_s(ctx.rounds * per_round) / secs
