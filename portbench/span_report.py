"""The program's spans in a cell's rounds on the card, read as the span
metrics read them (the benchmark's runs never run this):

    python3 portbench/span_report.py --workload <cell> --seed <n> \\
        [--rounds 1] [--cost-pairs 6] [--cost-rounds 2]

It sets up the cell's program as a benchmark run does (weights and
tokens from the seed, the check's rounds, which build and warm every
kernel), then:

* the cost of spans that record: ``--cost-pairs`` pairs of windows of
  ``--cost-rounds`` rounds, one with the spans off and one with them
  recording and no profiler, in turns (off first in even pairs), each
  window's ``train_tokens_per_s`` ending in a synchronize;
* the span rounds (``span_rounds``): ``--rounds`` rounds with the spans
  recording under a profiler of the host and the card, put down to the
  spans (``yardstick/spans.py``), and each metric of ``SPAN_METRICS``
  read from them by its ``metrics/<name>.py`` (``ctx.spans``), with the
  coverage, the operations that start before their round span, the
  device operations without a launch, and the ten longest device
  operations' seconds by span.

One JSON line on standard output. Without a CUDA card it exits 3."""
import json
import os
import statistics
import sys
import time
import types
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import runner  # noqa: E402
from portbench.yardstick import spans as sp  # noqa: E402
from portbench.yardstick import trace as tr  # noqa: E402

SPAN_METRICS = ("local_steps_busy_s.train", "local_steps_idle_s.train",
                "seam_idle_s.train", "aggregate_busy_s.train",
                "aggregate_idle_s.train", "int4_encode_busy_s.train",
                "moe_dispatch_busy_s.train", "moe_experts_busy_s.train",
                "moe_combine_busy_s.train")


def span_rounds(prog, n: int) -> sp.Attribution:
    """``n`` rounds of ``prog`` with the program's spans recording, under
    a profiler of the host and the card between two markers."""
    from repro_torch.obs import recording
    with recording(), tr.profiled(cpu=True) as prof:
        for _ in range(n):
            prog.round()
    evs = sp.events(prof)
    return sp.attribute(evs, sp.device_ops(evs), n)


def read_metrics(attr: sp.Attribution) -> dict:
    """Each metric of ``SPAN_METRICS`` as its reader gives it."""
    ctx = types.SimpleNamespace(spans=attr)
    return {m: runner.reader(m)(ctx) for m in SPAN_METRICS}


def spread(values) -> float:
    """The distance between the first and the third quartile over the
    median."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / q[1]


def cost(prog, pairs: int, rounds: int, device) -> dict:
    """``train_tokens_per_s`` of windows with the spans off and
    recording (no profiler), in turns."""
    from portbench.drivers.common import sync
    from repro_torch.obs import recording
    rates = {"off": [], "on": []}
    for i in range(pairs):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            with recording(side == "on"):
                sync(device)
                t0 = time.perf_counter()
                for _ in range(rounds):
                    prog.round()
                sync(device)
            rates[side].append(rounds * prog.tokens_per_round
                               / (time.perf_counter() - t0))
    out = {side: {"rates": v, "median": statistics.median(v),
                  "spread": spread(v)} for side, v in rates.items()}
    out["wins_off"] = sum(a > b for a, b in zip(rates["off"], rates["on"]))
    return out


def report(cell, seed: int, rounds: int, pairs: int, cost_rounds: int,
           device, log) -> dict:
    from portbench.drivers import train as drv
    from portbench.drivers.common import device_info
    from portbench.yardstick.tokens import lm_data
    t = cell.traffic
    data = lm_data(seed, t["data"], t["seq_len"],
                   cell.config["model"]["vocab_size"])
    prog = drv.Program(cell, seed, device, data)
    for r in range(t["check_rounds"]):
        prog.round()
        log(f"warm-up round {r}")
    out = {"workload": cell.name, "seed": seed}
    if pairs:
        out["cost"] = cost(prog, pairs, cost_rounds, device)
        log("cost: " + json.dumps({k: v["median"] for k, v in
                                   out["cost"].items() if k != "wins_off"}))
    attr = span_rounds(prog, rounds)
    log("span rounds")
    total = Counter()
    for name, a, b, _ in attr.ops:
        total[name[:120]] += b - a
    top = [k for k, _ in total.most_common(10)]
    out.update(
        metrics=read_metrics(attr), coverage=attr.coverage(),
        early=attr.early, unlinked=attr.unlinked, rounds=rounds,
        window_s=attr.window_s,
        busy_s={n: attr.busy_per_round(n) for n in sorted(attr.seen)},
        idle_s={n: attr.idle_per_round(n) for n in sorted(attr.seen)},
        top_ops={k: attr.kernel_s(k) for k in top},
        indexing_backward=attr.kernel_s("indexing_backward_kernel"),
        gaps=[[(g[1] - g[0]) / 1e9, sorted(g[2])] for g in
              sorted(attr.gaps, key=lambda g: g[0] - g[1])[:10]],
        device=device_info(device))
    return out


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cost-pairs", type=int, default=6)
    ap.add_argument("--cost-rounds", type=int, default=2)
    args = ap.parse_args(argv)
    runner.set_cache_env()
    cell = runner.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("span_report.py needs a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(runner.ROOT, "src"))
    out = report(cell, args.seed, args.rounds, args.cost_pairs,
                 args.cost_rounds, torch.device("cuda", 0),
                 runner.Log(time.perf_counter()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
