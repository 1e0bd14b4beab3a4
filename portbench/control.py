"""The controls of the check that decides ``correct``, run on the card at
a cell's own size (the benchmark's runs never run them):

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--fault half_batch|no_aggregate]

A training cell's control is the float32 reference put in the program's
place and computed in the precision below the configuration's bfloat16
(``fp8``: every matrix product's operands and result, and every
activation the program keeps in its compute dtype, rounded to float8
e4m3), or with one of the check's faults planted (``--fault``). Its
rounds are compared with the float32 reference's exactly as the
program's are and judged against the cell's limits: a control that the
check catches comes out ``"correct": false``. One JSON line a seed, with
each number beside its limit and the numbers the check does not
compare."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import runner  # noqa: E402


def train_control(cell, seed: int, device, precision: str = "fp8",
                  fault=None):
    """The control's numbers against the float32 reference."""
    from portbench.drivers import train as drv
    from portbench.yardstick.tokens import lm_data
    t = cell.traffic
    data = lm_data(seed, t["data"], t["seq_len"],
                   cell.config["model"]["vocab_size"])
    ref = drv.reference_numbers(cell, seed, device, data)
    ctrl = drv.reference_numbers(cell, seed, device, data,
                                 precision="f32" if fault else precision,
                                 fault=fault, codec_draws="control codec")
    return drv.compare(ctrl, ref, t["check_rounds"])


def judged(cell, numbers):
    """(the checks of the numbers the cell compares, ``correct``)."""
    from portbench.drivers import train as drv
    checks = runner.judge(drv.compared(numbers), cell.limits)
    return checks, runner.is_correct(checks)


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half_batch", "no_aggregate"))
    args = ap.parse_args(argv)
    runner.set_cache_env()
    cell = runner.find_cell(args.workload)
    sys.path.insert(0, os.path.join(runner.ROOT, "src"))
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = train_control(cell, seed, dev, fault=args.fault)
        checks, correct = judged(cell, numbers)
        later = {k: v for k, v in numbers.items()
                 if k.startswith("later_") and not k.endswith("_worst")}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "fp8",
                          "correct": correct, "checks": checks, **later,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
