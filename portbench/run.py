"""The benchmark of the PyTorch port (``src/repro_torch``) on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: it makes
the cell's weights and inputs from ``--seed``, sets up and warms the
program, measures for ``--seconds`` (``--trace 1``: a profiled window
that gives the per-layer metrics instead of the end-to-end ones), checks
what the window's path produced against a plain PyTorch reference, and
prints one JSON line. It exits non-zero, printing no result, without
enough CUDA cards or when JAX or the JAX package was loaded."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import runner  # noqa: E402


def main(argv=None) -> int:
    runner.set_cache_env()
    args = runner.parse(argv)
    cell = runner.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(runner.ROOT, "src"))
    out = runner.driver(cell.traffic["kind"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        t_start=T_START, device=torch.device("cuda", 0))
    bad = runner.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 4
    runner.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
