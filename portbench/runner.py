"""What every cell's run shares: the command line, the caches inside the
checkout, finding a cell's files by the names in ``BENCHMARK.json``, the
per-layer metric readers, the checks that decide ``correct``, and the
result line.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix's ``kind`` names the driver
(``drivers/<kind>.py``) that runs it; ``limits/<cell>.json`` holds the
limits of the numbers the cell's check compares; each per-layer metric
is read by ``metrics/<metric>.py``. A new cell, configuration, mix or
metric is new files and new entries, never an edit."""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")

# top-level module names that must not be loaded by a run: JAX and the
# JAX package the program was ported from (compared whole: the program's
# own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a checkout's first run builds; libraries that could load
    JAX by themselves are told not to."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv_compute")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(*parts: str) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""
    name: str
    chips: int
    config: Dict                # configs/<config>.json
    traffic: Dict               # traffic/<traffic>.json
    limits: Dict                # limits/<cell>.json
    end_to_end: List[Dict]      # the end-to-end metrics the cell reports
    per_layer: List[Dict]       # the per-layer metrics the cell reports


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[Dict] = None,
              root: str = ROOT) -> Cell:
    bench = bench or load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if m["moves"] in names and _reports(m, name)]
    here = os.path.join(root, "portbench")
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(here, "configs", w["config"] + ".json"),
                traffic=load_json(here, "traffic", w["traffic"] + ".json"),
                limits=load_json(here, "limits", name + ".json"),
                end_to_end=e2e, per_layer=per)


def reader(metric: str, root: str = ROOT) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit; a number that is missing
    or not finite fails."""
    return {k: {"value": values.get(k, float("nan")), "limit": lim}
            for k, lim in limits.items()}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


class Log:
    """Progress lines on standard error, seconds since the process
    started."""

    def __init__(self, t_start: float):
        self.t_start = t_start

    def __call__(self, msg: str) -> None:
        import time
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {msg}",
              file=sys.stderr, flush=True)


def emit(result: Dict, checks: Dict[str, Dict[str, float]]) -> None:
    """The checks as the last lines of standard error, and the result as
    the last line of standard output with the checks last."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()
