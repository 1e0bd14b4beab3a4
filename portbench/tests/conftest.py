"""Shared pieces of the benchmark's CPU tests: the repository root and
``src`` on the path, smoke-size cells built in memory, and the ``card``
marker for tests that need a CUDA card (they skip here, deciding inside
the test)."""
import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import runner  # noqa: E402

SMOKE = {
    "moe": {"name": "olmoe-smoke", "family": "moe", "n_layers": 2,
            "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
            "d_ff": 0, "vocab_size": 256, "rope_theta": 10000.0,
            "norm_eps": 1e-5,
            "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 32,
                    "capacity_factor": 2.0, "load_balance_loss": 0.01,
                    "router_z_loss": 0.001},
            "moe_every": 1, "remat": True},
    "dense": {"name": "stablelm-smoke", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
              "d_ff": 96, "vocab_size": 256, "rope_theta": 10000.0,
              "norm_eps": 1e-5, "remat": True},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


def smoke_cell(kind: str, traffic_name: str, limits_of: str,
               compute_dtype: str = "float32", **traffic_over):
    """A cell of the benchmark's own traffic and limits files at a smoke
    size: ``kind`` "moe" or "dense"."""
    here = os.path.join(ROOT, "portbench")
    traffic = runner.load_json(here, "traffic", traffic_name + ".json")
    traffic = copy.deepcopy(traffic)
    if traffic["kind"] == "train":
        traffic.update(seq_len=32, data={**traffic["data"], "n_seq": 32})
    traffic.update(traffic_over)
    model = {**copy.deepcopy(SMOKE[kind]), "compute_dtype": compute_dtype}
    bench = runner.load_json(ROOT, "BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]]
    return runner.Cell(
        name="smoke", chips=1, config={"model": model}, traffic=traffic,
        limits=runner.load_json(here, "limits", limits_of + ".json"),
        end_to_end=e2e, per_layer=[])


def read_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
