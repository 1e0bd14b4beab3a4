"""Inputs and weights come from the seed alone, in the program's layout;
the work arithmetic and the trace reading give the numbers they should."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT, SMOKE
from portbench.drivers.common import port_config
from portbench.yardstick import tokens, trace, work
from portbench.yardstick.weights import make_tree, walk

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_tokens_are_determined_by_the_seed(seed):
    a = tokens.zipf_bigram(seed, 8, 50, 300)
    b = tokens.zipf_bigram(seed, 8, 50, 300)
    c = tokens.zipf_bigram(seed + 1, 8, 50, 300)
    assert a.dtype == np.int32 and a.shape == (8, 50)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 300


@pytest.mark.parametrize("kind", sorted(SMOKE))
def test_weights_are_determined_by_the_seed_in_the_programs_layout(kind):
    from repro_torch.models.transformer import abstract_params
    model = SMOKE[kind]
    a = make_tree(model, 2**33 + 1, "cpu")
    b = make_tree(model, 2**33 + 1, "cpu")
    c = make_tree(model, 2**33 + 2, "cpu")
    shapes, _ = abstract_params(port_config(model))
    want = {p: tuple(x.shape) for p, x in walk(shapes)}
    assert {p: tuple(x.shape) for p, x in walk(a)} == want
    diff = [not torch.equal(x, y) for (_, x), (_, y) in zip(walk(a), walk(c))]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(walk(a), walk(b)))
    assert sum(diff) == sum(x.dim() > 1 for _, x in walk(a))


def test_work_arithmetic():
    assert work.wagg_bytes(4, 10, 4, 0) == 4 * 10 * 8 + 16
    assert work.wagg_bytes(3, 10, 4, 1) == 3 * 10 * 9 + 12
    assert work.norm_bytes(5, 8, 2, 1) == 2 * 5 * 8 * 2 + 8 * 4 + 5 * 4
    assert work.norm_bytes(5, 8, 2, 2, fused=True) == \
        4 * 5 * 8 * 2 + 2 * 8 * 4 + 5 * 4
    assert work.ce_bytes(3, 7) == 3 * 7 * 4 + 3 * 4 + 2 * 3 * 4


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "stablelm-3b"])
def test_model_flops_match_the_programs_parameter_count(name):
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        model = json.load(f)["model"]
    cfg = port_config(model)
    d, v = cfg.d_model, cfg.padded_vocab
    norms = (3 * cfg.n_layers + 1) * d        # as param_count counts them
    # the program's count less the embedding gather and the norm scales
    assert work.active_matmul_params(model) == \
        cfg.active_param_count() - v * d - norms
    seq = 640
    causal = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq * (
        seq + 1) / 2
    assert work.train_flops_per_sequence(model, seq) == pytest.approx(
        6 * work.active_matmul_params(model) * seq + 3 * causal)


def test_trace_window_union_and_gaps():
    ms = 1_000_000
    dev = [("spin_kernel", 0, 1 * ms), ("a", 2 * ms, 5 * ms),
           ("b", 4 * ms, 6 * ms), ("Memcpy HtoD", 8 * ms, 9 * ms),
           ("a", 12 * ms, 13 * ms), ("spin_kernel", 19 * ms, 20 * ms),
           ("late", 30 * ms, 31 * ms)]
    host = [("aten::mm", 6 * ms, 12 * ms), ("aten::add", 6 * ms, 7 * ms),
            ("python", 0, 40 * ms)]
    w = trace.Window(dev, host)
    assert w.window_s == pytest.approx(0.020)
    assert w.busy_s == pytest.approx(0.006)
    assert len(w.kernels()) == 3
    assert w.kernel_time("a") == (2, pytest.approx(0.004))
    gaps = w.idle_gaps(2)
    assert gaps[0] == ["python", pytest.approx(0.007)]
    assert gaps[1] == ["aten::mm", pytest.approx(0.003)]
    assert w.top_ops(1) == [["a", pytest.approx(0.004)]]
