"""The check that decides ``correct``, on the CPU at smoke sizes: the
reference agrees with the program's plain path where both compute in
float32, a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have, and so does the control."""
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, smoke_cell
from portbench import runner
from portbench.drivers import train as train_driver
from portbench.yardstick.tokens import lm_data

TRAIN = [("moe", "wasgd_p4_tau4_seq640_f32", "olmoe_train"),
         ("dense", "wasgd_p3_tau4_seq640_int4", "stablelm3b_train_int4")]


def cell_limits(name):
    return runner.load_json(ROOT, "portbench", "limits", name + ".json")


def run_train(cell, seed=3_000_000_123):
    return train_driver.run(cell, seed=seed, seconds=0.01, trace=False,
                            t_start=time.perf_counter(),
                            device=torch.device("cpu"))


@pytest.mark.parametrize("kind,traffic,limits", TRAIN)
def test_reference_agrees_with_program_in_f32(kind, traffic, limits):
    out = run_train(smoke_cell(kind, traffic, limits,
                               backend="pallas_wagg:f32"))
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, (name, c)
    assert out["result"]["correct"]


def test_int4_payload_noise_is_the_only_gap():
    """With the int4 payload the two sides draw independent rounding
    noise, so their numbers differ by that noise alone: small, finite, and
    the same numbers."""
    out = run_train(smoke_cell("dense", "wasgd_p3_tau4_seq640_int4",
                               "stablelm3b_train_int4"))
    assert set(out["checks"]) == set(cell_limits("stablelm3b_train_int4"))
    for name, c in out["checks"].items():
        assert 0 <= c["value"] < 0.2, (name, c)


def _unchanged(monkeypatch):
    from repro_torch.train.trainer import Trainer
    orig = Trainer.run

    def run(self, *a, **k):
        before = self.state
        out = orig(self, *a, **k)
        self.state = self.state._replace(params=before.params)
        return out
    monkeypatch.setattr(Trainer, "run", run)


def _half_batch(monkeypatch):
    from repro_torch.train.lm import LMLoss
    orig = LMLoss.stacked

    def stacked(self, params, in_dims, batch):
        half = batch["labels"].shape[-1] // 2
        cut = {k: (v[..., :half] if k in ("tokens", "labels") else v)
               for k, v in batch.items()}
        return orig(self, params, in_dims, cut)
    monkeypatch.setattr(LMLoss, "stacked", stacked)


def _no_exchange(monkeypatch):
    from repro_torch.core import backends
    monkeypatch.setattr(backends, "aggregate_from_config",
                        lambda wcfg, params, axes, theta, **kw: params)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind,traffic,limits", TRAIN)
def test_broken_train_path_is_not_correct(monkeypatch, fault, kind, traffic,
                                          limits):
    FAULTS[fault](monkeypatch)
    out = run_train(smoke_cell(kind, traffic, limits))
    assert not out["result"]["correct"], out["checks"]


def test_the_check_keeps_one_loss_a_worker_and_local_step():
    """The loss handed to the trainer keeps the (p,) losses of each local
    step of the check's rounds, and nothing in the window."""
    cell = smoke_cell("dense", "wasgd_p3_tau4_seq640_int4",
                      "stablelm3b_train_int4")
    t = cell.traffic
    data = lm_data(11, t["data"], t["seq_len"],
                   cell.config["model"]["vocab_size"])
    prog = train_driver.Program(cell, 11, torch.device("cpu"), data)
    prog.loss.on = True
    prog.round()
    prog.loss.on = False
    prog.round()
    losses = prog.history(1)["losses"]
    assert len(losses) == 1 and losses[0].shape == (t["tau"], t["p"])
    assert np.all(np.isfinite(losses[0]))


@pytest.mark.parametrize("kind,traffic,limits", TRAIN)
def test_control_is_not_correct(kind, traffic, limits):
    """The control (the reference in fp8 in the program's place) fails the
    cell's limits at the smoke size, judged as a run's numbers are; the
    card run at the cell's size is ``python3 portbench/control.py``."""
    from portbench import control
    cell = smoke_cell(kind, traffic, limits, compute_dtype="bfloat16")
    numbers = control.train_control(cell, 3_000_000_321, torch.device("cpu"))
    checks, correct = control.judged(cell, numbers)
    assert not correct, checks
