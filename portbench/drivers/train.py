"""Training cells: synchronous WASGD+ through the program's ``Trainer.run``.

Set-up makes the weights and the token set from the seed, builds one
``Trainer`` (the model, its round and its optimizer state), and drives it
through its first ``check_rounds`` rounds with the window's own call, one
round a call, reading what the check compares: the workers' losses of the
first local step (the loss the ``Trainer`` is given passes them on as the
round computes them), each round's energies and theta, and after the
first and the last of those rounds the norm of each leaf's change from
the start (a worker leaf row by row; the initial leaf is made again from
its seed). Those rounds also build and warm every kernel and shape the
window uses. The same trainer then runs the window.

Window (``--trace 0``): whole rounds until ``seconds`` have passed,
``train_tokens_per_s`` over all of them and their time, ending in a
synchronize; ``peak_mem_gib`` from ``max_memory_allocated`` after a reset
at the window's start. Traced run (``--trace 1``): ``trace_rounds`` rounds
under the profiler (the card only), one round with the host's operations
profiled too (to name the idle gaps), and ``phase_rounds`` rounds with a
``RingSink`` (the program's phase-fenced rounds, ``RoundTrace``).

Then the program is freed and ``reference/wasgd.py`` follows the same
rounds from the same weights and samples in float32."""
from __future__ import annotations

import math
import time
import types
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import runner
from portbench.drivers.common import (device_info, port_config, release,
                                      reset_peak, sync)
from portbench.reference import wasgd as ref_wasgd
from portbench.yardstick import trace as tr
from portbench.yardstick.tokens import lm_data, sub_seed
from portbench.yardstick.weights import (get_path, is_expert, leaf_specs,
                                         make_leaf, make_tree)

Norms = Dict[Tuple[str, ...], List[float]]


def with_order_seed(traffic: Dict, seed: int) -> Dict:
    return {**traffic, "order_seed": sub_seed(seed, "order") % (2**31 - 1)}


class RecordedLoss:
    """The program's loss, unchanged, that keeps the workers' losses (p,)
    of each call of its worker-stacked form while ``on``: one call a
    local step, as the round computes them."""

    def __init__(self, loss):
        self.loss, self.on, self.kept = loss, False, []

    def __call__(self, params, batch):
        return self.loss(params, batch)

    def stacked(self, params, in_dims, batch):
        losses, aux = self.loss.stacked(params, in_dims, batch)
        if self.on:
            self.kept.append(losses.detach().clone())
        return losses, aux


class Program:
    """One trainer of the cell, driven one round a call."""

    def __init__(self, cell, seed: int, device, data: Dict):
        from repro_torch.configs.base import TrainConfig, WASGDConfig
        from repro_torch.data.pipeline import OrderedDataset
        from repro_torch.models import param_axes
        from repro_torch.train import Trainer, make_lm_loss
        t = with_order_seed(cell.traffic, seed)
        self.model, self.traffic, self.seed = cell.config["model"], t, seed
        self.device = device
        cfg = port_config(self.model)
        tcfg = TrainConfig(
            learning_rate=t["lr"], optimizer=t["optimizer"],
            seq_len=t["seq_len"],
            wasgd=WASGDConfig(tau=t["tau"], beta=t["beta"],
                              strategy=t["strategy"], a_tilde=t["a_tilde"],
                              m_estimate=t["m_estimate"],
                              record_chunks=t["record_chunks"],
                              backend=t["backend"]))
        params = make_tree(self.model, seed, device)
        self.loss = RecordedLoss(make_lm_loss(cfg))
        self.trainer = Trainer(self.loss, params, param_axes(params),
                               tcfg, t["p"], rule="wasgd+", device=device)
        del params
        self.ds = OrderedDataset(data, t["p"], t["tau"], t["b_local"],
                                 n_segments=t["n_segments"],
                                 seed=t["order_seed"])
        self.batches = self.ds.batches()

    def round(self, telemetry=None) -> None:
        done = len(self.trainer.history)
        self.trainer.run(
            self.batches, 1, order_state=self.ds.order,
            segment_fn=lambda r: self.ds.segment_of_round(r + done),
            telemetry=telemetry)

    @property
    def tokens_per_round(self) -> int:
        t = self.traffic
        return t["p"] * t["tau"] * t["b_local"] * t["seq_len"]

    def change_norms(self) -> Norms:
        """Each leaf's change from its initial value: a norm a worker row,
        one for a one-copy (expert) leaf."""
        params, out = self.trainer.state.params, {}
        for spec in leaf_specs(self.model):
            x0 = make_leaf(spec, self.seed, self.device, torch.float32)
            x = get_path(params, spec[0])
            rows = [x] if is_expert(spec[0]) else list(x)
            out[spec[0]] = torch.stack(
                [torch.linalg.vector_norm(r.float() - x0) for r in rows])
            del x0
        return {k: v.tolist() for k, v in out.items()}

    def history(self, n: int) -> Dict:
        """Rounds ``0..n-1``: energies, theta, and the workers' losses of
        each local step (of the rounds run with ``loss.on``)."""
        h = self.trainer.history[:n]
        tau = self.traffic["tau"]
        kept = [x.cpu().numpy().astype(np.float64) for x in self.loss.kept]
        return {"h": [np.asarray(r["h"], np.float64) for r in h],
                "theta": [np.asarray(r["theta"], np.float64) for r in h],
                "losses": [np.stack(kept[i:i + tau])
                           for i in range(0, len(kept), tau)]}

    def worker_leaf_sizes(self) -> List[int]:
        return [int(np.prod(s[1])) for s in leaf_specs(self.model)
                if not is_expert(s[0])]


def counters() -> Dict[str, int]:
    """The program's own launch counters."""
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    return {"rmsnorm": rmsnorm_fwd.launches,
            "rmsnorm_fused": add_rmsnorm_fwd.launches,
            "fused_ce": fused_ce_fwd.launches,
            "wagg_fused": wagg_fused.launches}


def compare(prog: Dict, ref: Dict, last: int) -> Dict:
    """The numbers the check compares. At the first local step, before
    any update (only rounding moves it): the mean over the workers of the
    relative gap of each worker's loss. After the first round, whose
    workers start from the same weights: the worst leaf's gap of change
    norms after the round's aggregate (a worker leaf row by row),
    measured against the larger of that leaf's reference norm and the
    median leaf's; leaves whose reference change is under a thousandth
    of the median leaf's are left out (they move by round-off alone).
    After round ``last``: the relative gap of the median leaf's change
    norm. A cell's limits file names which of these its check compares.
    Returned under ``later_*`` for the record, never compared (no
    control or fault reads far enough above sound runs, ``PERF.md``):
    the widest worker's first-step gap and the gap of the workers' mean
    first-step loss, both sides' first-step losses, the widest relative
    gap of a worker's energy in the first round (its summed losses of
    the round's local steps, each after the previous one's update) and
    in any round, theta's widest gap, and the worst leaves."""
    hp, hr = np.array(prog["h"]), np.array(ref["h"])
    rel = np.abs(hp - hr) / np.abs(hr)
    lp, lr = prog["losses"][0][0], ref["losses"][0][0]
    first = ref["norms"][1]
    med1 = float(np.median([v for vs in first.values() for v in vs]))

    def worst(r):
        rn, pn = ref["norms"][r], prog["norms"][r]
        med = float(np.median([v for vs in rn.values() for v in vs]))
        gap, where = 0.0, None
        for path, rv in rn.items():
            for i, (a, b) in enumerate(zip(pn[path], rv)):
                if first[path][i] < med1 / 1000:
                    continue
                g = abs(a - b) / max(b, med)
                if g > gap:
                    gap, where = g, ("/".join(path), i, a, b, med)
        return gap, where

    def median(norms):
        return float(np.median([v for vs in norms.values() for v in vs]))

    med_p, med_r = median(prog["norms"][last]), median(ref["norms"][last])
    change1, where1 = worst(1)
    loss0 = np.abs(lp - lr) / np.abs(lr)
    return {"loss0_gap": float(loss0.mean()),
            "change1_gap": change1,
            f"change{last}_median_gap": abs(med_p - med_r) / med_r,
            "later_loss0_worker_gap": float(loss0.max()),
            "later_loss0_mean_gap": float(abs(lp.mean() - lr.mean())
                                          / abs(lr.mean())),
            "later_energy0_gap": float(rel[0].max()),
            "later_loss0_program": lp.tolist(),
            "later_loss0_reference": lr.tolist(),
            "later_theta0_gap": float(np.max(np.abs(
                np.array(prog["theta"][0]) - np.array(ref["theta"][0])))),
            "later_energy_gap": float(rel.max()),
            "later_change1_worst": where1,
            f"later_change{last}_worst": worst(last)}


def compared(numbers: Dict) -> Dict:
    return {k: v for k, v in numbers.items() if not k.startswith("later_")}


def reference_numbers(cell, seed: int, device, data: Dict,
                      precision: str = "f32", fault=None,
                      codec_draws: str = "codec") -> Dict:
    """The reference's (or, with ``precision``/``fault``, the control's)
    energies, thetas and change norms of the check's rounds; the int4
    codec's draws come from the stream ``codec_draws`` of the seed (a
    control draws its own, as the program does)."""
    model = cell.config["model"]
    t = with_order_seed(cell.traffic, seed)
    n = t["check_rounds"]
    leaves = [(s[0], (lambda s=s: make_leaf(s, seed, device, torch.float32)))
              for s in leaf_specs(model)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref_wasgd.run(model, t, data, leaves, n, (1, n), device,
                         precision=precision,
                         seed=sub_seed(seed, codec_draws),
                         fault=fault)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device) -> Dict:
    log = runner.Log(t_start)
    t = cell.traffic
    data = lm_data(seed, t["data"], t["seq_len"], cell.config["model"]
                   ["vocab_size"])
    log("data made")
    prog = Program(cell, seed, device, data)
    log("trainer built")
    n_check = t["check_rounds"]
    norms = {}
    prog.loss.on = True
    for r in range(n_check):
        prog.round()
        log(f"set-up round {r}")
        if r + 1 in (1, n_check):
            norms[r + 1] = prog.change_norms()
            log("change norms")
    prog.loss.on = False
    prog_numbers = {**prog.history(n_check), "norms": norms}
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")

    reset_peak(device)
    breakdown = None
    if not trace:
        t0 = time.perf_counter()
        ends = []
        while True:
            prog.round()
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        sync(device)
        wall = time.perf_counter() - t0
        rounds = len(ends)
        log("round walls: " + " ".join(
            f"{b - a:.3f}" for a, b in zip([t0] + ends, ends)))
        values = {"train_tokens_per_s": rounds * prog.tokens_per_round / wall,
                  "setup_s": setup_s}
    else:
        rounds, values, breakdown, dev_extra = traced(cell, prog)
    dev = device_info(device)
    if trace:
        dev.update(dev_extra)
    else:
        values["peak_mem_gib"] = dev["memory_peak_bytes"] / 2**30
    log(f"window: {rounds} rounds")
    prog = None
    release()

    ref = reference_numbers(cell, seed, device, data)
    log("reference")
    for r in range(n_check):
        log(f"round {r} energies: program {np.round(prog_numbers['h'][r], 4)}"
            f" reference {np.round(ref['h'][r], 4)}")
    numbers = compare(prog_numbers, ref, n_check)
    log("not compared (worst leaf: path, row, program, reference, "
        "median): " + ", ".join(f"{k} {v}" for k, v in numbers.items()
                                if k.startswith("later_")))
    checks = runner.judge(compared(numbers), cell.limits)
    names = cell.end_to_end if not trace else cell.per_layer
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in names if values.get(m["name"]) is not None}
    result = {"correct": runner.is_correct(checks), "attempted": rounds,
              "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return {"result": result, "checks": checks}


def traced(cell, prog: Program):
    """The traced window: per-layer values, the breakdown, and
    ``busy_s``/``window_s``."""
    from repro_torch.obs import RingSink
    n = cell.traffic["trace_rounds"]
    before = counters()
    with tr.profiled() as prof:
        for _ in range(n):
            prog.round()
    after = counters()
    win = tr.Window(*tr.events(prof))
    with tr.profiled(cpu=True) as prof_host:
        prog.round()
    gaps = tr.Window(*tr.events(prof_host)).idle_gaps(10)
    sink = RingSink()
    for _ in range(cell.traffic["phase_rounds"]):
        prog.round(telemetry=sink)
    ctx = types.SimpleNamespace(
        model=cell.config["model"], traffic=cell.traffic, window=win,
        rounds=n, counters={k: after[k] - before[k] for k in after},
        worker_leaf_sizes=prog.worker_leaf_sizes(),
        phases=[e.phases for e in sink.by_kind("round_trace")])
    values = {}
    for m in cell.per_layer:
        v = runner.reader(m["name"])(ctx)
        if v is not None and math.isfinite(v):
            values[m["name"]] = v
    breakdown = {"device_ops": win.top_ops(10), "idle_gaps": gaps}
    rounds = n + 1 + cell.traffic["phase_rounds"]
    return rounds, values, breakdown, {"busy_s": win.busy_s,
                                       "window_s": win.window_s}
