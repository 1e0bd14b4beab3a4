"""Plain PyTorch reference of synchronous WASGD+ rounds (the paper's
Alg. 1 with Eq. 10 and Eq. 13), written from the paper and the traffic
file's settings, not from the program:

* each of ``p`` workers takes ``tau`` plain SGD steps on its own samples,
  from the same start; a leaf under an ``experts`` scope is one copy that
  every worker reads, updated by the mean of the workers' gradients;
* a worker's energy ``h_i`` is the sum of its losses over the recorded
  steps (Alg. 2 ``RecordIndex``: the last ``m/c`` steps of each of ``c``
  segments of the round);
* theta = softmax(-a * h / sum(h)) (Boltzmann, Eq. 13);
* every worker leaf becomes ``(1 - beta) x_i + beta * sum_j theta_j y_j``
  (Eq. 10), ``y_j = x_j`` for the ``f32`` codec; for ``int4``, ``y_j`` is
  ``x_j`` rounded stochastically (unbiased, uniform draws of this file's
  own generator) to the integers -7..7 times ``max|x| / 7`` over the
  leaf's ``p`` rows;
* the samples: the data is split into ``n_segments`` segments, and worker
  ``w`` reads its segment in the order of ``permutation(seed_sw)``, the
  seeds drawn as ``default_rng(order_seed).integers(0, 2**31 - 1,
  (n_segments, p))``, ``tau * b_local`` samples a round (OrderGen's
  reshuffle happens only at a segment's end, past the rounds followed).

``run`` returns every round's energies, theta and the workers' losses of
each local step (tau, p) and, after the rounds named in ``norm_after``, the norm of each leaf's change from the start, a
worker leaf row by row."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.lm import Model

Path = Tuple[str, ...]


def record_steps(tau: int, m: int, c: int) -> List[int]:
    """Alg. 2 ``RecordIndex``: the last ``m/c`` steps (at least one, at
    most ``tau/c``) of each of the ``c`` segments of a round."""
    c = max(1, min(c, tau))
    per = max(1, min(m // c if m >= c else 1, tau // c))
    out = set()
    for i in range(c):
        end = (i + 1) * tau // c
        out.update(end - j - 1 for j in range(per) if 0 <= end - j - 1 < tau)
    return sorted(out)


def round_rows(r: int, p: int, tau: int, b_local: int, n: int,
               n_segments: int, order_seed: int) -> np.ndarray:
    """(p, tau * b_local) sample indices of round ``r``."""
    seg_len = n // n_segments
    per_round = tau * b_local
    per_seg = max(1, seg_len // per_round)
    seg, within = (r // per_seg) % n_segments, r % per_seg
    seeds = np.random.default_rng(order_seed).integers(
        0, 2**31 - 1, size=(n_segments, p))
    start = (within * per_round) % max(1, seg_len - per_round + 1)
    rows = np.empty((p, per_round), np.int64)
    for w in range(p):
        perm = np.random.default_rng(int(seeds[seg, w])).permutation(seg_len)
        sel = perm[start:start + per_round]
        if len(sel) < per_round:
            sel = np.concatenate([sel, perm[:per_round - len(sel)]])
        rows[w] = seg * seg_len + sel
    return rows


def int4_payload(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """x (p, ...) rounded stochastically to -7..7 steps of max|x| / 7."""
    scale = x.abs().amax().clamp_min(1e-12) / 7.0
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.clamp(torch.floor(x / scale + u), -7, 7) * scale


def run(cfg: Dict, traffic: Dict, data: Dict[str, np.ndarray],
        leaves: Sequence[Tuple[Path, Callable[[], torch.Tensor]]],
        n_rounds: int, norm_after: Iterable[int], device,
        precision: str = "f32", seed: int = 0,
        fault: Optional[str] = None) -> Dict:
    """``leaves``: (path, a function making the leaf's initial value in
    float32). ``fault`` plants one of the check's faults in place of the
    program: ``"half_batch"`` (each loss over half of each sequence),
    ``"no_aggregate"`` (beta 0: the exchange between workers left out)."""
    p, tau, b = traffic["p"], traffic["tau"], traffic["b_local"]
    lr, beta, a = traffic["lr"], traffic["beta"], traffic.get("a_tilde", 1.0)
    if fault == "no_aggregate":
        beta = 0.0
    codec = traffic["backend"].split(":")[1]
    keep = traffic["seq_len"] // 2 if fault == "half_batch" else None
    recorded = set(record_steps(tau, traffic["m_estimate"],
                                traffic["record_chunks"]))
    model = Model(cfg, precision)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    norm_after = set(norm_after)

    shared: Dict[Path, torch.Tensor] = {}
    own: List[Dict[Path, torch.Tensor]] = [{} for _ in range(p)]
    for path, make in leaves:
        x0 = make()
        if "experts" in path:
            shared[path] = x0.requires_grad_()
        else:
            for w in range(p):
                own[w][path] = x0.clone().requires_grad_()
        del x0

    def tree(w: int) -> Dict:
        out: Dict = {}
        for path, x in list(own[w].items()) + list(shared.items()):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = x
        return out

    def change_norms() -> Dict[Path, List[float]]:
        out: Dict[Path, List[float]] = {}
        for path, make in leaves:
            x0 = make()
            if path in shared:
                out[path] = [float((shared[path].detach() - x0).norm())]
            else:
                out[path] = [float((own[w][path].detach() - x0).norm())
                             for w in range(p)]
            del x0
        return out

    toks = torch.as_tensor(data["tokens"])
    labs = torch.as_tensor(data["labels"])
    n = toks.shape[0]
    energies, thetas, step_losses, norms = [], [], [], {}
    for r in range(n_rounds):
        rows = round_rows(r, p, tau, b, n, traffic.get("n_segments", 1),
                          traffic["order_seed"])
        h = torch.zeros(p, dtype=torch.float32, device=device)
        losses = torch.zeros(tau, p, dtype=torch.float64, device=device)
        for t in range(tau):
            for w in range(p):
                sel = rows[w, t * b:(t + 1) * b]
                tk = toks[sel].to(device)
                lb = labs[sel].to(device)
                loss = model.loss(tree(w), tk, lb, keep=keep)
                loss.backward()
                with torch.no_grad():
                    for x in own[w].values():
                        if x.grad is not None:
                            x.sub_(x.grad, alpha=lr)
                        x.grad = None
                losses[t, w] = loss.detach()
                if t in recorded:
                    h[w] += loss.detach()
                del loss
            with torch.no_grad():
                for x in shared.values():
                    if x.grad is not None:
                        x.sub_(x.grad, alpha=lr / p)
                    x.grad = None
        theta = torch.softmax(-a * h / h.sum().clamp_min(1e-30), dim=0)
        with torch.no_grad():
            for path in own[0]:
                x = torch.stack([own[w][path].detach() for w in range(p)])
                y = x if codec == "f32" else int4_payload(x, gen)
                m = torch.tensordot(theta, y, dims=1)
                for w in range(p):
                    own[w][path].copy_((1.0 - beta) * x[w] + beta * m)
                del x, y, m
        energies.append(h.cpu().numpy())
        thetas.append(theta.cpu().numpy())
        step_losses.append(losses.cpu().numpy())
        if r + 1 in norm_after:
            norms[r + 1] = change_norms()
    return {"h": energies, "theta": thetas, "losses": step_losses,
            "norms": norms}
