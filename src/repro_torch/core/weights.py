"""Worker assessment: the policy that turns per-worker loss energies ``h``
(shape ``(p,)``) into aggregation weights ``theta`` (summing to 1). The
counterpart of ``repro/core/weights.py``, with the same stages, spec
grammar, legacy aliases and tie-breaking; it runs on the device of ``h``.

Stages, by role (a spec is ``stage|stage|...``, each ``name(args)``):

``kernel``    boltzmann(a=) (Eq. 13, WASGD+) | inverse (WASGD v1) | equal |
              best. At most one; omitted means ``boltzmann`` with the
              config's ``a_tilde``.
``energy``    ema(decay=0.9) (bias-corrected, masked per-worker EMA) |
              time_aware(gamma=1.0) (energies scaled by measured round
              times, fed by ``observe_times``).
``mask``      topk(k) | trimmed(k=1), robust to outlier workers.
``modifier``  anneal(kind, rate=, period=, peak=): schedules the kernel's
              ``a`` over rounds.

A policy is called as ``theta, state = policy(h, active, state, t)``;
``active`` is an optional ``(p,)`` bool mask (Alg. 4 rounds), ``state`` a
dict of tensors (``()`` when every stage is stateless).
"""
from __future__ import annotations

import inspect
import math
import re
from typing import Any, Dict, List, Optional

import torch

POLICY_ROLES = ("kernel", "energy", "mask", "modifier")


# ---------------------------------------------------------------------------
# The paper's weight evaluating functions
# ---------------------------------------------------------------------------

def normalize_energy(h: torch.Tensor) -> torch.Tensor:
    """h'_i = h_i / sum_j h_j (Eq. 12 normalization)."""
    h = h.float()
    return h / torch.clamp_min(h.sum(), 1e-30)


def boltzmann_weights(h: torch.Tensor, a_tilde) -> torch.Tensor:
    """Eq. 13, the Boltzmann weight evaluating function of WASGD+."""
    return torch.softmax(-a_tilde * normalize_energy(h), dim=0)


def inverse_weights(h: torch.Tensor) -> torch.Tensor:
    """WASGD v1: theta_i = (1/h_i) / sum_j (1/h_j)."""
    inv = 1.0 / torch.clamp_min(h.float(), 1e-30)
    return inv / inv.sum()


def equal_weights(p: int, device=None) -> torch.Tensor:
    return torch.full((p,), 1.0 / p, dtype=torch.float32, device=device)


def best_weights(h: torch.Tensor) -> torch.Tensor:
    """One-hot on the minimum energy; ties go to the first index."""
    out = torch.zeros(h.shape[0], dtype=torch.float32, device=h.device)
    return out.scatter_(0, torch.argmin(h).reshape(1), 1.0)


def no_active_error() -> ValueError:
    return ValueError(
        "no active worker: an all-False activity mask has no Alg. 4 "
        "aggregate to late-join (masked theta would be the softmax of an "
        "all -inf row -> NaN); every round needs >= 1 active worker")


def _reject_all_false(active: torch.Tensor) -> None:
    """Raises on an all-False mask. It reads the mask on the host, so the
    Alg. 4 round skips it (``PipelinePolicy.__call__(checked=True)``)
    once its schedule has been checked in numpy
    (``core/async_device.validate_active_rounds``)."""
    if active.numel() and not bool(active.any()):
        raise no_active_error()


# ---------------------------------------------------------------------------
# Stage registry
# ---------------------------------------------------------------------------

_STAGES: Dict[str, type] = {}


def register_policy(cls):
    """Class decorator: registers a policy stage by its ``name``. The class
    declares ``role`` and the role's method (``weights`` / ``transform`` /
    ``refine`` / ``factor``); its ``__init__`` keywords become the stage's
    spec arguments."""
    name = getattr(cls, "name", None)
    if not name or getattr(cls, "role", None) not in POLICY_ROLES:
        raise ValueError(f"policy stage {cls!r} needs a `name` and a `role` "
                         f"in {POLICY_ROLES}")
    if name in _STAGES:
        raise ValueError(f"weight policy {name!r} already registered")
    _STAGES[name] = cls
    return cls


def available_policies():
    return tuple(sorted(_STAGES))


# ---------------------------------------------------------------------------
# Kernels (role "kernel")
# ---------------------------------------------------------------------------

@register_policy
class Boltzmann:
    """Eq. 13. ``a=None`` inherits the config's ``a_tilde``."""
    name = "boltzmann"
    role = "kernel"
    stateful = False
    uses_a = True

    def __init__(self, a: Optional[float] = None):
        self.a = None if a is None else float(a)

    def weights(self, h, active, a):
        if active is None:
            return boltzmann_weights(h, a)
        # normalize over the active energies, then softmax with inactive
        # logits at -inf: the softmax over the active subset.
        h = h.float()
        m = active.float()
        hn = h / torch.clamp_min((m * h).sum(), 1e-30)
        return torch.softmax(torch.where(active, -a * hn, -math.inf), dim=0)


@register_policy
class Inverse:
    name = "inverse"
    role = "kernel"
    stateful = False
    uses_a = False

    def weights(self, h, active, a):
        if active is None:
            return inverse_weights(h)
        inv = active.float() / torch.clamp_min(h.float(), 1e-30)
        return inv / torch.clamp_min(inv.sum(), 1e-30)


@register_policy
class Equal:
    name = "equal"
    role = "kernel"
    stateful = False
    uses_a = False

    def weights(self, h, active, a):
        if active is None:
            return equal_weights(h.shape[0], h.device)
        m = active.float()
        return m / torch.clamp_min(m.sum(), 1.0)


@register_policy
class Best:
    name = "best"
    role = "kernel"
    stateful = False
    uses_a = False

    def weights(self, h, active, a):
        if active is None:
            return best_weights(h)
        # argmin over the active energies (first active worker on a tie);
        # an all-False mask gives NaN (0/0), like the other kernels.
        h = h.float()
        oh = best_weights(torch.where(active, h, math.inf)) * active.float()
        return oh / oh.sum()


def _kernel(strategy: str):
    cls = _STAGES.get(strategy)
    if cls is None or getattr(cls, "role", None) != "kernel":
        kernels = [n for n, c in sorted(_STAGES.items())
                   if getattr(c, "role", None) == "kernel"]
        raise ValueError(f"unknown weighting strategy {strategy!r}; "
                         f"registered kernel policies: {kernels}")
    return cls()


# ---------------------------------------------------------------------------
# Energy transforms (role "energy")
# ---------------------------------------------------------------------------

@register_policy
class Ema:
    """Per-worker EMA over the loss energies, bias-corrected; inactive
    workers' averages freeze."""
    name = "ema"
    role = "energy"
    stateful = True

    def __init__(self, decay: float = 0.9):
        decay = float(decay)
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"ema decay must be in [0, 1), got {decay}")
        self.decay = decay

    def init_state(self, p: int, device):
        return {"h_bar": torch.zeros(p, dtype=torch.float32, device=device),
                "n": torch.zeros(p, dtype=torch.float32, device=device)}

    def transform(self, h, active, state, t):
        h = h.float()
        m = torch.ones_like(h) if active is None else active.float()
        n = state["n"] + m
        h_bar = torch.where(
            m > 0, self.decay * state["h_bar"] + (1 - self.decay) * h,
            state["h_bar"])
        corr = 1.0 - torch.pow(torch.tensor(self.decay, device=h.device),
                               torch.clamp_min(n, 1.0))
        h_hat = torch.where(n > 0, h_bar / torch.clamp_min(corr, 1e-30), h)
        return h_hat, {"h_bar": h_bar, "n": n}

    def expand_state(self, state, new_p: int):
        """Membership resize: survivors keep their slots; newcomers adopt
        the mean accumulator and count over the survivors that have seen a
        round (zeros if none has)."""
        h_bar, n = state["h_bar"], state["n"]
        old_p = h_bar.shape[0]
        if new_p <= old_p:
            return {"h_bar": h_bar[:new_p], "n": n[:new_p]}
        seen = n > 0
        denom = torch.clamp_min(seen.sum(), 1).float()
        agg_h = torch.where(seen, h_bar, 0.0).sum() / denom
        agg_n = torch.where(seen, n, 0.0).sum() / denom
        grow = new_p - old_p
        return {"h_bar": torch.cat([h_bar, agg_h.expand(grow)]),
                "n": torch.cat([n, agg_n.expand(grow)])}


@register_policy
class TimeAware:
    """Energies scaled by ``(round_time / mean_active_round_time) **
    gamma`` (slow worker -> smaller weight); the identity until the first
    ``observe``."""
    name = "time_aware"
    role = "energy"
    stateful = True

    def __init__(self, gamma: float = 1.0):
        self.gamma = float(gamma)

    def init_state(self, p: int, device):
        return {"times": torch.ones(p, dtype=torch.float32, device=device),
                "seen": torch.zeros((), dtype=torch.bool, device=device)}

    def transform(self, h, active, state, t):
        h = h.float()
        tm = state["times"]
        m = torch.ones_like(h) if active is None else active.float()
        mean = (m * tm).sum() / torch.clamp_min(m.sum(), 1.0)
        scale = (tm / torch.clamp_min(mean, 1e-30)) ** self.gamma
        return torch.where(state["seen"], h * scale, h), state

    def observe(self, state, times):
        dev = state["times"].device
        return {"times": torch.as_tensor(times, dtype=torch.float32,
                                         device=dev),
                "seen": torch.ones((), dtype=torch.bool, device=dev)}

    def expand_state(self, state, new_p: int):
        """Membership resize: newcomers take the survivors' mean round time
        until their own first observation; ``seen`` is fleet state."""
        tm = state["times"]
        old_p = tm.shape[0]
        if new_p <= old_p:
            return {"times": tm[:new_p], "seen": state["seen"]}
        return {"times": torch.cat([tm, tm.mean().expand(new_p - old_p)]),
                "seen": state["seen"]}


# ---------------------------------------------------------------------------
# Mask refinements (role "mask")
# ---------------------------------------------------------------------------

def _as_mask(h, active):
    return (torch.ones(h.shape, dtype=torch.bool, device=h.device)
            if active is None else active.bool())


def _active_ranks(h, act):
    """Rank of each worker by energy among the active set (stable ties);
    inactive workers rank past every active one."""
    key = torch.where(act, h.float(), math.inf)
    order = torch.argsort(key, stable=True)
    return torch.argsort(order, stable=True)


@register_policy
class TopK:
    """Keep only the k lowest-energy active workers."""
    name = "topk"
    role = "mask"
    stateful = False

    def __init__(self, k: int):
        k = int(k)
        if k < 1:
            raise ValueError(f"topk needs k >= 1, got {k}")
        self.k = k

    def refine(self, h, active):
        act = _as_mask(h, active)
        return act & (_active_ranks(h, act) < self.k)


@register_policy
class Trimmed:
    """Drop the k highest and k lowest energy active workers; a round with
    <= 2k active workers is left untrimmed."""
    name = "trimmed"
    role = "mask"
    stateful = False

    def __init__(self, k: int = 1):
        k = int(k)
        if k < 1:
            raise ValueError(f"trimmed needs k >= 1, got {k}")
        self.k = k

    def refine(self, h, active):
        act = _as_mask(h, active)
        ranks = _active_ranks(h, act)
        n_act = act.sum()
        keep = act & (ranks >= self.k) & (ranks < n_act - self.k)
        return torch.where(n_act > 2 * self.k, keep, act)


# ---------------------------------------------------------------------------
# Kernel modifiers (role "modifier")
# ---------------------------------------------------------------------------

@register_policy
class Anneal:
    """Schedules the kernel's ``a`` over rounds t: ``linear`` a(1+rate t),
    ``exp`` a e^{rate t}, ``cosine`` a half-cosine ramp from a to a*peak
    over ``period`` rounds."""
    name = "anneal"
    role = "modifier"
    stateful = True
    KINDS = ("linear", "exp", "cosine")

    def __init__(self, kind: str = "linear", rate: float = 0.05,
                 period: float = 100.0, peak: float = 100.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown anneal kind {kind!r}; "
                             f"known: {self.KINDS}")
        self.kind = kind
        self.rate = float(rate)
        self.period = float(period)
        self.peak = float(peak)

    def factor(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.kind == "linear":
            return 1.0 + self.rate * t
        if self.kind == "exp":
            return torch.exp(self.rate * t)
        frac = torch.clamp(t / self.period, 0.0, 1.0)
        return 1.0 + (self.peak - 1.0) * 0.5 * (1.0 - torch.cos(math.pi
                                                               * frac))


# ---------------------------------------------------------------------------
# The composed pipeline policy
# ---------------------------------------------------------------------------

class PipelinePolicy:
    """A parsed spec: energy transforms -> mask refinements -> one
    (annealed) kernel. State is a flat dict keyed by stage position, plus
    the round counter ``t`` when a modifier needs it."""

    def __init__(self, stages: List[Any], default_a: float = 1.0,
                 spec: Optional[str] = None):
        kernels = [s for s in stages if s.role == "kernel"]
        if len(kernels) > 1:
            raise ValueError(
                f"policy spec names {len(kernels)} kernels "
                f"({[k.name for k in kernels]}); compose at most one "
                f"weight evaluating function per spec")
        self.kernel = kernels[0] if kernels else Boltzmann()
        self.energy_stages = [s for s in stages if s.role == "energy"]
        self.mask_stages = [s for s in stages if s.role == "mask"]
        self.modifiers = [s for s in stages if s.role == "modifier"]
        if self.modifiers and not getattr(self.kernel, "uses_a", False):
            raise ValueError(
                f"'{self.modifiers[0].name}' schedules the kernel's 'a', "
                f"but kernel '{self.kernel.name}' takes none; use the "
                f"'boltzmann' kernel (or drop the modifier)")
        a = getattr(self.kernel, "a", None)
        self.a = float(default_a) if a is None else float(a)
        self._needs_t = any(getattr(m, "stateful", False)
                            for m in self.modifiers)
        self.stateful = self._needs_t or any(
            getattr(s, "stateful", False)
            for s in self.energy_stages + self.mask_stages)
        self.name = spec if spec is not None else "|".join(
            s.name for s in stages) or self.kernel.name
        self.spec = self.name

    def _stage_key(self, i: int, stage) -> str:
        return f"s{i}_{stage.name}"

    def init_state(self, p: int, device="cpu"):
        st = {}
        for i, s in enumerate(self.energy_stages):
            if getattr(s, "stateful", False):
                st[self._stage_key(i, s)] = s.init_state(p, device)
        if self._needs_t:
            st["t"] = torch.zeros((), dtype=torch.float32, device=device)
        return st if st else ()

    def __call__(self, h, active=None, state=None, t=None, *,
                 checked: bool = False):
        """``checked=True``: the caller has already checked that ``active``
        holds an active worker (on the host, in numpy), so the call reads
        nothing back from the device."""
        if active is not None and not checked:
            _reject_all_false(active)
        if state is None or (isinstance(state, tuple) and not state):
            state = self.init_state(h.shape[0], h.device)   # round 0
        st = dict(state) if isinstance(state, dict) else {}
        if t is None:
            t = st.get("t", torch.zeros((), dtype=torch.float32,
                                        device=h.device))
        t = torch.as_tensor(t, dtype=torch.float32, device=h.device)
        for i, s in enumerate(self.energy_stages):
            key = self._stage_key(i, s)
            h, sub = s.transform(h, active, st.get(key), t)
            if getattr(s, "stateful", False):
                st[key] = sub
        act = None if active is None else active.bool()
        for s in self.mask_stages:
            act = s.refine(h, act)
        a_eff = self.a
        for m in self.modifiers:
            a_eff = a_eff * m.factor(t)
        theta = self.kernel.weights(h, act, a_eff)
        if self._needs_t:
            st["t"] = t + 1.0
        return theta, (st if st else ())

    def observe_times(self, state, times):
        """Feed measured per-worker round times to the stages that read
        them (``time_aware``); the state of any other pipeline passes
        through."""
        if not isinstance(state, dict):
            return state
        st = dict(state)
        for i, s in enumerate(self.energy_stages):
            key = self._stage_key(i, s)
            if hasattr(s, "observe") and key in st:
                st[key] = s.observe(st[key], times)
        return st

    def expand_state(self, state, new_p: int):
        """Re-shards the policy state across a membership resize
        (``core/membership.py``): each stateful stage keeps the survivors'
        slots and fills newcomers from its aggregate (its own
        ``expand_state``, else the survivor mean); the round counter ``t``
        is fleet state and carries over."""
        if not isinstance(state, dict) or not state:
            return state
        st = dict(state)
        for i, s in enumerate(self.energy_stages):
            key = self._stage_key(i, s)
            if key not in st:
                continue
            if hasattr(s, "expand_state"):
                st[key] = s.expand_state(st[key], new_p)
            else:
                st[key] = _generic_expand_state(st[key], new_p)
        return st


def _generic_expand_state(sub, new_p: int):
    """Resize of a stage without ``expand_state``: every tensor with a
    leading dim is per-worker (survivors keep slots, newcomers get the
    survivor mean); 0-d tensors are fleet state."""
    def visit(x):
        if isinstance(x, dict):
            return {k: visit(v) for k, v in x.items()}
        if x.dim() == 0:
            return x
        old_p = x.shape[0]
        if new_p <= old_p:
            return x[:new_p]
        fill = x.float().mean(dim=0, keepdim=True).expand(
            new_p - old_p, *x.shape[1:]).to(x.dtype)
        return torch.cat([x, fill])

    return visit(sub)


# ---------------------------------------------------------------------------
# Spec parsing and config resolution
# ---------------------------------------------------------------------------

_STAGE_RE = re.compile(r"([A-Za-z_]\w*)\s*(?:\((.*)\))?\s*$", re.S)


def _parse_value(tok: str):
    tok = tok.strip()
    low = tok.lower()
    if low in ("true", "false"):
        return low == "true"
    for conv in (int, float):
        try:
            return conv(tok)
        except ValueError:
            pass
    return tok


def _parse_args(argstr: Optional[str]):
    args, kwargs = [], {}
    if not argstr or not argstr.strip():
        return args, kwargs
    for tok in argstr.split(","):
        if "=" in tok:
            k, v = tok.split("=", 1)
            kwargs[k.strip()] = _parse_value(v)
        else:
            if kwargs:
                raise ValueError(
                    f"positional policy argument {tok.strip()!r} after a "
                    f"keyword argument")
            args.append(_parse_value(tok))
    return args, kwargs


def parse_policy(spec: str, default_a: float = 1.0) -> PipelinePolicy:
    """Parse a policy spec; raises ``ValueError`` naming the registered
    policies on an unknown stage or malformed arguments."""
    stages = []
    for part in spec.split("|"):
        part = part.strip()
        m = _STAGE_RE.match(part) if part else None
        if m is None:
            raise ValueError(
                f"malformed stage {part!r} in policy spec {spec!r}; "
                f"expected 'name' or 'name(arg, key=value, ...)'")
        name, argstr = m.group(1), m.group(2)
        cls = _STAGES.get(name)
        if cls is None:
            raise ValueError(
                f"unknown weight policy {name!r} in spec {spec!r}; "
                f"registered policies: {list(available_policies())}")
        args, kwargs = _parse_args(argstr)
        try:
            stage = cls(*args, **kwargs)
        except TypeError as e:
            sig = str(inspect.signature(cls.__init__)).replace("self, ", "") \
                .replace("self", "")
            raise ValueError(
                f"bad arguments for policy stage {part!r}: {e}; "
                f"{name} takes {sig}") from None
        stages.append(stage)
    return PipelinePolicy(stages, default_a=default_a, spec=spec)


def as_policy(policy, default_a: float = 1.0) -> PipelinePolicy:
    """A spec string -> its parsed pipeline; a policy object passes
    through."""
    if isinstance(policy, str):
        return parse_policy(policy, default_a=default_a)
    if isinstance(policy, PipelinePolicy):
        return policy
    raise TypeError(f"expected a policy spec string or a PipelinePolicy, "
                    f"got {type(policy).__name__}")


def policy_from_config(wcfg) -> PipelinePolicy:
    """A ``WASGDConfig`` -> its policy. An explicit ``wcfg.policy`` wins
    (a kernel without ``a`` takes ``wcfg.a_tilde``); otherwise the legacy
    ``strategy``/``a_tilde`` select the bare kernel and
    ``a_schedule="anneal"`` appends ``anneal(linear, rate=anneal_rate)``
    where the kernel has an ``a``."""
    spec = getattr(wcfg, "policy", "") or ""
    a = float(getattr(wcfg, "a_tilde", 1.0))
    if spec:
        return parse_policy(spec, default_a=a)
    strategy = getattr(wcfg, "strategy", "boltzmann")
    kernel_cls = _STAGES.get(strategy)
    if kernel_cls is None or getattr(kernel_cls, "role", None) != "kernel":
        _kernel(strategy)                          # raises the listing error
    if getattr(wcfg, "a_schedule", "constant") == "anneal" \
            and getattr(kernel_cls, "uses_a", False):
        rate = float(getattr(wcfg, "anneal_rate", 0.05))
        return parse_policy(f"{strategy}|anneal(linear, rate={rate})",
                            default_a=a)
    return parse_policy(strategy, default_a=a)


def validate_config_spec(strategy: str, policy: str = "") -> None:
    """Config-construction-time validation (``WASGDConfig.__post_init__``)."""
    _kernel(strategy)
    if policy:
        parse_policy(policy)


# ---------------------------------------------------------------------------
# Stateless entry points and diagnostics
# ---------------------------------------------------------------------------

def compute_theta(h: torch.Tensor, strategy: str = "boltzmann",
                  a_tilde: float = 1.0) -> torch.Tensor:
    return _kernel(strategy).weights(h, None, a_tilde)


def masked_compute_theta(h: torch.Tensor, active: torch.Tensor,
                         a_tilde: float = 1.0,
                         strategy: str = "boltzmann") -> torch.Tensor:
    """theta over the active workers only; exactly 0 for inactive ones. At
    least one worker must be active."""
    _reject_all_false(active)
    return _kernel(strategy).weights(h.float(), active.bool(), a_tilde)


def theta_entropy(theta: torch.Tensor) -> torch.Tensor:
    """Entropy of the weight distribution (log p = equal)."""
    t = torch.clamp_min(theta, 1e-30)
    return -(t * torch.log(t)).sum()


def omega(theta: torch.Tensor) -> torch.Tensor:
    """omega = sum_i theta_i^2 (Lemma 2), the aggregate's variance factor."""
    return torch.sum(torch.square(theta))
