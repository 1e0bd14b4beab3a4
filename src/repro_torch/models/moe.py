"""Top-k mixture-of-experts FFN with capacity-based dispatch, the
counterpart of ``repro/models/moe.py``.

Expert weights live under the ``experts`` scope and are the one part of
the parameter tree that gets no WASGD worker dimension: one copy that
every worker trains (``models.transformer.param_axes`` names their
``experts`` axis, and ``core.replicate_workers`` then keeps them
single-copy). The round gives them the workers' mean gradient.

Dispatch follows JAX's sort-based form: each (token, k) slot is ranked
within its expert by a stable argsort over the token-major (T K)
flattening of the expert ids (so a token of a lower index wins a place
before a later one), slots beyond the capacity C are dropped, the kept
tokens fill an (E, C, d) buffer, a gated MLP runs over all experts at
once, and each token's kept outputs are combined with its renormalized
gates. The segment starts come from per-expert counts (a comparison with
``arange(E)`` and a sum) instead of ``searchsorted``, and the buffer is
filled by a gather from the sorted order instead of JAX's scatter-add
into ``E C + 1`` rows: every kept slot owns its (expert, rank) place
alone, so both give the same buffer, and both forms are plain gathers
that ``torch.func.vmap`` batches over workers (the round runs this under
``vmap`` with the router mapped and the experts not).

``torch.topk`` does not promise JAX's lower-index-first order between
equal router probabilities; the parity tests draw router inputs without
ties. The expert products are batched matrix products that JAX also
leaves to its compiler: the JAX package has no Pallas MoE kernel. They
run through ``ExpertMatmul``, whose ``vmap`` rule folds the workers into
the rows of one product per expert: ``torch.func``'s own rule for
``bmm`` would copy the unmapped expert weights once per worker (a
gigabyte a matrix for olmoe-1b-7b at p 4, and its gradient as large).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.param import ParamBuilder
from repro_torch.obs.spans import span


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


class ExpertMatmul(torch.autograd.Function):
    """(a (E, C, k), b (E, k, n)) -> a @ b for each of the E experts. When
    only ``a`` is mapped (the round's workers over one copy of the
    experts) the ``vmap`` rule runs one product with the workers' rows
    side by side, (E, p C, k) @ (E, k, n); the gradient of ``b`` is then
    the sum over the workers' rows, as autograd of a shared leaf gives
    it."""

    @staticmethod
    def forward(a, b):
        return torch.bmm(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (torch.bmm(g, b.transpose(1, 2)),
                torch.bmm(a.transpose(1, 2), g))

    @staticmethod
    def vmap(info, in_dims, a, b):
        a_d, b_d = in_dims
        n = info.batch_size
        if b_d is None:
            if a_d is None:
                return ExpertMatmul.apply(a, b), None
            a = a.movedim(a_d, 1)                               # (E, n, C, k)
            E, _, C, k = a.shape
            out = ExpertMatmul.apply(a.reshape(E, n * C, k), b)
            return out.reshape(E, n, C, -1), 1
        b = b.movedim(b_d, 0)
        a = a.expand(n, *a.shape) if a_d is None else a.movedim(a_d, 0)
        out = ExpertMatmul.apply(a.flatten(0, 1), b.flatten(0, 1))
        return out.unflatten(0, (n, -1)), 0


def moe_init(b: ParamBuilder, name: str, d_model: int, m: MoEConfig):
    s = b.scope(name)
    s.param("router", (d_model, m.n_experts), ("embed", None), scale=0.02)
    e = s.scope("experts")
    e.param("w_gate", (m.n_experts, d_model, m.d_ff_expert),
            ("experts", "embed", "expert_ffn"))
    e.param("w_up", (m.n_experts, d_model, m.d_ff_expert),
            ("experts", "embed", "expert_ffn"))
    e.param("w_down", (m.n_experts, m.d_ff_expert, d_model),
            ("experts", "expert_ffn", "embed"))


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: the capacity
    factor's share, rounded up to a multiple of 8 and at least 8."""
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


def moe_ffn(params: Dict, x: torch.Tensor, m: MoEConfig,
            compute_dtype: torch.dtype) -> Tuple[torch.Tensor, MoEAux]:
    """x (b, s, d) -> ((b, s, d) in x's dtype, the auxiliary losses). All
    b s rows are routed together: the capacity, and which tokens compete
    for it, depend on the whole batch."""
    b, s, d = x.shape
    T = b * s
    E, K = m.n_experts, m.top_k
    C = _capacity(T, m)
    xf = x.reshape(T, d)
    dev = x.device

    with span("moe.route"):
        logits = xf.float() @ params["router"].float()           # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (T, K)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)          # renormalize

        # -- aux losses (Switch-style) --------------------------------------
        flat_e = expert_idx.reshape(-1)                          # (T K,)
        counts = (flat_e[:, None] == torch.arange(E, device=dev)).sum(0)
        me = probs.mean(dim=0)                                   # (E,)
        ce = counts.float() / (T * K)
        load_balance = E * torch.sum(me * ce) * m.load_balance_loss
        z_loss = m.router_z_loss * torch.mean(
            torch.square(torch.logsumexp(logits, dim=-1)))

        # -- rank the slots within their expert (stable sort, token-major) -
        order = torch.argsort(flat_e, stable=True)  # slots sorted by expert
        seg_start = torch.cumsum(counts, 0) - counts             # (E,)
        rank_sorted = (torch.arange(T * K, device=dev)
                       - seg_start[flat_e[order]])
        rank = torch.empty_like(rank_sorted).scatter(0, order, rank_sorted)
        keep = rank < C
        slot = torch.where(keep, flat_e * C + rank,
                           torch.full_like(rank, E * C))  # E*C: dropped

    # -- dispatch: place (e, c) holds the c-th slot of expert e's segment --
    with span("moe.dispatch"):
        place = seg_start[:, None] + torch.arange(C, device=dev)  # (E, C)
        filled = torch.arange(C, device=dev) < counts[:, None]
        src = order[torch.clamp(place, max=T * K - 1)] // K      # token ids
        buf = torch.where(filled[..., None], xf.to(compute_dtype)[src],
                          torch.zeros((), dtype=compute_dtype, device=dev))

    # -- expert computation (gated MLP over all experts) --------------------
    with span("moe.experts"):
        ep = params["experts"]
        g = ExpertMatmul.apply(buf, ep["w_gate"].to(compute_dtype))
        u = ExpertMatmul.apply(buf, ep["w_up"].to(compute_dtype))
        out_buf = ExpertMatmul.apply(F.silu(g) * u,
                                     ep["w_down"].to(compute_dtype))

    # -- combine: gather back and weight by the gates -----------------------
    with span("moe.combine"):
        out_flat = out_buf.reshape(E * C, d)
        safe_slot = torch.clamp(slot, max=E * C - 1)
        gathered = torch.where(keep[:, None], out_flat[safe_slot],
                               torch.zeros((), dtype=compute_dtype,
                                           device=dev))
        combined = (gathered.reshape(T, K, d)
                    * gate_vals[..., None].to(compute_dtype)).sum(dim=1)
        out = combined.reshape(b, s, d).to(x.dtype)

    aux = MoEAux(load_balance, z_loss, 1.0 - keep.float().mean())
    return out, aux
