"""Plain PyTorch reference of the decoder the benchmark's configurations
describe: float32 throughout, no kernel, no cache, no batching trick. It
imports nothing of the program and reads only the tensors the benchmark
made, in the same nested-dict layout.

The block (what the program's model computes, and each departure from a
published model is listed in the configuration file): RMSNorm with a
plain ``scale``; rotary embeddings over the whole head, split in halves;
causal softmax attention with GQA; a SwiGLU MLP, or a top-k mixture of
experts whose router runs in float32, whose top-k gates are renormalized
to sum to 1, and whose experts take at most ``C`` tokens each, ranked by
(token, slot) order, ``C = max(8, 8 * ceil(int(T k f / E) / 8))`` for
``T`` tokens routed together and capacity factor ``f`` (each expert's
products over its own kept tokens alone); the auxiliary losses (load
balance, router z-loss) added to the loss; a final RMSNorm and an untied
head over the padded vocabulary.

``precision`` decides the rounding: ``f32`` none (the reference);
``fp8`` (the control, the precision below the configuration's bfloat16)
rounds to float8 e4m3, with a scale per tensor, every matrix product's
operands and result and every activation the program keeps in its
compute dtype (the embedding rows, the norms' outputs, the residual
stream), gradients passing straight through. The router's logits, the
softmaxes and the loss stay float32, as in the program."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@torch.no_grad()
def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    back in x's dtype."""
    scale = x.abs().amax().float().clamp_min(1e-12) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return q.float().mul_(scale).to(x.dtype)


class Rounded(torch.autograd.Function):
    """An activation rounded to float8 e4m3, the gradient passed straight
    through: where the program keeps a tensor in its compute dtype."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class RoundedMatmul(torch.autograd.Function):
    """``round(round(a) @ round(b))`` whose gradients are the rounded
    product's (the rounding passes gradients straight through); it keeps
    a and b, not their rounded copies, and rounds them again in the
    backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(fp8_round(a) @ fp8_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ra, rb = fp8_round(a), fp8_round(b)
        ga = g @ rb.transpose(-1, -2)
        gb = ra.transpose(-1, -2) @ g
        # sum broadcast batch dimensions back to each operand's shape
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def plain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def unrounded(x: torch.Tensor) -> torch.Tensor:
    return x


# precision -> (matrix product, rounding of a kept activation)
PRECISIONS: Dict[str, Tuple[Callable, Callable]] = {
    "f32": (plain_matmul, unrounded),
    "fp8": (RoundedMatmul.apply, Rounded.apply)}


class Model:
    """The reference decoder of a configuration's ``model`` block."""

    def __init__(self, cfg: Dict, precision: str = "f32"):
        self.cfg = cfg
        self.mm, self.keep = PRECISIONS[precision]

    # -- pieces --------------------------------------------------------------

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ms = x.pow(2).mean(-1, keepdim=True)
        return self.keep(
            x * torch.rsqrt(ms + self.cfg.get("norm_eps", 1e-6)) * scale)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        freqs = 1.0 / (self.cfg.get("rope_theta", 10000.0) ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
            / hd))
        ang = pos[..., :, None].float() * freqs            # (..., s, hd/2)
        c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    def attention(self, lp: Dict, h: torch.Tensor, pos: torch.Tensor
                  ) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = h.shape
        nh, kvh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        q = self.mm(h, lp["wq"].reshape(d, nh * hd)).reshape(b, s, nh, hd)
        k = self.mm(h, lp["wk"].reshape(d, kvh * hd)).reshape(b, s, kvh, hd)
        v = self.mm(h, lp["wv"].reshape(d, kvh * hd)).reshape(b, s, kvh, hd)
        q, k = self.rope(q, pos), self.rope(k, pos)
        g = nh // kvh
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (b, h, s, hd)
        scores = self.mm(q, k.transpose(-1, -2)) * hd ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        att = self.mm(torch.softmax(scores, dim=-1), v).transpose(1, 2)
        return self.mm(att.reshape(b, s, nh * hd),
                       lp["wo"].reshape(nh * hd, d))

    def mlp(self, mp: Dict, h: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, mp["w_gate"]))
                       * self.mm(h, mp["w_up"]), mp["w_down"])

    def moe(self, mp: Dict, h: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(output, load-balance loss + router z-loss)."""
        m = self.cfg["moe"]
        b, s, d = h.shape
        T, E, K = b * s, m["n_experts"], m["top_k"]
        x = h.reshape(T, d)
        logits = x @ mp["router"]                      # float32 router
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, K, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        flat = idx.reshape(-1)                         # slot t*K + k
        counts = torch.bincount(flat, minlength=E)
        lb = (E * torch.sum(probs.mean(0) * counts.float() / (T * K))
              * m.get("load_balance_loss", 1e-2))
        z = m.get("router_z_loss", 1e-3) * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2)
        c = int(T * K * m.get("capacity_factor", 1.25) / E)
        cap = max(8, -(-c // 8) * 8)
        # each slot's rank among its expert's slots, in slot order
        onehot = F.one_hot(flat, E)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
        kept = torch.nonzero(rank < cap).flatten()
        # the kept slots in expert order; each expert's products over its
        # own slots alone
        slot = kept[torch.argsort(flat[kept], stable=True)]
        sizes = torch.bincount(flat[slot], minlength=E).tolist()
        tok = slot // K
        ex = mp["experts"]
        w_gate, w_up, w_down = (ex[k].unbind(0)
                                for k in ("w_gate", "w_up", "w_down"))
        ye = torch.cat([
            self.mm(F.silu(self.mm(xe, w_gate[e])) * self.mm(xe, w_up[e]),
                    w_down[e])
            for e, xe in enumerate(torch.split(x[tok], sizes)) if len(xe)])
        out = torch.zeros_like(x).index_add(
            0, tok, ye * gates.reshape(-1)[slot, None])
        return out.reshape(b, s, d), lb + z

    # -- the model ---------------------------------------------------------------

    def forward(self, params: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (b, s) -> (float32 logits (b, s, V), auxiliary loss)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self.keep(params["embed"]["tok"][tokens.long()].float())
        pos = torch.arange(s, device=x.device).expand(b, s)
        aux = torch.zeros((), device=x.device)
        for i in range(cfg["n_layers"]):
            lp = params["layers"][f"L{i}"]
            x = self.keep(x + self.attention(
                lp["attn"], self.norm(x, lp["attn_norm"]["scale"]), pos))
            h = self.norm(x, lp["ffn_norm"]["scale"])
            if "moe" in lp:
                y, a = self.moe(lp["moe"], h)
                aux = aux + a
            else:
                y = self.mlp(lp["mlp"], h)
            x = self.keep(x + y)
        x = self.norm(x, params["final_norm"]["scale"])
        return self.mm(x, params["head"]["w"]), aux

    def loss(self, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
             keep: Optional[int] = None) -> torch.Tensor:
        """Mean next-token cross-entropy plus the auxiliary loss. ``keep``
        counts only the first ``keep`` positions of each sequence (a fault
        of the check's own tests: half the batch left out)."""
        logits, aux = self.forward(params, tokens)
        nll = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, labels.long()[..., None])[..., 0])
        if keep is not None:
            nll = nll[:, :keep]
        return nll.mean() + aux
