"""Decoder assembly, the counterpart of ``repro/models/transformer.py``:
the training forward (``forward`` :149 over ``_apply_layer`` :94, and
``loss_fn`` :178) and the serving path (``init_params``, ``init_cache``,
``prefill`` :328, ``decode_step`` :254, ``PagedKV``, ``cache_layout``
:462 and ``decode_step_paged`` :511).

Every layer kind of the JAX model is ported, for training and serving:
dense attention, Mamba2 SSM layers, top-k MoE FFNs (with arctic's dense
residual MLP), the hybrid's interleave of all three, the VLM's gated
cross-attention over media embeddings (``x + tanh(cross_gate) * y`` after
self-attention, on layers ``cross_attn_every - 1`` mod ``cross_attn_every``)
and the audio models' parallel codebooks (tokens (b, s, n_q), the n_q
embeddings summed, logits (b, s, n_q, V)). An MoE layer's auxiliary
losses (load balance and router z-loss) are summed over the layers into
``loss = ce + moe_loss``, as JAX's ``loss_fn``. Media (b, M, d) ride
beside the tokens: in the batch's ``media`` leaf for training, as
``prefill``'s argument for serving; ``prefill`` keeps each cross layer's
media K/V in the cache and ``decode_step`` attends over them with the
``decode_attn`` kernel (``cache_len`` M), as JAX's ``decode_step`` does
with its jnp twin. A cross layer given no media skips its cross branch,
as in JAX.

Where JAX returns fresh arrays, the port writes caches and pools in place:
a cache is as large as the model's K/V working set, and a copy per step
would double it. Each function returns the structure it wrote.

Parameters are cast to ``compute_dtype`` at every use, as in JAX; for a
tensor already in that dtype the cast is free, so a caller may hold one
compute-dtype copy of the weights (the serving engines do).

Every RMSNorm goes through ``kernels.rmsnorm``, and every one that follows
a residual add (all but the first layer's first) adds that residual in the
same launch (``layers.add_rmsnorm``): the layer loops carry the pending
residual ``delta`` to the next norm. The loss's per-token NLL
through ``kernels.fused_ce``, every SSM layer's prefill and training
forward through ``kernels.ssd_chunk`` (in training through its
``autograd.Function``: one launch for all workers, a plain backward) and
every attention layer of ``decode_step`` through ``kernels.decode_attn``:
the CUDA kernels on a CUDA tensor, their plain versions on the CPU. The
functions take these as keyword arguments (``norm``, ``ce``, ``ssd``,
``attn``, ``attn_kernel``) that default to the kernels; only
``chip_smoke.py``'s agreement phases pass the plain versions.

``worker_losses`` is the training round's form of ``loss_fn``: the
per-worker losses of worker-stacked parameters, ``torch.func.vmap`` of
each piece (embedding, each layer, head and CE) in turn. With
``cfg.remat`` each layer's vmapped call runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of each block): the
backward pass recomputes the layer from its inputs, the pair (x, pending
residual), instead of keeping its activations and weight casts. The
checkpoint lies outside the ``vmap``, so it sees plain worker-stacked
tensors. ``cfg.windowed_qblock`` takes ``flash_attention_windowed`` on
sliding-window layers, in training and in ``prefill``, as JAX does. Under
that ``vmap`` an MoE layer's router is a worker leaf and its experts are
not (``param_axes``): one copy of the experts serves every worker.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attn.decode_attn import decode_attn
from repro_torch.kernels.decode_attn.ops import (decode_attention,
                                                 paged_decode_attention)
from repro_torch.kernels.decode_attn.paged import paged_decode_attn
from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.ssd_chunk import ssd_chunked_kernel
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.attention import (KVCache, attention_init,
                                         cross_attention,
                                         cross_attention_init, cross_kv,
                                         flash_attention,
                                         flash_attention_windowed,
                                         merge_heads, proj_heads)
from repro_torch.models.param import ParamBuilder, build, build_abstract


def _has_attn(cfg: ModelConfig) -> bool:
    return any(cfg.layer_is_attn(i) for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(b: ParamBuilder, cfg: ModelConfig, i: int):
    """The leaves of ``repro/models/transformer.py:39``: a cross-attention
    layer's ``cross_norm``, ``cross`` and ``cross_gate`` (zeros, so the
    branch starts closed) after its self-attention; an MoE FFN on MoE
    layers (with arctic's ``dense_mlp`` beside it), else an MLP after
    attention, and after an SSM mixer only in a hybrid model."""
    s = b.scope(f"L{i}")
    d = cfg.d_model
    if cfg.layer_is_attn(i):
        L.rmsnorm_init(s, "attn_norm", d)
        attention_init(s, "attn", d, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
        if cfg.layer_is_cross_attn(i):
            L.rmsnorm_init(s, "cross_norm", d)
            cross_attention_init(s, "cross", d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim)
            s.param("cross_gate", (1,), (None,), init="zeros")
    if cfg.layer_is_ssm(i):
        L.rmsnorm_init(s, "ssm_norm", d)
        SSM.ssm_init(s, "ssm", d, cfg.ssm)
    if cfg.layer_is_moe(i):
        L.rmsnorm_init(s, "ffn_norm", d)
        MOE.moe_init(s, "moe", d, cfg.moe)
        if cfg.moe.dense_residual and cfg.d_ff > 0:
            L.mlp_init(s, "dense_mlp", d, cfg.d_ff)
    elif cfg.d_ff > 0 and (cfg.layer_is_attn(i) or cfg.family == "hybrid"):
        L.rmsnorm_init(s, "ffn_norm", d)
        L.mlp_init(s, "mlp", d, cfg.d_ff)


def _init_model(b: ParamBuilder, cfg: ModelConfig):
    L.embed_init(b, "embed", cfg.padded_vocab, cfg.d_model, cfg.n_codebooks)
    lb = b.scope("layers")
    for i in range(cfg.n_layers):
        _init_layer(lb, cfg, i)
    L.rmsnorm_init(b, "final_norm", cfg.d_model)
    if not cfg.tie_embeddings:
        L.head_init(b, "head", cfg.d_model, cfg.padded_vocab,
                    cfg.n_codebooks)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                param_dtype=None) -> Dict:
    """Random parameters from ``seed`` on ``device`` (``None``: cuda)."""
    dtype = dtype_of(param_dtype or cfg.param_dtype)
    return build(functools.partial(_init_model, cfg=cfg), seed, dtype,
                 resolve_device(device))


def abstract_params(cfg: ModelConfig, param_dtype=None) -> Tuple[Dict, Dict]:
    """(the parameter tree as meta tensors, its logical-axes tree), as
    JAX's ``abstract_params``: no byte is allocated."""
    dtype = dtype_of(param_dtype or cfg.param_dtype)
    return build_abstract(functools.partial(_init_model, cfg=cfg), dtype)


def param_axes(params: Dict, _path: Tuple[str, ...] = ()) -> Dict:
    """The axes tree the ``Trainer`` takes with ``params``: the leaves
    under an ``experts`` scope (an MoE layer's expert weights) name their
    leading axis ``"experts"``, as JAX's ``ParamBuilder`` does, so
    ``core.replicate_workers`` keeps them single-copy; every other leaf
    names no axis and gets the worker axis."""
    if isinstance(params, dict):
        return {k: param_axes(v, _path + (k,)) for k, v in params.items()}
    if "experts" in _path:
        return ("experts",) + (None,) * (params.dim() - 1)
    return (None,) * params.dim()


def cast_params(params: Dict, dtype: torch.dtype, device=None,
                _name: str = "") -> Dict:
    """The tree on ``device`` (when given) with every matrix in ``dtype``:
    the leaves the model casts to ``compute_dtype`` at use. Vectors (the
    RMSNorm scales and the SSM's per-head leaves, read in float32) and an
    MoE layer's ``router`` (its logits are float32, as JAX's) keep their
    dtype. A leaf that needs no change shares its storage."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device, k)
                for k, v in params.items()}
    keep = params.dim() < 2 or _name == "router"
    return params.to(device=device, dtype=params.dtype if keep else dtype)


# ---------------------------------------------------------------------------
# Shared pieces of one layer
# ---------------------------------------------------------------------------

def _qkv(ap: Dict, h: torch.Tensor, rope, dt: torch.dtype):
    q = L.apply_rope_tables(proj_heads(h, ap["wq"].to(dt)), *rope)
    k = L.apply_rope_tables(proj_heads(h, ap["wk"].to(dt)), *rope)
    return q, k, proj_heads(h, ap["wv"].to(dt))


def _ffn(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
         delta: Optional[torch.Tensor], dt: torch.dtype, norm: L.NormFn
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                    Optional[torch.Tensor]]:
    """The layer's FFN behind its norm, whose launch adds the pending
    residual ``delta`` into x first: the MoE FFN (plus arctic's dense
    residual MLP on the same normed input) or the gated MLP. Returns (x,
    the residual now pending: the FFN's output, the MoE layer's
    ``load_balance_loss + router_z_loss`` or None)."""
    if "moe" in lp:
        x, h = L.add_rmsnorm(lp["ffn_norm"], x, delta, cfg.norm_eps, norm)
        y, aux = MOE.moe_ffn(lp["moe"], h, cfg.moe, dt)
        if cfg.moe.dense_residual and "dense_mlp" in lp:
            y = y + L.mlp(lp["dense_mlp"], h, dt)
        return x, y, aux.load_balance_loss + aux.router_z_loss
    if "mlp" not in lp:
        return x, delta, None
    x, h = L.add_rmsnorm(lp["ffn_norm"], x, delta, cfg.norm_eps, norm)
    return x, L.mlp(lp["mlp"], h, dt), None


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Causal self-attention over the whole sequence: q-blocked on a
    sliding-window layer when ``cfg.windowed_qblock`` is set."""
    if cfg.windowed_qblock and window is not None:
        return flash_attention_windowed(q, k, v, window=window)
    return flash_attention(q, k, v, causal=True, window=window)


def _gated(lp: Dict, y: torch.Tensor) -> torch.Tensor:
    """``tanh(cross_gate) * y``, the gate in y's dtype as JAX casts it to
    the residual's."""
    return torch.tanh(lp["cross_gate"].to(y.dtype)) * y


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor,
            delta: Optional[torch.Tensor], dt: torch.dtype,
            norm: L.NormFn) -> torch.Tensor:
    """The final norm, with the last layer's residual fused in, and the
    head."""
    _, x = L.add_rmsnorm(params["final_norm"], x, delta, cfg.norm_eps, norm)
    if cfg.tie_embeddings:
        return L.tied_head(params["embed"], x, dt, cfg.logits_softcap)
    return L.head(params["head"], x, dt, cfg.logits_softcap)


# ---------------------------------------------------------------------------
# Training / scoring forward
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                 delta: Optional[torch.Tensor], media: Optional[torch.Tensor],
                 rope, i: int, dt: torch.dtype, norm: L.NormFn,
                 ssd: SSM.SSDFn) -> Tuple:
    """JAX's ``_apply_layer`` without a cache: causal self-attention over
    the whole sequence (the layer's window, if any), on a cross layer
    given ``media`` the gated cross-attention over them, and/or the
    Mamba2 mixer in its prefill form (through ``ssd``), then the layer's
    FFN (``_ffn``), each behind its RMSNorm and residual. Each residual
    add runs in the next norm's launch: takes (x, the pending residual)
    and returns them, and an MoE layer's auxiliary loss after them."""
    if cfg.layer_is_attn(i):
        x, h = L.add_rmsnorm(lp["attn_norm"], x, delta, cfg.norm_eps, norm)
        q, k, v = _qkv(lp["attn"], h, rope, dt)
        att = _attend(cfg, q, k, v, cfg.window_for_layer(i))
        delta = merge_heads(att, lp["attn"]["wo"].to(dt))
        if cfg.layer_is_cross_attn(i) and media is not None:
            x, h = L.add_rmsnorm(lp["cross_norm"], x, delta, cfg.norm_eps,
                                 norm)
            delta = _gated(lp, cross_attention(lp["cross"], h, media,
                                               compute_dtype=dt))
    if cfg.layer_is_ssm(i):
        x, h = L.add_rmsnorm(lp["ssm_norm"], x, delta, cfg.norm_eps, norm)
        delta, _ = SSM.ssm_layer(lp["ssm"], h, cfg.ssm, cfg.d_model, dt,
                                 ssd=ssd)
    x, delta, moe_loss = _ffn(cfg, lp, x, delta, dt, norm)
    return (x, delta) if moe_loss is None else (x, delta, moe_loss)


def _call_layer(layer: Callable, key: str, lp: Dict, x: torch.Tensor,
                delta: Optional[torch.Tensor], media: Optional[torch.Tensor]):
    """Runs ``layer`` as it is: the per-layer call of ``forward``."""
    return layer(lp, x, delta, media)


def _layers(cfg: ModelConfig, layer_params: Dict, x: torch.Tensor,
            media: Optional[torch.Tensor], dt: torch.dtype, norm: L.NormFn,
            ssd: SSM.SSDFn, call: Callable = _call_layer
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                       Optional[torch.Tensor]]:
    """The layer loop of the training forward over x (..., b, s, d) and the
    media (..., b, M, d) or None: returns (x, the pending residual, the
    MoE layers' summed auxiliary loss or None for a model without them).
    ``call(layer, key, lp, x, delta, media)`` runs layer ``key``,
    ``layer(lp, x, delta, media)`` on one model's tensors: ``forward``
    calls it as it is, ``worker_losses`` under ``vmap`` (and
    ``checkpoint``)."""
    b, s = x.shape[-3:-1]
    rope = _rope(cfg, torch.arange(s, device=x.device).expand(b, s))
    delta = moe_loss = None
    for i in range(cfg.n_layers):
        def layer(lp, x, delta, media, i=i):
            return _apply_layer(cfg, lp, x, delta, media, rope, i, dt, norm,
                                ssd)
        key = f"L{i}"
        x, delta, *aux = call(layer, key, layer_params[key], x, delta, media)
        if aux:
            moe_loss = aux[0] if moe_loss is None else moe_loss + aux[0]
    return x, delta, moe_loss


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            media: Optional[torch.Tensor] = None, *,
            norm: L.NormFn = rmsnorm_kernel,
            ssd: SSM.SSDFn = ssd_chunked_kernel
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s), or (b, s, n_q) for codebooks, and media (b, M, d) or
    None -> (logits (b, s, V) or (b, s, n_q, V) in ``compute_dtype``, the
    MoE auxiliary loss summed over the layers, zero for a model without
    MoE layers), as JAX's ``forward``. Every norm a layer has and the
    final one are calls of ``norm`` (2 * n_layers + 1 for a dense or MoE
    model, one more a cross layer given media, n_layers + 1 for mamba2),
    all but the first with the residual add before it fused in; every SSM
    layer runs ``ssd`` (default: the ``ssd_chunk`` kernel)."""
    dt = dtype_of(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, dt)
    x, delta, moe_loss = _layers(cfg, params["layers"], x, media, dt, norm,
                                 ssd)
    if moe_loss is None:
        moe_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x, delta, dt, norm), moe_loss


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict, *,
            norm: L.NormFn = rmsnorm_kernel,
            ce: Callable = fused_ce,
            ssd: SSM.SSDFn = ssd_chunked_kernel) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy of ``batch`` (``tokens``, ``labels``, both
    (b, s) or (b, s, n_q), and ``media`` (b, M, d) where the model has
    cross layers), as JAX's ``loss_fn``: (loss, {"ce", "moe_loss"}). The
    logits are widened to float32 and ``ce`` (default: the ``fused_ce``
    kernel; ``kernels.fused_ce.fused_ce_ref`` is its plain version) gives
    each token's (each codebook's) ``logsumexp - label logit``, and the
    mean runs over them all. JAX's two CE forms (``cfg.sharded_ce``:
    one-hot contraction, or ``log_softmax`` and a gather) are that same
    function, so both take ``ce`` here."""
    logits, moe_loss = forward(cfg, params, batch["tokens"],
                               batch.get("media"), norm=norm, ssd=ssd)
    return _loss_of_logits(logits, moe_loss, batch["labels"], ce)


def _loss_of_logits(logits, moe_loss, labels, ce):
    loss_ce = ce(logits.float(), labels).mean()
    return loss_ce + moe_loss, {"ce": loss_ce, "moe_loss": moe_loss}


def worker_losses(cfg: ModelConfig, params: Dict, in_dims: Dict,
                  batch: Dict, *, norm: L.NormFn = rmsnorm_kernel,
                  ce: Callable = fused_ce,
                  ssd: SSM.SSDFn = ssd_chunked_kernel
                  ) -> Tuple[torch.Tensor, Dict]:
    """``vmap(loss_fn)`` over the worker axis, piece by piece: params
    worker-stacked as ``in_dims`` says (0 or None a leaf), batch leaves
    (p, b, s) (``tokens``/``labels``, (p, b, s, n_q) with codebooks, and
    ``media`` (p, b, M, d), mapped like x into every layer). Returns
    (losses (p,), {"ce", "moe_loss"} each (p,)), the same numbers as
    ``vmap(lambda q, b: loss_fn(cfg, q, b))``. With ``cfg.remat`` each
    layer is recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant; no dropout, so no RNG
    state to keep): its norms and its ``ssd_chunk`` launch run twice a
    step (4 * n_layers + 1 calls of ``norm`` a forward and backward for a
    dense or MoE model). Expert leaves come unmapped (``in_dims`` None):
    one copy serves every worker, and each worker's MoE layers add their
    auxiliary loss to its loss."""
    dt = dtype_of(cfg.compute_dtype)
    x = vmap(lambda e, t: L.embed(e, t, dt),
             in_dims=(in_dims["embed"], 0))(params["embed"], batch["tokens"])

    def call(layer, key, lp, x, delta, media):
        run = vmap(layer, in_dims=(in_dims["layers"][key], 0,
                                   None if delta is None else 0,
                                   None if media is None else 0))
        if cfg.remat:
            return checkpoint(run, lp, x, delta, media, use_reentrant=False,
                              preserve_rng_state=False)
        return run(lp, x, delta, media)

    x, delta, moe_loss = _layers(cfg, params["layers"], x,
                                 batch.get("media"), dt, norm, ssd, call)
    out_key = "embed" if cfg.tie_embeddings else "head"
    tail_params = {k: params[k] for k in ("final_norm", out_key)}
    tail_dims = {k: in_dims[k] for k in tail_params}
    moe_dim = 0
    if moe_loss is None:
        moe_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        moe_dim = None

    def tail(tp, x, delta, labels, moe_loss):
        return _loss_of_logits(_logits(cfg, tp, x, delta, dt, norm),
                               moe_loss, labels, ce)

    return vmap(tail, in_dims=(tail_dims, 0, 0, 0, moe_dim))(
        tail_params, x, delta, batch["labels"], moe_loss)


# ---------------------------------------------------------------------------
# Serving: monolithic cache, prefill and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """Per-layer caches: attention layers a ``KVCache`` of ``(batch, size,
    kv, hd)`` in ``dtype``, where ``size`` is the window for sliding-window
    layers (ring layout, slot ``p % size``) and ``max_len`` otherwise, and
    cross layers a second one, ``cross``, of ``(batch, n_media_tokens, kv,
    hd)`` for the media's K/V; SSM layers an ``SSMState`` in float32.
    ``device="meta"`` gives the abstract cache (shapes only), the dry
    run's counterpart of JAX's ``eval_shape`` of ``init_cache``."""
    dev = resolve_device(device)
    cache: Dict[str, Dict] = {}
    for i in range(cfg.n_layers):
        entry: Dict = {}
        if cfg.layer_is_attn(i):
            w = cfg.window_for_layer(i)
            size = min(w, max_len) if w is not None else max_len
            shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
            entry["kv"] = KVCache(
                k=torch.zeros(shape, dtype=dtype_of(dtype), device=dev),
                v=torch.zeros(shape, dtype=dtype_of(dtype), device=dev))
            if cfg.layer_is_cross_attn(i):
                shape = (batch, cfg.n_media_tokens, cfg.n_kv_heads,
                         cfg.head_dim)
                entry["cross"] = KVCache(
                    k=torch.zeros(shape, dtype=dtype_of(dtype), device=dev),
                    v=torch.zeros(shape, dtype=dtype_of(dtype), device=dev))
        if cfg.layer_is_ssm(i):
            entry["ssm"] = SSM.init_ssm_state(batch, cfg.d_model, cfg.ssm,
                                              torch.float32, dev)
        cache[f"L{i}"] = entry
    return cache


def cache_axes(cfg: ModelConfig, long_context: bool = False) -> Dict:
    """The logical-axes tree of ``init_cache``'s output, as JAX's
    (``long_context`` is accepted and, as there, changes nothing: the
    long-context rule table shards ``kv_seq``)."""
    ax: Dict[str, Dict] = {}
    for i in range(cfg.n_layers):
        entry: Dict = {}
        if cfg.layer_is_attn(i):
            spec = ("batch", "kv_seq", "kv_heads", "head_dim")
            entry["kv"] = KVCache(k=spec, v=spec)
            if cfg.layer_is_cross_attn(i):
                mspec = ("batch", "media", "kv_heads", "head_dim")
                entry["cross"] = KVCache(k=mspec, v=mspec)
        if cfg.layer_is_ssm(i):
            entry["ssm"] = SSM.SSMState(
                s=("batch", "ssm_heads", "ssm_state", None),
                conv=("batch", None, "ssm_heads"))
        ax[f"L{i}"] = entry
    return ax


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """The rotary tables of ``positions``, or None for a model without
    attention layers."""
    if not _has_attn(cfg):
        return None
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache: Dict, media: Optional[torch.Tensor] = None, *,
            norm: L.NormFn = rmsnorm_kernel,
            ssd: SSM.SSDFn = ssd_chunked_kernel
            ) -> Tuple[torch.Tensor, Dict]:
    """Fills ``cache`` (in place) from whole prompts ``tokens`` (b, s), or
    (b, s, n_q) for codebooks; returns (last-position logits (b, 1, V) or
    (b, 1, n_q, V), cache). Cross layers given ``media`` (b, M, d) attend
    over them and keep their K/V in the ``cross`` cache (without media
    they skip the branch and that cache stays as it was, as in JAX). SSM
    layers run ``ssd`` (default: the ``ssd_chunk`` kernel's forward) and
    keep their final state and the last ``conv_width - 1``
    pre-convolution inputs."""
    dt = dtype_of(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, dt)
    b, s = tokens.shape[:2]
    rope = _rope(cfg, torch.arange(s, device=x.device).expand(b, s))
    delta = None                # the residual the next norm adds in

    for i in range(cfg.n_layers):
        lp = params["layers"][f"L{i}"]
        entry = cache[f"L{i}"]
        if cfg.layer_is_attn(i):
            kv = entry["kv"]
            w = cfg.window_for_layer(i)
            size = kv.k.shape[1]
            x, h = L.add_rmsnorm(lp["attn_norm"], x, delta, cfg.norm_eps,
                                 norm)
            q, k, v = _qkv(lp["attn"], h, rope, dt)
            att = _attend(cfg, q, k, v, w)
            delta = merge_heads(att, lp["attn"]["wo"].to(dt))
            if w is not None and s >= size:
                # ring layout: the slot of token p is p % size
                kv.k.copy_(torch.roll(k[:, -size:], s % size, dims=1))
                kv.v.copy_(torch.roll(v[:, -size:], s % size, dims=1))
            else:
                kv.k[:, :s] = k.to(kv.k.dtype)
                kv.v[:, :s] = v.to(kv.v.dtype)
            if cfg.layer_is_cross_attn(i) and media is not None:
                x, h = L.add_rmsnorm(lp["cross_norm"], x, delta,
                                     cfg.norm_eps, norm)
                # the media K/V once: attended here, then kept in the cache
                ck, cv = cross_kv(lp["cross"], media, dt)
                cq = proj_heads(h, lp["cross"]["wq"].to(dt))
                delta = _gated(lp, merge_heads(
                    flash_attention(cq, ck, cv, causal=False),
                    lp["cross"]["wo"].to(dt)))
                entry["cross"].k.copy_(ck)
                entry["cross"].v.copy_(cv)
        if cfg.layer_is_ssm(i):
            x, h = L.add_rmsnorm(lp["ssm_norm"], x, delta, cfg.norm_eps,
                                 norm)
            delta, st = SSM.ssm_prefill(lp["ssm"], h, cfg.ssm, cfg.d_model,
                                        dt, ssd)
            entry["ssm"].s.copy_(st.s)
            entry["ssm"].conv.copy_(st.conv)
        x, delta, _ = _ffn(cfg, lp, x, delta, dt, norm)

    # only the last position reaches the head, and nothing reads the full
    # final x: the last residual is added for that row alone
    last = None if delta is None else delta[:, -1:]
    return _logits(cfg, params, x[:, -1:], last, dt, norm), cache


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                cache: Dict, index: int, media: Optional[torch.Tensor] = None,
                *, attn: Callable = decode_attn,
                norm: L.NormFn = rmsnorm_kernel
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token per sequence against the monolithic cache, as JAX's
    ``decode_step``: tokens (b, 1), or (b, 1, n_q) for codebooks;
    ``index`` is the number of tokens already in the cache, the same for
    every row (the host's loop counter, so no step reads the device).
    Attention layers write the new K/V at slot ``index`` (``index % size``
    on ring layers) and attend over ``min(index + 1, size)`` positions
    with ``attn`` (default: the ``decode_attn`` kernel), without a
    window; cross layers then attend over all ``n_media_tokens`` media
    positions of their ``cross`` cache with ``attn`` too; SSM layers step
    their state. The cache is written in place. Returns (logits (b, 1, V)
    or (b, 1, n_q, V), cache). ``media`` is taken and not read, as in
    JAX's signature: the cross layers read the media's K/V that
    ``prefill`` left in the cache."""
    dt = dtype_of(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, dt)
    rope = _rope(cfg, torch.full((x.shape[0], 1), index, device=x.device))
    delta = None                # the residual the next norm adds in

    for i in range(cfg.n_layers):
        lp = params["layers"][f"L{i}"]
        entry = cache[f"L{i}"]
        if cfg.layer_is_attn(i):
            kv = entry["kv"]
            size = kv.k.shape[1]
            x, h = L.add_rmsnorm(lp["attn_norm"], x, delta, cfg.norm_eps,
                                 norm)
            q, k, v = _qkv(lp["attn"], h, rope, dt)
            slot = index if cfg.window_for_layer(i) is None else index % size
            kv.k[:, slot] = k[:, 0].to(kv.k.dtype)
            kv.v[:, slot] = v[:, 0].to(kv.v.dtype)
            att = decode_attention(q, kv.k, kv.v, min(index + 1, size),
                                   window=None, kernel=attn)
            delta = merge_heads(att, lp["attn"]["wo"].to(dt))
            if cfg.layer_is_cross_attn(i):
                ck = entry["cross"]
                x, h = L.add_rmsnorm(lp["cross_norm"], x, delta,
                                     cfg.norm_eps, norm)
                cq = proj_heads(h, lp["cross"]["wq"].to(dt))
                catt = decode_attention(cq, ck.k, ck.v, ck.k.shape[1],
                                        window=None, kernel=attn)
                delta = _gated(lp, merge_heads(
                    catt, lp["cross"]["wo"].to(dt)))
        if cfg.layer_is_ssm(i):
            x, h = L.add_rmsnorm(lp["ssm_norm"], x, delta, cfg.norm_eps,
                                 norm)
            delta, st = SSM.ssm_layer(lp["ssm"], h, cfg.ssm, cfg.d_model, dt,
                                      state=entry["ssm"])
            entry["ssm"].s.copy_(st.s)
            entry["ssm"].conv.copy_(st.conv)
        x, delta, _ = _ffn(cfg, lp, x, delta, dt, norm)

    return _logits(cfg, params, x, delta, dt, norm), cache


# ---------------------------------------------------------------------------
# Serving: paged cache layout + decode
# ---------------------------------------------------------------------------

class PagedKV(NamedTuple):
    """Per-layer K/V block pools, shape (n_pool, block_size, kv_heads,
    head_dim). The last pool row is the trash block inactive rows write
    into; every other row is addressed through a per-request block table."""
    k: torch.Tensor
    v: torch.Tensor


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def cache_layout(cfg: ModelConfig, max_len: int, block_size: int = 16
                 ) -> Dict:
    """Static paged-cache geometry, as ``repro.models.cache_layout``:
    ``"full"`` groups full-attention layers (slot ``p``, a table of
    ``ceil(max_len / block_size)`` entries filled at admission);
    ``"ring{R}"`` groups sliding-window layers whose window is padded to a
    block multiple ``R`` (slot ``p % R``, static tables). SSM layers are
    marked ``"ssm": True`` and hold per-slot state instead of blocks; a
    model without attention layers has no groups. Cross-attention (media)
    layers have no paged form and raise, as in JAX: those archs serve
    through the legacy ``ServeEngine``."""
    layers: Dict[str, Dict] = {}
    groups: Dict[str, Dict] = {}
    for i in range(cfg.n_layers):
        ent: Dict = {}
        if cfg.layer_is_cross_attn(i):
            raise NotImplementedError(
                "paged cache does not cover cross-attention (media) layers; "
                "use the legacy ServeEngine for media archs")
        if cfg.layer_is_attn(i):
            w = cfg.window_for_layer(i)
            size = min(w, max_len) if w is not None else max_len
            if w is not None:
                ring = _ceil_to(size, block_size)
                group = f"ring{ring}"
                groups.setdefault(group, {"ring": ring,
                                          "n_blk": ring // block_size})
            else:
                ring = None
                group = "full"
                groups.setdefault(group, {
                    "ring": None,
                    "n_blk": _ceil_to(max_len, block_size) // block_size})
            ent["attn"] = {"group": group, "ring": ring, "window": size}
        if cfg.layer_is_ssm(i):
            ent["ssm"] = True
        layers[f"L{i}"] = ent
    return {"layers": layers, "groups": groups, "block_size": block_size,
            "max_len": max_len}


def decode_step_paged(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                      pools: Dict, tables: Dict, index: torch.Tensor,
                      active: Optional[torch.Tensor] = None, *,
                      max_len: int, block_size: int = 16,
                      attn_kernel: Callable = paged_decode_attn,
                      norm: L.NormFn = rmsnorm_kernel
                      ) -> Tuple[torch.Tensor, Dict]:
    """One decode step against the paged cache; rows are independent
    requests at independent positions.

    tokens (n, 1); ``index`` (n,) int32 is the position each row's token is
    written at; ``tables`` maps layout-group name to (n, n_blk) int32
    physical block ids; ``pools`` maps ``L{i}`` to ``{"attn": PagedKV}``
    and/or ``{"ssm": SSMState}`` (one state row per slot), written in
    place. ``active`` (n,) bool redirects inactive rows' K/V writes to the
    trash block and freezes their SSM state. ``attn_kernel`` is the paged
    attention function of ``kernels.decode_attn``; the engine keeps the
    default. Returns (logits (n, 1, V), pools)."""
    layout = cache_layout(cfg, max_len, block_size)
    dt = dtype_of(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, dt)
    rope = _rope(cfg, index[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    idx = index.long()
    writes: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    delta = None                # the residual the next norm adds in

    for i in range(cfg.n_layers):
        lp = params["layers"][f"L{i}"]
        lay = layout["layers"][f"L{i}"]
        if "attn" in lay:
            al = lay["attn"]
            kv: PagedKV = pools[f"L{i}"]["attn"]
            table, ring = tables[al["group"]], al["ring"]
            if al["group"] not in writes:     # shared by the group's layers
                slot = torch.remainder(idx, ring) if ring is not None else idx
                # a finished row keeps its last index, which may lie past a
                # table sliced to the running rows' width: clamp (JAX's
                # gather clamps too); the row is redirected to the trash
                # block below
                col = torch.clamp(slot // block_size, max=table.shape[1] - 1)
                pb = table[rows, col].long()
                if active is not None:
                    pb = torch.where(active, pb,
                                     torch.full_like(pb, kv.k.shape[0] - 1))
                writes[al["group"]] = (pb, torch.remainder(slot, block_size))
            pb, off = writes[al["group"]]
            x, h = L.add_rmsnorm(lp["attn_norm"], x, delta, cfg.norm_eps,
                                 norm)
            q, k, v = _qkv(lp["attn"], h, rope, dt)
            kv.k[pb, off] = k[:, 0].to(kv.k.dtype)
            kv.v[pb, off] = v[:, 0].to(kv.v.dtype)
            att = paged_decode_attention(q, kv.k, kv.v, table, index,
                                         ring=ring, window=al["window"],
                                         kernel=attn_kernel)
            delta = merge_heads(att, lp["attn"]["wo"].to(dt))
        if "ssm" in lay:
            old = pools[f"L{i}"]["ssm"]
            x, h = L.add_rmsnorm(lp["ssm_norm"], x, delta, cfg.norm_eps,
                                 norm)
            delta, st = SSM.ssm_layer(lp["ssm"], h, cfg.ssm, cfg.d_model, dt,
                                      state=old)
            for new_t, old_t in zip(st, old):
                if active is not None:      # inactive rows keep their state
                    keep = active.reshape((-1,) + (1,) * (new_t.dim() - 1))
                    new_t = torch.where(keep, new_t, old_t)
                old_t.copy_(new_t)
        x, delta, _ = _ffn(cfg, lp, x, delta, dt, norm)

    return _logits(cfg, params, x, delta, dt, norm), pools


__all__ = ["KVCache", "PagedKV", "cache_layout", "cast_params",
           "decode_step", "decode_step_paged", "forward", "init_cache",
           "init_params", "loss_fn", "param_axes", "prefill",
           "worker_losses"]
