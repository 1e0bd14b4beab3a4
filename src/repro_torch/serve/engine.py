"""Serving engines, the counterparts of ``repro/serve/engine.py``:
``ContinuousEngine`` (:128-434), continuous batching on the paged KV
cache, the legacy ``ServeEngine`` (:50-114), a monolithic cache and a
host token loop, and ``HotSwapBridge`` (:437-483), which swaps a trainer's
consensus into a running ``ContinuousEngine``. Both engines serve
dense-attention, SSM, MoE and hybrid archs; the vision (cross-attention)
and audio (codebook) archs serve through ``ServeEngine`` only, as in JAX.

Requests are admitted into and evicted from the running batch at token
boundaries (``serve/scheduler.py``). Admission prefills a request into a
monolithic scratch cache and scatters it into the request's reserved
blocks (``serve/paged_cache.py``); its first token rides the batch state
until the next collect.

The JAX decode chunk is one jitted ``lax.while_loop``. Here it is a host
loop of up to ``chunk`` decode steps. The per-row state (last token,
index, remaining budget, done flags, output buffer) stays on the device
and the host reads it once per chunk, in ``_collect``. The host works out
the chunk's length from what it knows without reading the device: each
running request's remaining budget. With requests waiting (``stop_early``)
the chunk ends when the first running request spends its budget, as the
JAX loop's early exit does; otherwise it runs until every budget is spent
or ``chunk`` steps. A request that emits ``eos_id`` stops on the device at
once (its later steps write to the trash block) and is collected at the
chunk's end: the JAX loop may end such a chunk earlier, which changes no
request's tokens.

Greedy decoding is an argmax in float32. Sampling uses Gumbel-max with
noise from a counter-based hash of (engine seed, request seed, absolute
position, vocab id): a pure function of the request, never of the batch it
rides in, so sampled output does not depend on the schedule. JAX's
``fold_in`` bits cannot be matched, so sampled tokens differ from the JAX
engine's; greedy tokens are held to it.

``ServeEngine`` prefills a batch of equal-length prompts into a
monolithic cache and decodes one token a step for every row
(``models.transformer.decode_step``, whose attention layers run the
``decode_attn`` kernel, the cross layers' attention over the media too).
An audio arch decodes a token per codebook a step: each (row, codebook)
is a stream, with its own sampling key and its own stop token. The host
loop knows the position, so it passes ``cache_len`` to the kernel as an
argument; the tokens stay on the device until the end, unless ``eos_id``
is set, when each step's tokens are read to decide whether every stream
has stopped (as in JAX).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import fence, resolve_device
from repro_torch.models.transformer import (cast_params, decode_step,
                                            decode_step_paged, init_cache,
                                            prefill)
from repro_torch.obs import NULL, HotSwap, ServeSample
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.train.evaluate import consensus_params
from repro_torch.tree import tree_leaves

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32), on Python ints or int64
    tensors, without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """murmur3's 32-bit finalizer on values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _request_key(engine_seed: int, request_seed: int) -> int:
    return _hash32(_hash32(engine_seed & _M32) ^ (request_seed & _M32))


def _stream_keys(seed: int, rows: int, n_codebooks: int) -> List[int]:
    """The sampling key of each stream, row-major: a row's request key, or
    for codebooks that key hashed with the codebook."""
    keys = [_request_key(seed, row) for row in range(rows)]
    if not n_codebooks:
        return keys
    return [_hash32(k ^ c) for k in keys for c in range(n_codebooks)]


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                keys: torch.Tensor, pos: torch.Tensor,
                any_sampled: bool) -> torch.Tensor:
    """Per-row sampling: argmax where temp <= 0, else Gumbel-max on
    ``logits / temp`` with noise hashed from (key, position, vocab id).
    logits (n, V) float32 -> (n,) int32."""
    greedy = logits.argmax(dim=-1)
    if not any_sampled:
        return greedy.to(torch.int32)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    row = _hash32((keys + _mul32(pos.long() & _M32, 0x9E3779B1)) & _M32)
    bits = _hash32(row[:, None] ^ vocab[None, :])
    u = ((bits >> 8).float() + 0.5) / float(1 << 24)      # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    cat = (logits / safe_t[:, None] + gumbel).argmax(dim=-1)
    return torch.where(temps > 0, cat, greedy).to(torch.int32)


class ServeEngine:
    """Legacy engine: a monolithic ``(b, max_len, ...)`` cache and a
    Python token loop, as ``repro/serve/engine.py:50``. It covers every
    arch, media (cross-attention) and codebook (audio) ones included.
    ``device=None`` means cuda.
    """

    def __init__(self, cfg: ModelConfig, params: Dict, max_len: int = 2048,
                 cache_dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # one compute-dtype copy of the weights, as ContinuousEngine keeps
        self.params = cast_params(params, dtype_of(cfg.compute_dtype),
                                  self.device)
        self.max_len = max_len
        self.cache_dtype = dtype_of(cache_dtype)
        self.decode_steps = 0
        self.prefills = 0

    def generate(self, prompt: np.ndarray, n_new: int,
                 media: Optional[np.ndarray] = None,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """prompt: (b, s) int32, or (b, s, n_q) for a codebook arch.
        ``media`` (b, M, d), numpy or a tensor: the patch embeddings a
        cross-attention arch's prefill attends over (the decode steps read
        their K/V from the cache); a text arch ignores them, as JAX's
        engine does. Greedy (an argmax in float32, per codebook) if
        ``temperature`` <= 0, else Gumbel-max sampling keyed by (``seed``,
        row, codebook, absolute position). Returns (b, n) int32 tokens, or
        (b, n, n_q), n = n_new unless ``eos_id`` stopped every stream
        earlier; with ``eos_id`` a stream's (a row's, or a row's
        codebook's) tokens after its first stop token are the stop token,
        as in JAX."""
        prompt = np.asarray(prompt, np.int32)
        b, s = prompt.shape[:2]
        if s + n_new > self.max_len:
            raise ValueError(
                f"prompt ({s}) + n_new ({n_new}) = {s + n_new} tokens "
                f"exceeds the cache budget max_len={self.max_len}")
        cfg, dev = self.cfg, self.device
        if media is not None:
            media = torch.as_tensor(media).to(dev)
        cache = init_cache(cfg, b, self.max_len, self.cache_dtype, dev)
        logits, cache = prefill(cfg, self.params,
                                torch.from_numpy(prompt).to(dev), cache,
                                media)
        self.prefills += 1
        keys = torch.tensor(_stream_keys(seed, b, cfg.n_codebooks),
                            dtype=torch.int64, device=dev)
        n = len(keys)                   # streams: rows x codebooks
        temps = torch.full((n,), float(temperature), device=dev)
        sampled = temperature > 0

        def sample(lg, pos):
            rows = lg[:, -1].float().reshape(n, lg.shape[-1])
            tok = sample_rows(rows, temps, keys,
                              torch.full((n,), pos, device=dev), sampled)
            return tok.reshape(b, 1, *lg.shape[2:-1])

        out = [sample(logits, s)]
        done = (out[-1][:, 0] == eos_id).cpu().numpy() \
            if eos_id is not None else None
        index = s
        for _ in range(n_new - 1):
            if done is not None and done.all():
                break
            logits, cache = decode_step(cfg, self.params, out[-1], cache,
                                        index)
            self.decode_steps += 1
            out.append(sample(logits, index + 1))
            if done is not None:
                done |= (out[-1][:, 0] == eos_id).cpu().numpy()
            index += 1
        toks = torch.cat(out, dim=1).cpu().numpy()
        if eos_id is not None:
            hit = toks == eos_id
            past_eos = np.cumsum(hit, axis=1) - hit   # strictly after first
            toks = np.where(past_eos > 0, eos_id, toks)
        return toks


class ContinuousEngine:
    """Continuous-batching engine on the paged KV cache.

    ``n_slots`` concurrent requests share per-layer block pools; admission
    reserves each request's whole token budget from the free list, so
    decode never allocates. Finished rows keep riding the batch (K/V writes
    go to the trash block) until the host recycles their slot at the end of
    the chunk. ``eos_id``, when set, is a stop token: a row that emits it
    finishes whatever its remaining budget. ``device=None`` means cuda.

    ``telemetry`` (a ``repro_torch.obs`` sink; default ``NullSink``, off)
    receives one ``ServeSample`` a ``step()``: the fenced chunk wall, the
    inter-token latency, the time to first token of the requests admitted
    in the step, block-pool occupancy, queue depth, admissions and
    finishes. With the default sink the engine adds no fence and no host
    read.
    """

    def __init__(self, cfg: ModelConfig, params: Dict, n_slots: int = 8,
                 max_len: int = 2048, block_size: int = 16,
                 cache_dtype=torch.bfloat16, chunk: int = 32,
                 full_blocks: Optional[int] = None, seed: int = 0,
                 eos_id: Optional[int] = None, device=None, telemetry=None):
        for i in range(cfg.n_layers):
            if cfg.layer_is_cross_attn(i):
                raise NotImplementedError(
                    "ContinuousEngine does not serve cross-attention "
                    "(media) archs — use the legacy ServeEngine")
        if cfg.n_codebooks:
            raise NotImplementedError(
                "ContinuousEngine does not serve multi-codebook (audio) "
                "archs — use the legacy ServeEngine")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        # what the engine was handed (JAX's engine serves from it; the
        # bridge measures drift against it), beside its own copy
        self.given_params = params
        self.params = self._on_device(params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.cache_dtype = dtype_of(cache_dtype)
        self.chunk = chunk
        self.cache = PagedCache(cfg, n_slots, max_len, block_size,
                                dtype=self.cache_dtype,
                                full_blocks=full_blocks, device=self.device)
        self.scheduler = Scheduler(n_slots)
        self.tokens_generated = 0
        self.decode_steps = 0
        self.prefills = 0                # batched prefill calls
        self.n_swaps = 0
        self.eos_id = eos_id
        self.seed = seed
        self.telemetry = telemetry if telemetry is not None else NULL

        n, dev = n_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._st: Dict[str, torch.Tensor] = {
            "last_tok": torch.zeros((n, 1), **i32),
            "index": torch.zeros((n,), **i32),
            "remaining": torch.zeros((n,), **i32),
            "active": torch.zeros((n,), dtype=torch.bool, device=dev),
            # chunk steps + the admission-time first token of a fresh row
            "out_buf": torch.zeros((n, chunk + 1), **i32),
            "out_pos": torch.zeros((n,), **i32),
            "keys": torch.zeros((n,), dtype=torch.int64, device=dev),
            "temps": torch.zeros((n,), dtype=torch.float32, device=dev),
        }
        self._rows = torch.arange(n, device=dev)
        # host copies of what the host set itself: remaining budget (not
        # counting stop tokens) and temperature of each slot's request
        self._remaining = np.zeros(n, np.int64)
        self._temps = np.zeros(n, np.float32)
        # prefill scratch caches keyed (batch, prompt bucket)
        self._mono_scratch: Dict[tuple, Dict] = {}

    def _on_device(self, params: Dict) -> Dict:
        # One compute-dtype copy of the weights on the card: the model's
        # per-use casts to compute_dtype are then free (JAX casts its f32
        # params at every use instead).
        return cast_params(params, self.compute_dtype, self.device)

    # -- request API --------------------------------------------------------

    def submit(self, prompt: np.ndarray, n_new: int,
               temperature: float = 0.0, seed: int = 0) -> int:
        """prompt: (s,) int32. Returns a request id; drive with step()/run().
        The whole token budget is validated here."""
        prompt = np.asarray(prompt, np.int32)
        s = prompt.shape[-1]
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if s + n_new > self.max_len:
            raise ValueError(
                f"prompt ({s}) + n_new ({n_new}) = {s + n_new} tokens "
                f"exceeds the cache budget max_len={self.max_len}")
        need = self.cache.blocks_needed(s + n_new)
        total = self.cache._group_phys.get("full", 0)
        if need > total > 0:
            raise ValueError(
                f"request needs {need} cache blocks but the pool only has "
                f"{total}: raise full_blocks or max_len")
        return self.scheduler.submit(prompt, n_new, temperature, seed)

    def swap_params(self, params: Dict) -> None:
        """Serve ``params`` from the next decode step on; in-flight request
        state is untouched."""
        self.given_params = params
        self.params = self._on_device(params)
        self.n_swaps += 1

    @property
    def n_running(self) -> int:
        return len(self.scheduler.running)

    # -- drive --------------------------------------------------------------

    def _admit_all(self) -> List[Request]:
        """Admit every waiting request that fits (FIFO, stop at the first
        that does not). Admissions sharing a prompt length share one batched
        prefill into a bucketed scratch cache; each request's prefill K/V is
        then scattered into its reserved blocks and its first token set in
        the batch state, to be collected with the next chunk. A telemetry
        sink adds one fence a prefill group, to stamp its requests' first
        tokens for the time to first token."""
        admitted: List[Request] = []
        while True:
            req = self.scheduler.next_admit()
            if req is None or not self.cache.can_admit(req.total_budget):
                break
            r = self.scheduler.admit()
            self.cache.reserve(r.slot, r.total_budget)
            admitted.append(r)
        by_len: Dict[int, List[Request]] = {}
        for r in admitted:
            by_len.setdefault(len(r.prompt), []).append(r)
        st, dev = self._st, self.device
        for n_prompt, group in by_len.items():
            k = len(group)
            bucket = min(self.max_len,
                         1 << max(3, (n_prompt - 1).bit_length()))
            if (k, bucket) not in self._mono_scratch:
                self._mono_scratch[(k, bucket)] = init_cache(
                    self.cfg, k, bucket, self.cache_dtype, dev)
            prompts = torch.from_numpy(
                np.stack([r.prompt for r in group])).to(dev)
            logits, mono = prefill(self.cfg, self.params, prompts,
                                   self._mono_scratch[(k, bucket)])
            self.prefills += 1
            for i, r in enumerate(group):
                self.cache.write_prefill(r.slot, mono, n_prompt, row=i)
            slots = [r.slot for r in group]
            temps = np.asarray([r.temperature for r in group], np.float32)
            keys = torch.tensor([_request_key(self.seed, r.seed)
                                 for r in group], dtype=torch.int64,
                                device=dev)
            temps_t = torch.from_numpy(temps).to(dev)
            tok = sample_rows(logits[:, -1].float(), temps_t, keys,
                              torch.full((k,), n_prompt, device=dev),
                              bool((temps > 0).any()))
            sl = torch.tensor(slots, device=dev)
            n_new = torch.tensor([r.n_new for r in group], dtype=torch.int32,
                                 device=dev)
            st["last_tok"][sl, 0] = tok
            st["index"][sl] = n_prompt
            st["remaining"][sl] = n_new - 1
            st["active"][sl] = n_new > 1
            st["out_buf"][sl, 0] = tok
            st["out_pos"][sl] = 1
            st["keys"][sl] = keys
            st["temps"][sl] = temps_t
            for r in group:
                self._remaining[r.slot] = r.n_new - 1
                self._temps[r.slot] = r.temperature
            if self.telemetry.enabled:
                fence(self.device)
                now = time.perf_counter()
                for r in group:
                    r.t_first = now
        return admitted

    def _chunk_steps(self, stop_early: bool) -> int:
        rem = [int(self._remaining[s]) for s in self.scheduler.running
               if self._remaining[s] > 0]
        if not rem:
            return 0
        return min(self.chunk, min(rem) if stop_early else max(rem))

    def _decode_once(self, tables: Dict[str, torch.Tensor],
                     any_sampled: bool) -> None:
        st = self._st
        logits, _ = decode_step_paged(
            self.cfg, self.params, st["last_tok"], self.cache.pools, tables,
            st["index"], st["active"], max_len=self.max_len,
            block_size=self.block_size)
        self.decode_steps += 1
        tok = sample_rows(logits[:, -1].float(), st["temps"], st["keys"],
                          st["index"] + 1, any_sampled)
        act = st["active"]
        st["last_tok"] = torch.where(act[:, None], tok[:, None],
                                     st["last_tok"])
        opc = st["out_pos"].clamp(max=st["out_buf"].shape[1] - 1).long()
        st["out_buf"][self._rows, opc] = torch.where(
            act, tok, st["out_buf"][self._rows, opc])
        inc = act.to(torch.int32)
        st["index"] += inc
        st["out_pos"] += inc
        st["remaining"] -= inc
        act = act & (st["remaining"] > 0)
        if self.eos_id is not None:        # done-flag on the device
            act = act & (tok != self.eos_id)
        st["active"] = act

    def _collect(self) -> List[Request]:
        st = self._st
        host = torch.cat([st["out_buf"], st["out_pos"][:, None],
                          st["active"][:, None].to(torch.int32)],
                         dim=1).cpu().numpy()          # the chunk's one read
        out_buf, out_pos, active = host[:, :-2], host[:, -2], host[:, -1]
        finished: List[Request] = []
        for slot, req in list(self.scheduler.running.items()):
            k = int(out_pos[slot])
            if k:
                req.tokens.extend(int(t) for t in out_buf[slot, :k])
                self.tokens_generated += k
            if not active[slot]:         # budget spent or stop token emitted
                self.cache.release(slot)
                finished.append(self.scheduler.evict(slot))
        st["out_pos"].zero_()
        return finished

    def step(self) -> List[Request]:
        """One scheduling round: admit waiting requests into free slots, run
        one decode chunk, collect tokens and recycle finished slots. Returns
        the requests that finished this round."""
        tele = self.telemetry
        obs_on = tele.enabled
        admitted = self._admit_all()
        if not self.scheduler.running:
            return []
        n_steps = self._chunk_steps(stop_early=bool(self.scheduler.queue))
        t0 = time.perf_counter() if obs_on else 0.0
        if n_steps:
            # attend only over full-group table columns that reserved blocks
            # back (the kernel takes a contiguous table)
            tables = self.cache.tables
            full = tables.get("full")
            w = self.cache.used_width()
            if full is not None and w is not None and w < full.shape[1]:
                tables = {**tables, "full": full[:, :w].contiguous()}
            running = list(self.scheduler.running)
            any_sampled = bool((self._temps[running] > 0).any())
            for _ in range(n_steps):
                self._decode_once(tables, any_sampled)
            for s in running:
                self._remaining[s] = max(0, self._remaining[s] - n_steps)
        if obs_on:
            fence(self.device)
            chunk_s = time.perf_counter() - t0
        tokens_before = self.tokens_generated
        finished = self._collect()
        if obs_on:
            now = time.perf_counter()
            free = self.cache.free_blocks()
            total = self.cache._group_phys.get("full", 0)
            tele.emit(ServeSample(
                chunk_s=chunk_s, steps=n_steps,
                tokens=self.tokens_generated - tokens_before,
                itl_s=chunk_s / max(n_steps, 1),
                n_running=self.n_running,
                queue_depth=len(self.scheduler.queue),
                admitted=len(admitted), finished=len(finished),
                blocks_free=free, blocks_total=total,
                occupancy=(1.0 - free / total) if total else 0.0,
                ttft_s=[r.t_first - r.t_submit for r in admitted
                        if r.t_first is not None],
                e2e_s=[now - r.t_submit for r in finished]))
        return finished

    def run(self) -> Dict[int, np.ndarray]:
        """Drain queue + running batch; returns {rid: generated tokens}."""
        while not self.scheduler.idle:
            self.step()
        return {rid: np.asarray(r.tokens, np.int32)
                for rid, r in self.scheduler.finished.items()}

    def generate(self, prompts: np.ndarray, n_new: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Submit one request per row (row i seeded ``seed + i``), drain,
        return (b, n_new) in submission order."""
        prompts = np.asarray(prompts, np.int32)
        rids = [self.submit(p, n_new, temperature, seed + i)
                for i, p in enumerate(prompts)]
        done = self.run()
        return np.stack([done[r] for r in rids])


class HotSwapBridge:
    """``Trainer.run(serve_hook=...)`` adapter: each call takes the Sec. 4.1
    fixed point (``train.evaluate.consensus_params``) and swaps it into a
    live ``ContinuousEngine``; in-flight requests keep decoding. Each swap
    appends a staleness record to ``swaps``: the round, rounds since the
    last swap, tokens served under the previous params, the L2 drift the
    swap closed and the requests in flight.

    ``param_drift_l2`` is the float32 distance between the params last
    handed to the engine (``engine.given_params``: at its construction or
    at the last swap, in the dtype the caller gave them) and the new
    consensus, as JAX measures it against what its engine was given; not
    against the engine's compute-dtype copy.

    ``telemetry`` defaults to the engine's sink, so a bridge over an
    instrumented engine emits a ``HotSwap`` a swap; an explicit sink (or
    ``repro_torch.obs.NULL``) overrides it."""

    def __init__(self, engine, telemetry=None):
        self.engine = engine
        self.telemetry = (telemetry if telemetry is not None
                          else getattr(engine, "telemetry", NULL))
        self.swaps: List[Dict] = []
        self._last_round: Optional[int] = None
        self._tokens_at_swap = engine.tokens_generated

    @staticmethod
    def _drift(old: Dict, new: Dict) -> float:
        sq = [torch.sum(torch.square(
                  a.to(device=b.device, dtype=torch.float32) - b.float()))
              for a, b in zip(tree_leaves(old), tree_leaves(new))]
        return float(torch.sqrt(sum(sq)))

    def __call__(self, round_idx: int, params: Dict, axes: Dict) -> Dict:
        new = consensus_params(params, axes)
        rec = {
            "round": int(round_idx),
            "rounds_since_last": (int(round_idx) - self._last_round
                                  if self._last_round is not None else None),
            "tokens_under_prev": self.engine.tokens_generated
            - self._tokens_at_swap,
            "param_drift_l2": self._drift(self.engine.given_params, new),
            "in_flight": self.engine.n_running,
        }
        self.engine.swap_params(new)
        self._last_round = int(round_idx)
        self._tokens_at_swap = self.engine.tokens_generated
        self.swaps.append(rec)
        if self.telemetry.enabled:
            self.telemetry.emit(HotSwap(**rec))
        return rec
