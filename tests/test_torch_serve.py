"""The port's serving slice against the JAX package, at the smoke size.

Both packages run gemma3's smoke config in float32 with the same weights
(JAX's, carried over by ``params_from_numpy``). Logits of ``prefill`` and
``decode_step_paged`` agree within 1e-4 absolute (logits of order ten,
float32 sums in another order); greedy tokens of ``ContinuousEngine`` are
identical. Sampled tokens cannot match JAX's ``fold_in`` bits, so sampling
is held to schedule independence within the port.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import decode_step_paged as jax_decode_step_paged
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import PagedCache as JaxPagedCache
from repro_torch.configs import get_smoke_config
from repro_torch.models import (decode_step_paged, init_cache, prefill,
                                params_from_numpy)
from repro_torch.serve import ContinuousEngine, PagedCache

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LOGIT_ATOL = 1e-4
MAX_LEN, BLOCK = 64, 8


def _setup(seed):
    jcfg = dataclasses.replace(jax_smoke("gemma3-1b"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"),
                              compute_dtype="float32")
    jp, _ = jax_init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _engines(seed, **kw):
    jcfg, jp, cfg, tp = _setup(seed)
    jeng = JaxEngine(jcfg, jp, max_len=MAX_LEN, block_size=BLOCK,
                     cache_dtype=jnp.float32, **kw)
    teng = ContinuousEngine(cfg, tp, max_len=MAX_LEN, block_size=BLOCK,
                            cache_dtype=torch.float32, device="cpu", **kw)
    return jeng, teng


def _serve(eng, prompts, n_news):
    rids = [eng.submit(p, n, seed=i)
            for i, (p, n) in enumerate(zip(prompts, n_news))]
    done = eng.run()
    return [np.asarray(done[r]) for r in rids]


def test_prefill_and_paged_decode_logits_match_jax():
    """Two requests, one past gemma3's 16-token window, prefilled into the
    paged cache and decoded step by step; one row sits out a step
    (inactive: its K/V write goes to the trash block)."""
    jcfg, jp, cfg, tp = _setup(0)
    prompts = _prompts(0, (20, 7), cfg.vocab_size)
    steps = 6
    j_prefill = jax.jit(functools.partial(jax_prefill, jcfg))
    j_decode = jax.jit(functools.partial(jax_decode_step_paged, jcfg),
                       static_argnames=("max_len", "block_size"))
    jcache = JaxPagedCache(jcfg, 2, MAX_LEN, BLOCK, dtype=jnp.float32)
    tcache = PagedCache(cfg, 2, MAX_LEN, BLOCK, dtype=torch.float32,
                        device="cpu")
    for slot, p in enumerate(prompts):
        jl, jmono = j_prefill(jp, jnp.asarray(p[None]),
                              jax_init_cache(jcfg, 1, 32, jnp.float32))
        tl, tmono = prefill(cfg, tp, torch.from_numpy(p[None]),
                            init_cache(cfg, 1, 32, torch.float32, "cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for cache, mono in ((jcache, jmono), (tcache, tmono)):
            cache.reserve(slot, len(p) + steps)
            cache.write_prefill(slot, mono, len(p))

    feed = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    index = np.asarray([len(p) for p in prompts], np.int32)
    for t in range(steps):
        active = np.asarray([True, t != 3])
        jl, jcache.pools = j_decode(
            jp, jnp.asarray(feed[t]), jcache.pools, jcache.tables,
            jnp.asarray(index), jnp.asarray(active), max_len=MAX_LEN,
            block_size=BLOCK)
        tl, _ = decode_step_paged(
            cfg, tp, torch.from_numpy(feed[t]), tcache.pools, tcache.tables,
            torch.from_numpy(index), torch.from_numpy(active),
            max_len=MAX_LEN, block_size=BLOCK)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        index = index + active
    for i in range(cfg.n_layers):
        for part in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tcache.pools[f"L{i}"]["attn"], part).numpy(),
                np.asarray(getattr(jcache.pools[f"L{i}"]["attn"], part)),
                atol=1e-5)


def test_greedy_tokens_match_jax_engine_under_insert_evict():
    """Five requests on two slots: requests finish mid-flight, slots and
    blocks recycle, later requests join running ones; one prompt is longer
    than the 16-token window and one request decodes far past it."""
    jeng, teng = _engines(1, n_slots=2, chunk=8)
    prompts = _prompts(5, (8, 20, 8, 12, 8), 512)
    n_news = [3, 30, 7, 14, 1]
    want = _serve(jeng, prompts, n_news)
    got = _serve(teng, prompts, n_news)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert [len(g) for g in got] == n_news
    assert teng.scheduler.idle and teng.n_running == 0
    assert teng.cache.free_blocks() == teng.cache._group_phys["full"]


def test_eos_matches_jax_engine_and_recycles():
    """A stop token ends a request early: the port's tokens equal the JAX
    engine's with the same ``eos_id``, the first request ends at its first
    stop token, and every slot and block is recycled."""
    jcfg, jp, cfg, tp = _setup(9)
    prompts = _prompts(11, (8, 8, 8), cfg.vocab_size)
    probe = ContinuousEngine(cfg, tp, n_slots=1, max_len=MAX_LEN,
                             block_size=BLOCK, cache_dtype=torch.float32,
                             device="cpu")
    base = _serve(probe, prompts[:1], [16])[0]
    eos = int(base[5])
    j = list(base).index(eos)
    jeng, teng = _engines(9, n_slots=2, chunk=4, eos_id=eos)
    want = _serve(jeng, prompts, [16] * 3)
    got = _serve(teng, prompts, [16] * 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], base[:j + 1])
    for toks in got[1:]:
        assert len(toks) == 16 or toks[-1] == eos
    assert teng.scheduler.idle and teng.n_running == 0
    assert teng.cache.free_blocks() == teng.cache._group_phys["full"]


def test_constrained_blocks_queue_like_jax():
    """A block budget that fits one request at a time still drains the
    queue: admission waits on the free list."""
    jeng, teng = _engines(6, n_slots=4, chunk=8, full_blocks=2)
    prompts = _prompts(6, (8, 8, 8), 512)
    want = _serve(jeng, prompts, [6] * 3)
    got = _serve(teng, prompts, [6] * 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert teng.cache.free_blocks() == 2


def _port_engine(seed=2, **kw):
    _, _, cfg, tp = _setup(seed)
    kw.setdefault("n_slots", 2)
    return cfg, tp, ContinuousEngine(cfg, tp, max_len=32, block_size=BLOCK,
                                     cache_dtype=torch.float32, chunk=8,
                                     device="cpu", **kw)


def test_sampled_decode_is_schedule_independent():
    """temperature > 0: a request samples the same tokens alone and beside
    other requests."""
    cfg, _, solo = _port_engine(seed=7)
    prompt = _prompts(2, (6,), cfg.vocab_size)[0]
    rid = solo.submit(prompt, 10, temperature=0.8, seed=3)
    a = solo.run()[rid]
    _, _, busy = _port_engine(seed=7)
    for i, p in enumerate(_prompts(9, (6, 6, 6), cfg.vocab_size)):
        busy.submit(p, 4 + 3 * i, temperature=0.5, seed=20 + i)
    rid = busy.submit(prompt, 10, temperature=0.8, seed=3)
    b = busy.run()[rid]
    np.testing.assert_array_equal(a, b)
    _, _, greedy = _port_engine(seed=7)
    rid = greedy.submit(prompt, 10)
    assert not np.array_equal(greedy.run()[rid], a)


def test_swap_params_identity_under_same_params():
    cfg, tp, plain = _port_engine(seed=8, n_slots=1)
    prompt = _prompts(8, (8,), cfg.vocab_size)[0]
    rid = plain.submit(prompt, 20)
    a = plain.run()[rid]
    _, _, swapped = _port_engine(seed=8, n_slots=1)
    rid = swapped.submit(prompt, 20)
    swapped.step()
    swapped.swap_params({k: v for k, v in tp.items()})
    np.testing.assert_array_equal(swapped.run()[rid], a)
    assert swapped.n_swaps == 1


def test_budget_validation():
    _, _, eng = _port_engine(n_slots=1)
    with pytest.raises(ValueError, match="exceeds the cache budget"):
        eng.submit(np.zeros((30,), np.int32), n_new=3)
    with pytest.raises(ValueError, match="n_new"):
        eng.submit(np.zeros((3,), np.int32), n_new=0)
    _, _, small = _port_engine(full_blocks=2)
    with pytest.raises(ValueError, match="cache blocks"):
        small.submit(np.zeros((20,), np.int32), n_new=4)


_IMPORT_PROBE = """
import sys
import repro_torch, repro_torch.configs, repro_torch.device
import repro_torch.kernels.build, repro_torch.kernels.decode_attn
import repro_torch.models, repro_torch.serve
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""


def test_port_imports_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_name_no_jax_and_no_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\.|"
                     r"from repro import)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card: non-zero exit and no result line. The same holds for the
    script alone, outside a checkout of the repository."""
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as src:
        alone.write_text(src.read())
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        out = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
