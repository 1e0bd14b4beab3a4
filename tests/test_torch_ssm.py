"""The port's SSM serving path and legacy ``ServeEngine`` against the JAX
package, at the smoke sizes.

Both packages run in float32 with the same weights (JAX's, carried over by
``params_from_numpy``). Mixer outputs agree within 1e-5 absolute (values
of order one); logits within 1e-4 (order ten, float32 sums in another
order); greedy tokens of both engines are identical to JAX's. Sampled
tokens cannot match JAX's key splits, so only greedy decoding is held to
JAX.
"""
import dataclasses
import functools
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import decode_step_paged as jax_decode_step_paged
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as JSSM
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import PagedCache as JaxPagedCache
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import (ModelConfig, SSMConfig, get_config,
                                 get_smoke_config)
from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.models import (cache_layout, decode_step_paged, forward,
                                init_cache, init_params, params_from_numpy,
                                prefill, ssd_chunked, ssm_layer)
from repro_torch.models import ssm as TSSM
from repro_torch.serve import ContinuousEngine, PagedCache, ServeEngine

ATOL = 1e-5
LOGIT_ATOL = 1e-4
MAX_LEN, BLOCK = 64, 8
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def _setup(arch, seed):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp, _ = jax_init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# -- configs and params -------------------------------------------------------

def test_ssm_config_matches_jax_field_for_field():
    ours = [(f.name, f.default) for f in dataclasses.fields(SSMConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxSSMConfig)]
    assert ours == ref
    for d_model in (128, 1024):
        assert SSMConfig().d_inner(d_model) == JaxSSMConfig().d_inner(d_model)
        assert SSMConfig().n_heads(d_model) == JaxSSMConfig().n_heads(d_model)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_mamba2_config_matches_jax_field_for_field(which):
    ours = (get_config if which == "full" else get_smoke_config)("mamba2-370m")
    ref = (jax_get_config if which == "full" else jax_smoke)("mamba2-370m")
    for f in PORT_FIELDS:
        if f == "ssm":
            assert dataclasses.asdict(ours.ssm) == dataclasses.asdict(ref.ssm)
        else:
            assert getattr(ours, f) == getattr(ref, f), f
    assert isinstance(ours.ssm, SSMConfig)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_init_params_tree_matches_jax():
    cfg = get_smoke_config("mamba2-370m")
    jp, _ = jax_init_params(jax_smoke("mamba2-370m"), jax.random.key(0))
    tp = init_params(cfg, seed=0, device="cpu")
    assert _shapes(tp) == _shapes(jp)
    # A_log uniform in [-1, 1), as JAX's init
    a_log = tp["layers"]["L0"]["ssm"]["A_log"]
    assert a_log.abs().max() <= 1 and a_log.std() > 0.2


def test_ssm_archs_serve_and_train():
    """The paged cache keeps SSM state per slot and no K/V blocks; the
    training forward runs (it refused SSM layers before their backward
    through ``ssd_chunk`` was ported) and gives finite logits."""
    cfg = get_smoke_config("mamba2-370m")
    layout = cache_layout(cfg, MAX_LEN, BLOCK)
    assert layout["groups"] == {}
    assert all(lay == {"ssm": True} for lay in layout["layers"].values())
    cache = PagedCache(cfg, 3, MAX_LEN, BLOCK, device="cpu")
    assert cache.blocks_needed(40) == 0 and cache.used_width() is None
    st = cache.pools["L1"]["ssm"]
    assert st.s.shape == (3, 8, 16, 32) and st.conv.shape == (3, 3, 288)
    assert st.s.dtype == torch.float32
    tp = init_params(cfg, seed=0, device="cpu")
    logits, moe_loss = forward(cfg, tp, torch.zeros((1, 16),
                                                    dtype=torch.int32))
    assert logits.shape == (1, 16, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert float(moe_loss) == 0.0


# -- the mixer ------------------------------------------------------------------

def test_ssm_layer_prefill_and_decode_match_jax():
    """The prefill form over 21 tokens (no chunk multiple: the tail is
    padded), then three decode steps from the prefill's state."""
    jcfg, jp, cfg, tp = _setup("mamba2-370m", 1)
    jlp, tlp = jp["layers"]["L0"]["ssm"], tp["layers"]["L0"]["ssm"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    jy, _ = JSSM.ssm_layer(jlp, jnp.asarray(x), jcfg.ssm, jcfg.d_model,
                           jnp.float32)
    ty, none = ssm_layer(tlp, torch.from_numpy(x), cfg.ssm, cfg.d_model,
                         torch.float32)
    assert none is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    # the plain chunked scan as ``ssd`` gives the same output
    ty2, _ = ssm_layer(tlp, torch.from_numpy(x), cfg.ssm, cfg.d_model,
                       torch.float32, ssd=ssd_chunked)
    np.testing.assert_allclose(ty2.numpy(), ty.numpy(), atol=ATOL)

    _, st = TSSM.ssm_prefill(tlp, torch.from_numpy(x), cfg.ssm, cfg.d_model,
                             torch.float32)
    jst = JSSM.SSMState(jnp.asarray(st.s.numpy()), jnp.asarray(st.conv.numpy()))
    for t in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JSSM.ssm_layer(jlp, jnp.asarray(xt), jcfg.ssm, jcfg.d_model,
                                 jnp.float32, state=jst)
        ty, st = ssm_layer(tlp, torch.from_numpy(xt), cfg.ssm, cfg.d_model,
                           torch.float32, state=st)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(st.s.numpy(), np.asarray(jst.s), atol=ATOL)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                                   atol=ATOL)


def test_prefill_and_paged_decode_logits_match_jax():
    """Two prompts (one shorter than the conv width's history, one past a
    chunk) prefilled into the paged cache's SSM slots and decoded step by
    step; one row sits out a step (its state frozen). Logits, the SSM
    states and the conv histories agree with JAX."""
    jcfg, jp, cfg, tp = _setup("mamba2-370m", 2)
    prompts = _prompts(2, (2, 37), cfg.vocab_size)
    steps = 5
    j_prefill = jax.jit(functools.partial(jax_prefill, jcfg))
    j_decode = jax.jit(functools.partial(jax_decode_step_paged, jcfg),
                       static_argnames=("max_len", "block_size"))
    jcache = JaxPagedCache(jcfg, 2, MAX_LEN, BLOCK, dtype=jnp.float32)
    tcache = PagedCache(cfg, 2, MAX_LEN, BLOCK, dtype=torch.float32,
                        device="cpu")
    for slot, p in enumerate(prompts):
        jl, jmono = j_prefill(jp, jnp.asarray(p[None]),
                              jax_init_cache(jcfg, 1, 64, jnp.float32))
        tl, tmono = prefill(cfg, tp, torch.from_numpy(p[None]),
                            init_cache(cfg, 1, 64, torch.float32, "cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for cache, mono in ((jcache, jmono), (tcache, tmono)):
            cache.reserve(slot, len(p) + steps)
            cache.write_prefill(slot, mono, len(p))

    feed = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    index = np.asarray([len(p) for p in prompts], np.int32)
    for t in range(steps):
        active = np.asarray([True, t != 2])
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
        for part in ("s", "conv"):
            np.testing.assert_allclose(
                getattr(tcache.pools[f"L{i}"]["ssm"], part).numpy(),
                np.asarray(getattr(jcache.pools[f"L{i}"]["ssm"], part)),
                atol=ATOL)


def test_prefill_runs_ssd_chunk_once_per_ssm_layer():
    """Every SSM layer's prefill goes through the kernel's wrapper (its
    plain version here): count the plain calls."""
    _, _, cfg, tp = _setup("mamba2-370m", 0)
    # the package's ``ssd_chunk`` attribute is the op, not its module
    mod = sys.modules["repro_torch.kernels.ssd_chunk.ssd_chunk"]
    calls = []
    orig = mod.ssd_chunk_ref
    mod.ssd_chunk_ref = lambda *a: calls.append(1) or orig(*a)
    try:
        prefill(cfg, tp, torch.zeros((1, 20), dtype=torch.int32),
                init_cache(cfg, 1, 32, torch.float32, "cpu"))
    finally:
        mod.ssd_chunk_ref = orig
    assert len(calls) == cfg.n_layers
    assert ssd_chunk.launches == 0


# -- engines --------------------------------------------------------------------

def _serve(eng, prompts, n_news):
    rids = [eng.submit(p, n, seed=i)
            for i, (p, n) in enumerate(zip(prompts, n_news))]
    done = eng.run()
    return [np.asarray(done[r]) for r in rids]


def test_continuous_engine_matches_jax_under_insert_evict():
    """Five mamba2 requests on two slots: requests finish mid-flight, slots
    recycle (the SSM state row is overwritten at admission) and later
    requests join running ones."""
    jcfg, jp, cfg, tp = _setup("mamba2-370m", 4)
    jeng = JaxEngine(jcfg, jp, n_slots=2, max_len=MAX_LEN, block_size=BLOCK,
                     cache_dtype=jnp.float32, chunk=8)
    teng = ContinuousEngine(cfg, tp, n_slots=2, max_len=MAX_LEN,
                            block_size=BLOCK, cache_dtype=torch.float32,
                            chunk=8, device="cpu")
    prompts = _prompts(5, (8, 20, 8, 12, 3), cfg.vocab_size)
    n_news = [3, 30, 7, 14, 1]
    want = _serve(jeng, prompts, n_news)
    got = _serve(teng, prompts, n_news)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert teng.scheduler.idle and teng.n_running == 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_serve_engine_matches_jax_greedy_and_with_eos(arch):
    """20-token prompts (past gemma3 smoke's 16-token window) and 14 new
    tokens: the local layers' ring wraps. Then a stop token taken from
    row 0's greedy output: the rows stop, and pad, as JAX's do."""
    jcfg, jp, cfg, tp = _setup(arch, 5)
    prompts = np.stack(_prompts(6, (20, 20), cfg.vocab_size))
    jeng = JaxServeEngine(jcfg, jp, max_len=40, cache_dtype=jnp.float32)
    teng = ServeEngine(cfg, tp, max_len=40, cache_dtype=torch.float32,
                       device="cpu")
    want = np.asarray(jeng.generate(prompts, 14))
    got = teng.generate(prompts, 14)
    np.testing.assert_array_equal(got, want)
    assert teng.decode_steps == 13 and teng.prefills == 1
    eos = int(want[0, 3])
    want = np.asarray(jeng.generate(prompts, 14, eos_id=eos))
    got = teng.generate(prompts, 14, eos_id=eos)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == eos).all()


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_port_engines_agree(arch):
    """Batched continuous decode equals the legacy engine's solo decode
    token for token, as ``tests/test_serve_continuous.py`` holds the JAX
    engines."""
    _, _, cfg, tp = _setup(arch, 6)
    prompts = np.stack(_prompts(7, (8, 8, 8), cfg.vocab_size))
    legacy = ServeEngine(cfg, tp, max_len=MAX_LEN, cache_dtype=torch.float32,
                         device="cpu")
    eng = ContinuousEngine(cfg, tp, n_slots=4, max_len=MAX_LEN,
                           block_size=BLOCK, cache_dtype=torch.float32,
                           chunk=16, device="cpu")
    out = eng.generate(prompts, n_new=12)
    for i in range(3):
        np.testing.assert_array_equal(out[i],
                                      legacy.generate(prompts[i:i + 1], 12)[0])


def test_serve_engine_sampling_is_seeded_and_per_row():
    """Sampled rows depend on (seed, row, position) only: the same seed
    repeats, another seed differs, and a row does not depend on its
    neighbours."""
    _, _, cfg, tp = _setup("mamba2-370m", 7)
    eng = ServeEngine(cfg, tp, max_len=MAX_LEN, cache_dtype=torch.float32,
                      device="cpu")
    prompts = np.stack(_prompts(8, (6, 6), cfg.vocab_size))
    a = eng.generate(prompts, 10, temperature=1.0, seed=3)
    assert np.array_equal(a, eng.generate(prompts, 10, temperature=1.0,
                                          seed=3))
    assert not np.array_equal(a, eng.generate(prompts, 10, temperature=1.0,
                                              seed=4))
    assert np.array_equal(a[:1], eng.generate(prompts[:1], 10,
                                              temperature=1.0, seed=3))


def test_serve_engine_guards():
    _, _, cfg, tp = _setup("gemma3-1b", 8)
    eng = ServeEngine(cfg, tp, max_len=24, cache_dtype=torch.float32,
                      device="cpu")
    prompts = np.zeros((1, 20), np.int32)
    with pytest.raises(ValueError, match="exceeds the cache budget"):
        eng.generate(prompts, 5)
    # a text arch ignores media, as JAX's engine does
    np.testing.assert_array_equal(
        eng.generate(prompts[:, :12], 4,
                     media=np.ones((1, 4, cfg.d_model), np.float32)),
        eng.generate(prompts[:, :12], 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(cfg, tp)
