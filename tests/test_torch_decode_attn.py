"""The port's contiguous-cache decode attention against the JAX package.

The port's plain version (``repro_torch.kernels.decode_attn.ref.
decode_attn_ref``) is held to JAX's ``decode_attn_ref`` and to JAX's Pallas
``decode_attn`` in interpret mode, on the same numpy inputs: float32 within
atol 1e-5 (the two differ only in summation order), bfloat16 within 2e-2
(one bf16 ulp of an output below 4 is at most 2^-6). The legacy
monolithic-cache ``decode_step`` is held to JAX's, logits within 1e-4
(float32 logits of order ten). The CUDA kernel itself runs on the card
only: ``chip_smoke.py`` holds it to the plain version there.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.decode_attn import decode_attn as jax_decode_kernel
from repro.kernels.decode_attn import decode_attn_ref as jax_decode_ref
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attn import (decode_attention, decode_attn,
                                             decode_attn_ref)
from repro_torch.kernels.decode_attn.decode_attn import split_plan
from repro_torch.models import (decode_step, init_cache, params_from_numpy,
                                prefill)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_ATOL = 1e-4


def _inputs(b, S, kv, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, S, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, S, kv, hd)).astype(np.float32)
    return q, k, v


def _as(a, dtype):
    """numpy f32 -> (torch tensor, jax array), both in ``dtype``."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(a).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 77])
@pytest.mark.parametrize("which_len", ["one", "mid", "full"])
def test_plain_matches_jax_ref_and_interpret_kernel(dtype, window, which_len):
    """S = 600 is no multiple of the Pallas kernel's 512-position block,
    so its last block is padded; the window cuts inside the cache."""
    b, S, kv, g, hd = 2, 600, 2, 4, 32
    cache_len = {"one": 1, "mid": 333, "full": S}[which_len]
    q, k, v = _inputs(b, S, kv, g, hd, seed=len(which_len))
    (tq, jq), (tk, jk), (tv, jv) = (_as(a, dtype) for a in (q, k, v))
    ours = decode_attn_ref(tq, tk, tv, cache_len, window=window)
    assert ours.dtype == tq.dtype and ours.shape == (b, kv, g, hd)
    ref = jax_decode_ref(jq, jk, jv, jnp.int32(cache_len), window=window)
    kern = jax_decode_kernel(jq, jk, jv, jnp.int32(cache_len), window=window,
                             interpret=True)
    ours = ours.float().numpy()
    for other in (ref, kern):
        np.testing.assert_allclose(ours, np.asarray(other.astype(jnp.float32)),
                                   rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("g,hd", [(1, 64), (8, 128), (4, 256)])
def test_plain_matches_jax_ref_over_group_and_head_sizes(g, hd):
    b, S, kv = 3, 70, 1
    q, k, v = _inputs(b, S, kv, g, hd, seed=g + hd)
    for cache_len, window in ((1, None), (40, None), (70, 16)):
        ours = decode_attn_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               cache_len, window=window).numpy()
        ref = np.asarray(jax_decode_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                        jnp.int32(cache_len), window=window))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL["float32"])


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("g,hd,q_dtype,kv_dtype", [
    (7, 80, "bfloat16", "float32"),     # arctic's g, stablelm-3b's hd
    (7, 80, "float32", "float32"),
    (4, 256, "bfloat16", "float32"),    # gemma3-1b, bf16 model, f32 cache
    (2, 80, "bfloat16", "bfloat16")])
def test_plain_matches_jax_at_the_widened_dtypes_and_shapes(window, g, hd,
                                                            q_dtype,
                                                            kv_dtype):
    """The pairs and shapes the CUDA kernel gained: (bf16 q, f32 cache),
    head_dim 80, group size 7, against JAX's ref and interpret kernel."""
    b, S, kv, cache_len = 2, 70, 2, 53
    q, k, v = _inputs(b, S, kv, g, hd, seed=g * hd)
    tq, jq = _as(q, q_dtype)
    (tk, jk), (tv, jv) = (_as(a, kv_dtype) for a in (k, v))
    ours = decode_attn_ref(tq, tk, tv, cache_len, window=window)
    assert ours.dtype == tq.dtype and ours.shape == (b, kv, g, hd)
    ref = jax_decode_ref(jq, jk, jv, jnp.int32(cache_len), window=window)
    kern = jax_decode_kernel(jq, jk, jv, jnp.int32(cache_len), window=window,
                             interpret=True)
    for other in (ref, kern):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(other.astype(jnp.float32)),
                                   rtol=0, atol=TOL[q_dtype])


def test_cpu_tensor_takes_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 50, 1, 4, 32, seed=1))
    before = decode_attn.launches
    out = decode_attn(q, k, v, 30, window=20)
    ref = decode_attn_ref(q, k, v, 30, window=20)
    assert torch.equal(out, ref)
    # a 0-d tensor cache_len gives the same as the int
    assert torch.equal(decode_attn(q, k, v, torch.tensor(30, dtype=torch.int32),
                                   window=20), ref)
    assert decode_attn.launches == before
    # the model-layout entry reshapes (b, 1, h, hd) around the same call
    out4 = decode_attention(q.reshape(2, 1, 4, 32), k, v, 30, window=20)
    assert torch.equal(out4.reshape(out.shape), ref)
    assert decode_attn.launches == before


def test_model_layout_entry_matches_jax_reference():
    """``decode_attention`` (q (b, 1, h, hd)) against JAX's pure-jnp twin
    ``models.attention.decode_attention``, the function JAX's
    ``decode_step`` calls."""
    from repro.models.attention import decode_attention as jax_twin
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 1, 8, 32)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 32)).astype(np.float32)
    ours = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), 17)
    ref = jax_twin(*(jnp.asarray(a) for a in (q, k, v)), jnp.int32(17))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL["float32"])


def test_other_devices_never_take_the_plain_version():
    from test_torch_dryrun import other_device
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 16, 1, 4, 32, seed=2))
    with pytest.raises(ValueError, match="several devices"):
        decode_attn(q.to("meta"), k, v, 5)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        decode_attn(other_device(q), other_device(k), other_device(v), 5)


@pytest.mark.parametrize("b,kv,S", [(4, 1, 512), (4, 1, 1024), (1, 1, 7),
                                    (8, 8, 600), (64, 4, 33)])
def test_split_plan_covers_the_cache(b, kv, S):
    per, n_split = split_plan(b, kv, S)
    assert per >= 1 and 1 <= n_split <= 16      # one cluster a row
    assert per * n_split >= S > per * (n_split - 1)


def _gemma(seed):
    jcfg = dataclasses.replace(jax_smoke("gemma3-1b"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"),
                              compute_dtype="float32")
    jp, _ = jax_init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def test_decode_step_matches_jax_through_ring_wrap():
    """Prefill 12 tokens (under gemma3 smoke's 16-token window), then 10
    monolithic-cache decode steps: the local layers' ring wraps; logits
    and both caches agree with JAX's ``decode_step``, and each step's
    attention goes through ``decode_attn``'s plain version (no launch)."""
    jcfg, jp, cfg, tp = _gemma(3)
    b, s, steps, max_len = 2, 12, 10, 32
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (steps, b, 1)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(jax_prefill, jcfg))(
        jp, jnp.asarray(prompt), jax_init_cache(jcfg, b, max_len, jnp.float32))
    tl, tc = prefill(cfg, tp, torch.from_numpy(prompt),
                     init_cache(cfg, b, max_len, torch.float32, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    j_decode = jax.jit(functools.partial(jax_decode_step, jcfg))
    before = decode_attn.launches
    for t in range(steps):
        jl, jc = j_decode(jp, jnp.asarray(feed[t]), jc, jnp.int32(s + t))
        tl, tc = decode_step(cfg, tp, torch.from_numpy(feed[t]), tc, s + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    assert decode_attn.launches == before
    for i in range(cfg.n_layers):
        for part in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tc[f"L{i}"]["kv"], part).numpy(),
                np.asarray(getattr(jc[f"L{i}"]["kv"], part)), atol=1e-5)


def test_decode_step_takes_the_plain_version_as_attn():
    """``attn=decode_attn_ref`` (what chip_smoke's agreement phase passes)
    gives the same logits as the default on the CPU."""
    _, _, cfg, tp = _gemma(4)
    prompt = torch.randint(0, cfg.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(0))
    logits = []
    for attn in (decode_attn, decode_attn_ref):
        cache = init_cache(cfg, 2, 16, torch.float32, "cpu")
        prefill(cfg, tp, prompt, cache)
        logits.append(decode_step(cfg, tp, prompt[:, -1:], cache, 5,
                                  attn=attn)[0])
    assert torch.equal(logits[0], logits[1])
