"""The port's q-blocked sliding-window attention
(``models.attention.flash_attention_windowed``) against JAX's, and the
model paths that take it (``cfg.windowed_qblock``).

float32 inputs from numpy: the two packages reduce in another order, so
outputs agree within 1e-5 absolute (values of order one); the model loss
within 1e-5 relative. Against the port's own chunked ``flash_attention``
with the same window the q-blocked form agrees within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models.attention import (  # noqa: E402
    flash_attention_windowed as j_windowed)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (init_cache, loss_fn, params_from_numpy,  # noqa: E402
                                prefill)
from repro_torch.models.attention import (  # noqa: E402
    flash_attention, flash_attention_windowed)

ATOL = 1e-5


def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, n, hd)).astype(np.float32)
                 for n in (h, kv, kv))


@pytest.mark.parametrize("s, block, window, h, kv", [
    (70, 16, 20, 4, 1),       # q-blocked: 5 query blocks, a ragged last one
    (70, 16, 20, 4, 4),
    (64, 16, 16, 2, 1),       # window a multiple of the block
    (12, 16, 5, 4, 1),        # s <= block: falls back to flash_attention
    (40, 16, 50, 4, 2),       # window >= s: falls back too
])
def test_windowed_attention_matches_jax(s, block, window, h, kv):
    q, k, v = _qkv(s, 2, s, h, kv, 8)
    ref = np.asarray(j_windowed(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window, block=block))
    got = flash_attention_windowed(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), window=window,
                                   block=block)
    assert got.shape == (2, s, h, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    chunked = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, block_k=block)
    np.testing.assert_allclose(got.numpy(), chunked.numpy(), rtol=0,
                               atol=ATOL)


def test_windowed_attention_keeps_bf16_inputs_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(3, 1, 40, 4, 1, 16))
    out = flash_attention_windowed(q, k, v, window=8, block=16)
    ref = flash_attention(q, k, v, causal=True, window=8, block_k=16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=0, atol=2e-2)


def _gemma3(windowed):
    kw = dict(compute_dtype="float32", windowed_qblock=windowed)
    return (dataclasses.replace(jax_smoke("gemma3-1b"), **kw),
            dataclasses.replace(get_smoke_config("gemma3-1b"), **kw))


def test_gemma3_loss_with_windowed_qblock_matches_jax():
    """The smoke model (window 16) at 520 tokens, past the 512-token
    block, so the local layers take the q-blocked path: the loss equals
    JAX's with ``windowed_qblock=True`` and the port's without it."""
    jcfg, cfg = _gemma3(True)
    jp, _ = j_init_params(jcfg, jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, 520)).astype(np.int32)
             for k in ("tokens", "labels")}
    jl, _ = jax.jit(lambda p, b: j_loss_fn(jcfg, p, b))(
        jp, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, _ = loss_fn(cfg, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    plain, _ = loss_fn(_gemma3(False)[1], tp, tb)
    np.testing.assert_allclose(float(tl), float(plain), rtol=1e-5)


def test_prefill_with_windowed_qblock_matches_the_chunked_path():
    _, cfg = _gemma3(True)
    _, plain_cfg = _gemma3(False)
    jp, _ = j_init_params(jax_smoke("gemma3-1b"), jax.random.key(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 530)).astype(np.int32))
    outs = []
    for c in (cfg, plain_cfg):
        cache = init_cache(c, 1, 544, dtype=torch.float32, device="cpu")
        logits, cache = prefill(c, tp, toks, cache)
        outs.append((logits, cache))
    (la, ca), (lb, cb) = outs
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=0, atol=ATOL)
    for key in ca:                  # later layers' K/V carry the rounding
        for a, b in zip(ca[key]["kv"], cb[key]["kv"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=ATOL)
