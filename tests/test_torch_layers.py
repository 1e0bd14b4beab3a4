"""The port's configs, parameter init and layers against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU. Tolerances are float32 ones: 1e-5 absolute on values of order
one, where the two packages differ only in the order of their sums.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JA
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.models import init_cache, init_params, params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.device import resolve_device
from repro_torch.serve import ContinuousEngine, PagedCache

ATOL = 1e-5
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in PORT_FIELDS})


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_gemma3_config_matches_jax_field_for_field(which):
    ours = (get_config if which == "full" else get_smoke_config)("gemma3-1b")
    ref = (jax_get_config if which == "full" else jax_smoke)("gemma3-1b")
    for f in PORT_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_layer_predicates_match_jax(arch):
    """Every arch's layer schedule reads the same through the port's
    config, and the port builds every arch's smoke model: dense, SSM,
    MoE, hybrid (jamba), vision (cross-attention) and audio (codebooks)."""
    jcfg = jax_get_config(arch)
    cfg = _port_cfg(jcfg)
    assert cfg.padded_vocab == jcfg.padded_vocab
    for i in range(jcfg.n_layers):
        for pred in ("layer_is_attn", "layer_is_ssm", "layer_is_moe",
                     "layer_is_global_attn", "layer_is_cross_attn",
                     "window_for_layer"):
            assert getattr(cfg, pred)(i) == getattr(jcfg, pred)(i), (pred, i)
    assert cfg.n_media_tokens == jcfg.n_media_tokens
    assert cfg.n_codebooks == jcfg.n_codebooks
    assert init_params(get_smoke_config(arch), seed=0, device="cpu")


# -- layers -------------------------------------------------------------------

def test_rmsnorm():
    r = _rng(0)
    x = r.normal(size=(3, 5, 64)).astype(np.float32)
    scale = r.normal(size=(64,)).astype(np.float32)
    ref = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    ours = TL.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    r = _rng(1)
    x = r.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(500, 507)]).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope_frequencies(32, theta).numpy(),
        np.asarray(JL.rope_frequencies(32, theta)), rtol=1e-6)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    ours = TL.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_mlp():
    r = _rng(2)
    x = r.normal(size=(2, 3, 16)).astype(np.float32)
    p = {n: (r.normal(size=s) * 0.2).astype(np.float32)
         for n, s in (("w_gate", (16, 40)), ("w_up", (16, 40)),
                      ("w_down", (40, 16)))}
    ref = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                 jnp.float32)
    ours = TL.mlp({k: _t(v) for k, v in p.items()}, _t(x), torch.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_embed_and_heads(softcap):
    r = _rng(3)
    tok = r.normal(size=(64, 16)).astype(np.float32)
    w = r.normal(size=(16, 64)).astype(np.float32)
    ids = r.integers(0, 64, size=(2, 5)).astype(np.int32)
    x = (r.normal(size=(2, 5, 16)) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        TL.embed({"tok": _t(tok)}, _t(ids), torch.float32).numpy(),
        np.asarray(JL.embed({"tok": jnp.asarray(tok)}, jnp.asarray(ids),
                            jnp.float32)))
    np.testing.assert_allclose(
        TL.tied_head({"tok": _t(tok)}, _t(x), torch.float32, softcap).numpy(),
        np.asarray(JL.tied_head({"tok": jnp.asarray(tok)}, jnp.asarray(x),
                                jnp.float32, softcap)), atol=1e-4)
    np.testing.assert_allclose(
        TL.head({"w": _t(w)}, _t(x), torch.float32, softcap).numpy(),
        np.asarray(JL.head({"w": jnp.asarray(w)}, jnp.asarray(x),
                           jnp.float32, softcap)), atol=1e-4)


@pytest.mark.parametrize("window,block_k", [
    (None, 8), (5, 8), (None, 64), (7, 6)])
def test_flash_attention(window, block_k):
    """Chunked over keys, with a ragged last block."""
    r = _rng(4)
    q = r.normal(size=(2, 13, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 13, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 13, 2, 16)).astype(np.float32)
    ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, block_k=block_k)
    ours = TA.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, block_k=block_k)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


# -- params ---------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def test_init_params_same_tree_shapes_and_std_as_jax():
    cfg = get_smoke_config("gemma3-1b")
    jp, _ = jax_init_params(jax_smoke("gemma3-1b"), jax.random.key(0))
    ours = _flatten(init_params(cfg, seed=0, device="cpu"))
    ref = _flatten(jp)
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        assert tuple(leaf.shape) == ref[name].shape, name
        assert leaf.dtype == torch.float32
        if name.endswith("/scale"):
            assert torch.equal(leaf, torch.ones_like(leaf))
        elif leaf.numel() >= 4096:
            want = float(np.std(np.asarray(ref[name])))
            assert abs(leaf.std().item() / want - 1) < 0.05, name
    again = _flatten(init_params(cfg, seed=0, device="cpu"))
    other = _flatten(init_params(cfg, seed=1, device="cpu"))
    key = "/layers/L0/attn/wq"
    assert torch.equal(again[key], ours[key])
    assert not torch.equal(other[key], ours[key])


def test_params_from_numpy_round_trip_is_exact():
    jp, _ = jax_init_params(jax_smoke("gemma3-1b"), jax.random.key(3))
    tree = jax.tree.map(np.asarray, jp)
    ours = _flatten(params_from_numpy(tree, "cpu"))
    for name, ref in _flatten(tree).items():
        np.testing.assert_array_equal(ours[name].numpy(), ref)
    bf = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32), jnp.bfloat16)
    got = params_from_numpy({"w": np.asarray(bf)}, "cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(bf, np.float32))


# -- device guard -----------------------------------------------------------------

def test_entry_points_without_a_card_raise(monkeypatch):
    """``device=None`` means cuda: with no card every entry point raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("gemma3-1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedCache(cfg, 1, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(cfg, params, n_slots=1, max_len=32)
    assert resolve_device("cpu") == torch.device("cpu")
