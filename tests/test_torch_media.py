"""The port's vision (gated cross-attention) and audio (parallel codebook)
archs, llama-3.2-vision-11b and musicgen-large, against the JAX package at
their smoke sizes.

Inputs come from numpy seeds; JAX runs on the CPU; both packages hold the
same weights (JAX's, carried across by ``params_from_numpy``). Every
``cross_gate`` starts at zero in both packages, which makes ``tanh(gate) *
y`` exactly zero and would hide any fault of the cross branch: every test
here that runs a vision model first sets each gate to a value drawn from
U(0.5, 1.0) with the test's seed (``_params``), the same values in both
packages, and asserts that none is zero.

Tolerances:
  * float32 compute: 1e-5 relative (logits to the largest logit, losses,
    gradients to each leaf's largest entry); the codebook embedding's sum
    bitwise.
  * bfloat16 compute: 2e-2 relative to the largest value; the codebook
    embedding within one bf16 ulp of JAX's one-hot einsum.
  * Trainer rounds: h and losses rtol 1e-5, theta atol 1e-6, params atol
    1e-5 every round, as ``tests/test_torch_lm.py``.
  * Serving: greedy tokens equal to JAX's, token for token.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serve import ContinuousEngine as JEngine  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.evaluate import evaluate_lm as j_evaluate_lm  # noqa: E402
from repro.train.lm import make_lm_loss as j_make_lm_loss  # noqa: E402
from repro_torch.configs import (ARCH_IDS, ModelConfig,  # noqa: E402
                                 TrainConfig, WASGDConfig, get_config,
                                 get_smoke_config)
from repro_torch.data import OrderedDataset, lm_batch  # noqa: E402
from repro_torch.models import (cache_layout, decode_step,  # noqa: E402
                                forward, init_cache, init_params, loss_fn,
                                param_axes, params_from_numpy, prefill)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import ContinuousEngine, ServeEngine  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.train.evaluate import evaluate_lm  # noqa: E402

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-large"
ARCHS = [VLM, AUDIO]
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def _cfgs(arch, compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype,
                               **kw)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype=compute_dtype, **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_init(arch, seed):
    return j_init_params(jax_smoke(arch), jax.random.key(seed))


def _open_gates(tree, seed):
    """The tree (numpy leaves) with every ``cross_gate`` drawn from
    U(0.5, 1.0): the gates JAX initialises to zero would hide the cross
    branch. Returns (tree, number of gates set)."""
    rng = np.random.default_rng(seed)
    n = 0
    for lp in tree["layers"].values():
        if "cross_gate" in lp:
            lp["cross_gate"] = rng.uniform(0.5, 1.0, lp["cross_gate"].shape
                                           ).astype(np.float32)
            n += 1
    return tree, n


def _params(arch, seed=0):
    """(JAX params as numpy, JAX axes, port params on the CPU): JAX's init
    with every cross gate opened (nonzero, asserted)."""
    jp, axes = _jax_init(arch, seed)
    jp, n = _open_gates(jax.tree.map(np.array, jp), seed)
    cfg = get_smoke_config(arch)
    assert n == sum(cfg.layer_is_cross_attn(i) for i in range(cfg.n_layers))
    for lp in jp["layers"].values():
        if "cross_gate" in lp:
            assert np.all(lp["cross_gate"] != 0)
    return jp, axes, params_from_numpy(jp, "cpu")


def _batch(cfg, seed=0, b=2, s=12, media_dtype="float32"):
    """lm_batch of the config (codebook tokens, media for a VLM), media
    in ``media_dtype``: numpy dict for JAX, tensor dict for the port."""
    nb = lm_batch(seed, b, s, cfg.vocab_size, n_codebooks=cfg.n_codebooks,
                  media_tokens=cfg.n_media_tokens, d_model=cfg.d_model)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    if "media" in nb:
        jb["media"] = jb["media"].astype(media_dtype)
        tb["media"] = tb["media"].to(getattr(torch, media_dtype))
    return jb, tb


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy().copy()}
    return {prefix: np.array(tree, np.float32, copy=True)}


def _close_rel(got, ref, rtol, what=""):
    """max|got - ref| <= rtol * max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        (what, np.abs(got - ref).max(), np.abs(ref).max())


def _np(t):
    return t.detach().float().numpy()


# -- configs and params ------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_for_field(arch, which):
    ours = (get_config if which == "full" else get_smoke_config)(arch)
    ref = (jax_get_config if which == "full" else jax_smoke)(arch)
    for f in PORT_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    assert arch in ARCH_IDS
    if arch == VLM:
        assert ours.n_media_tokens == (1600 if which == "full" else 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax_and_carries_across(arch):
    """The port builds JAX's tree: a cross layer's ``cross_norm``,
    ``cross`` and ``cross_gate`` (1,) zeros; the codebook ``embed.tok``
    (n_q, V, d) and ``head.w`` (n_q, d, V). The generic
    ``params_from_numpy`` carries every leaf across unchanged."""
    cfg = get_smoke_config(arch)
    ours = _flat(init_params(cfg, 0, device="cpu"))
    jp, _ = _jax_init(arch, 0)
    ref = _flat(jp)
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    came = _flat(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    for k in ref:
        np.testing.assert_array_equal(came[k], ref[k])
    if arch == VLM:
        assert "/layers/L1/cross/wk" in ours and "/layers/L0/cross/wk" \
            not in ours
        np.testing.assert_array_equal(ours["/layers/L1/cross_gate"], [0.0])
    else:
        V = cfg.padded_vocab
        assert ours["/embed/tok"].shape == (4, V, cfg.d_model)
        assert ours["/head/w"].shape == (4, cfg.d_model, V)


# -- layers ----------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_codebook_embedding_and_head_match_jax(compute_dtype):
    """The gather-and-sum embedding against JAX's one-hot einsum: bitwise
    in float32, within one bf16 ulp in bfloat16; the (n_q, d, V) head's
    logits (b, s, n_q, V)."""
    rng = np.random.default_rng(0)
    nq, V, d = 4, 64, 32
    tok = rng.normal(size=(nq, V, d)).astype(np.float32)
    toks = rng.integers(0, V, (2, 5, nq)).astype(np.int32)
    jdt, tdt = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    ref = np.asarray(JL.embed({"tok": jnp.asarray(tok)}, jnp.asarray(toks),
                              jdt), np.float32)
    ours = _np(TL.embed({"tok": torch.from_numpy(tok)},
                        torch.from_numpy(toks), tdt))
    if compute_dtype == "float32":
        np.testing.assert_array_equal(ours, ref)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(ours - ref) <= ulp)
    w = rng.normal(size=(nq, d, V)).astype(np.float32)
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    jref = np.asarray(JL.head({"w": jnp.asarray(w)},
                              jnp.asarray(x).astype(jdt), jdt), np.float32)
    got = _np(TL.head({"w": torch.from_numpy(w)},
                      torch.from_numpy(x).to(tdt), tdt))
    assert got.shape == (2, 5, nq, V)
    _close_rel(got, jref, 1e-5 if compute_dtype == "float32" else 2e-2,
               "head")


@pytest.mark.parametrize("media_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(compute_dtype, media_dtype):
    """Gated layers' cross-attention: no mask, no rope, media K/V in the
    promotion of the media's and the compute dtype (float32 media give
    float32 K/V beside bf16 queries, as JAX's einsum does); the output in
    the query's dtype."""
    rng = np.random.default_rng(1)
    d, h, kv, hd, M = 64, 4, 2, 16, 20
    params = {n: rng.normal(size=s).astype(np.float32) * 0.2 for n, s in (
        ("wq", (d, h, hd)), ("wk", (d, kv, hd)), ("wv", (d, kv, hd)),
        ("wo", (h, hd, d)))}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    media = rng.normal(size=(2, M, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    ref = np.asarray(JA.cross_attention(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jdt), jnp.asarray(media).astype(media_dtype),
        compute_dtype=jdt), np.float32)
    tm = torch.from_numpy(media).to(getattr(torch, media_dtype))
    k, _ = TA.cross_kv({k: torch.from_numpy(v) for k, v in params.items()},
                       tm, tdt)
    assert k.dtype == torch.promote_types(tm.dtype, tdt)
    out = TA.cross_attention({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x).to(tdt), tm,
                             compute_dtype=tdt)
    assert out.dtype == tdt
    _close_rel(_np(out), ref, 1e-5 if compute_dtype == "float32" else 2e-2,
               "cross_attention")


# -- forward, loss and gradients -----------------------------------------------------

CASES = [(VLM, "float32", "float32"), (VLM, "float32", "bfloat16"),
         (VLM, "bfloat16", "float32"), (VLM, "bfloat16", "bfloat16"),
         (AUDIO, "float32", None), (AUDIO, "bfloat16", None)]


@pytest.mark.parametrize("arch,compute_dtype,media_dtype", CASES)
def test_forward_and_loss_match_jax(arch, compute_dtype, media_dtype):
    """Logits and loss of both archs, media as float32 and as bfloat16;
    the cross gates are nonzero (``_params``)."""
    jcfg, cfg = _cfgs(arch, compute_dtype)
    jp, _, tp = _params(arch, seed=1)
    jb, tb = _batch(cfg, 1, media_dtype=media_dtype or "float32")
    jl, _ = jax.jit(functools.partial(j_forward, jcfg))(
        jp, jb["tokens"], jb.get("media"))
    tl, _ = forward(cfg, tp, tb["tokens"], tb.get("media"))
    assert tl.dtype == getattr(torch, compute_dtype)
    if arch == AUDIO:
        assert tl.shape == (2, 12, 4, cfg.padded_vocab)
    rtol = 1e-5 if compute_dtype == "float32" else 2e-2
    _close_rel(_np(tl), jl, rtol, "logits")
    jloss, jaux = jax.jit(functools.partial(j_loss_fn, jcfg))(jp, jb)
    tloss, taux = loss_fn(cfg, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=rtol)


def test_media_moves_the_vlm_logits():
    """With the gates open the media reach the logits: other media give
    other logits, and no media (the cross branch skipped) others again."""
    _, cfg = _cfgs(VLM)
    _, _, tp = _params(VLM, seed=1)
    _, tb = _batch(cfg, 1)
    a, _ = forward(cfg, tp, tb["tokens"], tb["media"])
    b, _ = forward(cfg, tp, tb["tokens"], tb["media"] * 2.0)
    c, _ = forward(cfg, tp, tb["tokens"])
    assert (a - b).abs().max() > 1e-3 and (a - c).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    """float32 gradients of every leaf, the cross branch's and the
    codebook tables' included."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=2)
    jb, tb = _batch(cfg, 2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, jb), has_aux=True))(jp)
    tg, (tl, _) = torch.func.grad_and_value(
        lambda p: loss_fn(cfg, p, tb), has_aux=True)(tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    ft, fj = _flat(tg), _flat(jg)
    assert sorted(ft) == sorted(fj)
    for k in fj:
        _close_rel(ft[k], fj[k], 1e-5, k)
    if arch == VLM:
        assert np.abs(ft["/layers/L1/cross/wk"]).max() > 0


# -- serving ------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax_and_the_forward(arch):
    """prefill of s - 1 tokens and one decode_step (float32 cache; the
    cross layers' media K/V in the cache, their decode through
    ``decode_attn``'s plain version over all M positions) against JAX's
    prefill and decode_step, and against JAX's own full forward, as
    ``tests/test_serve.py`` holds JAX's."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=3)
    b, s = 2, 24
    jb, tb = _batch(cfg, 3, b=b, s=s)
    full, _ = jax.jit(functools.partial(j_forward, jcfg))(
        jp, jb["tokens"], jb.get("media"))
    jcache = j_init_cache(jcfg, b, 64, dtype=jnp.float32)
    jpre, jcache = j_prefill(jcfg, jp, jb["tokens"][:, :-1], jcache,
                             jb.get("media"))
    jdec, _ = j_decode_step(jcfg, jp, jb["tokens"][:, -1:], jcache,
                            jnp.int32(s - 1), jb.get("media"))
    cache = init_cache(cfg, b, 64, torch.float32, "cpu")
    if arch == VLM:
        assert cache["L1"]["cross"].k.shape == (b, 16, 2, 32)
    pre, cache = prefill(cfg, tp, tb["tokens"][:, :-1], cache,
                         tb.get("media"))
    dec, _ = decode_step(cfg, tp, tb["tokens"][:, -1:], cache, s - 1)
    _close_rel(_np(pre), jpre, 1e-5, "prefill")
    _close_rel(_np(dec), jdec, 1e-5, "decode")
    _close_rel(_np(pre[:, 0]), np.asarray(full)[:, -2], 1e-5, "vs forward")
    _close_rel(_np(dec[:, 0]), np.asarray(full)[:, -1], 1e-5, "vs forward")
    if arch == VLM:
        np.testing.assert_allclose(
            _np(cache["L1"]["cross"].k),
            np.asarray(jcache["L1"]["cross"].k), rtol=0, atol=1e-5)


@pytest.mark.parametrize("compute_dtype,media_dtype,cache_dtype", [
    ("float32", "bfloat16", "float32"), ("bfloat16", "float32", "bfloat16"),
    ("bfloat16", "bfloat16", "bfloat16")])
def test_vlm_prefill_matches_jax_across_dtypes(compute_dtype, media_dtype,
                                               cache_dtype):
    """The vision prefill with media and cache in other dtypes than the
    compute dtype: its logits and the cross layers' cached media K/V (one
    ``cross_kv`` product, attended and then stored) against JAX's prefill,
    and its logits against the port's own forward at the last position;
    the cross gates are nonzero (``_params``)."""
    jcfg, cfg = _cfgs(VLM, compute_dtype)
    jp, _, tp = _params(VLM, seed=4)
    b, s = 2, 16
    jb, tb = _batch(cfg, 4, b=b, s=s, media_dtype=media_dtype)
    jcache = j_init_cache(jcfg, b, 32, dtype=jnp.dtype(cache_dtype))
    jpre, jcache = j_prefill(jcfg, jp, jb["tokens"], jcache, jb["media"])
    cache = init_cache(cfg, b, 32, getattr(torch, cache_dtype), "cpu")
    pre, cache = prefill(cfg, tp, tb["tokens"], cache, tb["media"])
    full, _ = forward(cfg, tp, tb["tokens"], tb["media"])
    rtol = 1e-5 if compute_dtype == "float32" else 2e-2
    _close_rel(_np(pre), jpre, rtol, "prefill")
    _close_rel(_np(pre[:, 0]), _np(full[:, -1]), rtol, "vs forward")
    for i in range(cfg.n_layers):
        if cfg.layer_is_cross_attn(i):
            for n in ("k", "v"):
                got = getattr(cache[f"L{i}"]["cross"], n)
                assert got.dtype == getattr(torch, cache_dtype)
                _close_rel(_np(got), getattr(jcache[f"L{i}"]["cross"], n),
                           rtol, f"L{i} cross {n}")


def _prompts(cfg, seed, b=2, s=10):
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _media(cfg, seed, b=2):
    if not cfg.n_media_tokens:
        return None
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_matches_jax(arch, compute_dtype):
    """``ServeEngine.generate`` greedy, with media (vision) and with
    codebook prompts (audio, output (b, n, n_q)), token for token against
    JAX's engine, float32 cache."""
    jcfg, cfg = _cfgs(arch, compute_dtype)
    jp, _, tp = _params(arch, seed=4)
    prompts, media = _prompts(cfg, 5), _media(cfg, 6)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=32,
                                   cache_dtype=jnp.float32).generate(
        prompts, 8, media=media))
    got = ServeEngine(cfg, tp, max_len=32, cache_dtype=torch.float32,
                      device="cpu").generate(prompts, 8, media=media)
    assert got.shape == ((2, 8, 4) if arch == AUDIO else (2, 8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_eos_id_follows_jax_per_stream(arch):
    """``eos_id`` with JAX's semantics: each stream (a row, or a row's
    codebook) is padded with the stop token after its first one, and
    decoding stops once every stream has emitted it. The stop token is
    one the greedy run emits mid-way in one stream."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=7)
    prompts, media = _prompts(cfg, 8), _media(cfg, 9)
    jeng = JServeEngine(jcfg, jp, max_len=32, cache_dtype=jnp.float32)
    teng = ServeEngine(cfg, tp, max_len=32, cache_dtype=torch.float32,
                       device="cpu")
    free = np.asarray(jeng.generate(prompts, 10, media=media))
    eos = int(free[0, 3] if arch == VLM else free[0, 3, 1])
    want = np.asarray(jeng.generate(prompts, 10, media=media, eos_id=eos))
    got = teng.generate(prompts, 10, media=media, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got == eos).any() and not np.array_equal(got, free)


def test_serve_engine_sampling_is_seeded_per_codebook_stream():
    """Sampled codebook streams depend on (seed, row, codebook, position):
    the same seed repeats, another seed differs, a row does not depend on
    its neighbours, and the codebooks of a row are not one stream."""
    _, cfg = _cfgs(AUDIO)
    _, _, tp = _params(AUDIO, seed=10)
    eng = ServeEngine(cfg, tp, max_len=32, cache_dtype=torch.float32,
                      device="cpu")
    prompts = _prompts(cfg, 11)
    a = eng.generate(prompts, 8, temperature=1.0, seed=3)
    assert np.array_equal(a, eng.generate(prompts, 8, temperature=1.0,
                                          seed=3))
    assert not np.array_equal(a, eng.generate(prompts, 8, temperature=1.0,
                                              seed=4))
    assert np.array_equal(a[:1], eng.generate(prompts[:1], 8,
                                              temperature=1.0, seed=3))
    assert not np.array_equal(a[..., 0], a[..., 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_with_jax_messages(arch):
    """Neither package's ``ContinuousEngine`` serves these archs; the
    port raises JAX's message. The paged layout refuses cross layers as
    JAX's does."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jcfg, jp)
    with pytest.raises(NotImplementedError) as terr:
        ContinuousEngine(cfg, tp, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "legacy ServeEngine" in str(terr.value)
    if arch == VLM:
        with pytest.raises(NotImplementedError, match="cross-attention"):
            cache_layout(cfg, 64)


# -- training --------------------------------------------------------------------------

P, TAU, B_LOCAL, SEQ, ROUNDS = 2, 2, 1, 16, 2


def _trainer_run(framework, jcfg, cfg, jp, axes, backend):
    """WASGD+ rounds through one package's Trainer from the numpy params
    ``jp``, the batch's ``media`` leaf (vision) or codebook tokens (audio)
    riding worker-major; returns the trainer and each round's params."""
    data = lm_batch(0, 64, SEQ, cfg.vocab_size, n_codebooks=cfg.n_codebooks,
                    media_tokens=cfg.n_media_tokens, d_model=cfg.d_model)
    wkw = dict(tau=TAU, beta=0.9, a_tilde=1.0, strategy="boltzmann",
               backend=backend)
    if framework == "jax":
        tr = JTrainer(j_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, jp),
                      axes,
                      JTrainConfig(learning_rate=0.03, optimizer="sgd",
                                   wasgd=JWASGDConfig(**wkw)), P,
                      rule="wasgd+")
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2)
    else:
        params = params_from_numpy(jp, "cpu")
        tr = Trainer(make_lm_loss(cfg), params, param_axes(params),
                     TrainConfig(learning_rate=0.03, optimizer="sgd",
                                 wasgd=WASGDConfig(**wkw)), P, rule="wasgd+",
                     device="cpu")
        ds = OrderedDataset(data, P, TAU, B_LOCAL, n_segments=2)
    snaps = []
    step = tr._step

    def recording_step(state, batch):
        out = step(state, batch)
        snaps.append(_flat(out[0].params))
        return out

    tr._step = recording_step
    tr.run(ds.batches(), ROUNDS, order_state=ds.order,
           segment_fn=ds.segment_of_round)
    return tr, snaps


@pytest.mark.parametrize("arch,backend,remat", [
    (VLM, "einsum:f32", True), (VLM, "pallas_wagg:f32", False),
    (AUDIO, "einsum:f32", False), (AUDIO, "pallas_wagg:f32", True)])
def test_trainer_rounds_match_jax(arch, backend, remat):
    """Two WASGD+ rounds at p 2 through both Trainers (JAX's Pallas
    aggregation in interpret mode, the port's plain version of
    ``wagg_fused``), nonzero cross gates; ``remat`` on one schedule of
    each arch runs the media through ``torch.utils.checkpoint`` around
    each layer's ``vmap``."""
    jcfg, cfg = _cfgs(arch, remat=remat)
    jp, axes, _ = _params(arch, seed=5)
    tr_j, snaps_j = _trainer_run("jax", jcfg, cfg, jp, axes, backend)
    tr_t, snaps_t = _trainer_run("port", jcfg, cfg, jp, axes, backend)
    assert len(snaps_t) == len(snaps_j) == ROUNDS
    for r in range(ROUNDS):
        hj, ht = tr_j.history[r], tr_t.history[r]
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
        assert sorted(snaps_t[r]) == sorted(snaps_j[r])
        for k, ref in snaps_j[r].items():
            assert snaps_t[r][k].shape == ref.shape == (P,) + ref.shape[1:]
            np.testing.assert_allclose(snaps_t[r][k], ref, rtol=0,
                                       atol=1e-5, err_msg=f"round {r} {k}")
    if arch == VLM:     # the gates trained: the cross branch was live
        g0 = jp["layers"]["L1"]["cross_gate"]
        assert np.abs(snaps_t[-1]["/layers/L1/cross_gate"] - g0).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_evaluate_lm_matches_jax(arch):
    """evaluate_lm passes the batch's media to the forward, as JAX's
    does; the audio model's accuracy is over every codebook."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=6)

    def batches():
        seed = 100
        while True:
            yield lm_batch(seed, 2, SEQ, cfg.vocab_size,
                           n_codebooks=cfg.n_codebooks,
                           media_tokens=cfg.n_media_tokens,
                           d_model=cfg.d_model)
            seed += 1

    want = j_evaluate_lm(jcfg, jax.tree.map(jnp.asarray, jp), batches(), 2)
    got = evaluate_lm(cfg, tp, batches(), 2)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=0, atol=1e-6)
