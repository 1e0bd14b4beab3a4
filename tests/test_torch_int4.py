"""The port's int4 codec (stochastic rounding, carried in int8) against its
contract and the JAX package.

The two packages draw their rounding noise from different generators (JAX:
threefry fold-ins; the port: a counter-based hash in integer torch ops),
so their payloads are not equal. Both are held to the codec's
``error_bound`` (per element, one Eq. 10 step: ``beta * scale + 1e-5``)
against the float32 aggregate (at beta = 1 in an Alg. 4 round, whose
stragglers adopt the aggregate whole), so a port round and JAX's on the
same inputs differ by at most twice that bound. The draw itself is held to
unbiasedness (the mean over keys within 4 standard errors of x / scale),
to determinism per (content, leaf index, key) and to independence of its
chunking. Energies are drawn in float32 and checked to be distinct there,
so no policy tie breaks by index.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as jbk  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.weights import compute_theta as j_compute_theta  # noqa: E402
from repro_torch.configs import WASGDConfig  # noqa: E402
from repro_torch.core import backends as tbk  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core.weights import compute_theta  # noqa: E402
from repro_torch.train.step import wasgd_rule  # noqa: E402

SCHEDULES = ["einsum", "hierarchical", "pallas_wagg"]
BETA = 0.9
ACTIVE = np.array([True, False, True, True])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().float().numpy()


def _tree(p=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": (rng.normal(size=(p, 5, 3)) * 2).astype(np.float32),
              "blk": {"w": rng.normal(size=(p, 17)).astype(np.float32),
                      "shared": rng.normal(size=(6,)).astype(np.float32)},
              "z": rng.normal(size=(p, 40)).astype(np.float32)}
    axes = {"a": ("worker", None, None),
            "blk": {"w": ("worker", "embed"), "shared": ("embed",)},
            "z": ("worker", None)}
    return params, axes


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [x for k in sorted(tree) for x in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _energies(seed, p=4):
    """Energies drawn in float32 and distinct there."""
    h = np.random.default_rng(seed).uniform(0.5, 3.0, p).astype(np.float32)
    assert len(np.unique(h)) == p
    return h


def _ctx(masked):
    return tbk.AggregationContext(
        n_pods=2, active=_t(ACTIVE) if masked else None)


def _bound(x, theta, masked):
    """The codec's bound; an Alg. 4 round's stragglers adopt m whole, so a
    masked round's bound is taken at beta = 1 (as JAX's composition grid
    takes it)."""
    return float(tcodecs.get_codec("int4").error_bound(
        _t(x), theta, 1.0 if masked else BETA))


# -- the codec ----------------------------------------------------------------

def test_int4_codec_is_registered_with_jaxs_attributes_and_bound():
    ours, ref = tcodecs.get_codec("int4"), jcodecs.get_codec("int4")
    assert (ours.name, ours.quantizing) == (ref.name, ref.quantizing)
    assert ours.wire_dtype == torch.int8 and ours.reduce_dtype == torch.float32
    assert "int4" in tcodecs.available_codecs()
    x = np.random.default_rng(1).normal(size=(4, 33)).astype(np.float32)
    theta = np.random.default_rng(2).dirichlet(np.ones(4)).astype(np.float32)
    np.testing.assert_allclose(
        _np(ours.error_bound(_t(x), _t(theta), BETA)),
        ref.error_bound(jnp.asarray(x), jnp.asarray(theta), BETA),
        rtol=1e-6, atol=0)
    q, scale = ours.encode(_t(x))
    _, jscale = ref.encode(jnp.asarray(x))
    np.testing.assert_array_equal(_np(scale), np.asarray(jscale))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 7
    # one step at most: |q * scale - x| < scale
    assert float((q.float() * scale - _t(x)).abs().max()) < float(scale)
    m = np.random.default_rng(3).normal(size=33).astype(np.float32)
    np.testing.assert_allclose(_np(ours.decode_reduced(_t(m), scale)),
                               ref.decode_reduced(jnp.asarray(m), jscale),
                               rtol=0, atol=1e-7)


def test_int4_draw_is_unbiased_over_keys():
    """E[q * scale] = x: the mean over 256 keys lies within 4 standard
    errors of x in every element. A draw rounds x / scale up with
    probability f, its fractional part, so its standard deviation is
    scale * sqrt(f (1 - f)); the mean's is that over sqrt(256)."""
    codec = tcodecs.get_codec("int4")
    x = _t(np.random.default_rng(4).normal(size=(4, 300)).astype(np.float32))
    n = 256
    draws = torch.stack([
        codec.encode(x, tbk.AggregationContext(key=k))[0].float()
        for k in range(n)])
    scale = codec.encode(x)[1]
    f = x / scale - torch.floor(x / scale)
    se = scale * torch.sqrt(f * (1 - f) / n)
    err = (draws.mean(dim=0) * scale - x).abs()
    assert bool((err <= 4 * se + 1e-6).all()), float((err / (se + 1e-12)).max())
    # the 24-bit uniforms themselves: mean 1/2, variance 1/12
    u = tcodecs.int4_uniform(tcodecs.int4_key(x), 0, 1 << 16)
    assert abs(float(u.mean()) - 0.5) < 4 * (1 / 12) ** 0.5 / 256
    assert abs(float(u.var()) - 1 / 12) < 2e-3
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def _lowbias32(h):
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x7FEB352D) & m
    h ^= h >> 15
    h = (h * 0x846CA68B) & m
    return h ^ (h >> 16)


@pytest.mark.parametrize("start", [0, 123456789, 2 ** 31 + 5, 3 * 2 ** 31])
def test_int4_uniform_is_the_u32_hash_on_int32_lanes(start):
    """The draw on int32 lanes (wrapping products, masked shifts) gives
    the bits of the u32 hash in Python integers: u = (h >>> 8 xor 2^23) /
    2^24, h = lowbias32(i * golden + key mod 2^32), also for a flat index
    past 2^31."""
    x = _t(np.random.default_rng(8).normal(size=(3, 50)).astype(np.float32))
    key = tcodecs.int4_key(x, None, 5)
    assert key.dtype == torch.int32 and key.dim() == 0
    k = int(key) & 0xFFFFFFFF
    u = tcodecs.int4_uniform(key, start, start + 64)
    ref = [((_lowbias32(((start + j) * 0x9E3779B1 + k) & 0xFFFFFFFF) >> 8)
            ^ 1 << 23) * 2.0 ** -24 for j in range(64)]
    assert u.dtype == torch.float32
    assert u.tolist() == ref


def test_int4_encode_is_deterministic_per_content_leaf_index_and_key():
    codec = tcodecs.get_codec("int4")
    x = _t(np.random.default_rng(5).normal(size=(4, 257)).astype(np.float32))

    def enc(t, **kw):
        return codec.encode(t, tbk.AggregationContext(**kw))[0]

    base = enc(x, leaf_index=2)
    assert torch.equal(base, enc(x.clone(), leaf_index=2))
    assert torch.equal(enc(x), codec.encode(x)[0])          # default key
    assert torch.equal(enc(x, key=0x144), enc(x))
    for other in (enc(x, leaf_index=3), enc(x, leaf_index=2, key=7),
                  enc(x + 1e-6, leaf_index=2)):
        assert (other != base).float().mean() > 0.1


def test_int4_encode_does_not_depend_on_its_chunking(monkeypatch):
    codec = tcodecs.get_codec("int4")
    x = _t(np.random.default_rng(6).normal(size=(3, 1001)).astype(np.float32))
    whole = codec.encode(x)[0]
    monkeypatch.setattr(tcodecs, "INT4_CHUNK", 97)
    assert torch.equal(codec.encode(x)[0], whole)
    assert torch.equal(tcodecs.int4_key(x),
                       tcodecs.int4_key(x.reshape(-1)))


def test_equal_content_leaves_draw_different_noise(monkeypatch):
    """Two worker leaves with the same values (zero-inits, tied copies)
    get distinct leaf indices in the aggregate, so distinct payloads."""
    codec = tcodecs.get_codec("int4")
    x = np.random.default_rng(7).normal(size=(4, 64)).astype(np.float32)
    params = {"a": _t(x), "b": _t(x.copy())}
    axes = {"a": ("worker", None), "b": ("worker", None)}
    seen = {}
    real = codec.encode

    def spy(t, ctx=None):
        out = real(t, ctx)
        seen[ctx.leaf_index] = out[0]
        return out

    monkeypatch.setattr(codec, "encode", spy)
    out = tbk.aggregate_with("einsum:int4", params, axes,
                             torch.full((4,), 0.25), BETA)
    assert sorted(seen) == [0, 1]
    assert (seen[0] != seen[1]).float().mean() > 0.1
    assert not torch.equal(out["a"], out["b"])


# -- the schedules --------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_int4_aggregate_within_error_bound_of_f32(sched, masked):
    params, axes = _tree(seed=8)
    theta = compute_theta(_t(_energies(9)), "boltzmann")
    if masked:
        theta = theta * _t(ACTIVE).float()
        theta = theta / theta.sum()
    tp = _tmap(_t, params)
    got = tbk.aggregate_with(f"{sched}:int4", tp, axes, theta, BETA,
                             ctx=_ctx(masked))
    ref = tbk.aggregate_with("einsum:f32", tp, axes, theta, BETA,
                             ctx=_ctx(masked))
    for o, r, x in zip(_leaves(got), _leaves(ref), _leaves(params)):
        if x.ndim == 1:                       # the shared leaf: untouched
            np.testing.assert_array_equal(_np(o), x)
            continue
        assert np.abs(_np(o) - _np(r)).max() <= _bound(x, theta, masked)


@pytest.mark.parametrize("masked", [False, True])
def test_pallas_wagg_int4_equals_einsum_int4_on_the_same_payload(masked):
    """The fused path (scale folded into theta, the int8-carried payload
    widened in the kernel's plain version) against the tensordot of the
    same payload: float reassociation only."""
    params, axes = _tree(seed=10)
    theta = _t(np.random.default_rng(11).dirichlet(np.ones(4))
               .astype(np.float32))
    tp = _tmap(_t, params)
    a = tbk.aggregate_with("pallas_wagg:int4", tp, axes, theta, BETA,
                           ctx=_ctx(masked))
    b = tbk.aggregate_with("einsum:int4", tp, axes, theta, BETA,
                           ctx=_ctx(masked))
    for o, r in zip(_leaves(a), _leaves(b)):
        np.testing.assert_allclose(_np(o), _np(r), rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_int4_rounds_stay_within_twice_the_bound_of_jax(sched, masked):
    """Three rounds: each round's inputs are JAX's previous output plus a
    local step's drift; theta comes from float32 energies through both
    packages' policy; the port's and JAX's ``<sched>:int4`` outputs differ
    by at most twice the codec's bound (each is within one of f32)."""
    params, axes = _tree(seed=12)
    spec = f"{sched}:int4"
    rng = np.random.default_rng(13)
    act = ACTIVE if masked else None
    for r in range(3):
        h = _energies(100 + r)
        th_j = j_compute_theta(jnp.asarray(h), "boltzmann")
        th_t = compute_theta(_t(h), "boltzmann")
        np.testing.assert_allclose(_np(th_t), np.asarray(th_j), rtol=0,
                                   atol=1e-6)
        if masked:
            th_j = th_j * jnp.asarray(act) / jnp.sum(th_j * jnp.asarray(act))
            th_t = th_t * _t(act).float() / (th_t * _t(act).float()).sum()
        ref = jbk.aggregate_with(
            spec, _tmap(jnp.asarray, params), axes, th_j, BETA,
            ctx=jbk.AggregationContext(
                n_pods=2, active=None if act is None else jnp.asarray(act)))
        got = tbk.aggregate_with(spec, _tmap(_t, params), axes, th_t, BETA,
                                 ctx=_ctx(masked))
        for o, j, x in zip(_leaves(got), _leaves(ref), _leaves(params)):
            tol = 2 * float(jcodecs.get_codec("int4").error_bound(
                jnp.asarray(x), th_j, 1.0 if masked else BETA))
            assert np.abs(_np(o) - np.asarray(j)).max() <= tol, (r, x.shape)
        params = _tmap(lambda a: (np.asarray(a) + rng.normal(
            scale=0.05, size=np.shape(a))).astype(np.float32), ref)


@pytest.mark.parametrize("spec", ["einsum:int4", "hierarchical:int4",
                                  "pallas_wagg:int4"])
def test_int4_specs_build_rules_and_resolve(spec):
    assert tbk.resolve_spec(spec) == (spec.split(":")[0], "int4")
    wasgd_rule(WASGDConfig(backend=spec, n_pods=2))
    assert tbk.canonical_spec(spec) == spec
