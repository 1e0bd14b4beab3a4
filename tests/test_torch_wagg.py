"""The port's fused Eq. 10 aggregation against the JAX package.

The port's plain version (``repro_torch.kernels.wagg.ref``) is held to
JAX's ``wagg_fused_ref`` and to JAX's Pallas kernel in interpret mode, on
the same numpy inputs, over payload x mask x dtype and a ragged N.
Tolerances: float32 output atol 1e-6 (values of order one; the two differ
only in summation order over <= 5 workers); bfloat16 output rtol 2^-7
(one bfloat16 ulp: a float32 difference in the last bit can round to the
neighbouring bfloat16). The CUDA kernel itself runs on the card only:
``chip_smoke.py`` holds it to the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.codecs import get_codec as jax_get_codec  # noqa: E402
from repro.kernels.wagg import wagg_fused as jax_wagg_fused  # noqa: E402
from repro.kernels.wagg import wagg_fused_leaf as jax_fused_leaf  # noqa: E402
from repro.kernels.wagg import wagg_fused_ref as jax_wagg_fused_ref  # noqa: E402
from repro.kernels.wagg import wagg_ref as jax_wagg_ref  # noqa: E402
from repro_torch.core.codecs import get_codec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wagg import (wagg_fused, wagg_fused_leaf,  # noqa: E402
                                      wagg_fused_ref, wagg_leaf, wagg_ref)
from repro_torch.kernels.wagg import wagg as wagg_mod  # noqa: E402

F32_ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
BETA = 0.9


def _inputs(p, n, payload, mask, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(p, n)).astype(np.float32)
    theta = rng.uniform(0.1, 1.0, size=p).astype(np.float32)
    theta /= theta.sum()
    q = None
    if payload == "bfloat16":
        q = rng.normal(size=(p, n)).astype(np.float32)
    elif payload == "int8":
        # reprolint: allow=DT001 -- int8 codes drawn in [-127, 127]
        q = rng.integers(-127, 128, size=(p, n)).astype(np.int8)
        theta = (theta * np.float32(4 / 127)).astype(np.float32)
    act = None if mask == "none" else (np.arange(p) % 2 == 0).astype(
        np.float32)
    return x, theta, q, act


def _port(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _jax(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _close(ours, ref, dtype):
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(ours, ref, rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [257, 1000])
@pytest.mark.parametrize("mask", ["none", "mixed"])
@pytest.mark.parametrize("payload", ["none", "bfloat16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_ref_and_interpret_kernel(dtype, payload, mask, n):
    x, theta, q, act = _inputs(5, n, payload, mask, seed=n + len(payload))
    tdt = getattr(torch, dtype)
    qdt = {"none": None, "bfloat16": torch.bfloat16, "int8": None}[payload]
    jq = {"none": None, "bfloat16": jnp.bfloat16, "int8": None}[payload]
    ours = wagg_fused_ref(
        _port(x, tdt), _port(theta), BETA,
        payload=None if q is None else _port(q, qdt),
        active=None if act is None else _port(act))
    assert ours.dtype == tdt and ours.shape == x.shape
    args = (_jax(x, getattr(jnp, dtype)), _jax(theta), BETA)
    kw = {"payload": None if q is None else _jax(q, jq),
          "active": None if act is None else _jax(act)}
    ref = jax_wagg_fused_ref(*args, **kw)
    kern = jax_wagg_fused(*args, **kw, block_n=128, interpret=True)
    ours = ours.float().numpy()
    _close(ours, ref, dtype)
    _close(ours, kern, dtype)


def test_wagg_ref_matches_jax():
    x, theta, _, _ = _inputs(4, 333, "none", "none", seed=3)
    ours = wagg_ref(_port(x), _port(theta), 0.7).numpy()
    np.testing.assert_allclose(ours, jax_wagg_ref(_jax(x), _jax(theta), 0.7),
                               rtol=0, atol=F32_ATOL)
    # the f32 maskless leaf entry is the same function
    leaf = wagg_leaf(_port(x).reshape(4, 9, 37), _port(theta), 0.7)
    np.testing.assert_allclose(leaf.reshape(4, -1).numpy(), ours, rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_fused_leaf_folds_the_codec_scale_like_jax(codec):
    """A (p, a, b) leaf through the codec, then the fused leaf entry: the
    int8 scale is folded into theta on the device, as JAX does."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4, 6, 7)) * 3).astype(np.float32)
    theta = rng.dirichlet(np.ones(4)).astype(np.float32)
    act = np.array([True, False, True, True])
    q, aux = get_codec(codec).encode(_port(x))
    jq, jaux = jax_get_codec(codec).encode(_jax(x))
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(jq, np.float32))
    ours = wagg_fused_leaf(_port(x), q, aux, _port(theta), BETA,
                           active=_port(act)).numpy()
    ref = jax_fused_leaf(_jax(x), jq, jaux, _jax(theta), BETA,
                         active=_jax(act))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=F32_ATOL)


def test_cpu_tensor_takes_plain_version_without_a_launch():
    x, theta, q, act = _inputs(3, 100, "int8", "mixed", seed=5)
    before = wagg_fused.launches
    out = wagg_fused(_port(x), _port(theta), BETA, payload=_port(q),
                     active=_port(act))
    ref = wagg_fused_ref(_port(x), _port(theta), BETA, payload=_port(q),
                         active=_port(act))
    assert torch.equal(out, ref)
    assert wagg_fused.launches == before


def test_other_devices_never_take_the_plain_version():
    from test_torch_dryrun import other_device
    x, theta, _, _ = _inputs(3, 10, "none", "none", seed=6)
    with pytest.raises(ValueError, match="several devices"):
        wagg_fused(_port(x).to("meta"), _port(theta), BETA)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        wagg_fused(other_device(_port(x)), other_device(_port(theta)), BETA)


@pytest.mark.parametrize("bad, match", [
    (lambda x, t, q, a: (x[0], t, q, a), "must be \\(p, N\\)"),
    (lambda x, t, q, a: (x.double(), t, q, a), "float32 or bfloat16"),
    (lambda x, t, q, a: (x, t[:2], q, a), "theta must be"),
    (lambda x, t, q, a: (x, t, q[:, :5], a), "does not match"),
    (lambda x, t, q, a: (x, t, q.to(torch.int32), a), "payload must be"),
    (lambda x, t, q, a: (x, t, q, a[:1]), "active must be"),
    (lambda x, t, q, a: (x.t().contiguous().t(), t, q.t().contiguous().t(),
                         a), "contiguous"),
])
def test_launch_checks_refuse_what_the_kernel_does_not_take(bad, match):
    x, theta, q, act = _inputs(4, 8, "int8", "mixed", seed=7)
    args = bad(_port(x), _port(theta), _port(q), _port(act))
    with pytest.raises((ValueError, TypeError), match=match):
        wagg_mod._check(*args)


def test_vector_width_needs_n_multiple_of_4_and_aligned_rows():
    """16 bytes of x a thread: 4 float32 or 8 bfloat16 columns, on the
    vector path only when every row starts on a vector boundary (one row
    may end in a scalar tail)."""
    x = torch.zeros(3, 64)
    assert wagg_mod.columns_per_thread(torch.float32) == 4
    assert wagg_mod.columns_per_thread(torch.bfloat16) == 8
    assert wagg_mod.rows_aligned(3, 64, 4, x)
    assert not wagg_mod.rows_aligned(3, 63, 4, x[:, :63].contiguous())
    assert not wagg_mod.rows_aligned(3, 60, 4, x.reshape(-1)[1:181])
    assert wagg_mod.rows_aligned(1, 63, 4, x[:1, :63].contiguous())
    xb = torch.zeros(3, 68, dtype=torch.bfloat16)
    assert not wagg_mod.rows_aligned(3, 68, 8, xb)
    assert wagg_mod.rows_aligned(3, 64, 8, xb[:, :64].contiguous())


def test_build_knows_the_wagg_source():
    src = build.SOURCES["wagg_fused"]
    assert src.is_file()
    text = src.read_text()
    assert 'extern "C" int wagg_fused_launch' in text
    assert "src/repro/kernels/wagg/wagg.py:88" in text
