"""The port's Mamba2 SSD chunk against the JAX package.

The port's plain ``ssd_chunk_ref`` is held to JAX's ``ssd_chunk_ref`` and
to JAX's Pallas ``ssd_chunk`` in interpret mode; the port's
``ssd_chunked_kernel`` (the kernel's wrapper around the inter-chunk
recurrence) and plain ``ssd_chunked`` to JAX's ``ssd_chunked_kernel``,
``models.ssm.ssd_chunked`` and the per-step ``ssd_reference``, on the same
numpy inputs. Float32 within atol 1e-4 (outputs of order ten, sums of up
to 64 products taken in another order; states chained across chunks).
bfloat16 inputs are widened to float32 by both packages, so they meet the
same tolerance. The CUDA kernel runs on the card only: ``chip_smoke.py``
holds it to the plain version there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_chunk as jax_ssd_chunk
from repro.kernels.ssd_chunk import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.kernels.ssd_chunk import ssd_chunked_kernel as jax_chunked_kernel
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_ref,
                                           ssd_chunked_kernel)
from repro_torch.models import ssd_chunked, ssd_reference

ATOL = 1e-4


def _chunk_inputs(b, nc, L, nh, hd, ds, seed, pad_tail=0):
    """xs, dt > 0, a < 0, B, C as numpy float32; the last ``pad_tail``
    steps of the last chunk padded as prefill pads them (zeros, dt = 0)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, nc, L, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, nc, L, nh)).astype(np.float32)
    a = -np.exp(rng.uniform(-1, 1, size=(nh,))).astype(np.float32)
    B = rng.normal(size=(b, nc, L, ds)).astype(np.float32)
    C = rng.normal(size=(b, nc, L, ds)).astype(np.float32)
    if pad_tail:
        for arr in (xs, dt, B, C):
            arr[:, -1, L - pad_tail:] = 0
    return xs, dt, a, B, C


def _to(arrays, dtype, which=(0, 3, 4)):
    """torch tensors and jax arrays; the ``which`` inputs (xs, B, C) in
    ``dtype``, dt and a in float32 as prefill gives them."""
    ts, js = [], []
    for i, a in enumerate(arrays):
        t, j = torch.from_numpy(a), jnp.asarray(a)
        if i in which:
            t, j = t.to(getattr(torch, dtype)), j.astype(getattr(jnp, dtype))
        ts.append(t)
        js.append(j)
    return ts, js


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # (b, nc, L, nh, hd, ds): mamba2 smoke's chunk, head and state sizes,
    # then its full chunk, head and state sizes with fewer heads
    (2, 3, 16, 4, 32, 16), (1, 2, 64, 2, 64, 128)])
@pytest.mark.parametrize("pad_tail", [0, 5])
def test_plain_matches_jax_ref_and_interpret_kernel(dtype, shape, pad_tail):
    arrays = _chunk_inputs(*shape, seed=sum(shape), pad_tail=pad_tail)
    ts, js = _to(arrays, dtype)
    ours = ssd_chunk_ref(*ts)
    ref = jax_ssd_chunk_ref(*js)
    kern = jax_ssd_chunk(*js, interpret=True)
    for o, r, k in zip(ours, ref, kern):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(k), rtol=0,
                                   atol=ATOL)


def test_large_decay_above_the_diagonal_stays_finite():
    """dt * a of order -30 a step: exp(cum_i - cum_j) overflows above the
    diagonal, where it must be masked before it meets a zero."""
    xs, dt, a, B, C = _chunk_inputs(1, 1, 16, 2, 32, 16, seed=9)
    dt[:] = 10.0
    a[:] = -3.0
    ys = ssd_chunk_ref(*(torch.from_numpy(x) for x in (xs, dt, a, B, C)))
    ref = jax_ssd_chunk_ref(*(jnp.asarray(x) for x in (xs, dt, a, B, C)))
    for o, r in zip(ys, ref):
        assert torch.isfinite(o).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=ATOL)


def _seq_inputs(b, s, nh, hd, ds, seed, pad_tail=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, s, nh)).astype(np.float32)
    a = -np.exp(rng.uniform(-1, 1, size=(nh,))).astype(np.float32)
    B = rng.normal(size=(b, s, ds)).astype(np.float32)
    C = rng.normal(size=(b, s, ds)).astype(np.float32)
    if pad_tail:
        for arr in (xs, dt, B, C):
            arr[:, s - pad_tail:] = 0
    init = rng.normal(size=(b, nh, ds, hd)).astype(np.float32)
    return (xs, dt, a, B, C), init


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("pad_tail", [0, 7])
def test_chunked_forms_match_jax_and_the_recurrence(with_init, pad_tail):
    """Four chunks of 16 (mamba2 smoke): the kernel wrapper and the plain
    chunked scan against JAX's two chunked forms and the per-step
    recurrence of both packages; y and the final state."""
    (xs, dt, a, B, C), init = _seq_inputs(2, 64, 4, 32, 16, seed=11,
                                          pad_tail=pad_tail)
    chunk = 16
    targs = [torch.from_numpy(x) for x in (xs, dt, a, B, C)]
    jargs = [jnp.asarray(x) for x in (xs, dt, a, B, C)]
    t_init = torch.from_numpy(init) if with_init else None
    j_init = jnp.asarray(init) if with_init else None
    before = ssd_chunk.launches
    ours = [ssd_chunked_kernel(*targs, chunk, init_state=t_init),
            ssd_chunked(*targs, chunk, init_state=t_init),
            ssd_reference(*targs, init_state=t_init)]
    assert ssd_chunk.launches == before          # CPU: the plain version
    refs = [jax_chunked_kernel(*jargs, chunk, init_state=j_init),
            jax_ssd_chunked(*jargs, chunk, init_state=j_init),
            jax_ssd_reference(*jargs, init_state=j_init)]
    want_y, want_s = (np.asarray(r) for r in refs[2])
    for (y, st), (jy, js) in zip(ours, refs):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(js), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ATOL)
        np.testing.assert_allclose(st.numpy(), want_s, rtol=0, atol=ATOL)


def test_chunked_kernel_wrapper_takes_bf16_inputs():
    """Prefill hands xs, B and C over in the compute dtype: the wrapper
    widens them as JAX's does."""
    (xs, dt, a, B, C), _ = _seq_inputs(1, 32, 2, 32, 16, seed=12)
    t = [torch.from_numpy(x) for x in (xs, dt, a, B, C)]
    j = [jnp.asarray(x) for x in (xs, dt, a, B, C)]
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
        # reprolint: allow=DT001 -- the same bf16 inputs prefill hands over
        j[i] = j[i].astype(jnp.bfloat16)
    y, st = ssd_chunked_kernel(*t, 16)
    jy, js = jax_chunked_kernel(*j, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), rtol=0, atol=ATOL)


def test_wrapper_dispatch():
    """A CPU tensor takes the plain version without a launch; other devices
    and mixed devices raise; a sequence that is no chunk multiple raises."""
    from test_torch_dryrun import other_device
    arrays = [torch.from_numpy(x)
              for x in _chunk_inputs(1, 2, 16, 2, 32, 16, seed=13)]
    before = ssd_chunk.launches
    for o, r in zip(ssd_chunk(*arrays), ssd_chunk_ref(*arrays)):
        assert torch.equal(o, r)
    assert ssd_chunk.launches == before
    with pytest.raises(ValueError, match="several devices"):
        ssd_chunk(arrays[0].to("meta"), *arrays[1:])
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        ssd_chunk(*(other_device(x) for x in arrays))
    (xs, dt, a, B, C), _ = _seq_inputs(1, 20, 2, 32, 16, seed=14)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_chunked_kernel(*(torch.from_numpy(x) for x in (xs, dt, a, B, C)),
                           16)
