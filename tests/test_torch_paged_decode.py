"""The port's paged decode attention against the JAX package.

The port's plain version (``repro_torch.kernels.decode_attn.ref``) is held
to JAX's ``paged_decode_attn_ref`` and to JAX's Pallas kernel in interpret
mode, on the same numpy inputs, in float32 with atol 1e-5 (the two differ
only in summation order). The CUDA kernel itself runs on the card only:
``chip_smoke.py`` holds it to the plain version there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attn import paged_decode_attn as jax_paged_kernel
from repro.kernels.decode_attn import paged_decode_attn_ref as jax_paged_ref
from repro_torch.kernels import build
from repro_torch.kernels.decode_attn import (paged_decode_attention,
                                             paged_decode_attn,
                                             paged_decode_attn_ref)
from repro_torch.kernels.decode_attn.paged import split_plan

ATOL = 1e-5


def _inputs(b, kv, g, hd, bs, n_blk, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    n_pool = b * n_blk + 1
    kp = rng.normal(size=(n_pool, bs, kv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pool, bs, kv, hd)).astype(np.float32)
    tab = rng.permutation(b * n_blk).reshape(b, n_blk).astype(np.int32)
    return q, kp, vp, tab


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


LAYOUTS = {"linear": lambda S: (None, None),
           "ring": lambda S: (S, None),
           "ring_window": lambda S: (S, S // 3)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [32, 256])
def test_plain_matches_jax_ref_and_interpret_kernel(layout, g, hd):
    b, kv, bs, n_blk = 3, 1, 8, 4
    S = bs * n_blk
    ring, window = LAYOUTS[layout](S)
    q, kp, vp, tab = _inputs(b, kv, g, hd, bs, n_blk, seed=g * hd)
    # index 0, one inside the first ring pass, one past the wrap (ring
    # layouts) or at the last slot (linear)
    idx = np.asarray([0, S // 2 + 3, 3 * S + 5 if ring else S - 1], np.int32)
    ours = paged_decode_attn_ref(*_torch(q, kp, vp, tab, idx), ring=ring,
                                 window=window).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, tab, idx)]
    ref = np.asarray(jax_paged_ref(*args, ring=ring, window=window))
    kern = np.asarray(jax_paged_kernel(*args, ring=ring, window=window,
                                       interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, kern, rtol=0, atol=ATOL)


def test_plain_matches_jax_on_gqa_and_trash_row():
    """kv > 1 heads, and a row whose table points at the trash block."""
    b, kv, g, hd, bs, n_blk = 2, 2, 2, 32, 8, 3
    q, kp, vp, tab = _inputs(b, kv, g, hd, bs, n_blk, seed=7)
    tab[1] = kp.shape[0] - 1
    idx = np.asarray([5, 17], np.int32)
    for ring, window in [(None, None), (bs * n_blk, 10)]:
        ours = paged_decode_attn_ref(*_torch(q, kp, vp, tab, idx),
                                     ring=ring, window=window).numpy()
        ref = np.asarray(jax_paged_ref(*[jnp.asarray(a) for a in
                                         (q, kp, vp, tab, idx)],
                                       ring=ring, window=window))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_cpu_tensor_takes_plain_version_without_a_launch():
    q, kp, vp, tab = _torch(*_inputs(2, 1, 4, 32, 8, 4, seed=1))
    idx = torch.tensor([3, 30], dtype=torch.int32)
    before = paged_decode_attn.launches
    out = paged_decode_attn(q, kp, vp, tab, idx, ring=32, window=20)
    ref = paged_decode_attn_ref(q, kp, vp, tab, idx, ring=32, window=20)
    assert torch.equal(out, ref)
    assert paged_decode_attn.launches == before
    # the model-layout entry reshapes (b, 1, h, hd) around the same call
    out4 = paged_decode_attention(q.reshape(2, 1, 4, 32), kp, vp, tab, idx,
                                  ring=32, window=20)
    assert torch.equal(out4.reshape(out.shape), ref)


def test_other_devices_never_take_the_plain_version():
    q, kp, vp, tab = _torch(*_inputs(2, 1, 4, 32, 8, 4, seed=2))
    idx = torch.tensor([3, 30], dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        paged_decode_attn(q.to("meta"), kp, vp, tab, idx)
    meta = [t.to("meta") for t in (q, kp, vp, tab, idx)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_decode_attn(*meta)


def test_ring_capacity_must_match_table():
    q, kp, vp, tab = _torch(*_inputs(2, 1, 4, 32, 8, 4, seed=3))
    idx = torch.tensor([3, 30], dtype=torch.int32)
    with pytest.raises(ValueError, match="ring capacity"):
        paged_decode_attn(q, kp, vp, tab, idx, ring=16)


@pytest.mark.parametrize("b,kv,n_blk", [(4, 1, 32), (4, 1, 64), (1, 1, 64),
                                        (8, 8, 5), (64, 4, 3)])
def test_split_plan_covers_the_table(b, kv, n_blk):
    per, n_split = split_plan(b, kv, n_blk)
    assert per >= 1 and 1 <= n_split <= 64
    assert per * n_split >= n_blk > per * (n_split - 1)


def test_build_without_nvcc_raises(monkeypatch):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
