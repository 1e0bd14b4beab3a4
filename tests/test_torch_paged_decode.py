"""The port's paged decode attention against the JAX package.

The port's plain version (``repro_torch.kernels.decode_attn.ref``) is held
to JAX's ``paged_decode_attn_ref`` and to JAX's Pallas kernel in interpret
mode, on the same numpy inputs, in float32 with atol 1e-5 (the two differ
only in summation order); a bfloat16 output within 2e-2 (one bf16 ulp of
an output below 4 is at most 2^-6). The CUDA kernel itself runs on the
card only: ``chip_smoke.py`` holds it to the plain version there.
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
from repro_torch.kernels.decode_attn.paged import check_shapes, split_plan

ATOL = 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


@pytest.mark.parametrize("layout", ["linear", "ring_window"])
@pytest.mark.parametrize("g,hd,q_dtype,kv_dtype", [
    (7, 80, "bfloat16", "float32"),     # arctic's g, stablelm-3b's hd
    (7, 80, "float32", "float32"),
    (4, 256, "bfloat16", "float32"),    # gemma3-1b, bf16 model, f32 cache
    (2, 80, "bfloat16", "bfloat16")])
def test_plain_matches_jax_at_the_widened_dtypes_and_shapes(layout, g, hd,
                                                            q_dtype,
                                                            kv_dtype):
    """The pairs and shapes the CUDA kernel gained: (bf16 q, f32 cache),
    head_dim 80, group size 7, against JAX's ref and interpret kernel."""
    b, kv, bs, n_blk = 3, 2, 8, 4
    S = bs * n_blk
    ring, window = LAYOUTS[layout](S)
    q, kp, vp, tab = _inputs(b, kv, g, hd, bs, n_blk, seed=g + hd)
    idx = np.asarray([0, S // 2 + 3, 3 * S + 5 if ring else S - 1], np.int32)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, kv_dtype))
              for a in (kp, vp))
    ours = paged_decode_attn_ref(tq, tk, tv, *_torch(tab, idx), ring=ring,
                                 window=window)
    assert ours.dtype == tq.dtype and ours.shape == (b, kv, g, hd)
    args = [jnp.asarray(q).astype(getattr(jnp, q_dtype)),
            jnp.asarray(kp).astype(getattr(jnp, kv_dtype)),
            jnp.asarray(vp).astype(getattr(jnp, kv_dtype)),
            jnp.asarray(tab), jnp.asarray(idx)]
    ref = jax_paged_ref(*args, ring=ring, window=window)
    kern = jax_paged_kernel(*args, ring=ring, window=window, interpret=True)
    for other in (ref, kern):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(other.astype(jnp.float32)),
                                   rtol=0, atol=TOL[q_dtype])


def test_shape_check_takes_every_dtype_pair_g_up_to_8_and_hd_by_16():
    """The wrappers raise only outside 1 <= g <= 8, hd a multiple of 16 up
    to 256, and float32/bfloat16."""
    for qd in (torch.float32, torch.bfloat16):
        for kd in (torch.float32, torch.bfloat16):
            for g in range(1, 9):
                for hd in range(16, 257, 16):
                    check_shapes(qd, kd, g, hd)
    for g, hd in ((0, 64), (9, 64), (4, 72), (4, 0), (4, 272)):
        with pytest.raises(ValueError, match="unsupported group size"):
            check_shapes(torch.float32, torch.float32, g, hd)
    with pytest.raises(TypeError, match="cache must be"):
        check_shapes(torch.float32, torch.float16, 4, 64)


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
    from test_torch_dryrun import other_device
    q, kp, vp, tab = _torch(*_inputs(2, 1, 4, 32, 8, 4, seed=2))
    idx = torch.tensor([3, 30], dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        paged_decode_attn(q.to("meta"), kp, vp, tab, idx)
    other = [other_device(t) for t in (q, kp, vp, tab, idx)]
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        paged_decode_attn(*other)


def test_ring_capacity_must_match_table():
    q, kp, vp, tab = _torch(*_inputs(2, 1, 4, 32, 8, 4, seed=3))
    idx = torch.tensor([3, 30], dtype=torch.int32)
    with pytest.raises(ValueError, match="ring capacity"):
        paged_decode_attn(q, kp, vp, tab, idx, ring=16)


@pytest.mark.parametrize("b,kv,n_blk,bs", [
    (4, 1, 32, 16), (4, 1, 64, 16), (1, 1, 64, 16), (8, 8, 5, 16),
    (64, 4, 3, 16), (4, 1, 64, 1), (1, 1, 4096, 16), (2, 1, 1000, 3)])
def test_split_plan_covers_the_table(b, kv, n_blk, bs):
    """Splits of whole 32-slot tiles that cover the table's slots with no
    empty split at the end, at most 16 of them (one thread block cluster),
    each within 1024 table entries; the serve run's shapes (b 4, ring 512
    and linear 1024) take 16 splits of 32 and 64 slots."""
    per, n_split = split_plan(b, kv, n_blk, bs)
    S = n_blk * bs
    assert per % 32 == 0 and 1 <= n_split <= 16
    assert per * n_split >= S > per * (n_split - 1)
    assert -(-per // bs) + 1 <= 1024
    if (b, kv, bs) == (4, 1, 16) and n_blk in (32, 64):
        assert (per, n_split) == (n_blk, 16)


def test_build_without_nvcc_raises(monkeypatch):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_build_digest_follows_the_headers(monkeypatch, tmp_path):
    """A library is named by its source and the headers beside it: an
    edited header gives a new name, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, header = csrc / "probe.cu", csrc / "probe_common.cuh"
    src.write_text('#include "probe_common.cuh"\n')
    header.write_text("constexpr int kStage = 32;\n")
    monkeypatch.setitem(build.SOURCES, "probe", src)
    first = build._target("probe")
    assert build._target("probe") == first
    header.write_text("constexpr int kStage = 64;\n")
    assert build._target("probe") != first
    for name in ("decode_attn", "paged_decode_attn"):
        text = build.SOURCES[name].read_text()
        assert '#include "decode_common.cuh"' in text
