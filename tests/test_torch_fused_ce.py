"""The port's fused cross-entropy (``repro_torch.kernels.fused_ce``)
against the JAX package's Pallas kernel (interpret mode) and its
``ref.py``, and its ``autograd.Function`` (backward, ``vmap`` rule) on the
CPU.

Inputs are made with numpy from a seed and fed to both packages. On the
CPU the wrapper runs the kernel's plain version; the CUDA kernel is held
to it on the card by ``chip_smoke.py``.

Tolerances: 1e-5 (float32 logits; logsumexp's sum in another order), 3e-2
for bfloat16 logits (JAX's own test's bound; both packages widen the same
bf16 values to float32, so the difference is summation order only) and
1e-4 for the random shapes with JAX's small blocks (as JAX's property
test).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_ce import fused_ce_ref as j_fused_ce_ref  # noqa: E402
from repro.kernels.fused_ce.fused_ce import fused_ce as j_fused_ce_pallas  # noqa: E402
from repro_torch.kernels.fused_ce import (FusedCEFunction, fused_ce,  # noqa: E402
                                          fused_ce_fwd, fused_ce_fwd_ref,
                                          fused_ce_ref)
from repro_torch.kernels.fused_ce.fused_ce import _check  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# the shape sweep of tests/test_kernels.py::test_fused_ce_sweep
SWEEP = [(16, 64, 8, 32), (100, 500, 32, 128), (256, 1000, 64, 256)]


def _inputs(t, v, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.normal(size=(t, v))).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v,br,bv", SWEEP)
def test_plain_ce_matches_jax_pallas_and_ref(t, v, br, bv, dtype):
    logits, labels = _inputs(t, v, t + v)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    ours = fused_ce_ref(tl, torch.from_numpy(labels))
    assert ours.dtype == torch.float32 and ours.shape == (t,)
    for ref in (j_fused_ce_pallas(jl, jnp.asarray(labels), block_rows=br,
                                  block_v=bv, interpret=True),
                j_fused_ce_ref(jl, jnp.asarray(labels))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("seed", range(6))
def test_plain_ce_matches_jax_pallas_on_random_shapes(seed):
    """JAX's property test's ranges (t in 1..60, v in 2..300), ragged
    against its 16 x 64 blocks."""
    rng = np.random.default_rng(100 + seed)
    t, v = int(rng.integers(1, 61)), int(rng.integers(2, 301))
    logits, labels = _inputs(t, v, seed, scale=3.0)
    ref = j_fused_ce_pallas(jnp.asarray(logits), jnp.asarray(labels),
                            block_rows=16, block_v=64, interpret=True)
    ours = fused_ce_ref(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_label_outside_the_vocab_gives_the_lse():
    """No vocab tile of the Pallas kernel owns a negative label or one past
    its last tile, and there it agrees with the port (a label inside the
    last tile's padding, here 300..319, picks the padding's -1e30 in the
    Pallas kernel; the port gives the lse for every label outside
    [0, V))."""
    logits, labels = _inputs(5, 300, 9)
    labels[1], labels[3] = -1, 400
    ours, lse = fused_ce_fwd_ref(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    pallas = np.asarray(j_fused_ce_pallas(
        jnp.asarray(logits), jnp.asarray(labels), block_rows=8, block_v=64,
        interpret=True))
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=1e-5, atol=1e-5)
    assert torch.equal(ours[[1, 3]], lse[[1, 3]])


def test_cpu_wrapper_and_op_are_the_plain_version():
    logits, labels = _inputs(33, 257, 10)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    before = fused_ce_fwd.launches
    nll, lse = fused_ce_fwd(tl, ty)
    assert torch.equal(nll, fused_ce_ref(tl, ty))
    assert torch.equal(fused_ce(tl, ty.long()), nll)
    assert torch.equal(lse, torch.logsumexp(tl, -1))
    nll3, _ = fused_ce_fwd(tl.reshape(3, 11, 257), ty.reshape(3, 11))
    assert torch.equal(nll3.reshape(-1), nll)
    assert fused_ce_fwd.launches == before


def test_backward_passes_gradcheck_in_float64():
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.normal(size=(2, 4, 13))).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 13, size=(2, 4)))
    labels[0, 1] = 13                         # outside: no one-hot entry
    assert torch.autograd.gradcheck(
        lambda a: FusedCEFunction.apply(a, labels)[0], (logits,))


def test_backward_matches_jax_autodiff():
    """The hand-written backward against ``jax.vjp`` of JAX's ref, on the
    same logits, labels and cotangent."""
    logits, labels = _inputs(40, 700, 12)
    g = np.random.default_rng(13).normal(size=40).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_fused_ce_ref(a, jnp.asarray(labels)),
                     jnp.asarray(logits))
    (ref,) = vjp(jnp.asarray(g))
    tl = torch.from_numpy(logits).requires_grad_()
    fused_ce(tl, torch.from_numpy(labels)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("labels_mapped", [True, False])
def test_vmap_rule_matches_a_loop_over_workers(labels_mapped):
    """``vmap(grad)`` over W workers ((W, T, V) logits become W * T rows
    of one launch) equals a Python loop of per-worker ``grad``s."""
    W, T, V = 4, 9, 50
    rng = np.random.default_rng(14)
    h = torch.from_numpy(rng.normal(size=(W, T, 8)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(V, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, V, size=(W, T)))
    if not labels_mapped:
        y = y[0]

    def loss(hi, yi):
        return fused_ce(hi @ emb.T, yi).mean()

    grad = torch.func.grad_and_value(loss)
    gh, val = torch.func.vmap(grad, in_dims=(0, 0 if labels_mapped
                                             else None))(h, y)
    for i in range(W):
        lh, lv = grad(h[i], y[i] if labels_mapped else y)
        torch.testing.assert_close(gh[i], lh, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(val[i], lv, rtol=1e-6, atol=0)


def test_wrapper_checks_and_devices():
    from test_torch_dryrun import other_device
    with pytest.raises(TypeError, match="float32"):
        _check(torch.zeros(3, 5, dtype=torch.bfloat16),
               torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        _check(torch.zeros(3, 5), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 or int64"):
        _check(torch.zeros(3, 5), torch.zeros(3))
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        fused_ce_fwd(other_device(torch.zeros(3, 5)),
                     other_device(torch.zeros(3, dtype=torch.int32)))
    with pytest.raises(ValueError, match="labels on"):
        fused_ce_fwd(torch.zeros(3, 5),
                     torch.zeros(3, dtype=torch.int32, device="meta"))
