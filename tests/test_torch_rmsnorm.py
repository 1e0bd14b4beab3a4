"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``) against the JAX
package's Pallas kernel (interpret mode) and its ``ref.py``, and its
``autograd.Function`` (backward, ``vmap`` rule) on the CPU.

Inputs are made with numpy from a seed and fed to both packages (bf16
inputs are the float32 arrays rounded to bf16 by each package, which round
the same way). On the CPU the wrapper runs the kernel's plain version; the
CUDA kernel is held to it on the card by ``chip_smoke.py``.

The fused op (``add_rmsnorm``: the residual add ``s = x + delta`` and the
norm of ``s`` in one launch) is held to JAX's ``x + delta`` followed by the
Pallas kernel: ``s`` bitwise in float32 and bfloat16 (both packages round
the float32 sum to nearest even), ``y`` at the tolerances below.

Tolerances: float32 1e-5 (the packages differ in the order of the mean's
sum); bfloat16 3e-2, JAX's own test's bound (one bf16 ulp of outputs of
magnitude up to 4 is 2^-6; an f32 difference in the last bit can flip a
rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm_ref as j_rmsnorm_ref  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm import rmsnorm as j_rmsnorm_pallas  # noqa: E402
from repro_torch.kernels.rmsnorm import (AddRMSNormFunction,  # noqa: E402
                                         RMSNormFunction, add_rmsnorm,
                                         add_rmsnorm_fwd, add_rmsnorm_fwd_ref,
                                         add_rmsnorm_ref, rmsnorm,
                                         rmsnorm_fwd, rmsnorm_fwd_ref,
                                         rmsnorm_ref)
from repro_torch.kernels.rmsnorm.rmsnorm import _check, vector_width  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# the shape sweep of tests/test_kernels.py::test_rmsnorm_sweep
SHAPES = [((8, 64), 4), ((3, 5, 128), 8), ((1000, 96), 256)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=shape[-1]).astype(np.float32)
    return x, s


def _pair(x, dtype):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,br", SHAPES)
def test_plain_rmsnorm_matches_jax_pallas_and_ref(shape, br, dtype):
    x, s = _inputs(shape, shape[-1])
    jx, tx = _pair(x, dtype)
    ours = rmsnorm_ref(tx, torch.from_numpy(s))
    assert ours.dtype == tx.dtype and ours.shape == tx.shape
    for ref in (j_rmsnorm_pallas(jx, jnp.asarray(s), block_rows=br,
                                 interpret=True),
                j_rmsnorm_ref(jx, jnp.asarray(s))):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,br", SHAPES)
def test_cpu_wrapper_and_op_are_the_plain_version(shape, br, dtype):
    """On a CPU tensor the wrapper, the op and the Function run the plain
    version: bitwise equal, and no launch is counted."""
    x, s = _inputs(shape, 7)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts = torch.from_numpy(s)
    before = rmsnorm_fwd.launches
    y, rstd = rmsnorm_fwd(tx, ts, 1e-6)
    ref = rmsnorm_ref(tx, ts, 1e-6)
    assert torch.equal(y, ref) and torch.equal(rmsnorm(tx, ts), ref)
    assert rstd.dtype == torch.float32 and rstd.shape == tx.shape[:-1]
    xf = tx.float()
    torch.testing.assert_close(
        rstd, torch.rsqrt(xf.square().mean(-1) + 1e-6), rtol=0, atol=0)
    assert rmsnorm_fwd.launches == before


def test_grouped_scale_is_a_loop_over_groups():
    """A (G, d) scale with x (G, ..., d): group g's rows take scale[g]."""
    x, _ = _inputs((4, 3, 5, 64), 1)
    s = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    y, rstd = rmsnorm_fwd_ref(tx, ts)
    for g in range(4):
        yg, rg = rmsnorm_fwd_ref(tx[g], ts[g])
        assert torch.equal(y[g], yg) and torch.equal(rstd[g], rg)


@pytest.mark.parametrize("grouped", [False, True])
def test_backward_passes_gradcheck_in_float64(grouped):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 4, 9))).requires_grad_()
    shape = (3, 9) if grouped else (9,)
    s = torch.from_numpy(rng.normal(size=shape)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: RMSNormFunction.apply(a, b, 1e-6)[0], (x, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_autodiff(dtype):
    """The hand-written backward against ``jax.grad`` of JAX's ref, on the
    same inputs and output cotangent."""
    x, s = _inputs((6, 5, 48), 4)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    _, vjp = jax.vjp(lambda a, b: j_rmsnorm_ref(a, b), jx, jnp.asarray(s))
    jdx, jds = vjp(jg)
    tx.requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    rmsnorm(tx, ts).backward(tg)
    tol = TOL[dtype]
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jdx, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds),
                               rtol=tol, atol=tol * np.abs(jds).max())


@pytest.mark.parametrize("scale_mapped", [True, False])
def test_vmap_rule_matches_a_loop_over_workers(scale_mapped):
    """``vmap(grad)`` over W workers with per-worker scales (one launch
    for all workers, G = W) equals a Python loop of per-worker ``grad``s;
    with one shared scale it is G = 1."""
    W = 4
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(W, 2, 7, 32)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(W, 32)).astype(np.float32))
    if not scale_mapped:
        s = s[0]
    w = torch.from_numpy(rng.normal(size=(2, 7, 32)).astype(np.float32))

    def loss(xi, si):
        return (rmsnorm(xi, si) * w).square().sum()

    grad = torch.func.grad_and_value(loss, argnums=(0, 1))
    (gx, gs), val = torch.func.vmap(
        grad, in_dims=(0, 0 if scale_mapped else None))(x, s)
    for i in range(W):
        (lx, ls), lv = grad(x[i], s[i] if scale_mapped else s)
        torch.testing.assert_close(gx[i], lx, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            gs[i], ls, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(val[i], lv, rtol=1e-6, atol=0)


def test_vmap_rule_with_an_unmapped_x_and_nested_vmap():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    out = torch.func.vmap(rmsnorm, in_dims=(None, 0))(x, s)
    for i in range(3):
        assert torch.equal(out[i], rmsnorm_ref(x, s[i]))
    x2 = torch.from_numpy(rng.normal(size=(2, 3, 5, 16)).astype(np.float32))
    s2 = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    out = torch.func.vmap(torch.func.vmap(rmsnorm))(x2, s2)
    for i in range(2):
        for j in range(3):
            assert torch.equal(out[i, j], rmsnorm_ref(x2[i, j], s2[i, j]))


def test_wrapper_checks_and_devices():
    from test_torch_dryrun import other_device
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="does not match"):
        _check(x, torch.zeros(7))
    with pytest.raises(ValueError, match="needs x"):
        _check(x, torch.zeros(3, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check(x.half(), torch.zeros(8))
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        rmsnorm_fwd(other_device(x), other_device(torch.zeros(8)))
    with pytest.raises(ValueError, match="scale on"):
        rmsnorm_fwd(x, torch.zeros(8, device="meta"))
    assert vector_width(64, x) == 4
    assert vector_width(64, x.bfloat16()) == 8
    assert vector_width(1001, torch.zeros(2, 1001)) == 1
    assert vector_width(64, torch.zeros(65)[1:]) == 1


# -- the fused residual add -----------------------------------------------------

def _add_inputs(shape, seed):
    x, s = _inputs(shape, seed)
    delta = np.random.default_rng(seed + 1).normal(size=shape).astype(
        np.float32)
    return x, delta, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,br", SHAPES)
def test_fused_plain_matches_jax_add_then_pallas(shape, br, dtype):
    """``add_rmsnorm_ref`` against JAX's ``x + delta`` and the Pallas
    kernel in interpret mode: s equal, y within the file's tolerance."""
    x, delta, s = _add_inputs(shape, 2 * shape[-1])
    (jx, tx), (jd, td) = _pair(x, dtype), _pair(delta, dtype)
    ts, y = add_rmsnorm_ref(tx, td, torch.from_numpy(s))
    assert ts.dtype == tx.dtype and y.dtype == tx.dtype
    js = jx + jd
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    ref = j_rmsnorm_pallas(js, jnp.asarray(s), block_rows=br, interpret=True)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grouped", [False, True])
def test_fused_cpu_wrapper_and_op_are_the_plain_version(grouped, dtype):
    """On CPU tensors the fused wrapper, its Function and the op run the
    plain version (torch's add, then the norm): bitwise, no launch."""
    x, delta, _ = _add_inputs((4, 3, 64), 9)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    td = torch.from_numpy(delta).to(getattr(torch, dtype))
    rng = np.random.default_rng(10)
    ts = torch.from_numpy(rng.normal(size=(4, 64) if grouped else (64,))
                          .astype(np.float32))
    before = rmsnorm_fwd.launches
    s, y, rstd = add_rmsnorm_fwd(tx, td, ts)
    y_ref, rstd_ref = rmsnorm_fwd_ref(tx + td, ts)
    assert torch.equal(s, tx + td) and torch.equal(y, y_ref)
    assert torch.equal(rstd, rstd_ref)
    for out in (add_rmsnorm_fwd_ref(tx, td, ts),
                AddRMSNormFunction.apply(tx, td, ts, 1e-6)):
        assert all(torch.equal(a, b) for a, b in zip(out, (s, y, rstd)))
    if not grouped:
        s2, y2 = add_rmsnorm(tx, td, ts)
        assert torch.equal(s2, s) and torch.equal(y2, y)
        assert rmsnorm.fused_add is add_rmsnorm
    assert rmsnorm_fwd.launches == before


@pytest.mark.parametrize("grouped", [False, True])
def test_fused_backward_passes_gradcheck_in_float64(grouped):
    """Both outputs' cotangents: s's reaches x and delta directly, y's
    through the norm."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(3, 4, 9))).requires_grad_()
    d = torch.from_numpy(rng.normal(size=(3, 4, 9))).requires_grad_()
    s = torch.from_numpy(rng.normal(size=(3, 9) if grouped else (9,))
                         ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b, c: AddRMSNormFunction.apply(a, b, c, 1e-6)[:2],
        (x, d, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_backward_matches_autograd_of_the_add_and_norm(dtype):
    """The Function's gradients against autograd through torch's add and
    the plain norm, for cotangents on both s and y."""
    x, delta, s = _add_inputs((6, 5, 48), 12)
    rng = np.random.default_rng(13)
    gs, gy = (torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
              .to(getattr(torch, dtype)) for _ in range(2))
    grads = []
    for fn in (add_rmsnorm, add_rmsnorm_ref):
        tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
        td = torch.from_numpy(delta).to(getattr(torch, dtype)
                                        ).requires_grad_()
        ts = torch.from_numpy(s).requires_grad_()
        out_s, out_y = fn(tx, td, ts)
        torch.autograd.backward((out_s, out_y), (gs, gy))
        grads.append((tx.grad, td.grad, ts.grad))
    tol = TOL[dtype]
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * float(b.abs().max()))


@pytest.mark.parametrize("scale_mapped", [True, False])
def test_fused_vmap_rule_matches_a_loop_over_workers(scale_mapped):
    """``vmap(grad)`` of the fused op over W workers (one launch for all
    workers) equals a loop of per-worker ``grad``s, with per-worker or
    shared scales, and with an unmapped delta."""
    W = 4
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(W, 2, 7, 32)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(W, 2, 7, 32)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(W, 32)).astype(np.float32))
    if not scale_mapped:
        s = s[0]
    w = torch.from_numpy(rng.normal(size=(2, 7, 32)).astype(np.float32))

    def loss(xi, di, si):
        out_s, y = add_rmsnorm(xi, di, si)
        return (y * w).square().sum() + (out_s * w).sum()

    grad = torch.func.grad_and_value(loss, argnums=(0, 1, 2))
    s_dim = 0 if scale_mapped else None
    (gx, gd, gs), val = torch.func.vmap(grad, in_dims=(0, 0, s_dim))(x, d, s)
    for i in range(W):
        (lx, ld, ls), lv = grad(x[i], d[i], s[i] if scale_mapped else s)
        torch.testing.assert_close(gx[i], lx, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gd[i], ld, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gs[i], ls, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(val[i], lv, rtol=1e-6, atol=0)
    out = torch.func.vmap(add_rmsnorm, in_dims=(0, None, s_dim))(x, d[0], s)
    for i in range(W):
        ref = add_rmsnorm_ref(x[i], d[0], s[i] if scale_mapped else s)
        assert torch.equal(out[0][i], ref[0])
        torch.testing.assert_close(out[1][i], ref[1], rtol=1e-6, atol=1e-6)


def test_fused_wrapper_checks_and_devices():
    from test_torch_dryrun import other_device
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="must match x"):
        _check(x, torch.zeros(8), torch.zeros(4, 7))
    with pytest.raises(ValueError, match="must match x"):
        _check(x, torch.zeros(8), x.bfloat16())
    with pytest.raises(ValueError, match="delta on"):
        add_rmsnorm_fwd(x, x.to("meta"), torch.zeros(8))
    other = other_device(x)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        add_rmsnorm_fwd(other, other, other_device(torch.zeros(8)))
