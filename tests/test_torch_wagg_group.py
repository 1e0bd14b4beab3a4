"""The grouped fused aggregation: a tree's worker leaves in few launches.

What runs here is the host side of ``repro_torch.kernels.wagg``'s grouped
launch and the ``pallas_wagg`` schedule that feeds it: the launch plan
(``group_plan``, ``payload_batches``, ``pallas_wagg_plan``), a numpy walk
of the kernel's block-to-(leaf, chunk) map over the table the wrapper
builds, and the plain version leaf by leaf, held to JAX's
``aggregate_tree_wagg`` (Pallas in interpret mode) and to the ``einsum``
schedule. The CUDA kernel itself runs on the card only: ``chip_smoke.py``
holds every grouped leaf bitwise to a one-leaf call there.

Tolerances: against JAX, those of ``test_torch_wagg.py`` (float32 atol
1e-6; bfloat16 rtol 2^-7, one bf16 ulp). ``pallas_wagg`` against
``einsum`` on the same codec: atol 1e-6 (float32 sums in another order;
int8/int4 decode the same payload), bf16 within the codec's
``error_bound`` (einsum sums in bfloat16, the kernel in float32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.wagg import ops as jax_wagg_ops  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import backends as B  # noqa: E402
from repro_torch.core.codecs import get_codec  # noqa: E402
from repro_torch.kernels.wagg import ops as wagg_ops  # noqa: E402
from repro_torch.kernels.wagg import wagg as W  # noqa: E402
from repro_torch.kernels.wagg import (aggregate_tree_wagg,  # noqa: E402
                                      wagg_fused, wagg_fused_many,
                                      wagg_fused_ref)
from repro_torch.models import abstract_params  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

F32_ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
BETA = 0.9


def _tree(seed, p=4, dtype=np.float32):
    """Worker leaves of mixed sizes (ragged, a vector multiple, a scalar
    per worker), a nested dict and a shared leaf."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.normal(size=(p,) + shape).astype(np.float32)

    params = {"a": leaf(3, 5), "b": {"w": leaf(64), "v": leaf(1)},
              "c": leaf(2, 257), "shared": rng.normal(size=(6,)).astype(
                  np.float32)}
    axes = {"a": ("worker", None, None),
            "b": {"w": ("worker", None), "v": ("worker", None)},
            "c": ("worker", None, None), "shared": (None,)}
    return params, axes


def _port(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_leaves", [1, 7, W.MAX_LEAVES])
def test_group_plan_takes_every_leaf_once_in_order_split_by_dtype_pair(
        max_leaves):
    rng = np.random.default_rng(0)
    kinds = [("f32", "x"), ("bf16", "x"), ("f32", "int8")]
    keys = [kinds[i] for i in rng.integers(0, 3, size=200)]
    plan = W.group_plan(keys, max_leaves)
    assert sorted(i for g in plan for i in g) == list(range(200))
    for g in plan:
        assert 1 <= len(g) <= max_leaves
        assert len({keys[i] for i in g}) == 1
        assert g == sorted(g)
    # one key's leaves: consecutive runs, in order, all full but the last
    for k in kinds:
        runs = [g for g in plan if keys[g[0]] == k]
        assert [i for g in runs for i in g] == [
            i for i, kk in enumerate(keys) if kk == k]
        assert all(len(g) == max_leaves for g in runs[:-1])
    firsts = [keys[g[0]] for g in plan]
    assert [k for i, k in enumerate(firsts) if k not in firsts[:i]] == \
        sorted(set(keys), key=keys.index)


def test_payload_batches_stay_within_the_cap_in_the_flatten_order(
        monkeypatch):
    monkeypatch.setattr(B, "WAGG_PAYLOAD_CAP", 1000)
    sizes = [300, 500, 200, 10, 999, 1, 1500, 0, 700, 400]
    batches = B.payload_batches(sizes)
    assert [i for b in batches for i in b] == list(range(len(sizes)))
    cap = max(1000, max(sizes))
    assert all(sum(sizes[i] for i in b) <= cap for b in batches)
    # a batch closes only when the next leaf would pass the cap
    for b, nxt in zip(batches, batches[1:]):
        assert sum(sizes[i] for i in b) + sizes[nxt[0]] > cap
    assert B.payload_batches([0] * 500) == [list(range(500))]
    assert B.payload_batches([]) == []


@pytest.mark.parametrize("arch, leaves, f32_launches", [
    ("gemma3-1b", 236, 3), ("mamba2-370m", 434, 6), ("stablelm-3b", 291, 4)])
def test_plan_of_a_full_tree(arch, leaves, f32_launches):
    """A round's aggregate of the full-width tree (meta tensors): the f32
    payload in ceil(leaves / MAX_LEAVES) launches; int4 payloads in
    batches under the cap (at p 3), each launch at most MAX_LEAVES."""
    shapes, _ = abstract_params(get_config(arch))
    tree = [(x.numel() * 4, x.dtype) for x in tree_leaves(shapes)]
    assert len(tree) == leaves
    plan = B.pallas_wagg_plan(tree, "f32")
    assert len(plan) == f32_launches == -(-leaves // W.MAX_LEAVES)
    assert [i for g in plan for i in g] == list(range(leaves))
    p3 = [(n // 4 * 3, dt) for n, dt in tree]
    int4 = B.pallas_wagg_plan(p3, "int4")
    assert [i for g in int4 for i in g] == list(range(leaves))
    assert all(len(g) <= W.MAX_LEAVES for g in int4)
    cap = max(B.WAGG_PAYLOAD_CAP, max(n for n, _ in p3))
    for b in B.payload_batches([n for n, _ in p3]):
        assert sum(p3[i][0] for i in b) <= cap


def test_plan_splits_a_bf16_payload_of_f32_leaves_from_bf16_leaves():
    leaves = [(10, torch.float32), (10, torch.bfloat16), (10, torch.float32)]
    assert B.pallas_wagg_plan(leaves, "bf16") == [[0, 2], [1]]
    assert B.pallas_wagg_plan(leaves, "f32") == [[0, 2], [1]]
    assert B.pallas_wagg_plan(leaves, "int8") == [[0, 2], [1]]


# ---------------------------------------------------------------------------
# the kernel's block -> (leaf, chunk) map
# ---------------------------------------------------------------------------

def _kernel_leaf(begins, count, block):
    """The kernel's binary search: the last leaf starting at or before
    ``block``."""
    lo, hi = 0, count - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if begins[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _walk(ns, aligned, vec):
    """Columns each leaf's blocks touch, as the kernel computes them:
    one counter a column; and whether every vector load is aligned."""
    begins = W.chunk_begins(ns, vec)
    seen = [np.zeros(n, np.int64) for n in ns]
    tid = np.arange(W.THREADS)
    vectors_aligned = True
    for block in range(begins[-1]):
        leaf = _kernel_leaf(begins, len(ns), block)
        n = ns[leaf]
        base = (block - begins[leaf]) * W.THREADS * vec
        if aligned[leaf]:
            c0 = base + tid * vec
            full = c0 + vec <= n
            tail = ~full & (c0 < n)
            vectors_aligned &= bool((c0[full] % vec == 0).all())
            cols = [c0[full] + k for k in range(vec)]
            cols += [(c0[tail] + k)[c0[tail] + k < n] for k in range(vec)]
        else:
            c0 = base + (tid >> 5) * 32 * vec + (tid & 31)
            live = c0 < n
            cols = [(c0[live] + 32 * k)[c0[live] + 32 * k < n]
                    for k in range(vec)]
        for c in cols:
            np.add.at(seen[leaf], c, 1)
    return seen, vectors_aligned


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_kernel_map_covers_every_column_of_every_leaf_once(x_dtype):
    vec = W.columns_per_thread(x_dtype)
    ns = [1, 3, vec * 256, vec * 256 - 1, vec * 256 + 1, 1000, 4097,
          2 ** 16 + 5, 7 * vec]
    p = 3
    xs = [torch.zeros(p, n, dtype=x_dtype) for n in ns]
    aligned = [W.rows_aligned(p, n, vec, x) for n, x in zip(ns, xs)]
    assert aligned == [n % vec == 0 for n in ns]
    one_row = [W.rows_aligned(1, n, vec, torch.zeros(1, n, dtype=x_dtype))
               for n in ns]
    assert all(one_row)                     # one row: a scalar tail
    for flags in (aligned, one_row, [False] * len(ns)):
        seen, vec_ok = _walk(ns, flags, vec)
        assert vec_ok
        for n, s in zip(ns, seen):
            assert (s == 1).all(), (n, np.unique(s))


def test_chunk_begins_is_the_prefix_sum_of_chunks():
    assert W.chunk_begins([1, 1024, 1025, 4096], 4) == [0, 1, 2, 4, 8]
    assert W.chunk_begins([2048, 2049], 8) == [0, 1, 3]


# ---------------------------------------------------------------------------
# the plain version of the grouped call, the tree entry and the schedule
# ---------------------------------------------------------------------------

def test_many_leaves_on_the_cpu_equal_one_leaf_calls_with_the_scale_folded():
    rng = np.random.default_rng(3)
    p, ns = 3, [1, 100, 1001]
    xs = [torch.from_numpy(rng.normal(size=(p, n)).astype(np.float32))
          for n in ns]
    # reprolint: allow=DT001 -- int8 codes drawn in [-127, 127]
    codes = rng.integers(-127, 128, size=(p, 100)).astype(np.int8)
    qs = [None, torch.from_numpy(codes),
          torch.from_numpy(rng.normal(size=(p, 1001)).astype(np.float32))
          .to(torch.bfloat16)]
    scales = [None, torch.tensor(0.03), torch.tensor(0.5).to(torch.bfloat16)]
    theta = torch.tensor([0.2, 0.5, 0.3])
    act = torch.tensor([1.0, 0.0, 1.0])
    before = (wagg_fused.launches, wagg_fused.leaves)
    outs = wagg_fused_many(xs, theta, BETA, payloads=qs, scales=scales,
                           active=act)
    assert (wagg_fused.launches, wagg_fused.leaves) == before
    for x, q, s, out in zip(xs, qs, scales, outs):
        t = theta if s is None else theta * s.float()
        assert torch.equal(out, wagg_fused(x, t, BETA, payload=q,
                                           active=act))
        assert torch.equal(out, wagg_fused_ref(x, t, BETA, payload=q,
                                               active=act))


def test_many_leaves_refuse_what_the_grouped_call_does_not_take():
    from test_torch_dryrun import other_device
    x = torch.zeros(2, 4)
    theta = torch.tensor([0.5, 0.5])
    with pytest.raises(ValueError, match="2 leaves, 1 payloads"):
        wagg_fused_many([x, x], theta, BETA, payloads=[None])
    with pytest.raises(ValueError, match="several devices"):
        wagg_fused_many([x, x.to("meta")], theta, BETA)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        wagg_fused_many([other_device(x)], other_device(theta), BETA)
    assert wagg_fused_many([], theta, BETA) == []
    with pytest.raises(ValueError, match="one float32 or bfloat16"):
        W._check_scale(torch.zeros(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_tree_wagg_matches_jax(dtype):
    params, axes = _tree(1)
    theta = np.random.default_rng(2).dirichlet(np.ones(4)).astype(
        np.float32)
    tdt = getattr(torch, dtype)
    jax_params = tree_map(lambda a: jnp.asarray(a, dtype), params)
    ours = aggregate_tree_wagg(_port(params, tdt), axes,
                               torch.from_numpy(theta), BETA)
    ref = jax_wagg_ops.aggregate_tree_wagg(jax_params, axes,
                                           jnp.asarray(theta), BETA)
    for o, r in zip(tree_leaves(ours), tree_leaves(ref)):
        assert o.dtype == tdt
        r = np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                       atol=F32_ATOL)
        else:
            np.testing.assert_allclose(o.float().numpy(), r, rtol=BF16_RTOL,
                                       atol=1e-6)
    assert torch.equal(ours["shared"],
                       torch.from_numpy(params["shared"]).to(tdt))


def _run(spec, params, axes, theta, ctx, path):
    backend = B.get_backend(spec)
    if path == "aggregate":
        return backend.aggregate(params, axes, theta, BETA, ctx=ctx)
    if path == "overlap":
        out, extra = backend.aggregate(params, axes, theta, BETA, ctx=ctx,
                                       overlap=lambda: 7)
        assert extra == 7
        return out
    run = backend.phase_major(params, axes, theta, ctx=ctx)
    run.reduce(0)
    return run.finalize(BETA)


@pytest.mark.parametrize("path", ["aggregate", "phase_major", "overlap"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8", "int4"])
def test_pallas_wagg_matches_einsum(codec, masked, path):
    params, axes = _tree(4)
    tparams = _port(params)
    theta = torch.from_numpy(np.random.default_rng(5).dirichlet(
        np.ones(4)).astype(np.float32))
    act = torch.tensor([True, False, True, True]) if masked else None
    ctx = B.AggregationContext(active=act, key=9)
    ours = _run(f"pallas_wagg:{codec}", tparams, axes, theta, ctx, path)
    ref = _run(f"einsum:{codec}", tparams, axes, theta, ctx, "aggregate")
    for o, r, x in zip(tree_leaves(ours), tree_leaves(ref),
                       tree_leaves(tparams)):
        tol = (float(get_codec("bf16").error_bound(x, theta, BETA))
               if codec == "bf16" else F32_ATOL)
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=0, atol=tol)
    assert torch.equal(ours["shared"], tparams["shared"])


@pytest.mark.parametrize("codec", ["f32", "int8", "int4"])
def test_schedule_hands_the_kernel_payload_batches_in_the_flatten_order(
        codec, monkeypatch):
    """A small cap splits the tree: each grouped call gets one batch of
    ``payload_batches``, in the flatten order, and the result equals the
    leaf-by-leaf aggregate (the int4 draw keys on each leaf's position)."""
    monkeypatch.setattr(B, "WAGG_PAYLOAD_CAP", 600)
    params, axes = _tree(6)
    tparams = _port(params)
    theta = torch.tensor([0.1, 0.2, 0.3, 0.4])
    calls, real = [], wagg_ops.wagg_fused_many

    def spy(xs, *a, **kw):
        calls.append([tuple(x.shape) for x in xs])
        return real(xs, *a, **kw)

    monkeypatch.setattr(wagg_ops, "wagg_fused_many", spy)
    ctx = B.AggregationContext(key=3)
    ours = B.get_backend(f"pallas_wagg:{codec}").aggregate(
        tparams, axes, theta, BETA, ctx=ctx)
    worker = [x for x, ax in zip(tree_leaves(tparams), tree_leaves(axes))
              if ax[0] == "worker"]
    c = get_codec(codec)
    sizes = [B.payload_bytes(x.numel(), codec, c.wire_dtype) for x in worker]
    want = [[tuple(worker[i].reshape(4, -1).shape) for i in b]
            for b in B.payload_batches(sizes)]
    assert calls == want
    assert (len(calls) > 1) == (codec != "f32")
    # the leaf-by-leaf schedule, one leaf a call
    one = {}
    for i, (x, ax) in enumerate(zip(tree_leaves(tparams), tree_leaves(axes))):
        if ax[0] == "worker":
            lctx = B.AggregationContext(key=3, leaf_index=i)
            sched = B._PallasWaggSchedule()
            one[i] = sched.finalize(sched.prepare(x, theta, c, lctx), x,
                                    theta, BETA, c, lctx)
    for i, o in enumerate(tree_leaves(ours)):
        if i in one:
            assert torch.equal(o, one[i])
