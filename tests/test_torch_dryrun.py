"""The port's dry run (``repro_torch/launch/{specs,dryrun,report}.py``,
``models/param.py``'s abstract build, ``train/lm.py``'s abstract state)
held to the JAX package's on the CPU.

* Specs: for all ten archs x ``INPUT_SHAPES`` at full size, the port's
  ``input_specs`` argument trees match JAX's leaf for leaf in shape and
  dtype (token ids are int32 in both), and the axes trees are equal. The
  port keeps two leaves on the host, ``TrainState.step`` and the decode
  ``index``: JAX's 0-d int32 leaves there are ints here.
* JAX's two long-context policies (``test_specs_matrix.py``) on the port.
* Argument bytes: stablelm-1.6b (smoke) ``train`` on the (2, 2) mesh, the
  port's ``memory.argument_bytes`` against XLA's
  ``memory_analysis().argument_size_in_bytes`` compiled in a subprocess on
  8 forced host devices: they differ by the 4 bytes of ``TrainState.step``.
* ``run_one`` on the smoke configs of ``test_dryrun_small.py``'s cases and
  ``test_policy.py``'s stateful-policy and ``on_device`` cases.
* The worker axis's collective bytes counted by ``worker_collectives``
  against the bytes the port's own collectives move in one ``rs_ag:f32``
  and one ``shard_map:f32`` round, counted by wrapping
  ``torch.distributed``'s calls in a spawned gloo group of 2 ranks.
* The kernel wrappers' meta route, the command line and the report.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.specs import effective_config as j_effective_config  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, SHAPES_BY_NAME,  # noqa: E402
                                 InputShape, TrainConfig, WASGDConfig,
                                 get_config, get_smoke_config)
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.specs import effective_config, input_specs  # noqa: E402
from repro_torch.models import abstract_params, init_params  # noqa: E402
from repro_torch.models.param import (ParamBuilder, add_worker_axis,  # noqa: E402
                                      build_abstract, is_expert_path)
from repro_torch.parallel.sharding import (MeshShape, leaves_with_axes,  # noqa: E402
                                           map_with_axes)
from repro_torch.train.lm import abstract_lm_state  # noqa: E402
from test_torch_sharding import jax_workload  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bool_): torch.bool}
SMALL = {"train": InputShape("t", 32, 16, "train"),
         "prefill": InputShape("p", 32, 4, "prefill"),
         "decode": InputShape("d", 64, 4, "decode")}
SPAWN_LIMIT_S = 120


class OtherDevice(torch.Tensor):
    """A tensor that says it lies on ``xpu``: shape, dtype and device, no
    data (this machine has no such device)."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"no data on this device ({func})")


def other_device(t: torch.Tensor) -> torch.Tensor:
    return OtherDevice(tuple(t.shape), t.dtype)


def _port_leaves(shapes, axes):
    out = []
    map_with_axes(lambda s, a: out.append((s, a)), shapes, axes)
    return out


def test_input_shapes_are_jax_shapes():
    assert [tuple(vars(s).values()) for s in INPUT_SHAPES] == \
        [tuple(vars(s).values()) for s in J_SHAPES]
    assert set(SHAPES_BY_NAME) == {s.name for s in J_SHAPES}


@pytest.mark.parametrize("shape", INPUT_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch, shape):
    """Leaf for leaf: shape, dtype and axes of every argument, at full
    size and 16 workers; the port's host leaves where JAX has 0-d int32
    counters."""
    jwl = jax_workload(arch, shape.name)
    pwl = input_specs(get_config(arch), shape, 16,
                      TrainConfig(wasgd=WASGDConfig(tau=1)))
    assert pwl.meta == jwl.meta and pwl.rules == jwl.rules
    assert pwl.cfg.attn_window == jwl.cfg.attn_window
    assert len(pwl.arg_shapes) == len(jwl.arg_shapes) \
        == len(pwl.arg_axes) == len(jwl.arg_axes)
    host = []
    for js, ja, ps, pa in zip(jwl.arg_shapes, jwl.arg_axes, pwl.arg_shapes,
                              pwl.arg_axes):
        leaves, treedef = jax.tree.flatten(js)
        jpairs = list(zip(leaves, treedef.flatten_up_to(ja)))
        ppairs = _port_leaves(ps, pa)
        assert len(jpairs) == len(ppairs)
        for (jl, jax_axes), (pl, port_axes) in zip(jpairs, ppairs):
            assert tuple(port_axes) == tuple(jax_axes), (arch, shape.name)
            if isinstance(pl, int):
                assert jl.shape == () and jl.dtype == jnp.int32
                host.append(pl)
                continue
            assert pl.is_meta
            assert tuple(pl.shape) == tuple(jl.shape), (arch, jax_axes)
            assert pl.dtype == DTYPES[jnp.dtype(jl.dtype)], (arch, jax_axes)
    # TrainState.step; the decode index (a full cache)
    want = {"train": [0], "prefill": [], "decode": [shape.seq_len - 1]}
    assert host == want[shape.kind]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long500k_subquadratic_policy(arch):
    """Every arch is sub-quadratic at 500k decode, natively (SSM, hybrid,
    sliding window) or through the flagged override, as in JAX."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME["long_500k"]
    eff = effective_config(cfg, shape)
    jeff = j_effective_config(j_get_config(arch),
                              next(s for s in J_SHAPES
                                   if s.name == "long_500k"))
    assert (eff.attn_window, eff.global_attn_every) == \
        (jeff.attn_window, jeff.global_attn_every)
    native = cfg.ssm is not None or cfg.attn_window is not None
    if native:
        assert eff.attn_window == cfg.attn_window
    else:
        assert eff.attn_window == shape.window_override
        assert eff.global_attn_every == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_cache_bounded(arch):
    """No decode cache leaf is quadratic in context: at long_500k every
    layer's K/V buffer is the full cache for global layers or
    window-sized for sliding-window layers."""
    shape = SHAPES_BY_NAME["long_500k"]
    wl = input_specs(get_config(arch), shape, n_workers=16)
    cache = wl.arg_shapes[2]
    for lname, entry in cache.items():
        if "kv" in entry:
            assert entry["kv"].k.is_meta
            size = entry["kv"].k.shape[1]
            w = wl.cfg.window_for_layer(int(lname[1:]))
            if w is not None:
                assert size <= w, (arch, lname, size)
            else:
                assert size == shape.seq_len


def test_train_batch_divisible_all_archs():
    shape = SHAPES_BY_NAME["train_4k"]
    for arch in ARCH_IDS:
        wl = input_specs(get_config(arch), shape, 32,
                         TrainConfig(wasgd=WASGDConfig(tau=1)))
        assert wl.arg_shapes[1]["tokens"].shape[0] % 32 == 0


def test_param_builder_records_axes_and_builds_abstract():
    """The concrete build records the abstract build's axes and shapes;
    a leaf whose axes do not match its rank is refused; the abstract
    build allocates nothing."""
    cfg = get_smoke_config("olmoe-1b-7b")
    shapes, axes = abstract_params(cfg)
    b = ParamBuilder(torch.Generator().manual_seed(0), torch.float32,
                     torch.device("cpu"))
    from repro_torch.models.transformer import _init_model
    _init_model(b, cfg)
    real = init_params(cfg, 0, device="cpu")
    assert b.axes == axes
    for (s, a), (r, _) in zip(leaves_with_axes(shapes, axes),
                              leaves_with_axes(real, axes)):
        assert s.is_meta and s.shape == r.shape and s.dtype == r.dtype
    with pytest.raises(AssertionError):
        b.scope("x").param("w", (3, 4), ("embed",))
    sw, aw = add_worker_axis(shapes, axes, 4, skip=is_expert_path)
    for (s, a), (s0, a0) in zip(leaves_with_axes(sw, aw),
                                leaves_with_axes(shapes, axes)):
        if a0 and a0[0] == "experts":
            assert s is s0 and a == a0
        else:
            assert s.shape == (4,) + s0.shape and a == ("worker",) + a0
    # a leaf with data is broadcast as a view
    rw, _ = add_worker_axis({"w": torch.ones(2, 3)}, {"w": (None, None)}, 3)
    assert rw["w"].shape == (3, 2, 3) and rw["w"].stride(0) == 0
    ps, pa = build_abstract(lambda bb: bb.param("v", (5,), ("embed",),
                                                init="ones"))
    assert ps["v"].is_meta and pa == {"v": ("embed",)}


def test_abstract_lm_state_comm_states():
    """The comm state of each mode, as ``init_comm_state`` makes it: ()
    for a stateless policy, the policy state, the Alg. 4 mask, both."""
    cfg = get_smoke_config("stablelm-1.6b")
    cases = {("", "host_sim"): (), ("", "on_device"): ("worker",)}
    for (pol, mode), want in cases.items():
        tcfg = TrainConfig(wasgd=WASGDConfig(tau=2, policy=pol,
                                             async_mode=mode))
        st, ax, _ = abstract_lm_state(cfg, tcfg, 4)
        assert ax.comm_state == want
        assert ax.step == () and st.step == 0
    tcfg = TrainConfig(wasgd=WASGDConfig(tau=2, policy="ema(0.9)",
                                         async_mode="on_device"))
    st, ax, _ = abstract_lm_state(cfg, tcfg, 4)
    assert set(st.comm_state) == {"active", "policy"}
    assert st.comm_state["active"].shape == (4,)
    assert st.comm_state["active"].dtype == torch.bool
    tcfg = TrainConfig(optimizer="adamw", wasgd=WASGDConfig(tau=2))
    st, ax, opt = abstract_lm_state(cfg, tcfg, 4)
    assert opt.name == "adamw" and ax.opt_state.count == ()
    assert ax.opt_state.mu == ax.params


XLA_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.configs import TrainConfig, WASGDConfig, get_smoke_config
    from repro.configs.base import InputShape
    from repro.launch.specs import input_specs
    from repro.parallel.sharding import num_workers, tree_shardings

    cfg = get_smoke_config("stablelm-1.6b")
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    w = num_workers(mesh)
    wl = input_specs(cfg, InputShape("t", 32, 16, "train"), w,
                     TrainConfig(wasgd=WASGDConfig(tau=2)))
    in_sh = tuple(tree_shardings(mesh, s, a, wl.rules)
                  for s, a in zip(wl.arg_shapes, wl.arg_axes))
    with mesh:
        compiled = jax.jit(wl.fn, in_shardings=in_sh).lower(
            *wl.arg_shapes).compile()
    print("RESULT", json.dumps(
        {"args": compiled.memory_analysis().argument_size_in_bytes,
         "workers": w}))
""")


@pytest.fixture
def smoke_registry(monkeypatch):
    """``run_one`` on the registry's smoke configs."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)


def test_argument_bytes_match_xla(smoke_registry):
    """One card's argument bytes under the rule tables against XLA's. The
    port keeps ``TrainState.step`` on the host: XLA counts its 4 bytes
    (an int32 scalar on every device) and the port does not."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", XLA_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    xla = json.loads(line[len("RESULT "):])
    rec = dryrun.run_one("stablelm-1.6b", SMALL["train"], False,
                         TrainConfig(wasgd=WASGDConfig(tau=2)), verbose=False,
                         mesh=MeshShape({"data": 2, "model": 2}))
    assert rec["workers"] == xla["workers"] == 2
    step_bytes = 4
    assert xla["args"] - rec["memory"]["argument_bytes"] == step_bytes


# test_dryrun_small.py's five cases and its multi-pod case, and
# test_policy.py's stateful-policy and on-device cases
RUN_CASES = [
    ("stablelm-1.6b", "train", False, {}),
    ("olmoe-1b-7b", "train", False, {}),
    ("mamba2-370m", "train", False, {}),
    ("gemma3-1b", "decode", False, {}),
    ("yi-6b", "prefill", False, {}),
    ("stablelm-1.6b", "train", True, {}),
    ("stablelm-1.6b", "train", False, {"policy": "ema(0.9)|time_aware"}),
    ("stablelm-1.6b", "train", False, {"policy": "ema(0.9)",
                                       "async_mode": "on_device"}),
]


@pytest.mark.parametrize("arch, kind, multi, wkw", RUN_CASES,
                         ids=[f"{a}-{k}{'-multi' if m else ''}"
                              f"{'-' + '-'.join(w.values()) if w else ''}"
                              for a, k, m, w in RUN_CASES])
def test_run_one_on_smoke_configs(arch, kind, multi, wkw, smoke_registry):
    """Each case traces: ``ok``, the worker count of its mesh, FLOPs > 0.
    A train round's counted FLOPs lie within [0.5, 2] x ``model_flops``:
    6ND with N counting the embedding table (a gather, no FLOPs) and the
    recompute of ``remat`` (a second forward, 8ND) on either side of it,
    attention and the aggregate's products besides."""
    mesh = MeshShape({"pod": 2, "data": 2, "model": 2} if multi
                     else {"data": 2, "model": 2})
    tcfg = TrainConfig(wasgd=WASGDConfig(tau=2, **wkw))
    rec = dryrun.run_one(arch, SMALL[kind], False, tcfg, verbose=False,
                         mesh=mesh)
    assert rec["ok"] and rec["workers"] == (4 if multi else 2)
    assert rec["chips"] == (8 if multi else 4)
    assert rec["hlo_flops_per_chip"] > 0
    assert rec["port_memory"]["peak"] >= rec["port_memory"]["arguments"] > 0
    assert rec["collective_by_axis"]["model"] is None
    if kind == "train":
        ratio = rec["hlo_flops_per_chip"] * rec["chips"] / rec["model_flops"]
        assert 0.5 <= ratio <= 2.0, ratio
        assert rec["collective_bytes"]["total"] > 0
    else:
        assert rec["collective_bytes"]["total"] == 0


def _count_rank(rank, world, store, out_dir):
    """One rank of the 2-rank group: one round of each spec on olmoe's
    smoke config (one-copy experts), every ``torch.distributed`` call's
    input operand counted."""
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.train.lm import make_lm_loss
        from repro_torch.train.step import build_train_step
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        cfg = get_smoke_config("olmoe-1b-7b")
        kinds = {"all_reduce": ("all-reduce", 0),
                 "all_gather_into_tensor": ("all-gather", 1),
                 "reduce_scatter_tensor": ("reduce-scatter", 1)}
        out = {}
        for spec in ("rs_ag:f32", "shard_map:f32"):
            tcfg = TrainConfig(learning_rate=0.01, wasgd=WASGDConfig(
                tau=2, backend=spec))
            abs_state, axes, opt = abstract_lm_state(cfg, tcfg, 1)
            gen = torch.Generator().manual_seed(7)

            def real(x):
                if not isinstance(x, torch.Tensor):
                    return x
                if x.dtype == torch.bool:
                    return torch.ones(x.shape, dtype=torch.bool)
                return torch.randn(x.shape, generator=gen).to(x.dtype) * 0.02

            state = abs_state._replace(
                params=map_with_axes(lambda s, a: real(s), abs_state.params,
                                     axes.params),
                energy=torch.zeros(1))
            toks = torch.randint(0, cfg.vocab_size, (2 * 1 * 2, 17),
                                 generator=gen, dtype=torch.int32)
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "labels": toks[:, 1:].contiguous()}
            step = build_train_step(make_lm_loss(cfg), opt, axes.params,
                                    tcfg.wasgd, world, mesh=mesh)
            by_kind = {k: 0 for k in dryrun.COLLECTIVES}
            counts = {k: 0 for k in dryrun.COLLECTIVES}
            other = []
            saved = {n: getattr(dist, n) for n in
                     ("all_reduce", "all_gather_into_tensor",
                      "reduce_scatter_tensor", "all_gather", "broadcast",
                      "all_to_all_single", "reduce_scatter", "all_to_all",
                      "send", "recv", "isend", "irecv",
                      "batch_isend_irecv")}

            def wrap(name, fn):
                def counted(*args, **kwargs):
                    if name in kinds:
                        kind, i = kinds[name]
                        t = args[i]
                        by_kind[kind] += t.numel() * t.element_size()
                        counts[kind] += 1
                    else:
                        other.append(name)
                    return fn(*args, **kwargs)
                return counted

            for n, fn in saved.items():
                setattr(dist, n, wrap(n, fn))
            try:
                step(state, batch)
            finally:
                for n, fn in saved.items():
                    setattr(dist, n, fn)
            out[spec] = {"by_kind": by_kind, "counts": counts,
                         "other": other}
        with open(os.path.join(out_dir, f"count{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_worker_collective_bytes_match_the_counted_round(tmp_path):
    """``worker_collectives`` on a card's abstract state against the
    bytes one round's collectives move in each rank of a 2-rank gloo
    group: ``rs_ag:f32`` (reduce-scatter and all-gather a leaf) and
    ``shard_map:f32`` (an all-reduce a leaf), olmoe's one-copy experts'
    gradient all-reduced each local step, the energies' and losses'
    gathers."""
    world = 2
    ctx = mp.start_processes(
        _count_rank, args=(world, str(tmp_path / "store"), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo group over {SPAWN_LIMIT_S} s")
    cfg = get_smoke_config("olmoe-1b-7b")
    for r in range(world):
        with open(tmp_path / f"count{r}.json") as f:
            counted = json.load(f)
        for spec, got in counted.items():
            tcfg = TrainConfig(wasgd=WASGDConfig(tau=2, backend=spec))
            st, ax, _ = abstract_lm_state(cfg, tcfg, 1)
            want = dryrun.worker_collectives(tcfg.wasgd, st.params,
                                             ax.params, {"data": world})
            assert got["other"] == []
            assert got["by_kind"] == want["by_kind"], (spec, r)
            assert got["counts"] == want["counts"], (spec, r)
            assert want["per_step"] > 0              # the expert gradient
            kinds = {k for k, v in want["by_kind"].items() if v}
            assert kinds == ({"all-reduce", "all-gather", "reduce-scatter"}
                             if spec.startswith("rs_ag")
                             else {"all-reduce", "all-gather"})


def _meta(*ts):
    return [t.to("meta") for t in ts]


def _kernel_cases():
    """(name, wrapper, CPU inputs, keyword arguments) of every wrapper."""
    from repro_torch.kernels.decode_attn.decode_attn import decode_attn
    from repro_torch.kernels.decode_attn.paged import paged_decode_attn
    from repro_torch.kernels.fused_ce.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm.rmsnorm import (add_rmsnorm_fwd,
                                                     rmsnorm_fwd)
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk
    from repro_torch.kernels.wagg.wagg import wagg_fused
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    b, kv, grp, hd, S = 2, 2, 2, 32, 48
    table = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    return [
        ("wagg_fused", lambda *a: wagg_fused(*a[:2], 0.9, payload=a[2]),
         [r(3, 40), torch.softmax(r(3), 0), r(3, 40, dtype=torch.bfloat16)]),
        ("rmsnorm", lambda x, s: rmsnorm_fwd(x, s, 1e-6),
         [r(4, 8, 64, dtype=torch.bfloat16), r(64)]),
        ("add_rmsnorm", lambda x, d, s: add_rmsnorm_fwd(x, d, s, 1e-6),
         [r(4, 64), r(4, 64), r(64)]),
        ("fused_ce", fused_ce_fwd,
         [r(5, 7, 33), torch.randint(0, 33, (5, 7), generator=g,
                                     dtype=torch.int32)]),
        ("decode_attn", lambda q, k, v: decode_attn(q, k, v, 20),
         [r(b, kv, grp, hd), r(b, S, kv, hd), r(b, S, kv, hd)]),
        ("paged_decode_attn",
         lambda q, k, v, t, i: paged_decode_attn(q, k, v, t, i),
         [r(b, kv, grp, hd), r(7, 16, kv, hd), r(7, 16, kv, hd), table,
          torch.tensor([20, 33], dtype=torch.int32)]),
        ("ssd_chunk", ssd_chunk,
         [r(1, 2, 16, 2, 32), torch.rand(1, 2, 16, 2, generator=g),
          -torch.rand(2, generator=g), r(1, 2, 16, 8), r(1, 2, 16, 8)]),
    ]


@pytest.mark.parametrize("case", range(7), ids=[
    "wagg_fused", "rmsnorm", "add_rmsnorm", "fused_ce", "decode_attn",
    "paged_decode_attn", "ssd_chunk"])
def test_kernel_wrappers_take_meta_and_refuse_other_devices(case):
    """Meta tensors take the plain version, as CPU tensors do: the same
    shapes and dtypes, no data and no launch. A device other than cpu,
    meta or cuda still raises."""
    name, fn, inputs = _kernel_cases()[case]
    plain = fn(*inputs)
    on_meta = fn(*_meta(*inputs))
    plain = plain if isinstance(plain, tuple) else (plain,)
    on_meta = on_meta if isinstance(on_meta, tuple) else (on_meta,)
    assert len(plain) == len(on_meta)
    for p, m in zip(plain, on_meta):
        assert m.is_meta and m.shape == p.shape and m.dtype == p.dtype, name
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        fn(*(other_device(t) for t in inputs))


def test_dryrun_command_line_and_report(tmp_path, capsys, smoke_registry):
    """``main`` on a smoke config: prints each record as JSON, appends it
    to ``--out`` and returns 0; a combination that fails is a record with
    ``ok: false`` and makes it return 1. ``report`` renders the
    records."""
    out = tmp_path / "dry.jsonl"
    rc = dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                      "--out", str(out)])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rec = json.loads(lines[0])
    assert rec["ok"] and rec["shape"] == "decode_32k" \
        and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert json.loads(out.read_text().splitlines()[0]) == rec
    rc = dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                      "--out", str(out)])
    assert rc == 1
    bad = json.loads(out.read_text().splitlines()[1])
    assert not bad["ok"] and "no-such-arch" in bad["error"]
    report.main([str(out)])
    text = capsys.readouterr().out
    assert "## Dry-run matrix (1/2 OK)" in text
    assert "| gemma3-1b | decode_32k | 16x16 | OK |" in text
    assert "FAIL" in text
    with pytest.raises(SystemExit):
        dryrun.main(["--expert-sharding", "replicated"])


def test_hardware_model_and_axis_rates():
    """The H100 figures, and which axis crosses hosts: the worker axes
    ("pod", "data") of the production meshes (model minor, 8 cards a
    host) span hosts; a 16-way model axis spans two; a 1x8 mesh's data
    axis lies in one."""
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW,
            dryrun.NET_BW) == (989e12, 3.35e12, 450e9, 50e9)
    single = dryrun.production_mesh(False)
    assert single.size == 256 and dryrun.production_mesh(True).size == 512
    assert dryrun.axis_rate(single, ("pod", "data")) == dryrun.NET_BW
    assert dryrun.axis_rate(single, ("model",)) == dryrun.NET_BW
    assert dryrun.axis_rate(MeshShape({"data": 8}), ("data",)) \
        == dryrun.NVLINK_BW
    assert dryrun.axis_rate(MeshShape({"data": 2, "model": 4}),
                            ("data",)) == dryrun.NVLINK_BW
