"""One-copy (``ep_data``) experts, a ``model`` axis and any rank order
under a mesh (``Trainer(mesh=)``, ``core/shardmap_agg``,
``launch.make_host_mesh(data, model)``), on olmoe-1b-7b's smoke config
(float32 compute), whose expert leaves have no worker axis.

* One rank (a gloo group in the test process) against JAX's Trainer on a
  one-device ``make_host_mesh(1, 1)``, both from JAX's initial params:
  every round's h, loss and params within ``tests/test_torch_moe.py``'s
  Trainer tolerances (h and loss rtol 1e-5, theta atol 1e-6, params atol
  1e-5).
* Spawned gloo groups of 4 and then 2 ranks (each spawned once), w 8 and
  4, against the port's meshless run in each rank: ``wasgd+`` through
  ``rs_ag:f32``, ``spsgd``, a membership schedule w -> w/2, and a sharded
  save resumed under the group and without a mesh (the 2 ranks resume
  the 4 ranks' checkpoint too). Float32 params within 1e-5 of the leaf's
  largest value: the experts' gradient is each rank's sum, all-reduced,
  where the meshless round sums every worker at once, and that rounding
  difference passes through the routing and two rounds (measured at most
  3.6e-7 on these runs); resumes bitwise. The expert leaves, h and theta
  are the same bits on every rank.
* In the 4 ranks: a ``(data 2, model 2)`` mesh from ``make_host_mesh(2,
  2)``, bitwise the 2 ranks' ``(data 2)`` mesh replica by replica, of
  which only the ranks at ``model`` 0 write checkpoint files, and a
  ``(pod 1, data 2, model 2)`` mesh, bitwise the same; a
  ``("pod", "data")`` mesh over a permutation of the 4 ranks, and two
  ``("pod", "data")`` meshes over two halves of the ranks (one of them
  permuted), each within 1e-5 of the meshless round, its checkpoint the
  meshless state bitwise.

The ranks import no JAX.
"""
import dataclasses
import functools
import hashlib
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.checkpoint import io as ckio  # noqa: E402
from repro_torch.checkpoint.io import _flatten  # noqa: E402
from repro_torch.configs import (TrainConfig, WASGDConfig,  # noqa: E402
                                 get_smoke_config)
from repro_torch.core import is_worker_leaf  # noqa: E402
from repro_torch.core import shardmap_agg as smagg  # noqa: E402
from repro_torch.core.membership import MembershipSchedule  # noqa: E402
from repro_torch.data import OrderedDataset, make_tokens  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import init_params, param_axes  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_mesh_elastic import (_bitwise, _full_state,  # noqa: E402
                                     _max_rel, _put)

TAU, B_LOCAL, SEQ, ROUNDS, LR = 2, 2, 16, 2, 0.03
WORKERS = {4: 8, 2: 4}            # w of each group size
TOL = 1e-5
SPAWN_LIMIT_S = 120


def _cfg():
    return dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                               compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _data():
    toks = make_tokens(3, 128, SEQ, _cfg().vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _trainer(mesh, p, rule="wasgd+"):
    """olmoe-smoke (init seed 6) with momentum SGD, so that the optimizer
    state holds an expert copy too; ``rs_ag:f32`` under a mesh,
    ``einsum:f32`` without."""
    cfg = _cfg()
    params = init_params(cfg, 6, device="cpu")
    tcfg = TrainConfig(learning_rate=LR, optimizer="momentum",
                       wasgd=WASGDConfig(tau=TAU, backend=(
                           "rs_ag:f32" if mesh is not None
                           else "einsum:f32")))
    return Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg, p,
                   rule=rule, device="cpu", mesh=mesh)


def _dataset(p):
    return OrderedDataset(_data(), p, TAU, B_LOCAL, n_segments=2)


def _run(mesh, p, rule="wasgd+", **kw):
    tr = _trainer(mesh, p, rule)
    tr.run(_dataset(p), ROUNDS, **kw)
    return tr


def _worker_marks(tr):
    """Flat params key -> whether the leaf has the worker axis."""
    return _flatten(tree_map(is_worker_leaf, tr.axes))


def _params_of(tr, mesh):
    """Every worker's rows of the params (the experts as they are)."""
    marks = _worker_marks(tr)
    return {k: smagg.gather_rows(v, mesh) if marks[k] else v
            for k, v in _flatten(tr.state.params).items()}


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()


def _history(tr):
    return {k: [np.asarray(h[k]).tolist() for h in tr.history]
            for k in ("h", "theta", "loss")}


# ---------------------------------------------------------------------------
# The ranks' cases (no JAX here)
# ---------------------------------------------------------------------------

def _hold_meshless(name, tr, ref, mesh, out):
    """``tr`` (under ``mesh``) within TOL of the meshless ``ref``: params
    relative to each leaf's largest value, h and loss relative, theta
    absolute; its expert leaves, h and theta go to the cross-rank
    comparison."""
    got = _params_of(tr, mesh)
    want = _flatten(ref.state.params)
    errs = {k: _max_rel(got[k], v) for k, v in want.items()}
    first = all(np.allclose(a[k], b[k], rtol=TOL, atol=0)
                for a, b in zip(tr.history, ref.history)
                for k in ("h", "loss")) and all(
        np.abs(a["theta"] - b["theta"]).max() <= TOL
        for a, b in zip(tr.history, ref.history))
    ps = [h.get("p") for h in tr.history] == [h.get("p")
                                              for h in ref.history]
    _put(out, name, max(errs.values()) <= TOL and first and ps,
         [max(errs.values()), first, ps])
    flat = _flatten(tr.state)
    out["same"][f"{name}/experts"] = {
        k: _digest(v) for k, v in flat.items()
        if k not in tr._row_keys() and isinstance(v, torch.Tensor)}
    out["same"][f"{name}/history"] = _history(tr)
    return max(errs.values())


def _group_checks(mesh, p, out, out_dir, ck_in):
    """The rules, a resize, and a save/resume under ``mesh`` (its worker
    axis ``data`` over every rank) against the meshless port."""
    errs = {}
    for rule in ("wasgd+", "spsgd"):
        tr, ref = _run(mesh, p, rule), _run(None, p, rule)
        errs[rule] = _hold_meshless(f"rule/{rule}", tr, ref, mesh, out)
        if rule == "wasgd+":
            out["expert_keys"] = sorted(
                k for k, w in _worker_marks(tr).items() if not w)
            _save_local(tr, out_dir, f"data{smagg.mesh_worker_shards(mesh)}")
    sched = MembershipSchedule(p, {1: p // 2})
    tr = _run(mesh, p, membership_schedule=sched)
    ref = _run(None, p, membership_schedule=sched)
    errs["resize"] = _hold_meshless(f"resize/{p}->{p // 2}", tr, ref, mesh,
                                    out)
    out["errs"] = errs
    # save every round; the round-1 checkpoint resumed under the group is
    # the straight run bitwise, and the round-2 one without a mesh is the
    # gathered state bitwise
    s = smagg.mesh_worker_shards(mesh)
    ck = os.path.join(out_dir, f"ck{s}")
    tr = _run(mesh, p, checkpoint_every=1, checkpoint_path=ck)
    again = _trainer(mesh, p)
    again.run(_dataset(p), ROUNDS, resume_from=os.path.join(ck, "round_1"))
    bad = _bitwise(_flatten(again.state), _flatten(tr.state))
    plain = _trainer(None, p)
    assert plain.resume(os.path.join(ck, f"round_{ROUNDS}")) == ROUNDS
    bad_plain = _bitwise(_flatten(plain.state), _full_state(tr, mesh))
    _put(out, "save/resumed", not bad and not bad_plain, [bad, bad_plain])
    if ck_in is not None:
        # the 4 ranks' checkpoint (w 8) under these ranks, at w 8
        tr = _trainer(mesh, 8)
        plain = _trainer(None, 8)
        assert tr.resume(ck_in) == plain.resume(ck_in) == ROUNDS
        bad = _bitwise(_full_state(tr, mesh), _flatten(plain.state))
        _put(out, "save/4_ranks_resumed", not bad, bad)


def _save_local(tr, out_dir, name):
    """This rank's params and history, for the parent's bitwise
    comparison of two meshes."""
    rank = dist.get_rank()
    np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"),
             **{k: v.numpy() for k, v in _flatten(tr.state.params).items()})
    with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(_history(tr), f)


def _written_by(fn):
    """``fn()`` and the files this rank's checkpoint writer wrote."""
    written = []
    orig = ckio._write_npz

    def spy(file, flat):
        written.append(os.path.basename(file))
        return orig(file, flat)

    ckio._write_npz = spy
    try:
        fn()
    finally:
        ckio._write_npz = orig
    return written


def _model_axis_checks(out, out_dir):
    """The (data 2, model 2) mesh: this rank's run, to be compared with
    the 2 ranks' (data 2) run, and the checkpoint files it wrote."""
    mesh = make_host_mesh(2, 2)
    p = WORKERS[2]
    ck = os.path.join(out_dir, "ck_dm")
    holder = {}
    written = _written_by(lambda: holder.setdefault(
        "tr", _run(mesh, p, checkpoint_every=ROUNDS, checkpoint_path=ck)))
    tr = holder["tr"]
    _save_local(tr, out_dir, "data2_model2")
    out["model_axis"] = {"replica": smagg.replica_index(mesh),
                         "shard": smagg.shard_index(mesh),
                         "written": sorted(written)}
    plain = _trainer(None, p)
    assert plain.resume(os.path.join(ck, f"round_{ROUNDS}")) == ROUNDS
    bad = _bitwise(_flatten(plain.state.params), _params_of(tr, mesh))
    _put(out, "model_axis/checkpoint", not bad, bad)


def _pod_data_checks(mesh, name, out, out_dir):
    """``wasgd+`` under a ("pod", "data") mesh against the meshless round,
    and its checkpoint read back without a mesh."""
    p = 2 * smagg.mesh_worker_shards(mesh)
    ck = os.path.join(out_dir, f"ck_{name}")
    tr = _run(mesh, p, checkpoint_every=ROUNDS, checkpoint_path=ck)
    ref = _run(None, p)
    _hold_meshless(name, tr, ref, mesh, out)
    plain = _trainer(None, p)
    assert plain.resume(os.path.join(ck, f"round_{ROUNDS}")) == ROUNDS
    bad = _bitwise(_flatten(plain.state), _full_state(tr, mesh))
    _put(out, f"{name}/checkpoint", not bad, bad)


def _layout_checks(out, out_dir):
    """A ("pod", "data") mesh over a permutation of the 4 ranks, then two
    over two halves of them; every rank makes every mesh and its groups,
    in one order."""
    from torch.distributed.device_mesh import DeviceMesh
    dims = ("pod", "data")
    perm = DeviceMesh("cpu", torch.tensor([[2, 0], [3, 1]]),
                      mesh_dim_names=dims)
    me = dist.get_rank()
    out["same"]["permuted/shards"] = [2, 0, 3, 1]
    _put(out, "permuted/shard_index",
         smagg.shard_index(perm) == [2, 0, 3, 1].index(me),
         smagg.shard_index(perm))
    _pod_data_checks(perm, "permuted", out, out_dir)
    # (pod 1, data 2, model 2): the worker groups of the (data 2, model 2)
    # mesh, made by new_group; its runs go to the parent's comparison
    pdm = DeviceMesh("cpu", torch.tensor([[[0, 1], [2, 3]]]),
                     mesh_dim_names=("pod", "data", "model"))
    _save_local(_run(pdm, WORKERS[2]), out_dir, "pod1_data2_model2")
    halves = [DeviceMesh("cpu", torch.tensor([[3, 1]]), mesh_dim_names=dims),
              DeviceMesh("cpu", torch.tensor([[0, 2]]), mesh_dim_names=dims)]
    for m in halves:
        smagg.worker_group(m)
    mine = next(i for i, m in enumerate(halves)
                if me in m.mesh.flatten().tolist())
    for i, m in enumerate(halves):
        if i == mine:
            _pod_data_checks(m, f"subset{i}", out, out_dir)
    out["subset"] = mine


def _rank_main(rank, world, store, out_dir, ck_in):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(world)
        out = {"rank": rank, "checks": {}, "same": {}}
        _group_checks(mesh, WORKERS[world], out, out_dir, ck_in)
        if world == 4:
            _model_axis_checks(out, out_dir)
            _layout_checks(out, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, world, ck_in=None):
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(world, os.path.join(out_dir, "store"), out_dir,
                          ck_in),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo group of {world} over {SPAWN_LIMIT_S} s")
    outs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The 4-rank group, then the 2-rank group (which resumes the 4 ranks'
    checkpoint), each spawned once."""
    root = tmp_path_factory.mktemp("mesh_experts")
    four = _spawn(str(root / "four"), 4)
    two = _spawn(str(root / "two"), 2,
                 ck_in=str(root / "four" / "ck4" / f"round_{ROUNDS}"))
    return {4: four, 2: two, "root": root}


def _hold(outs, prefix=""):
    """Every rank's checks (those under ``prefix``) pass, and what each
    rank records under ``prefix`` is the same bits on every rank."""
    for o in outs:
        failed = {k: v[1] for k, v in o["checks"].items()
                  if k.startswith(prefix) and not v[0]}
        assert not failed, (o["rank"], failed)
    for o in outs[1:]:
        for k, v in outs[0]["same"].items():
            if k.startswith(prefix):
                assert o["same"][k] == v, (o["rank"], k)


@pytest.mark.parametrize("world", [4, 2])
def test_gloo_group_matches_the_meshless_port(groups, world):
    """wasgd+, spsgd, a resize to half the workers and a save/resume
    under the group against the meshless port; the expert leaves, h and
    theta the same bits on every rank."""
    outs = groups[world]
    for prefix in ("rule/", "resize/", "save/"):
        _hold(outs, prefix)
    names = set(outs[0]["checks"])
    p = WORKERS[world]
    assert {"rule/wasgd+", "rule/spsgd", f"resize/{p}->{p // 2}",
            "save/resumed"} <= names
    if world == 2:
        assert "save/4_ranks_resumed" in names
    keys = outs[0]["expert_keys"]
    assert keys and all("//experts//" in k for k in keys)
    digests = outs[0]["same"]["rule/wasgd+/experts"]
    for k in keys:
        assert {f"@params//{k}", f"@opt_state//{k}"} <= set(digests), k


@pytest.mark.parametrize("mesh", ["data2_model2", "pod1_data2_model2"])
def test_data_model_mesh_is_the_data_mesh_bitwise(groups, mesh):
    """Each rank (d, m) of the (data 2, model 2) mesh, and of the (pod 1,
    data 2, model 2) mesh, holds the params and history of rank d of the
    (data 2) mesh, bit for bit."""
    root = groups["root"]
    for r in range(4):
        info = groups[4][r]["model_axis"]
        d, m = divmod(r, 2)
        assert (info["shard"], info["replica"]) == (d, m)
        a = np.load(root / "four" / f"{mesh}_rank{r}.npz")
        b = np.load(root / "two" / f"data2_rank{d}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].tobytes() == b[k].tobytes(), (r, k)
        ha = json.load(open(root / "four" / f"{mesh}_rank{r}.json"))
        hb = json.load(open(root / "two" / f"data2_rank{d}.json"))
        assert ha == hb, r


def test_only_model_zero_writes_a_checkpoint(groups):
    """Only the ranks at model 0 write shard files (rank 0 the manifest),
    and the checkpoint holds the run's params bit for bit."""
    _hold(groups[4], "model_axis/")
    written = {r: groups[4][r]["model_axis"]["written"] for r in range(4)}
    assert written[1] == written[3] == []
    assert written[0] and written[2]
    assert not set(written[0]) & set(written[2])
    ck = groups["root"] / "four" / "ck_dm" / f"round_{ROUNDS}"
    shards = sorted(f for f in os.listdir(ck) if f.startswith("shard_"))
    assert shards == sorted(written[0] + written[2])
    assert "manifest.json" in os.listdir(ck)


@pytest.mark.parametrize("layout", ["permuted", "subset0", "subset1"])
def test_pod_data_mesh_in_any_rank_order(groups, layout):
    """A ("pod", "data") mesh over a permutation of the ranks, or over a
    half of them (one half permuted), runs the meshless round within
    TOL, and its checkpoint is the gathered state bitwise."""
    outs = groups[4]
    if layout == "permuted":
        _hold(outs, "permuted")
        return
    i = int(layout[-1])
    members = [o for o in outs if o["subset"] == i]
    assert len(members) == 2
    _hold(members, layout)
    assert f"{layout}/checkpoint" in members[0]["checks"]


# ---------------------------------------------------------------------------
# One rank against JAX on a one-device mesh
# ---------------------------------------------------------------------------

P1, ROUNDS1 = 2, 3


def test_one_rank_olmoe_mesh_round_matches_jax(tmp_path):
    """olmoe-smoke (``ep_data``: the experts one copy) at w 2 through
    ``rs_ag:f32`` under a one-rank gloo group, against JAX's Trainer on
    ``make_host_mesh(1, 1)``, both from JAX's initial params."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import TrainConfig as JTrainConfig
    from repro.configs import WASGDConfig as JWASGDConfig
    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import OrderedDataset as JOrderedDataset
    from repro.launch.mesh import make_host_mesh as j_make_host_mesh
    from repro.models import init_params as j_init_params
    from repro.train import Trainer as JTrainer
    from repro.train.lm import make_lm_loss as j_make_lm_loss
    from repro_torch.models import params_from_numpy
    jcfg = dataclasses.replace(jax_smoke("olmoe-1b-7b"),
                               compute_dtype="float32")
    cfg = _cfg()
    jp, axes = j_init_params(jcfg, jax.random.key(5))
    jp = jax.tree.map(np.asarray, jp)
    wkw = dict(tau=TAU, beta=0.9, a_tilde=1.0, strategy="boltzmann",
               backend="rs_ag:f32")
    snaps = {"jax": [], "port": []}

    def recording(tr, key):
        step = tr._step

        def rec(state, batch):
            out = step(state, batch)
            snaps[key].append({k: np.array(v, copy=True) for k, v in
                               _flatten(out[0].params).items()})
            return out
        tr._step = rec

    tr_j = JTrainer(j_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, jp),
                    axes, JTrainConfig(learning_rate=LR, optimizer="momentum",
                                       wasgd=JWASGDConfig(**wkw)), P1,
                    rule="wasgd+", mesh=j_make_host_mesh(1, 1))
    recording(tr_j, "jax")
    tr_j.run(JOrderedDataset(_data(), P1, TAU, B_LOCAL, n_segments=2),
             ROUNDS1)
    dist.init_process_group("gloo",
                            store=dist.FileStore(str(tmp_path / "st"), 1),
                            rank=0, world_size=1)
    try:
        params = params_from_numpy(jp, "cpu")
        tr_t = Trainer(make_lm_loss(cfg), params, param_axes(params),
                       TrainConfig(learning_rate=LR, optimizer="momentum",
                                   wasgd=WASGDConfig(**wkw)), P1,
                       rule="wasgd+", device="cpu",
                       mesh=make_host_mesh(1, 1))
        recording(tr_t, "port")
        tr_t.run(_dataset(P1), ROUNDS1)
    finally:
        dist.destroy_process_group()
    assert len(snaps["port"]) == len(snaps["jax"]) == ROUNDS1
    for r in range(ROUNDS1):
        hj, ht = tr_j.history[r], tr_t.history[r]
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
        assert sorted(snaps["port"][r]) == sorted(snaps["jax"][r])
        for k, ref in snaps["jax"][r].items():
            got = snaps["port"][r][k]
            assert got.shape == ref.shape, k
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=f"round {r} {k}")
    w_up = snaps["port"][-1]["layers//L0//moe//experts//w_up"]
    assert w_up.shape == (cfg.moe.n_experts, cfg.d_model,
                          cfg.moe.d_ff_expert)
