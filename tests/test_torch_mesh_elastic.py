"""The port's baseline rules, elastic resize and sharded checkpoints under a
device mesh (``Trainer(mesh=)``, ``core/membership.resize_train_state(
mesh=)``, ``checkpoint.AsyncCheckpointer.save(mesh=)``,
``restore(rows=)``).

* A one-rank gloo group (``tests/test_torch_mesh.py``'s ``world1``)
  against JAX's ``Trainer`` on a one-device mesh, on the benchmark MLP:
  each baseline rule for 3 rounds, a membership schedule, and a
  save/resume round trip read by both packages. Tolerances as that
  file's: params atol 1e-5, h and loss rtol 1e-5, theta atol 1e-6.
* Spawned gloo groups of 4 and then 2 ranks (``torch.multiprocessing``,
  a ``FileStore`` under a temporary directory, each spawn once with its
  own time limit), w 8, against the port's meshless run in each rank:
  the five rules (omwu, mmwu and seq bitwise, spsgd and easgd within
  1e-6 of the leaf's largest value, the all-reduce summing in its own
  order), ``Trainer.resize`` 8 -> 4 -> 8 (survivors bitwise, newcomers
  within 1e-6), a schedule 8 -> 4 -> 8 through ``run`` (1e-6: ``rs_ag``
  against ``einsum``; pipelined bitwise unpipelined), checkpoints (a group's is the meshless
  ``save_sharded(n_shards=S)`` key for key and bit for bit; the 4 ranks'
  resumes under 2 ranks and without a mesh bitwise, also at p 4; a JAX
  checkpoint resumes under 2 ranks bitwise), and a worker count that is
  not a multiple of S raising ``ValueError`` on every rank. Every rank
  must see the same h, theta, MWU weights and EASGD center. The ranks
  import no JAX; the parent writes the JAX checkpoint and reads the
  2-rank one back with JAX's ``restore_sharded``.
"""
import functools
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.checkpoint.io import _Npz, _flatten, save_sharded  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import shared_axes  # noqa: E402
from repro_torch.core import shardmap_agg as smagg  # noqa: E402
from repro_torch.core.membership import (MembershipSchedule,  # noqa: E402
                                         resize_train_state)
from repro_torch.core.weights import parse_policy  # noqa: E402
from repro_torch.data import (OrderedDataset, RoundPrefetcher,  # noqa: E402
                              make_classification)
from repro_torch.models import classification_loss, init_mlp, mlp_apply  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

RULES = ("spsgd", "easgd", "omwu", "mmwu", "seq")
BITWISE_RULES = ("omwu", "mmwu", "seq")
W, TAU, B_LOCAL, ROUNDS, LR = 8, 2, 4, 3, 0.05
POLICY = "ema|boltzmann"          # a policy state that a resize expands
SPAWN_LIMIT_S = 120


def _loss_fn(p, b):
    return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}


@functools.lru_cache(maxsize=None)
def _data():
    X, y = make_classification(0, 1024, d=16, n_classes=4)
    return {"x": X, "y": y}


def _trainer(mesh, rule="wasgd+", p=W, spec=None, pipeline=None, **wkw):
    """The MLP (init seed 0) with momentum SGD, so that the optimizer
    state holds worker rows too; ``spec`` defaults to ``rs_ag:f32`` under
    a mesh and ``einsum:f32`` without."""
    params = init_mlp(0, 16, 32, 4, device="cpu")
    spec = spec or ("rs_ag:f32" if mesh is not None else "einsum:f32")
    tcfg = TrainConfig(learning_rate=LR, optimizer="momentum",
                       wasgd=WASGDConfig(tau=TAU, backend=spec, **wkw))
    return Trainer(_loss_fn, params, shared_axes(params), tcfg, p,
                   rule=rule, device="cpu", mesh=mesh, pipeline=pipeline)


def _dataset(p=W, boundary_delay=0):
    return OrderedDataset(_data(), p, TAU, B_LOCAL, n_segments=2,
                          boundary_delay=boundary_delay)


def _full_state(tr, mesh):
    """Every worker's rows of the trainer's state, as a flat dict."""
    keys = tr._row_keys()
    return {k: smagg.gather_rows(v, mesh) if k in keys else v
            for k, v in _flatten(tr.state).items()}


def _flat(tr):
    return _flatten(tr.state)


def _max_rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _bitwise(a: dict, b: dict):
    """Keys that differ (values, not only the bits of -0.0 and 0.0)."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y)):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def _put(out, name, ok, detail=None):
    out["checks"][name] = [bool(ok), detail]


# ---------------------------------------------------------------------------
# The ranks' cases (no JAX here)
# ---------------------------------------------------------------------------

def _rule_checks(mesh, out):
    for rule in RULES:
        tr = _trainer(mesh, rule)
        tr.run(_dataset(), ROUNDS)
        ref = _trainer(None, rule)
        ref.run(_dataset(), ROUNDS)
        got = {k: smagg.gather_rows(v, mesh)
               for k, v in tr.state.params.items()}
        errs = {k: _max_rel(got[k], v) for k, v in ref.state.params.items()}
        if rule in BITWISE_RULES:
            ok = not _bitwise(got, ref.state.params)
        else:
            ok = max(errs.values()) <= 1e-6
        hist = all(np.array_equal(a[k], b[k]) for a, b in zip(
            tr.history, ref.history) for k in ("h", "theta"))
        cs, cs_ref = tr.state.comm_state, ref.state.comm_state
        if rule in ("omwu", "mmwu"):
            ok &= torch.equal(cs.log_w, cs_ref.log_w)
            out["same"][f"{rule}/log_w"] = cs.log_w.tolist()
        if rule == "easgd":
            center = {k: _max_rel(v, cs_ref.center[k])
                      for k, v in cs.center.items()}
            ok &= max(center.values()) <= 1e-6
            errs["center"] = center
            out["same"]["easgd/center"] = [
                v.flatten()[:8].tolist() for v in cs.center.values()]
        # every rule's first round starts from the same params: its h and
        # theta are the meshless round's bit for bit
        ok &= (hist if rule in BITWISE_RULES else
               np.array_equal(tr.history[0]["h"], ref.history[0]["h"]))
        _put(out, f"rule/{rule}", ok, errs)
        out["same"][f"rule/{rule}"] = {
            k: [np.asarray(h[k]).tolist() for h in tr.history]
            for k in ("h", "theta")}


def _resize_checks(mesh, out):
    """``Trainer.resize`` 8 -> 4 -> 8 against the meshless
    ``resize_train_state`` of the gathered state."""
    pol = parse_policy(POLICY)
    tr = _trainer(mesh, policy=POLICY)
    tr.run(_dataset(), 1)

    def gathered(tree):
        return {k: smagg.gather_rows(v, mesh) for k, v in tree.items()}

    for new_p in (4, 8):
        before = tr.state._replace(
            params=gathered(tr.state.params),
            opt_state=gathered(tr.state.opt_state),
            energy=smagg.gather_rows(tr.state.energy, mesh))
        old_p = tr.n_workers
        want = _flatten(resize_train_state(before, tr.axes, new_p,
                                           policy=pol))
        tr.resize(new_p, round=1)
        got = _full_state(tr, mesh)
        keep = min(old_p, new_p)
        survivors = {k: torch.equal(got[k][:keep], want[k][:keep])
                     for k in tr._row_keys()}
        newcomers = {k: _max_rel(got[k][keep:], want[k][keep:])
                     for k in tr._row_keys() if new_p > old_p}
        rest = _bitwise({k: v for k, v in got.items()
                         if k not in tr._row_keys()},
                        {k: v for k, v in want.items()
                         if k not in tr._row_keys()})
        ok = (all(survivors.values()) and not rest
              and all(e <= 1e-6 for e in newcomers.values())
              and tr.state.energy.shape[0] == smagg.local_workers(new_p,
                                                                   mesh))
        _put(out, f"resize/{old_p}->{new_p}", ok, [newcomers, rest])


def _schedule_checks(mesh, out):
    """8 -> 4 -> 8 through ``run`` against the meshless run, and the
    pipelined run (its prefetcher recut at each resize) bitwise the
    unpipelined one."""
    sched = MembershipSchedule(W, {1: 4, 2: W})
    delay = RoundPrefetcher.run_ahead()
    runs = []
    for m, pipe in ((mesh, None), (None, None), (mesh, "parity")):
        tr = _trainer(m, policy=POLICY, pipeline=pipe)
        tr.run(_dataset(boundary_delay=delay), ROUNDS,
               membership_schedule=sched)
        runs.append(tr)
    tr, ref, piped = runs
    got = {k: smagg.gather_rows(v, mesh) for k, v in tr.state.params.items()}
    errs = {k: _max_rel(got[k], v) for k, v in ref.state.params.items()}
    ps = [int(h["p"]) for h in tr.history]
    same = not _bitwise(_flat(piped), _flat(tr)) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(tr.history, piped.history)
        for k in ("h", "theta", "loss"))
    _put(out, "schedule/8-4-8", max(errs.values()) <= 1e-6 and same
         and ps == [int(h["p"]) for h in ref.history] == [8, 4, 8],
         [errs, same])
    out["same"]["schedule/theta"] = [np.asarray(h["theta"]).tolist()
                                     for h in tr.history]


def _save_checks(mesh, out, ck_dir):
    """A checkpoint of the group against the meshless save of the gathered
    state, and resumed under the group and without a mesh."""
    s = smagg.mesh_worker_shards(mesh)
    tr = _trainer(mesh, policy=POLICY)
    tr.run(_dataset(), 2)
    ck = os.path.join(ck_dir, f"ck{s}")
    tr.save_checkpoint(ck, 2)
    tr._ckpt.wait()
    full = _full_state(tr, mesh)
    if smagg.shard_index(mesh) == 0:
        ref = os.path.join(ck_dir, f"ref{s}")
        save_sharded(ref, full, meta={"round": 2},
                     topology=tr._topology(2), n_shards=s)
        man = [json.load(open(os.path.join(d, "manifest.json")))
               for d in (ck, ref)]
        diff = []
        for k, e in man[1]["keys"].items():
            f = "shard_%05d.npz" % e["shard"]
            a, b = (_Npz(os.path.join(d, f)) for d in (ck, ref))
            (x, dx), (y, dy) = a[k], b[k]
            if dx != dy or x.shape != y.shape or x.tobytes() != y.tobytes():
                diff.append(k)
            a.close()
            b.close()
        _put(out, f"rank0/save/{s}_ranks_is_the_meshless_save",
             man[0] == man[1] and not diff
             and man[0]["n_shards"] == s
             and all(man[0]["keys"][k]["shape"][0] == W
                     for k in tr._row_keys()), diff)
        plain = _trainer(None, policy=POLICY)
        plain.resume(ck)
        _put(out, f"rank0/save/{s}_ranks_resumed_meshless",
             not _bitwise(_flat(plain), full), _bitwise(_flat(plain), full))
    again = _trainer(mesh, policy=POLICY)
    assert again.resume(ck) == 2
    bad = _bitwise(_full_state(again, mesh), full)
    _put(out, f"save/{s}_ranks_resumed_under_{s}", not bad, bad)


def _resume_checks(mesh, out, ck4, jax_ck):
    """Under 2 ranks: the 4 ranks' checkpoint at p 8 and at p 4, and a JAX
    checkpoint, against the meshless port's resume of each."""
    for name, path, p in (("4_ranks_at_8", ck4, W), ("4_ranks_at_4", ck4, 4),
                          ("jax_at_8", jax_ck, W)):
        policy = POLICY if path == ck4 else ""
        tr = _trainer(mesh, p=p, policy=policy)
        plain = _trainer(None, p=p, policy=policy)
        assert tr.resume(path) == plain.resume(path)
        bad = _bitwise(_full_state(tr, mesh), _flat(plain))
        tr.run(_dataset(p).batches(start_round=2), 1)
        plain.run(_dataset(p).batches(start_round=2), 1)
        err = max(_max_rel(smagg.gather_rows(v, mesh), plain.state.params[k])
                  for k, v in tr.state.params.items())
        _put(out, f"resume/{name}", not bad and err <= 1e-6, [bad, err])


def _refusal_checks(mesh, out):
    s = smagg.mesh_worker_shards(mesh)
    bad_p = W + s // 2 if s > 1 else None
    tr = _trainer(mesh)
    msgs = []
    for call in (lambda: tr.resize(bad_p),
                 lambda: tr.run(_dataset(), 2, membership_schedule=(
                     MembershipSchedule(W, {1: bad_p})))):
        try:
            call()
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    _put(out, "refused/not_a_multiple",
         all(f"multiple of {s}" in m for m in msgs)
         and tr.n_workers == W and not tr.history, msgs)


def _rank_main(rank, world, store, out_dir, ck4, jax_ck):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        out = {"rank": rank, "checks": {}, "same": {}}
        _rule_checks(mesh, out)
        _resize_checks(mesh, out)
        _schedule_checks(mesh, out)
        _save_checks(mesh, out, out_dir)
        if ck4 is not None:
            _resume_checks(mesh, out, ck4, jax_ck)
        _refusal_checks(mesh, out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, world, ck4=None, jax_ck=None):
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(world, os.path.join(out_dir, "store"), out_dir,
                          ck4, jax_ck),
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


def _jax_checkpoint(path):
    """JAX's Trainer on the same MLP (w 8, momentum, the rank's config), 2
    rounds, then its sharded checkpoint at round 2."""
    jax = pytest.importorskip("jax")
    from repro.configs import TrainConfig as JTrainConfig
    from repro.configs import WASGDConfig as JWASGDConfig
    from repro.data import OrderedDataset as JOrderedDataset
    from repro.models import cnn as jcnn
    from repro.models.param import build
    from repro.train import Trainer as JTrainer
    params, _ = build(functools.partial(jcnn.mlp_init, d_in=16, d_hidden=32,
                                        n_classes=4), jax.random.key(1))
    axes = {k: (None,) * v.ndim for k, v in params.items()}

    def loss(p, b):
        return jcnn.classification_loss(jcnn.mlp_apply(p, b["x"]),
                                        b["y"]), {}
    jt = JTrainer(loss, params, axes, JTrainConfig(
        learning_rate=LR, optimizer="momentum",
        wasgd=JWASGDConfig(tau=TAU)), W, rule="wasgd+")
    jt.run(JOrderedDataset(_data(), W, TAU, B_LOCAL, n_segments=2), 2)
    jt.save_checkpoint(path, 2)
    jt._ckpt.wait()
    return path


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The 4-rank group, then the 2-rank group (which resumes the 4 ranks'
    checkpoint and a JAX one), each spawned once."""
    root = tmp_path_factory.mktemp("mesh_elastic")
    four = _spawn(str(root / "four"), 4)
    jax_ck = _jax_checkpoint(str(root / "jax_ck"))
    two = _spawn(str(root / "two"), 2, ck4=str(root / "four" / "ck4"),
                 jax_ck=jax_ck)
    return {4: four, 2: two, "root": root}


def _hold(outs):
    failed = {k: v[1] for k, v in outs[0]["checks"].items() if not v[0]}
    assert not failed, failed
    for o in outs[1:]:
        # rank 0 alone compares with the meshless save
        assert set(o["checks"]) == {k for k in outs[0]["checks"]
                                    if not k.startswith("rank0/")}
        assert all(v[0] for v in o["checks"].values()), o["rank"]
        for k, v in outs[0]["same"].items():
            assert o["same"][k] == v, (o["rank"], k)


@pytest.mark.parametrize("world", [4, 2])
def test_gloo_group_matches_the_meshless_port(groups, world):
    outs = groups[world]
    _hold(outs)
    names = set(outs[0]["checks"])
    assert {f"rule/{r}" for r in RULES} <= names
    assert {"resize/8->4", "resize/4->8", "schedule/8-4-8",
            "refused/not_a_multiple",
            f"rank0/save/{world}_ranks_is_the_meshless_save",
            f"rank0/save/{world}_ranks_resumed_meshless",
            f"save/{world}_ranks_resumed_under_{world}"} <= names
    if world == 2:
        assert {"resume/4_ranks_at_8", "resume/4_ranks_at_4",
                "resume/jax_at_8"} <= names
        # JAX reads the 2 ranks' checkpoint, bit for bit
        from repro.checkpoint import restore_sharded as j_restore
        ck = str(groups["root"] / "two" / "ck2")
        man = json.load(open(os.path.join(ck, "manifest.json")))
        like = {k: np.zeros(e["shape"], e["dtype"])
                for k, e in man["keys"].items()}
        got, meta = j_restore(ck, like)
        assert meta == {"round": 2}
        for k, e in man["keys"].items():
            z = _Npz(os.path.join(ck, "shard_%05d.npz" % e["shard"]))
            np.testing.assert_array_equal(np.asarray(got[k]), z[k][0],
                                          err_msg=k)
            z.close()


# ---------------------------------------------------------------------------
# One rank against JAX on a one-device mesh
# ---------------------------------------------------------------------------

P, N_SAMPLES, BETA = 4, 512, 0.9


def _harness(framework, mesh, rule="wasgd+", **wkw):
    """The benchmark MLP (``benchmarks/common.py``) with ``rule``, both
    packages from JAX's initial params, at ``P`` workers."""
    import jax
    from benchmarks import common
    from repro import configs as jcfg
    from repro.data import OrderedDataset as JOrderedDataset
    from repro.train import Trainer as JTrainer
    from repro_torch.models import params_from_numpy
    params_j, axes, loss_j, _ = common.model(0, False)
    X, y = common.dataset(0, False)
    data = {"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}
    wkw = dict(tau=8, beta=BETA, backend="rs_ag:f32", **wkw)
    if framework == "jax":
        tr = JTrainer(loss_j, params_j, axes, jcfg.TrainConfig(
            learning_rate=0.05, optimizer="momentum",
            wasgd=jcfg.WASGDConfig(**wkw)), P, rule=rule, mesh=mesh)
        return tr, JOrderedDataset(data, P, 8, 8, n_segments=2, seed=7)
    start = params_from_numpy(jax.tree.map(np.asarray, params_j),
                              device="cpu")
    tr = Trainer(lambda p, b: (classification_loss(mlp_apply(p, b["x"]),
                                                   b["y"]), {}),
                 start, axes, TrainConfig(
                     learning_rate=0.05, optimizer="momentum",
                     wasgd=WASGDConfig(**wkw)), P, rule=rule,
                 device="cpu", mesh=mesh)
    return tr, OrderedDataset(data, P, 8, 8, n_segments=2, seed=7)


def _hold_jax(tr_t, tr_j, rounds=None):
    import jax
    assert len(tr_t.history) == len(tr_j.history)
    for r, (ht, hj) in enumerate(zip(tr_t.history, tr_j.history)):
        assert ht.get("p") == hj.get("p"), r
        for k in ("h", "loss"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
    pj = jax.tree.map(np.asarray, tr_j.state.params)
    for k, v in tr_t.state.params.items():
        np.testing.assert_allclose(v.numpy(), pj[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("rule", RULES)
def test_one_rank_baseline_rule_matches_jax(rule, tmp_path):
    pytest.importorskip("jax")
    from test_torch_mesh import jmesh1, world1
    tr_j, ds_j = _harness("jax", jmesh1(), rule)
    tr_j.run(ds_j, ROUNDS)
    with world1(tmp_path / "store") as mesh:
        tr_t, ds_t = _harness("port", mesh, rule)
        tr_t.run(ds_t, ROUNDS)
    _hold_jax(tr_t, tr_j)
    cs_t, cs_j = tr_t.state.comm_state, tr_j.state.comm_state
    if rule in ("omwu", "mmwu"):
        np.testing.assert_allclose(cs_t.log_w.numpy(), np.asarray(cs_j.log_w),
                                   rtol=1e-5, atol=1e-6)
    if rule == "easgd":
        for k, v in cs_t.center.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(cs_j.center[k]),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_one_rank_membership_schedule_matches_jax(tmp_path):
    pytest.importorskip("jax")
    from repro.core import membership as jmem
    from test_torch_mesh import jmesh1, world1
    tr_j, ds_j = _harness("jax", jmesh1(), policy=POLICY)
    tr_j.run(ds_j, 4, membership_schedule=jmem.MembershipSchedule(
        P, {1: 2, 2: 5, 3: P}))
    with world1(tmp_path / "store") as mesh:
        tr_t, ds_t = _harness("port", mesh, policy=POLICY)
        tr_t.run(ds_t, 4, membership_schedule=MembershipSchedule(
            P, {1: 2, 2: 5, 3: P}))
    assert [h["p"] for h in tr_t.history] == [4, 2, 5, 4]
    _hold_jax(tr_t, tr_j)


def test_one_rank_checkpoint_round_trip_matches_jax(tmp_path):
    """The port under the group saves every 2 of 4 rounds; its round-2
    checkpoint resumed under the group gives the straight run bitwise,
    and JAX's Trainer (on its one-device mesh) resumes it at the saved
    state bitwise and continues as the port does."""
    pytest.importorskip("jax")
    import jax
    from repro.checkpoint.io import _flatten as j_flatten
    from test_torch_mesh import jmesh1, world1
    ck = str(tmp_path / "ck")
    with world1(tmp_path / "store") as mesh:
        straight, ds = _harness("port", mesh, policy=POLICY)
        straight.run(ds, 4, checkpoint_every=2, checkpoint_path=ck)
        resumed, ds = _harness("port", mesh, policy=POLICY)
        resumed.run(ds, 4, resume_from=os.path.join(ck, "round_2"))
        saved = _harness("port", mesh, policy=POLICY)[0]
        assert saved.resume(os.path.join(ck, "round_2")) == 2
    assert sorted(os.listdir(ck)) == ["round_2", "round_4"]
    assert not _bitwise(_flat(resumed), _flat(straight))
    for a, b in zip(resumed.history, straight.history[2:]):
        for k in ("h", "theta", "loss"):
            assert np.array_equal(a[k], b[k]), k
    tr_j, ds_j = _harness("jax", jmesh1(), policy=POLICY)
    assert tr_j.resume(os.path.join(ck, "round_2")) == 2
    ours, ref = _flatten(saved.state), j_flatten(tr_j.state)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v),
                                      err_msg=k)
    tr_j.run(ds_j, 4, resume_from=os.path.join(ck, "round_2"))
    _hold_jax(resumed, tr_j)
    assert jax.tree.map(np.shape, tr_j.state.params) == {
        k: tuple(v.shape) for k, v in resumed.state.params.items()}
