"""The port's checkpoints against the JAX package's: one on-disk format.

A checkpoint that the JAX ``Trainer`` writes (flat, or sharded through
``save_checkpoint``) restores into the port's ``Trainer`` bitwise, and the
reverse; the state holds a bfloat16 parameter, an ``AdamState`` and the
round counter (a 0-d int32 in JAX, an int in the port). CNN6 leaves cross
through ``models/convert.py``. Structure and dtype mismatches raise with
JAX's messages, and a run that saves, resumes and continues equals a
straight run bitwise on the CPU.
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as jck  # noqa: E402
import repro_torch.checkpoint as tck  # noqa: E402
from repro.checkpoint.io import _flatten as j_flatten  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.param import build  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.checkpoint.io import _flatten  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.data import OrderedDataset, make_classification  # noqa: E402
from repro_torch.models import (classification_loss, cnn6_from_jax,  # noqa: E402
                                cnn6_to_jax, init_mlp, mlp_apply,
                                params_from_numpy)
from repro_torch.train import Trainer  # noqa: E402

P, TAU, B_LOCAL = 2, 2, 4


def _data():
    X, y = make_classification(0, 256, d=8, n_classes=4)
    return {"x": X, "y": y}


def _trainer(framework, optimizer="adamw", policy="", rule="wasgd+"):
    """An MLP trainer (its output bias in bfloat16) from JAX's params."""
    params, axes = build(functools.partial(
        jcnn.mlp_init, d_in=8, d_hidden=16, n_classes=4), jax.random.key(0))
    # reprolint: allow=DT001 -- the checkpointed state needs a bf16 leaf
    params = dict(params, b_out=params["b_out"].astype(jnp.bfloat16))
    wkw = dict(tau=TAU, policy=policy)
    if framework == "jax":
        def loss(p, b):
            return jcnn.classification_loss(jcnn.mlp_apply(p, b["x"]),
                                            b["y"]), {}
        return JTrainer(loss, params, axes, JTrainConfig(
            learning_rate=0.05, optimizer=optimizer,
            wasgd=JWASGDConfig(**wkw)), P, rule=rule), JOrderedDataset(
            _data(), P, TAU, B_LOCAL)

    def loss(p, b):
        return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}
    start = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return Trainer(loss, start, axes, TrainConfig(
        learning_rate=0.05, optimizer=optimizer, wasgd=WASGDConfig(**wkw)),
        P, rule=rule, device="cpu"), OrderedDataset(_data(), P, TAU, B_LOCAL)


def _as_numpy(leaf):
    """A leaf of either package as (numpy array of its bits, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).replace("torch.", "")
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), name
        return leaf.numpy(), name
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    a = np.asarray(leaf)
    name = str(a.dtype)
    return (a.view(np.int16) if name == "bfloat16" else a), name


def _assert_states_bitwise(port_state, jax_state):
    ours, ref = _flatten(port_state), j_flatten(jax_state)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        (a, da), (b, db) = _as_numpy(ours[k]), _as_numpy(ref[k])
        assert da == db, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert isinstance(port_state.step, int)


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_checkpoints_cross_bitwise(tmp_path, fmt, writer):
    """Two rounds in the writer, a checkpoint, a resume in the other
    package's fresh trainer: its state is the writer's, bit for bit."""
    reader = "port" if writer == "jax" else "jax"
    tr_w, ds = _trainer(writer)
    tr_w.run(ds, 2)
    path = str(tmp_path / "ck")
    if fmt == "sharded":
        tr_w.save_checkpoint(path, 2)
        tr_w._ckpt.wait()
    else:
        (jck if writer == "jax" else tck).save(path, tr_w.state,
                                              meta={"round": 2})
    tr_r, _ = _trainer(reader)
    assert tr_r.resume(path) == 2
    port, ref = (tr_r, tr_w) if reader == "port" else (tr_w, tr_r)
    _assert_states_bitwise(port.state, ref.state)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["keys"]["@params//b_out"]["dtype"] == "bfloat16"
    assert man["keys"]["@step"]["dtype"] == "int32"
    assert "@opt_state//@count" in man["keys"]
    if fmt == "sharded":
        other, _ = _trainer(reader)
        assert jck.saved_topology(path)["topology"] == \
            (port if writer == "port" else ref)._topology(2)
        assert port._topology(2) == ref._topology(2) == \
            other._topology(2)


def test_cnn6_checkpoints_cross_through_convert(tmp_path):
    """CNN6 leaves change layout between the packages (HWIO/OIHW and the
    rows of fc_w): a JAX checkpoint restores into JAX-layout tensors,
    which ``cnn6_from_jax`` converts; the port writes ``cnn6_to_jax``'s
    tree for JAX to read."""
    pj = jax.tree.map(lambda x: jnp.stack([x, 2 * x]),
                      jcnn.init_cnn6(jax.random.key(1)))
    jck.save(str(tmp_path / "j"), pj)
    like = {k: torch.zeros(v.shape) for k, v in pj.items()}
    got, _ = tck.restore(str(tmp_path / "j"), like)
    ours = cnn6_from_jax({k: v.numpy() for k, v in got.items()},
                         device="cpu")
    want = cnn6_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    for k in want:
        assert torch.equal(ours[k], want[k]), k
    tck.save(str(tmp_path / "t"), {k: torch.from_numpy(v) for k, v in
                                    cnn6_to_jax(ours).items()})
    back, _ = jck.restore(str(tmp_path / "t"),
                          jax.tree.map(jnp.zeros_like, pj))
    for k in pj:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(pj[k]))


def _mismatch(pkg, path, case):
    """One restore scenario through ``pkg``; returns the ValueError's text
    or the restored tree."""
    arr = (lambda v: jnp.asarray(v)) if pkg is jck else torch.tensor
    f32, bf16 = ((jnp.float32, jnp.bfloat16) if pkg is jck
                 else (torch.float32, torch.bfloat16))

    def zeros(n, dt=None):
        return (jnp.zeros(n, dt or f32) if pkg is jck
                else torch.zeros(n, dtype=dt or f32))

    pkg.save(path, {"a": arr(np.arange(4, dtype=np.float32)),
                    "b": arr(np.ones(2, np.float32))})
    like = {"missing": {"a": zeros(4), "b": zeros(2), "c": zeros(2)},
            "unexpected": {"a": zeros(4)},
            "both": {"a": zeros(4), "c": zeros(2)},
            "dtype": {"a": zeros(4, bf16), "b": zeros(2)},
            "allow_cast": {"a": zeros(4, bf16), "b": zeros(2)},
            "shape": {"a": zeros(3), "b": zeros(2)},
            "corrupt": {"a": zeros(4), "b": zeros(2)},
            "not_sharded": {"a": zeros(4), "b": zeros(2)}}[case]
    if case == "corrupt":
        mf = os.path.join(path, "manifest.json")
        man = json.load(open(mf))
        man["keys"]["a"]["dtype"] = "int32"
        json.dump(man, open(mf, "w"))
    try:
        if case == "not_sharded":
            return pkg.restore_sharded(path, like)
        return pkg.restore(path, like, allow_cast=case == "allow_cast")
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("case", ["missing", "unexpected", "both", "dtype",
                                  "shape", "corrupt", "not_sharded",
                                  "allow_cast"])
def test_restore_refuses_as_jax_does(tmp_path, case):
    ours = _mismatch(tck, str(tmp_path / "t"), case)
    ref = _mismatch(jck, str(tmp_path / "j"), case)
    if case == "allow_cast":
        assert ours[0]["a"].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours[0]["a"].float().numpy(),
                                      np.asarray(ref[0]["a"], np.float32))
        return
    assert isinstance(ours, str) and ours == ref.replace(
        str(tmp_path / "j"), str(tmp_path / "t"))


@pytest.mark.parametrize("rule, policy, optimizer", [
    ("wasgd+", "ema|boltzmann", "adamw"), ("easgd", "", "momentum"),
    ("mmwu", "", "sgd")], ids=["wasgd+_ema", "easgd", "mmwu"])
def test_resume_and_continue_equals_a_straight_run(tmp_path, rule, policy,
                                                    optimizer):
    straight, ds = _trainer("port", optimizer, policy, rule)
    straight.run(ds, 4)
    first, ds = _trainer("port", optimizer, policy, rule)
    first.run(ds, 2, checkpoint_every=2, checkpoint_path=str(tmp_path))
    resumed, ds = _trainer("port", optimizer, policy, rule)
    out = resumed.run(ds, 4, resume_from=str(tmp_path / "round_2"))
    assert out["rounds"] == 2 and resumed.state.step == 4
    a, b = _flatten(resumed.state), _flatten(straight.state)
    assert sorted(a) == sorted(b)
    for k in b:
        if isinstance(b[k], torch.Tensor):
            assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
        else:
            assert a[k] == b[k], k
    for hr, hs in zip(resumed.history, straight.history[2:]):
        assert hr["round"] == hs["round"]
        np.testing.assert_array_equal(hr["theta"], hs["theta"])


def test_resume_refuses_another_rule(tmp_path):
    tr, ds = _trainer("port")
    tr.save_checkpoint(str(tmp_path), 0)
    tr._ckpt.wait()
    other, _ = _trainer("port", rule="spsgd")
    with pytest.raises(ValueError, match="saved by rule 'wasgd\\+'"):
        other.resume(str(tmp_path))


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    """The tree is copied when ``save`` returns (a later change of a leaf
    does not reach the file); a failed write raises at ``wait``."""
    ac = tck.AsyncCheckpointer()
    w = torch.arange(3.0)
    ac.save(str(tmp_path / "a"), {"w": w, "n": 7}, meta={"round": 1})
    w += 10
    ac.wait()
    got, meta = tck.restore(str(tmp_path / "a"), {"w": torch.zeros(3),
                                                  "n": 0})
    assert meta == {"round": 1} and got["n"] == 7
    np.testing.assert_array_equal(got["w"].numpy(), [0.0, 1.0, 2.0])
    bad = tmp_path / "a-file"
    bad.write_text("not a directory")
    ac.save(str(bad / "nested"), {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ac.wait()
    ac.close()
    assert not ac._thread.is_alive()


def test_async_checkpointer_writer_ends_at_wait(tmp_path):
    """No writer thread outlives ``wait``; a later ``save`` starts one
    again and its file is written."""
    ac = tck.AsyncCheckpointer()
    for name, v in (("a", 1.0), ("b", 2.0)):
        ac.save(str(tmp_path / name), {"w": torch.full((2,), v)})
        writer = ac._thread
        ac.wait()
        assert not writer.is_alive() and not ac._thread.is_alive()
        got, _ = tck.restore(str(tmp_path / name), {"w": torch.zeros(2)})
        np.testing.assert_array_equal(got["w"].numpy(), [v, v])
    ac.close()


def test_async_checkpointer_frees_each_snapshot_once_written(tmp_path,
                                                          monkeypatch):
    """The writer drops a save's snapshot when its write ends, not when
    the next save arrives: the last snapshot of a run (the whole train
    state, on the device) must not outlive ``wait()``."""
    import gc
    import weakref
    from repro_torch.checkpoint import io as tio
    seen = []
    real = tio.save_sharded

    def spy(path, snap, **kw):
        seen.extend(weakref.ref(v) for v in snap.values()
                    if isinstance(v, torch.Tensor))
        return real(path, snap, **kw)

    monkeypatch.setattr(tio, "save_sharded", spy)
    ac = tck.AsyncCheckpointer()
    ac.save(str(tmp_path / "a"), {"w": torch.arange(4.0)})
    ac.wait()
    gc.collect()
    assert seen and all(r() is None for r in seen)
    ac.close()


def test_port_init_trainer_checkpoint_keys_are_jaxs(tmp_path):
    """The port's own init (no JAX params) writes JAX's keys: the JAX
    Trainer resumes it."""
    params = init_mlp(0, 8, 16, 4, device="cpu")
    params["b_out"] = params["b_out"].to(torch.bfloat16)
    tr = Trainer(lambda p, b: (classification_loss(mlp_apply(p, b["x"]),
                                                    b["y"]), {}),
                 params, {k: (None,) * v.dim() for k, v in params.items()},
                 TrainConfig(optimizer="adamw", wasgd=WASGDConfig(tau=TAU)),
                 P, rule="wasgd+", device="cpu")
    tr.run(OrderedDataset(_data(), P, TAU, B_LOCAL), 1,
           checkpoint_every=1, checkpoint_path=str(tmp_path))
    jt, _ = _trainer("jax")
    assert jt.resume(str(tmp_path / "round_1")) == 1
    _assert_states_bitwise(tr.state, jt.state)
