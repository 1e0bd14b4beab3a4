"""The port's examples (``examples/torch_*.py``) and ``estimation_error``
(Eq. 27) against the JAX package.

* ``estimation_error`` on seeded numpy weight vectors against JAX's, and
  at both of its limits: 0 (the same weights) and 2 (disjoint one-hot
  weights); within 1e-6 (float32 sums of at most 16 terms).
* Each example runs in this process with ``--device cpu`` at a small
  ``--rounds``, its outputs under ``tmp_path``, and asserts what its JAX
  counterpart asserts (the quickstart's falling loss and checkpoint round
  trip, the serving demo's budgets, idle scheduler and hot swap; those run
  inside ``main``); the test holds the printed header to the JAX
  config's, the quickstart's data to JAX's ``make_tokens``, and the
  method table to JAX's. Without a card each example's default device
  (``cuda``) raises.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.io import _flatten  # noqa: E402
from repro_torch.core import estimation_error  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_quickstart", "torch_train_e2e",
            "torch_parallel_comparison", "torch_serve_demo")


def _example(name):
    """``examples/<name>.py`` as a fresh module (the JAX ones too)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(seed, n=16):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(n)).astype(np.float32),
            rng.dirichlet(np.ones(n) * 0.3).astype(np.float32))


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "zero", "two"])
def test_estimation_error_matches_jax(case):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import estimation_error as j_estimation_error
    if case == "zero":
        theta, _ = _weights(3)
        true = theta.copy()
    elif case == "two":
        theta, true = np.eye(16, dtype=np.float32)[[2, 9]]
    else:
        theta, true = _weights(int(case[-1]))
    got = estimation_error(torch.from_numpy(theta), torch.from_numpy(true))
    want = float(j_estimation_error(jnp.asarray(theta), jnp.asarray(true)))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6)
    if case == "zero":
        assert float(got) == 0.0
    elif case == "two":
        assert float(got) == 2.0
    else:
        assert 0.0 < float(got) < 2.0


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_default_device_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = {"torch_quickstart": ["--ckpt", str(tmp_path / "ck")],
            "torch_train_e2e": ["--smoke", "--rounds", "1",
                                "--metrics", str(tmp_path / "m.jsonl"),
                                "--ckpt", str(tmp_path / "ck")]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main(argv.get(name, []))


def test_torch_quickstart(tmp_path, capsys):
    pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import make_tokens as j_make_tokens
    mod = _example("torch_quickstart")
    seen = []

    class Recording(mod.OrderedDataset):
        def __init__(self, data, *a, **kw):
            seen.append(data)
            super().__init__(data, *a, **kw)

    mod.OrderedDataset = Recording
    trainer, restored = mod.main(["--device", "cpu", "--rounds", "4",
                                  "--ckpt", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.splitlines()
    jcfg = jax_smoke("stablelm-1.6b")
    assert lines[0] == f"model: {jcfg.name}  params={jcfg.param_count():,}"
    assert lines[-1] == ("checkpoint round-trip OK (meta={'rounds': 4, "
                         "'arch': 'stablelm-1.6b-smoke'})")
    assert any(ln.startswith("loss: ") for ln in lines)
    toks = j_make_tokens(0, 2048, 64, jcfg.vocab_size)
    np.testing.assert_array_equal(seen[0]["tokens"], toks[:, :-1])
    np.testing.assert_array_equal(seen[0]["labels"], toks[:, 1:])
    assert len(trainer.history) == 4
    got = _flatten(restored)
    for k, v in _flatten(trainer.state.params).items():
        assert torch.equal(got[k], v), k


def test_torch_train_e2e(tmp_path, capsys):
    pytest.importorskip("jax")
    j_e2e = _example("train_e2e")
    mod = _example("torch_train_e2e")
    trainer, metrics = mod.main([
        "--smoke", "--rounds", "4", "--device", "cpu",
        "--metrics", str(tmp_path / "m.jsonl"),
        "--ckpt", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.splitlines()
    jcfg = j_e2e.model_smoke()
    assert lines[0] == (f"model={jcfg.name} params={jcfg.param_count():,} "
                        f"workers=4 tau=4")
    assert any(ln.startswith("train: ") for ln in lines)
    assert lines[-1].startswith("held-out: ")
    recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [r["round"] for r in recs] == [0, 1, 2, 3]
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_2", "round_4"]
    assert set(metrics) == {"nll", "ppl", "acc"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert np.isfinite(trainer.losses()).all()


def test_torch_parallel_comparison(capsys):
    pytest.importorskip("jax")
    j_pc = _example("parallel_comparison")
    mod = _example("torch_parallel_comparison")
    assert [(label, rule, kw) for label, rule, kw in mod.METHODS] \
        == [(label, rule, kw) for label, rule, kw in j_pc.METHODS]
    results = mod.main(["--device", "cpu", "--rounds", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"{'method':24s} {'first':>8s} {'final':>8s}"
    assert [ln[:24].rstrip() for ln in lines[1:9]] == [
        m[0] for m in j_pc.METHODS]
    assert list(results) == [m[0] for m in j_pc.METHODS]
    assert all(np.isfinite(v) for v in results.values())
    assert lines[-1] == f"best: {min(results, key=results.get)}"


def test_torch_serve_demo(capsys):
    _example("torch_serve_demo").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "yi-6b", "gemma3-1b", "mamba2-370m", "hot-swap",
        "llama-3.2-vision-11b", "musicgen-large", "serving"]
    assert "lens=[4, 24, 9, 16, 2]" in lines[0]
    assert lines[3].endswith("32 tokens, 1 swap(s)")
    assert lines[4].endswith("out shape=(2, 6)")
    assert lines[5].endswith("out shape=(2, 6, 4)")
    assert lines[-1] == "serving demo OK"
