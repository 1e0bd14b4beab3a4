"""The port's training launcher (``repro_torch.launch.train``) and
``ModelConfig.param_count``/``active_param_count`` against the JAX
package: the counts of all ten configs, full and smoke; the command
line's options (JAX's, less ``--transfer-guard``, plus ``--device``);
the header line; the ``--ckpt`` file read by JAX's checkpoint reader;
the ``--telemetry`` file rendered by ``tools/obs_report.py``; a
``--resume`` at another ``--workers`` count. Every run is a smoke config
on the CPU (``--device cpu``) with a short round.
"""
import argparse
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# a short run: 2 workers, one local step of one sequence of 16 tokens
QUICK = ["--smoke", "--device", "cpu", "--workers", "2", "--tau", "1",
         "--b-local", "1", "--seq", "16"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_are_jaxs(arch):
    """Full and smoke configs; on the smoke config the port's params have
    the numel of JAX's (the analytic count is not that numel in either
    package, except for mamba2-370m)."""
    for ours, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke(arch))):
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
    smoke = get_smoke_config(arch)
    numel = sum(x.numel() for x in tree_leaves(init_params(smoke,
                                                           device="cpu")))
    shapes = jax.eval_shape(lambda k: j_init_params(j_get_smoke(arch), k)[0],
                            jax.random.key(0))
    assert numel == sum(int(np.prod(s.shape))
                        for s in jax.tree.leaves(shapes))
    assert (smoke.param_count() == numel) == (arch == "mamba2-370m")


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
    """The parser JAX's ``main`` builds, caught at its ``parse_args``."""
    seen = {}

    def grab(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        jtrain.main()
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None, a.required,
                     a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_options_are_jaxs_less_transfer_guard_plus_device(monkeypatch):
    ours = _options(ttrain.build_parser())
    ref = _options(_jax_parser(monkeypatch))
    assert ref.pop("transfer_guard")[0] == ("--transfer-guard",)
    assert ours.pop("device") == (("--device",), "cuda", None, None, False,
                                  None, None)
    assert ours == ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_run_prints_jaxs_header(arch, capsys):
    """One round of every smoke config: JAX's header line, the round
    line and the summary."""
    tr = ttrain.main(["--arch", arch, "--rounds", "1"] + QUICK)
    out = capsys.readouterr().out.splitlines()
    cfg = j_get_smoke(arch)
    assert out[0] == (f"arch={cfg.name} family={cfg.family} "
                      f"params={cfg.param_count():,} workers=2")
    assert out[1].startswith("round 1/1 loss=")
    assert out[-1].startswith("done: {'rounds': 1,")
    assert np.isfinite(tr.losses()).all()


def test_ckpt_telemetry_and_resume(tmp_path, capsys):
    from tools.obs_report import main as obs_report
    ck, tele = str(tmp_path / "final"), str(tmp_path / "run.jsonl")
    cdir = str(tmp_path / "ckpts")
    tr = ttrain.main(["--arch", "gemma3-1b", "--rounds", "2", "--ckpt", ck,
                      "--telemetry", tele, "--checkpoint-dir", cdir,
                      "--checkpoint-every", "1"] + QUICK)
    out = capsys.readouterr().out
    assert f"checkpoint written to {ck}" in out
    # a RoundTrace and a WorkerAssessment a round, a CheckpointSave a save
    assert f"telemetry: 6 events -> {tele}" in out
    host = _np_tree(tr.state.params)
    restored, meta = jckpt.restore(ck, jax.tree.map(np.zeros_like, host))
    assert meta["arch"] == "gemma3-smoke" and meta["rounds"] == 2
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(host),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert obs_report([tele]) == 0
    report = capsys.readouterr().out
    assert "rounds: 2" in report and "local_steps" in report
    assert obs_report([tele, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["checkpoints"]["n"] == 2
    # the round-1 checkpoint of the 2-worker run, resumed at 3 workers
    tr3 = ttrain.main(["--arch", "gemma3-1b", "--rounds", "3", "--resume",
                       os.path.join(cdir, "round_1")]
                      + QUICK[:3] + ["--workers", "3"] + QUICK[5:])
    assert tr3.n_workers == 3 and len(tr3.history) == 2
    assert all(x.shape[0] == 3 for x in tree_leaves(tr3.state.params))


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.mark.parametrize("flags", [["--pipeline", "parity"],
                                   ["--chaos", "3", "--rounds", "4"],
                                   ["--rule", "spsgd"],
                                   ["--policy", "ema(0.9)|boltzmann"]])
def test_launcher_flags_run(flags, capsys):
    rounds = ["--rounds", "2"] if "--rounds" not in flags else []
    tr = ttrain.main(["--arch", "stablelm-1.6b"] + rounds + flags + QUICK)
    out = capsys.readouterr().out
    if "--chaos" in flags:
        assert "chaos membership:" in out
    assert np.isfinite(tr.losses()).all()


def test_checkpoint_every_needs_a_dir():
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        ttrain.main(["--arch", "gemma3-1b", "--rounds", "1",
                     "--checkpoint-every", "1"] + QUICK)
