"""BENCHMARK.json keeps to its schema's names and shapes, every cell
finds its files by name (also ones added later), and nothing a run loads
is JAX, the JAX package, or (for the reference) the program."""
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap


from conftest import ROOT, read_bench
from portbench import runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_names_units_and_keys():
    b = read_bench()
    assert set(b) == KEYS
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    b = read_bench()
    for w in b["workloads"]:
        cell = runner.find_cell(w["name"], b)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in b["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_file_is_found_by_name():
    b = read_bench()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == \
            c["name"]
    for w in b["workloads"]:
        cell = runner.find_cell(w["name"], b)
        assert cell.traffic["kind"] == "train"
        assert runner.driver(cell.traffic["kind"]).run
        assert cell.limits
    for m in b["per_layer"]:
        assert callable(runner.reader(m["name"]))


def test_an_added_cell_is_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer
    metric added as new files in a copy are found by their names."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = read_bench()
    here = tmp_path / "portbench"
    cfg = json.load(open(here / "configs" / "stablelm-3b.json"))
    cfg["name"] = "added-model"
    (here / "configs" / "added-model.json").write_text(json.dumps(cfg))
    mix = json.load(open(here / "traffic" /
                         "wasgd_p3_tau4_seq640_int4.json"))
    mix["p"] = 2
    (here / "traffic" / "added_mix.json").write_text(json.dumps(mix))
    (here / "limits" / "added_cell.json").write_text('{"energy_gap": 1}')
    (here / "metrics" / "added_metric.train.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    b["configs"].append({"name": "added-model", "source": "x",
                         "file": "portbench/configs/added-model.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "added_cell", "config": "added-model",
                           "traffic": "added_mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "added_metric.train", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "x", "moves": "train_tokens_per_s",
                           "workloads": ["added_cell"]})
    for m in b["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("added_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = runner.find_cell("added_cell", root=str(tmp_path))
    assert cell.config["name"] == "added-model" and cell.traffic["p"] == 2
    assert cell.limits == {"energy_gap": 1}
    assert [m["name"] for m in cell.per_layer] == ["added_metric.train"]
    assert runner.reader("added_metric.train", root=str(tmp_path))(None) \
        == 42.0


FORBIDDEN_CHECK = textwrap.dedent("""
    import sys, time
    sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
    import torch
    from conftest import smoke_cell
    from portbench import runner, control
    from portbench.drivers import train
    b = runner.load_json({root!r}, "BENCHMARK.json")
    for m in b["per_layer"]:
        runner.reader(m["name"])
    cell = smoke_cell("moe", "wasgd_p4_tau4_seq640_f32", "olmoe_train")
    train.run(cell, seed=5, seconds=0.01, trace=False,
              t_start=time.perf_counter(), device=torch.device("cpu"))
    print(runner.loaded_forbidden())
""")


def test_a_run_loads_no_jax_and_no_jax_package():
    code = FORBIDDEN_CHECK.format(root=ROOT, src=os.path.join(ROOT, "src"),
                                  tests=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={**os.environ,
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.lm, portbench.reference.wasgd\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    ref = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            src = open(os.path.join(ref, name)).read()
            assert not re.search(r"^\s*(from|import)\s+(repro|jax)", src,
                                 re.M), name


def test_no_harness_file_reads_the_old_benchmarks():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        if "_cache" in dirpath or "tests" in dirpath:
            continue
        for name in files:
            if name.endswith(".py"):
                src = open(os.path.join(dirpath, name)).read()
                assert "benchmarks/" not in src and \
                    "import benchmarks" not in src, name
