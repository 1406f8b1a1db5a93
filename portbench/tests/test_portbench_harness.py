"""The harness finds cells, configurations, traffic kinds and metric
readers by name; ``BENCHMARK.json`` keeps to the benchmark's contract; the
run imports neither JAX nor the JAX package, and the reference nothing of
the program."""

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_a_new_cell_file_is_found_without_an_edit():
    path = harness.BENCH / "workloads" / "ljspeech.throwaway-test-cell.json"
    cell = dict(harness.cell_spec("ljspeech.stream-b1"), traffic="throwaway-test-cell")
    try:
        path.write_text(json.dumps(cell))
        assert "ljspeech.throwaway-test-cell" in harness.list_cells()
        got = harness.cell_spec("ljspeech.throwaway-test-cell")
        assert harness.kind_module(got["kind"]).run is not None
        assert harness.config_spec(got["config"])["model"]["d_model"] == 256
    finally:
        path.unlink()
    assert "ljspeech.throwaway-test-cell" not in harness.list_cells()


def test_every_cell_metric_and_config_resolves():
    s = spec()
    for w in s["workloads"]:
        cell = harness.cell_spec(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        harness.kind_module(cell["kind"])
        for trace in (False, True):
            names = [e["name"] for e in harness.cell_metrics(s, w["name"], trace)]
            assert names, (w["name"], trace)
            for n in names:
                assert callable(harness.reader(n).read)
        e2e = [e["name"] for e in harness.cell_metrics(s, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
    with pytest.raises(harness.HarnessError):
        harness.cell_spec("no.such-cell")


def test_reader_falls_back_to_the_base_name():
    assert harness.reader("decode.ms_per_step.some-later-cell") is not None
    with pytest.raises(harness.HarnessError):
        harness.reader("no_such_metric.serve")


def test_benchmark_json_keeps_to_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["command"] == ["python3", "portbench/run.py"] and s["paths"] == ["portbench"]
    assert 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) < 64 * 1024
    configs = {c["name"] for c in s["configs"]}
    used = {w["config"] for w in s["workloads"]}
    assert configs == used
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (harness.ROOT / c["file"]).exists()
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            e = next(x for x in s["end_to_end"] if x["name"] == m["moves"])
            assert w in e.get("workloads", [w])
    setup = next(m for m in s["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("transformertts_tpu_torch", "transformertts_tpu",
                                             "jax", "jaxlib", "flax"), (path.name, mod)


def test_a_run_imports_no_jax_and_no_jax_package():
    """Everything a run of each kind imports, in a fresh interpreter,
    compared by whole top-level names (the port's name begins with the
    JAX package's)."""
    code = """
import sys
sys.path.insert(0, %r)
from portbench import harness
harness.import_program()
for kind in ("poisson", "backlog", "stream", "train"):
    harness.kind_module(kind)
import glob, os
for f in glob.glob(os.path.join(%r, "metrics", "*.py")):
    harness.reader(os.path.basename(f)[:-3])
import transformertts_tpu_torch.infer.api, transformertts_tpu_torch.infer.serving
import transformertts_tpu_torch.train.train_step, transformertts_tpu_torch.data.dataset
import transformertts_tpu_torch.data.prefetch, transformertts_tpu_torch.models.factory
import portbench.run, portbench.control, portbench.sweep
print(",".join(harness.banned_modules()))
""" % (str(harness.ROOT), str(harness.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ljspeech.stream-b1", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_cuda_gives_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ljspeech.stream-b1", "--seed", str(2**31 + 8), "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300, env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and out.stdout.strip() == ""
