"""BENCHMARK.json against the benchmark's contract, the files it names, the
imports of every benchmark module, and the command's refusals."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_the_top_level_keys_and_the_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert ONE_LINE.match(x["why"])
    for p in BENCH["per_layer"]:
        assert ONE_LINE.match(p["layer"])


def test_configs_and_cells():
    assert [c["name"] for c in BENCH["configs"]] == ["labels2048", "prob2048"]
    assert [w["name"] for w in BENCH["workloads"]] == [
        "segment.b32", "refine.relief.b8", "refine.q16tunnel.b8"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and ONE_LINE.match(c["source"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"] == []
        for kind in ("entries", "reference"):
            key = "entry" if kind == "entries" else "reference"
            assert (ROOT / "benchmark" / kind / f"{config[key]}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "traffic" / f"{traffic['generator']}.py").is_file()


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"mps", "call_p95_ms", "peak_mem_gib", "setup_s"} <= set(e2e)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # the metric it moves is reported in every cell it lists
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert harness.reader_of(m["moves"]) == "mps"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{harness.reader_of(m['name'])}.py").is_file()
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and harness.reader_of(m["name"]).endswith("_roofline")
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        spec = harness.load_spec(ROOT, cell)
        assert "setup_s" in {m["name"] for m in spec.end_to_end} and len(spec.end_to_end) > 1
        assert spec.per_layer


FORBIDDEN = {"jax", "jaxlib", "flax", "particle_col_image_segmentation_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not set(tops) & FORBIDDEN, (path, tops)


def test_the_check_for_loaded_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "particle_col_image_segmentation_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_the_command_refuses_without_a_card_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "segment.b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "segment.b32",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
