"""BENCHMARK.json against the benchmark's contract (``contract.py``, over
whatever configurations and cells it lists), the files it names, the
imports of every benchmark module, and the command's refusals."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import contract

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the accepted benchmark's configurations and cells: later ones join them
ACCEPTED_CONFIGS = {"labels2048", "prob2048"}
ACCEPTED_CELLS = {"segment.b32", "refine.relief.b8", "refine.q16tunnel.b8"}


def test_the_top_level_keys_and_the_command():
    contract.check_top(ROOT, BENCH)


def test_names_units_and_lines():
    contract.check_names(ROOT, BENCH)


def test_configs_and_cells():
    contract.check_configs_and_cells(ROOT, BENCH)
    assert ACCEPTED_CONFIGS <= {c["name"] for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert ACCEPTED_CELLS <= set(cells)
    assert all(cells[w]["chips"] == 1 for w in ACCEPTED_CELLS)


def test_metrics():
    contract.check_metrics(ROOT, BENCH)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"mps", "call_p95_ms", "peak_mem_gib", "setup_s"} <= e2e


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path, json.loads((tmp_path / "BENCHMARK.json").read_text())


def _cell(bench, name, **kw):
    return {**bench["workloads"][0], "name": name, **kw}


def _unknown_config(root, bench):
    bench["workloads"].append(_cell(bench, "x.b1", config="nowhere"))


def _config_without_a_cell(root, bench):
    file = "benchmark/configs/spare.json"
    config = json.loads((root / bench["configs"][0]["file"]).read_text())
    (root / file).write_text(json.dumps({**config, "name": "spare"}))
    bench["configs"].append({**bench["configs"][0], "name": "spare", "file": file})


def _missing_generator(root, bench):
    (root / "benchmark" / "traffic" / "x.json").write_text(json.dumps({"generator": "nowhere"}))
    bench["workloads"].append(_cell(bench, "x.b1", traffic="x"))


def _two_chips(root, bench):
    bench["workloads"][0]["chips"] = 2


def _too_many_on_four_chips(root, bench):
    for w in bench["workloads"][:2]:
        w["chips"] = 4


def _too_many_cells(root, bench):
    for k in range(contract.MAX_CELLS):
        bench["workloads"].append(_cell(bench, f"x.b{k}", traffic=f"x{k}"))


def _reduced_differs_from_its_file(root, bench):
    bench["configs"][0]["reduced"] = ["plane"]


def _reduced_not_a_list_of_names(root, bench):
    for c in bench["configs"]:
        c["reduced"] = "plane"


def _a_name_twice(root, bench):
    bench["workloads"][1]["name"] = bench["workloads"][0]["name"]


def _a_name_with_a_space(root, bench):
    bench["per_layer"][0]["name"] = "launches per call"


def _a_layer_that_moves_setup(root, bench):
    bench["per_layer"][0]["moves"] = "setup_s"


def _a_layer_that_moves_the_peak(root, bench):
    bench["per_layer"][0]["moves"] = "peak_mem_gib"


@pytest.mark.parametrize("breach", [
    _unknown_config, _config_without_a_cell, _missing_generator, _two_chips,
    _too_many_on_four_chips, _too_many_cells, _reduced_differs_from_its_file,
    _reduced_not_a_list_of_names, _a_name_twice, _a_name_with_a_space,
    _a_layer_that_moves_setup, _a_layer_that_moves_the_peak,
], ids=lambda f: f.__name__.strip("_"))
def test_the_contract_check_finds_each_breach(tmp_path, breach):
    root, bench = _copy(tmp_path)
    contract.check(root, bench)  # the copy as it is passes
    breach(root, bench)
    with pytest.raises(AssertionError):
        contract.check(root, bench)


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
