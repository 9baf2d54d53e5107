"""The benchmark's contract, checked over whatever ``BENCHMARK.json`` holds.

Each ``check_*`` takes the root of a checkout and its ``BENCHMARK.json`` as
read, and fails an ``assert`` at the first breach.  The tests run them on
the repository itself and on copies with a configuration added as new
files (``toy_cells``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")
MAX_CELLS = 24
END_TO_END_KEYS = {"name", "unit", "better", "bound", "source"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
# end-to-end metrics that no per-layer metric moves: set-up and the memory
# peak are not the pace of the work that a layer speeds up or slows down
NOT_MOVED = {"setup_s", "peak_mem_gib"}


def check_top(root: Path, bench: dict) -> None:
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def check_names(root: Path, bench: dict) -> None:
    """Names are unique and of the contract's letters; units, lines."""
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)), names
    for n in names + [w[k] for w in bench["workloads"] for k in ("config", "traffic")]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for x in bench["configs"] + bench["workloads"]:
        assert ONE_LINE.match(x["why"]), x["name"]
    for c in bench["configs"]:
        assert ONE_LINE.match(c["source"]), c["name"]
    for p in bench["per_layer"]:
        assert ONE_LINE.match(p["layer"]), p["name"]


def check_configs_and_cells(root: Path, bench: dict) -> None:
    """Every configuration has a cell and every cell a configuration; the
    files they name exist; ``reduced`` agrees with the configuration's
    file; at most ``MAX_CELLS`` cells, a quarter of them (rounded down, but
    one always) on four chips."""
    configs = {c["name"]: c for c in bench["configs"]}
    cells = bench["workloads"]
    assert 1 <= len(configs) and 1 <= len(cells) <= MAX_CELLS
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files)), files
    for name, c in configs.items():
        assert set(c) == {"name", "source", "file", "reduced", "why"}, name
        assert any(Path(c["file"]).is_relative_to(p) for p in bench["paths"]), c["file"]
        assert (root / c["file"]).is_file(), c["file"]
        config = json.loads((root / c["file"]).read_text())
        assert config["name"] == name
        reduced = c["reduced"]
        assert isinstance(reduced, list) and len(reduced) <= 16, name
        assert all(isinstance(k, str) and NAME.match(k) for k in reduced), reduced
        assert config["reduced"] == reduced, name
        assert (root / "benchmark" / "entries" / f"{config['entry']}.py").is_file(), name
        assert (root / "benchmark" / "reference" / f"{config['reference']}.py").is_file(), name
        assert any(w["config"] == name for w in cells), f"configuration {name} has no cell"
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs)), pairs
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w["name"]
        assert w["config"] in configs, w["name"]
        assert w["chips"] in (1, 4), w["name"]
        traffic = json.loads(
            (root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (root / "benchmark" / "traffic" / f"{traffic['generator']}.py").is_file()
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4), f"{four} of {len(cells)} cells ask for 4 chips"


def check_metrics(root: Path, bench: dict) -> None:
    """Each metric has its reader, lists only cells that exist and, on a
    per-layer metric, only cells that report the end-to-end metric it
    moves, which is the pace of the work (none of ``NOT_MOVED``); every
    cell reports ``setup_s``, another end-to-end metric and a per-layer
    one."""
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == END_TO_END_KEYS, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == PER_LAYER_KEYS, m["name"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e, m["name"]
        assert harness.reader_of(m["moves"]) not in NOT_MOVED, m["name"]
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
        assert (root / "benchmark" / "metrics" / f"{harness.reader_of(m['name'])}.py").is_file()
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and harness.reader_of(m["name"]).endswith("_roofline")
    for cell in cells:
        spec = harness.load_spec(root, cell)
        reported = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in reported and len(reported) > 1 and spec.per_layer, cell


CHECKS = (check_top, check_names, check_configs_and_cells, check_metrics)


def check(root: Path, bench: dict | None = None) -> None:
    """Every check on the checkout at ``root``."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    for fn in CHECKS:
        fn(root, bench)
