"""Small copies of the benchmark's cells for tests on the CPU, where the
program runs its plain versions.

``toy_root`` copies ``BENCHMARK.json`` and ``benchmark/`` into a directory and
adds, as new files only, a toy configuration a configuration
(``toy_<config>``, its copy), one toy traffic mix a cell (the cell's own,
shrunk) and a toy cell on the two: ``toy.<cell>``.  ``add_toy_config``
adds to such a copy a configuration of an entry of its own
(``toy_median/``), as a later change would: new files, new entries.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import torch

# the tests run in several worker processes: one thread each keeps the
# small plain ops from contending for the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
TOY_CONFIG = Path(__file__).resolve().parent / "toy_median"

# a plane of more than 2**15 pixels, so that int16 labels and areas wrap
SHRINK = {
    "b32": dict(batch=2, staged=2, plane=[256, 192], particles=2, particle_r=[10, 20],
                particle_margin=24, cells=60, trace_calls=4),
    "relief.b8": dict(batch=2, staged=2, plane=[128, 96], pairs=8, margin=20, r2=[20, 60],
                      trace_calls=4),
    "q16tunnel.b8": dict(batch=2, staged=2, plane=[128, 96], pairs=8, margin=20,
                         r2=[20, 60], trace_calls=2),
}


def toy_root(tmp: Path) -> Path:
    """A copy of the benchmark with a toy cell beside each cell whose
    traffic ``SHRINK`` shrinks."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in list(bench["configs"]):
        config = json.loads((tmp / c["file"]).read_text())
        name = f"toy_{c['name']}"
        file = f"benchmark/configs/{name}.json"
        (tmp / file).write_text(json.dumps({**config, "name": name}))
        bench["configs"].append({**c, "name": name, "file": file})
    for w in list(bench["workloads"]):
        if w["traffic"] not in SHRINK:
            continue
        src = tmp / "benchmark" / "traffic" / f"{w['traffic']}.json"
        traffic = {**json.loads(src.read_text()), **SHRINK[w["traffic"]]}
        name = f"toy.{w['traffic']}"
        (src.parent / f"{name}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({**w, "name": f"toy.{w['name']}", "traffic": name,
                                   "config": f"toy_{w['config']}"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(f"toy.{w['name']}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return tmp


def digests(root: Path) -> dict:
    """sha256 of every file under ``root``, by its path relative to it."""
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def add_toy_config(root: Path) -> list:
    """Add the configuration laid out under ``toy_median/`` as under
    ``benchmark/`` to the copy at ``root``: its files as new files under
    ``benchmark/``, and its configurations and cells as new entries of
    ``BENCHMARK.json``, listed as well by the metrics that
    ``benchmark_entries.json`` says they report.  Returns the new files,
    relative to ``benchmark/``."""
    added = []
    for f in sorted(TOY_CONFIG.rglob("*")):
        if not f.is_file() or f.name == "benchmark_entries.json" or "__pycache__" in f.parts:
            continue
        rel = f.relative_to(TOY_CONFIG)
        dst = root / "benchmark" / rel
        if dst.exists():
            raise FileExistsError(dst)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(f, dst)
        added.append(rel)
    new = json.loads((TOY_CONFIG / "benchmark_entries.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += new["configs"]
    bench["workloads"] += new["workloads"]
    cells = [w["name"] for w in new["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in new["reports"]:
            m["workloads"] += cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return added
