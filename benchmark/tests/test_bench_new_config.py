"""A configuration that joins the benchmark by new files and new entries in
``BENCHMARK.json`` alone (``toy_median/``: an entry driver that is neither
``segment`` nor ``refine``, with its plain reference, generator, traffic
mix and configuration): the contract holds on the copy, a run on the CPU
is correct, a traced run reads ``call_roofline`` and ``entry_idle_pct``
from the driver's own declarations, and no file already there changes."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from benchmark import devtrace, harness, roofline
from benchmark.tests import contract
from benchmark.tests.toy_cells import add_toy_config, digests, toy_root

SEED = 2**31 + 29
CELL = "toy.median.b2"


@pytest.fixture(scope="module")
def joined(tmp_path_factory):
    root = toy_root(tmp_path_factory.mktemp("bench"))
    before = digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    added = add_toy_config(root)
    return root, before, bench, added


def _run(root, trace=False):
    spec = harness.load_spec(root, CELL)
    return harness.run_cell(root, spec, SEED, 0.3, trace, "cpu", time.perf_counter())


def test_the_contract_holds_on_the_copy(joined):
    root, _, _, _ = joined
    contract.check(root)


def test_no_file_already_there_changes(joined):
    root, before, old, added = joined
    after = digests(root)
    bench_json = Path("BENCHMARK.json")
    assert all(after[k] == v for k, v in before.items() if k != bench_json)
    assert set(after) - set(before) == {Path("benchmark") / a for a in added}
    assert {a.parts[0] for a in added} == {"entries", "reference", "traffic", "configs"}
    # BENCHMARK.json: the entries already there stand, the new ones follow
    new = json.loads((root / "BENCHMARK.json").read_text())
    for k in ("configs", "workloads"):
        assert new[k][:len(old[k])] == old[k] and len(new[k]) == len(old[k]) + 1
    assert new["configs"][-1]["reduced"] == ["plane"]
    for m, was in zip(new["end_to_end"] + new["per_layer"], old["end_to_end"] + old["per_layer"]):
        if m != was:
            assert m == {**was, "workloads": was["workloads"] + [CELL]}


def test_a_run_of_the_new_cell_is_correct(joined):
    root, _, _, _ = joined
    out = _run(root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert {"mps", "setup_s"} <= set(out["metrics"])
    assert out["checks"] == {"calls_wrong": {"value": 0, "limit": 0},
                             "den_wrong": {"value": 0, "limit": 0}}


def test_a_traced_run_reads_the_entry_drivers_declarations(joined, monkeypatch):
    """The CPU has no device, so the loaded trace gets one kernel over the
    first half of each traced call: the readers then have busy time."""
    root, _, _, _ = joined
    load = devtrace.load

    def with_kernels(path):
        trace = load(path)
        trace.kernels += [("toy_kernel", s, (s + e) / 2)
                          for _, n, s, e in trace.host if n == devtrace.CALL]
        return trace

    monkeypatch.setattr(devtrace, "load", with_kernels)
    out = _run(root, trace=True)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    B, H, W = 2, 128, 96
    least = roofline.least_seconds(B * H * W * 2)  # the driver's CALL_BYTES
    per_call = out["device"]["busy_s"] / out["attempted"]
    assert got["call_roofline"] == pytest.approx(100 * least / per_call)
    # the card idles in the second half of each call, inside pcis.toy_median
    assert 0 < got["entry_idle_pct"] < 100
    assert got["device_idle_pct"] > 0
