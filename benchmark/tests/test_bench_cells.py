"""The harness end to end on the CPU, through toy cells added as new files:
a sound run is correct, its last line has the contract's keys, and a run
whose timed path is broken underneath comes out not correct."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests.toy_cells import digests, toy_root

SEED = 2**31 + 11  # seeds reach past 32 signed bits
TOYS = ("toy.segment.b32", "toy.refine.relief.b8", "toy.refine.q16tunnel.b8")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seconds=0.3):
    spec = harness.load_spec(root, cell)
    return harness.run_cell(root, spec, SEED, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", TOYS)
def test_a_cell_added_by_files_alone_runs_correct(root, cell):
    before = digests(root)
    out = _run(root, cell)
    assert digests(root) == before  # the run changed no file
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {n.split(".")[0] for n in out["metrics"]}
    assert {"mps", "setup_s"} <= names
    assert ("call_p95_ms" in names) == ("q16tunnel" not in cell)
    for c in out["checks"].values():
        assert c == {"value": 0, "limit": 0}


def test_the_toy_files_are_new_files(root):
    real = digests(harness.ROOT / "benchmark")
    copy = digests(root / "benchmark")
    assert all(copy[k] == v for k, v in real.items())
    assert sorted(set(copy) - set(real)) == sorted(
        [Path("configs/toy_labels2048.json"), Path("configs/toy_prob2048.json")]
        + [Path(f"traffic/toy.{t}.json") for t in ("b32", "relief.b8", "q16tunnel.b8")])


def test_a_traced_run_keeps_checks_last_and_reads_the_counters(root):
    out = _run(root, "toy.refine.q16tunnel.b8", trace=True)
    assert list(out)[-2:] == ["breakdown", "checks"] and out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["metrics"]["tunnel_steps"]["value"] > 0  # read on the CPU too
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _half_batch(fn):
    """The first half of the batch computed, the rest copies of it."""
    def broken(x, *a, **k):
        half = x.shape[0] // 2
        out = fn(x[:half], *a, **k)
        return tuple(torch.cat([t, t]) if isinstance(t, torch.Tensor)
                     else type(t)(*(torch.cat([c, c]) for c in t)) for t in out)
    return broken


def _altered(fn, at: int):
    """The answer altered where it is produced: output ``at`` + 1 in one
    element."""
    def broken(*a, **k):
        out = list(fn(*a, **k))
        out[at] = out[at].clone()
        out[at].view(-1)[0] += 1
        return tuple(out)
    return broken


def _faults(cell):
    from particle_col_image_segmentation_tpu_torch.models import batch, refine

    if "segment" in cell:
        mod, name = batch, "fused_segment_batch"
        unchanged = (batch, "median_label_filter_auto", lambda img, *a, **k: img)
        outputs = (0, 1)  # seg, num
    else:
        mod, name = refine, "refine_plane_device"
        unchanged = (refine, "watershed_auto",
                     lambda img, mk, mask, **k: (mk.to(torch.int32) * mask,
                                                 torch.ones(img.shape[0], dtype=torch.bool)))
        outputs = (0, 2)  # labels, num
    fn = getattr(mod, name)
    yield "half of the batch left out", (mod, name, _half_batch(fn))
    yield "a step that returns its state unchanged", unchanged
    for at in outputs:
        yield f"output {at} altered where it is produced", (mod, name, _altered(fn, at))


@pytest.mark.parametrize("cell", TOYS[:2])
def test_a_broken_timed_path_is_not_correct(root, cell, monkeypatch):
    for what, (mod, name, broken) in _faults(cell):
        with monkeypatch.context() as m:
            m.setattr(mod, name, broken)
            out = _run(root, cell, seconds=0.1)
        assert not out["correct"], what
        assert any(c["value"] > c["limit"] for c in out["checks"].values()), what
