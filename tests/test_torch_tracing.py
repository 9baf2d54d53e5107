"""The port's tracer (``utils/profiling.py``) and the spans of its
benchmarked entries, ``fused_segment_batch``, ``refine_plane_device`` and
``zstack_stats_device``.

On the CPU: a span off records and allocates nothing; after ``enable`` the
entries give their step trees, one call id a call; threads keep their own
stacks; kept spans lie on the profiler's clock; the tunnel's step syncs
equal its steps; the verbs' ``--profile`` prints the report.  On the card
(marker ``cuda``, run with ``python -m pytest tests/test_torch_tracing.py
-q``): every synchronising call that ``torch.cuda.set_sync_debug_mode``
reports inside an entry lies in a ``pcis.sync.*`` span, one span a call,
at the benchmark's cells' shapes.
"""

import collections
import importlib
import json
import sys
import threading
import traceback
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig, RefineConfig
from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch
from particle_col_image_segmentation_tpu_torch.models.refine import refine_plane_device
from particle_col_image_segmentation_tpu_torch.models.zstack import zstack_stats_device
from particle_col_image_segmentation_tpu_torch.ops import gaussian_blur, threshold_and_count_batch
from particle_col_image_segmentation_tpu_torch.utils import profiling

from chip_smoke import refine_relief
from fixtures import synthetic_label_plane

ws = importlib.import_module("particle_col_image_segmentation_tpu_torch.ops.watershed")

SEGMENT_TREE = {
    "pcis.segment": None,
    "pcis.segment.median": "pcis.segment",
    "pcis.segment.ccl": "pcis.segment",
    "pcis.segment.compact": "pcis.segment",
    "pcis.segment.counts": "pcis.segment",
    "pcis.segment.stats": "pcis.segment",
}
_REFINE_STEPS = {
    "pcis.refine": None,
    "pcis.refine.mask": "pcis.refine",
    "pcis.refine.edt": "pcis.refine",
    "pcis.sync.edt_certificate": "pcis.refine.edt",
    "pcis.refine.sqrt": "pcis.refine",
    "pcis.refine.maxima": "pcis.refine",
    "pcis.refine.ccl": "pcis.refine",
    "pcis.refine.compact": "pcis.refine",
    "pcis.refine.watershed": "pcis.refine",
    "pcis.watershed.phase1": "pcis.refine.watershed",
    "pcis.refine.centroids": "pcis.refine",
}
# the plain phase 2 on the CPU; K11's chunks on the card
REFINE_TREE = {**_REFINE_STEPS, "pcis.watershed.phase2": "pcis.refine.watershed",
               "pcis.sync.claim_step": "pcis.watershed.phase2"}
TUNNEL_TREE = {**_REFINE_STEPS, "pcis.watershed.tunnel": "pcis.refine.watershed",
               "pcis.sync.tunnel_step": "pcis.watershed.tunnel"}
# the threshold body's steps, config #1's and config #2's
THRESHOLD_STEPS = ("pcis.threshold.otsu", "pcis.threshold.ccl", "pcis.threshold.compact",
                   "pcis.threshold.counts")
ZSTACK_TREE = {"pcis.zstack": None, "pcis.zstack.blur": "pcis.zstack",
               **{name: "pcis.zstack" for name in THRESHOLD_STEPS}}


@pytest.fixture
def kept():
    """The tracer keeping spans, from empty; off again afterwards."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


def _planes():
    return torch.from_numpy(np.stack([
        np.asarray(synthetic_label_plane(seed=s, shape=(64, 64)), np.uint8) for s in (3, 4)]))


def _relief(levels: int = 0):
    x = torch.from_numpy(np.stack([refine_relief(96, pairs=4, seed=s) for s in (1, 2)]))
    return torch.round(x * (levels - 1)) / (levels - 1) if levels else x


def _tree(spans) -> dict:
    """{name: parent's name} of the spans; every span of a name has the same
    parent."""
    names = {s.id: s.name for s in spans}
    tree = {}
    for s in spans:
        parent = names.get(s.parent)
        assert tree.setdefault(s.name, parent) == parent, s
    return tree


def test_off_a_span_records_and_allocates_nothing():
    profiling.reset()
    assert not torch.autograd._profiler_enabled()
    assert profiling.stage("pcis.a") is profiling.stage("pcis.b", 1.0)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.stage("pcis.off"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert grown == [] and profiling.records() == []


@pytest.mark.parametrize("entry", ["segment", "refine", "tunnel"])
def test_the_entries_give_their_step_trees_one_call_id_a_call(kept, entry):
    if entry == "segment":
        planes, tree = _planes(), SEGMENT_TREE

        def call():
            fused_segment_batch(planes, AnalysisConfig())
    else:
        planes = _relief(16 if entry == "tunnel" else 0)
        cfg, tree = ((RefineConfig(tunnel_basins=True), TUNNEL_TREE) if entry == "tunnel"
                     else (RefineConfig(), REFINE_TREE))

        def call():
            refine_plane_device(planes, cfg)
    call()
    call()
    spans = profiling.records()
    assert _tree(spans) == tree
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 2 and roots[0].call != roots[1].call
    for root in roots:
        inside = [s for s in spans if root.start_ns <= s.start_ns <= root.end_ns]
        assert {s.call for s in inside} == {root.id}
    assert {s.call for s in spans} == {r.id for r in roots}


def test_the_tunnel_step_syncs_are_its_steps(kept):
    refine_plane_device(_relief(16), RefineConfig(tunnel_basins=True))
    steps = [s for s in profiling.records() if s.name == "pcis.sync.tunnel_step"]
    assert len(steps) == ws.claim_labels.last_steps > 1


def _zstack():
    rng = np.random.default_rng(5)
    x = (rng.random((3, 64, 80)) * 400).astype(np.uint16)
    x[:, 20:30, 12:40] += 3000
    x[1:, 40:44, 50:70] += 9000
    return torch.from_numpy(x)


def test_the_zstack_entry_gives_its_step_tree_and_syncs_nothing(kept):
    """``zstack_stats_device`` opens ``pcis.zstack``, its blur and the
    threshold body's four steps inside it, and no ``pcis.sync.*`` span;
    config #1's ``threshold_and_count_batch`` runs the same body under the
    same four spans, and its six outputs are the entry's."""
    x = _zstack()
    got = zstack_stats_device(x)
    spans = profiling.records()
    assert _tree(spans) == ZSTACK_TREE
    assert [s.name for s in spans if s.parent is not None and s.name != "pcis.zstack.blur"] \
        == list(THRESHOLD_STEPS)
    profiling.reset()
    six = threshold_and_count_batch(gaussian_blur(x, 1.0, fma=True), max_regions=4095)
    assert _tree(profiling.records()) == {name: None for name in THRESHOLD_STEPS}
    assert not any(s.name.startswith(profiling.SYNC) for s in spans + profiling.records())
    want = (got.mask, got.seg, got.count, got.num_fg, got.num_total, got.converged)
    for name, a, b in zip(("mask", "seg", "count", "num_fg", "num_total", "converged"), six, want,
                          strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert six[2].tolist() == [1, 2, 2] and six[4].tolist() == [2, 3, 3]


def test_threads_keep_their_own_stacks(kept):
    """More threads than cores, each nesting spans, the interpreter
    switching threads as often as it can: every inner span's parent is its
    own thread's outer span, and no record is lost."""
    threads, rounds = 16, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for _ in range(rounds):
                with profiling.stage(f"pcis.t{t}"):
                    with profiling.stage(f"pcis.t{t}.inner"):
                        pass
        pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(switch)
    spans = profiling.records()
    assert len(spans) == 2 * threads * rounds
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.endswith(".inner"):
            outer = by_id[s.parent]
            assert outer.name + ".inner" == s.name and outer.thread == s.thread
            assert s.call == outer.call == outer.id
        else:
            assert s.parent is None


def test_kept_spans_lie_on_the_profilers_clock(kept, tmp_path):
    """Each kept span starts within 1 ms of its twin in a CPU
    torch.profiler Chrome trace (the trace's ts: the system clock in µs
    less its baseTimeNanoseconds)."""
    planes = _planes()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fused_segment_batch(planes, AnalysisConfig())
        refine_plane_device(_relief(), RefineConfig())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    theirs = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("pcis."):
            theirs[ev["name"]].append(float(ev["ts"]))
    mine = collections.defaultdict(list)
    for s in profiling.records():
        mine[s.name].append((s.start_ns - base) / 1e3)
    assert set(mine) == set(theirs) and "pcis.sync.edt_certificate" in mine
    for name, starts in mine.items():
        assert len(starts) == len(theirs[name]), name
        for a, b in zip(sorted(starts), sorted(theirs[name])):
            assert abs(a - b) < 1000, (name, a, b)


def test_under_a_profiler_alone_a_span_is_an_annotation_and_not_kept(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage("pcis.annotated"):
            torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [ev.get("name") for ev in json.loads(path.read_text())["traceEvents"]]
    assert names.count("pcis.annotated") == 1 and profiling.records() == []


def test_the_report_shows_self_time_and_the_syncs_apart():
    S = profiling.Span
    spans = [S(2, "pcis.step.a", 1_000_000, 3_000_000, 1, 1, 0),
             S(3, "pcis.sync.x", 3_000_000, 4_000_000, 1, 1, 0),
             S(1, "pcis.step", 0, 10_000_000, None, 1, 0)]
    lines = profiling.report(spans)
    step = next(ln for ln in lines if ln.split()[1] == "pcis.step")
    assert step.split()[2:] == ["10.000", "1", "7.000"]
    syncs = lines.index(next(ln for ln in lines if "host syncs" in ln))
    assert "1 in 1.000 ms" in lines[syncs]
    assert lines[syncs + 1].split()[1:] == ["pcis.sync.x", "1.000", "1"]
    assert all("pcis.sync" not in ln for ln in lines[:syncs])


def test_batch_profile_prints_the_tracers_report(tmp_path, capsys):
    import h5py

    (tmp_path / "3D05_C3M10").mkdir()
    for i in range(3):
        img = synthetic_label_plane(seed=60 + i, shape=(64, 64))
        with h5py.File(tmp_path / "3D05_C3M10" / f"scan_{i}.h5", "w") as f:
            f.create_dataset("exported_data", data=img[None])
    assert torch_cli(["batch", str(tmp_path), "--device", "cpu", "--batch-size", "2",
                      "--profile"]) == 0
    assert profiling.records() == []  # the verb leaves the tracer off and empty
    out = capsys.readouterr().out
    for name in ("pcis.batch", "pcis.segment", "pcis.segment.ccl"):
        assert f"profile: {name} " in out, out
    assert "profile: host syncs" in out and "pcis.sync.batch_readback" in out


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["segment.b32", "refine.relief.b8", "refine.q16tunnel.b8",
                                  "zstack.b50"])
def test_every_host_sync_of_an_entry_is_a_sync_span_on_the_card(dev, cell):
    """One call of the cell's entry on its staged inputs under
    ``torch.cuda.set_sync_debug_mode("warn")``: each synchronising call
    lies inside a ``pcis.sync.*`` span, and there are as many as spans
    (none in ``fused_segment_batch`` and ``zstack_stats_device``)."""
    from benchmark import harness

    spec = harness.load_spec(harness.ROOT, cell)
    entry = harness.load_module(harness.ROOT, "entries", spec.config["entry"]).Entry(spec.options)
    batches = harness.load_module(harness.ROOT, "traffic", spec.traffic["generator"]).make(
        spec.traffic, 2**31 + 11, dev)
    for x in batches:  # builds and loads the kernels; warms the allocator
        entry.readback(entry.call(x))
    torch.cuda.synchronize(dev)
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = getattr(profiling._local, "stack", None) or []
            span = stack[-1].name if stack else None
            where = f"{filename}:{lineno}"
            if not (span or "").startswith(profiling.SYNC):
                where += "\n" + "".join(traceback.format_stack(limit=12)[:-2])
            seen.append((where, span))

    profiling.reset()
    profiling.enable()
    # the mode is switched outside the recorded block: the switch itself may
    # emit a warning, which is not the entry's
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            out = entry.call(batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        profiling.disable()
    spans = collections.Counter(s.name for s in profiling.records()
                                if s.name.startswith(profiling.SYNC))
    profiling.reset()
    entry.readback(out)
    outside = collections.Counter(site for site, span in seen
                                  if not (span or "").startswith(profiling.SYNC))
    print(f"{cell}: {len(seen)} syncs, spans {dict(spans)}")
    assert not outside, f"syncs outside a pcis.sync span: {dict(outside)}"
    assert len(seen) == sum(spans.values())
    if cell in ("segment.b32", "zstack.b50"):
        assert not seen
    if "tunnel" in cell:
        assert spans["pcis.sync.tunnel_step"] == entry.counters()["tunnel_steps"]
