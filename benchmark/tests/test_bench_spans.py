"""The readers of the program's spans (``benchmark/spans.py``,
``host_syncs_per_call``, ``entry_idle_pct``, ``sync_idle_pct``) on
hand-built traces with known gaps and spans, and the entry driver's
declarations that they read (``SPAN``, ``CALL_BYTES``)."""

from __future__ import annotations

import json
import shutil
from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness, spans

K = "void (anonymous namespace)::ccl_local<int>(int const*, int*, unsigned int*, int, int, " \
    "int, int, int)"
# one call of 300 us and its readback of 20 us; the card idle at 1000-1010,
# 1140-1200 (the host in the certificate's sync), 1290-1300 and 1310-1320
DEVICE = [
    ("kernel", K, 1010, 100),
    ("kernel", K, 1110, 30),
    ("kernel", K, 1200, 50),
    ("kernel", K, 1250, 40),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1300, 10),
]
HARNESS = [
    ("user_annotation", devtrace.CALL, 1000, 300),
    ("user_annotation", devtrace.READBACK, 1300, 20),
]
PROGRAM = [
    ("cpu_op", "pcis.refine", 1005, 290),
    ("cpu_op", "pcis.refine.edt", 1005, 145),
    ("cpu_op", "pcis.sync.edt_certificate", 1130, 80),
    ("cpu_op", "pcis.sync.watershed_chunk", 900, 50),  # before the window
]


def _ctx(tmp_path, events, calls=1, entry="refine", root=harness.ROOT):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 0}
        for c, n, ts, d in events]}))
    spec = SimpleNamespace(options={"max_regions": 4095})
    entry_mod = harness.load_module(root, "entries", entry)
    return harness._trace_context(root, devtrace.load(path), spec, entry_mod, calls, {}, [],
                                  (1, 10, 10))


def _read(name, ctx):
    return harness.load_module(harness.ROOT, "metrics", harness.reader_of(name)).read(ctx)


READERS = ["host_syncs_per_call", "entry_idle_pct", "sync_idle_pct"]


def test_the_readers_on_a_call_with_a_sync(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + PROGRAM)
    assert _read("host_syncs_per_call", ctx) == 1.0
    # the idle inside pcis.refine: 1005-1010, 1140-1200, 1290-1295
    assert _read("entry_idle_pct.synced", ctx) == pytest.approx(100 * 70 / 320)
    # the gap that opens at 1140, inside the sync, to its end
    assert _read("sync_idle_pct", ctx) == pytest.approx(100 * 60 / 320)
    gaps = dict(harness._breakdown(ctx)["idle_gaps"])
    assert gaps["bench.call:pcis.sync.edt_certificate"] == pytest.approx(60e-6)
    assert gaps["bench.call:pcis.refine.edt"] == pytest.approx(10e-6)


def test_syncs_count_a_call_over_the_traced_calls(tmp_path):
    more = [("cpu_op", "pcis.sync.tunnel_step", 1212, 3),
            ("cpu_op", "pcis.sync.tunnel_step", 1252, 3)]
    ctx = _ctx(tmp_path, DEVICE + HARNESS + PROGRAM + more, calls=2)
    assert _read("host_syncs_per_call.synced", ctx) == 1.5
    # neither new sync opens a gap: the card is busy at 1212 and 1252
    assert _read("sync_idle_pct", ctx) == pytest.approx(100 * 60 / 320)


def test_a_call_with_spans_and_no_sync_reads_zero(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + [("cpu_op", "pcis.segment", 1002, 296),
                                             ("cpu_op", "pcis.segment.ccl", 1002, 200)],
               entry="segment")
    assert _read("host_syncs_per_call", ctx) == 0.0
    assert _read("sync_idle_pct", ctx) == 0.0
    # 1002-1010, 1140-1200, 1290-1298
    assert _read("entry_idle_pct", ctx) == pytest.approx(100 * 76 / 320)


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_program_spans_reads_nothing(tmp_path, name):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + [("cpu_op", "aten::item", 1150, 60),
                                             ("cuda_runtime", "cudaStreamSynchronize", 1160, 45)])
    assert _read(name, ctx) is None


def test_entry_idle_reads_nothing_without_an_entry_span(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + [("cpu_op", "pcis.sync.tunnel_step", 1130, 80)])
    assert _read("entry_idle_pct", ctx) is None
    assert _read("host_syncs_per_call", ctx) == 1.0


def test_each_entry_counts_only_its_own_span(tmp_path):
    # a segment call's span over the readback, beside the refine call's
    events = DEVICE + HARNESS + PROGRAM + [("cpu_op", "pcis.segment", 1300, 20)]
    # refine: 1005-1010, 1140-1200, 1290-1295, as without the segment span
    assert _read("entry_idle_pct", _ctx(tmp_path, events)) == pytest.approx(100 * 70 / 320)
    # segment: 1310-1320
    ctx = _ctx(tmp_path, events, entry="segment")
    assert _read("entry_idle_pct", ctx) == pytest.approx(100 * 10 / 320)


def test_an_entry_without_the_declarations_reads_nothing(tmp_path):
    """A driver that declares neither ``SPAN`` nor ``CALL_BYTES``: neither
    reader has anything to read, though the trace holds entry spans."""
    root = tmp_path / "root"
    (root / "benchmark" / "entries").mkdir(parents=True)
    shutil.copy(harness.ROOT / "benchmark" / "kernels.json", root / "benchmark")
    (root / "benchmark" / "entries" / "bare.py").write_text('"""A bare driver."""\n')
    ctx = _ctx(tmp_path, DEVICE + HARNESS + PROGRAM, entry="bare", root=root)
    assert ctx.busy_s > 0
    assert _read("entry_idle_pct", ctx) is None
    assert _read("call_roofline", ctx) is None
    assert _read("host_syncs_per_call", ctx) == 1.0


def test_interval_helpers():
    assert spans.union([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]
    assert spans.overlap_seconds([(0, 4), (6, 7)], [(1, 2), (3, 6.5)]) == 2.5
    assert spans.opened_inside([(0.5, 9), (2, 3), (5, 6)], [(0, 1), (4, 5)]) == [(0.5, 9)]
