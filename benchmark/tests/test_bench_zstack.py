"""Config #2's z-stacks in the benchmark (``zstack2048``, cell
``zstack.b50``): the configuration joined by new files and appended
entries alone; a toy copy of its cell runs correct on the CPU and its
control does not; and its three readers (``blur_roofline``,
``hist_roofline``, ``otsu_launches``) on hand-built traces."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, devtrace, harness, roofline
from benchmark.tests import contract
from benchmark.tests.toy_cells import digests, toy_root

CELL, CONFIG, TRAFFIC = "zstack.b50", "zstack2048", "stack.b50"
NEW_METRICS = ("blur_roofline", "hist_roofline", "otsu_launches")
# the files the configuration adds, relative to benchmark/
NEW_FILES = {Path(p) for p in ("configs/zstack2048.json", "entries/zstack.py",
                               "reference/zstack.py", "traffic/stack.b50.json",
                               "traffic/zstacks.py", "metrics/blur_roofline.py",
                               "metrics/hist_roofline.py", "metrics/otsu_launches.py",
                               "tests/test_bench_zstack.py")}
SEED = 2**31 + 47
TOY = "toy.zstack.b50"
SHRINK = dict(batch=4, staged=2, plane=[128, 96], particles=1, particle_r=[10, 20],
              particle_margin=24, cells=120, trace_calls=3)


def _without_zstack(bench: dict) -> dict:
    """``bench`` with the configuration's entries taken out again."""
    out = json.loads(json.dumps(bench))
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"] if m["name"] not in NEW_METRICS]
    for m in out["end_to_end"] + out["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].remove(CELL)
    return out


def test_the_configuration_joins_by_new_files_and_appended_entries(tmp_path):
    """The benchmark without the configuration's files and entries keeps
    the contract, and adding them back is adding files and appending
    entries: every file already there reads as before, and each list of
    ``BENCHMARK.json`` keeps its entries in their order, with the new ones
    last."""
    real = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in NEW_FILES:
        (tmp_path / "benchmark" / rel).unlink()
    before = _without_zstack(real)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(before, indent=2))
    contract.check(tmp_path)
    had = digests(tmp_path / "benchmark")
    now = digests(harness.ROOT / "benchmark")
    assert set(now) - set(had) == NEW_FILES
    assert all(now[k] == v for k, v in had.items())
    for k in ("configs", "workloads"):
        assert real[k][:-1] == before[k] and real[k][-1]["name"] in (CONFIG, CELL)
    names = [m["name"] for m in real["per_layer"]]
    assert names == [m["name"] for m in before["per_layer"]] + list(NEW_METRICS)
    for m, was in zip(real["end_to_end"] + real["per_layer"],
                      before["end_to_end"] + before["per_layer"]):
        assert m == was or m == {**was, "workloads": was["workloads"] + [CELL]}
    contract.check(harness.ROOT)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with a toy of the cell: its traffic shrunk,
    on the copy's ``toy_zstack2048``."""
    root = toy_root(tmp_path_factory.mktemp("bench"))
    src = root / "benchmark" / "traffic" / f"{TRAFFIC}.json"
    traffic = {**json.loads(src.read_text()), **SHRINK}
    (src.parent / f"toy.{TRAFFIC}.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({**next(w for w in bench["workloads"] if w["name"] == CELL),
                               "name": TOY, "traffic": f"toy.{TRAFFIC}",
                               "config": f"toy_{CONFIG}"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TOY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root


def _run(root, trace=False):
    spec = harness.load_spec(root, TOY)
    return harness.run_cell(root, spec, SEED, 0.3, trace, "cpu", time.perf_counter())


def test_the_toy_cell_runs_correct_and_every_limit_is_zero(root):
    contract.check(root)
    out = _run(root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    # the .synced family: the host's time between a readback and the next blur spreads the
    # cell's p95 past half of call_p95_ms's bound; no memory peak on the CPU
    assert set(out["metrics"]) == {"mps.synced", "call_p95_ms.synced", "setup_s"}
    assert out["checks"] == {k: {"value": 0, "limit": 0} for k in (
        "calls_wrong", "den_wrong", "seg_wrong", "areas_wrong", "classes_wrong")}


def test_a_traced_toy_run_reads_the_spans_and_no_device_metric_on_the_cpu(root):
    out = _run(root, trace=True)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["host_syncs_per_call.synced"] == 0.0
    # the CPU trace holds no kernel and no launch: the device's readers
    # have nothing to read
    assert not set(NEW_METRICS) & set(got)


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_the_control_fails_where_the_program_passes(root, seed):
    spec = harness.load_spec(root, TOY)
    ctl = control.control_readings(root, spec, seed, "cpu")
    assert ctl["den_wrong"][0] > 0 and any(v > lim for v, lim in ctl.values()), ctl
    prog = control.program_readings(root, spec, seed, "cpu")
    assert all(v <= lim for v, lim in prog.values()), prog


def _plane_sums(x):
    """Each plane's sum of values and of squares, sorted: what a flip or
    another order of the planes keeps."""
    v = x.view(torch.int16).to(torch.int64) & 0xFFFF
    return sorted(zip(v.sum((1, 2)).tolist(), (v * v).sum((1, 2)).tolist()))


def test_every_seed_stages_the_same_planes(root):
    """``--seed`` orders and flips the planes, never changes them."""
    spec = harness.load_spec(root, TOY)
    gen = harness.load_module(root, "traffic", spec.traffic["generator"])
    a, b = gen.make(spec.traffic, 1, "cpu"), gen.make(spec.traffic, 2**31 + 9, "cpu")
    assert [_plane_sums(x) for x in a] == [_plane_sums(x) for x in b]
    assert not any(torch.equal(x.view(torch.int16), y.view(torch.int16)) for x, y in zip(a, b))


# hand-built traces: one call of 300 us and its readback of 20 us
SHAPE = (2, 1000, 1675)  # 3.35e6 px: a float32 pass over them takes 4 us at 3.35 TB/s
RING = ("void (anonymous namespace)::blur_ring<2, true, unsigned short>(unsigned short const*, "
        "float*, int, int, int, int, long long, int, int, (anonymous namespace)::Taps)")
WINDOW = ("void (anonymous namespace)::blur_window<true, float>(float const*, float*, int, int, "
          "int, int, int, (anonymous namespace)::Taps)")
HIST = ("void (anonymous namespace)::histogram_kernel(float const*, float const*, float const*, "
        "int*, int, int, int, int)")
HARNESS = [("user_annotation", devtrace.CALL, 1000, 300),
           ("user_annotation", devtrace.READBACK, 1300, 20)]


def _ctx(tmp_path, events, bins=256):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 0}
        for c, n, ts, d in events]}))
    spec = SimpleNamespace(options={"max_regions": 4095, "bins": bins})
    entry_mod = harness.load_module(harness.ROOT, "entries", "zstack")
    return harness._trace_context(harness.ROOT, devtrace.load(path), spec, entry_mod, 1, {}, [],
                                  SHAPE)


def _read(name, ctx):
    return harness.load_module(harness.ROOT, "metrics", name).read(ctx)


def _least_us(nbytes):
    return roofline.least_seconds(nbytes) * 1e6


def test_the_roofline_readers_read_nothing_without_their_kernels(tmp_path):
    ctx = _ctx(tmp_path, HARNESS + [("kernel", "void at::native::reduce_kernel<512, 1>()", 1010, 50)])
    assert _read("blur_roofline", ctx) is None
    assert _read("hist_roofline", ctx) is None


@pytest.mark.parametrize("kernel, pixel", [(RING, 2), (WINDOW, 4)])
def test_the_blur_at_its_least_time_reads_100(tmp_path, kernel, pixel):
    px = SHAPE[0] * SHAPE[1] * SHAPE[2]
    least = _least_us(px * (pixel + 4))
    ctx = _ctx(tmp_path, HARNESS + [("kernel", kernel, 1010, least),
                                    ("kernel", kernel, 5000, 1)])  # outside the window
    value = _read("blur_roofline", ctx)
    assert value == pytest.approx(100.0, rel=1e-9) and value <= 100.0 * (1 + 1e-12)
    slower = _ctx(tmp_path, HARNESS + [("kernel", kernel, 1010, 2 * least)])
    assert _read("blur_roofline", slower) == pytest.approx(50.0, rel=1e-9)


def test_a_blur_of_an_unknown_pixel_type_reads_nothing(tmp_path):
    ctx = _ctx(tmp_path, HARNESS + [("kernel", RING.replace("unsigned short>", "double>"), 1010, 9)])
    assert _read("blur_roofline", ctx) is None


@pytest.mark.parametrize("bins", [256, 4096])
def test_the_histogram_at_its_least_time_reads_100(tmp_path, bins):
    B, px = SHAPE[0], SHAPE[0] * SHAPE[1] * SHAPE[2]
    least = _least_us(px * 4 + B * bins * 4)
    ctx = _ctx(tmp_path, HARNESS + [("kernel", HIST, 1010, least), ("kernel", RING, 1100, 8)],
               bins)
    value = _read("hist_roofline", ctx)
    assert value == pytest.approx(100.0, rel=1e-9) and value <= 100.0 * (1 + 1e-12)


OTSU = [("cpu_op", "pcis.zstack", 1002, 290), ("cpu_op", "pcis.threshold.otsu", 1050, 40)]


def test_otsu_launches_counts_the_launches_inside_the_otsu_span(tmp_path):
    launches = [
        ("cuda_runtime", "cudaLaunchKernel", 1010, 2),  # the blur: before the span
        ("cuda_runtime", "cudaLaunchKernel", 1051, 2),
        ("cuda_runtime", "cudaLaunchKernelExC", 1060, 2),
        ("cuda_driver", "cuLaunchKernel", 1060.5, 1),  # under the runtime's launch
        ("cuda_driver", "cuLaunchKernel", 1070, 1),  # a launch of its own
        ("cuda_runtime", "cudaMemsetAsync", 1075, 1),  # no kernel
        ("cuda_runtime", "cudaLaunchKernel", 1095, 2),  # after the span
    ]
    ctx = _ctx(tmp_path, HARNESS + OTSU + launches)
    assert _read("otsu_launches", ctx) == 3.0
    ctx.calls = 2
    assert _read("otsu_launches", ctx) == 1.5


def test_otsu_launches_counts_a_graphs_replay_as_one_launch(tmp_path):
    launches = [
        ("cuda_runtime", "cudaLaunchKernel", 1051, 2),  # the histogram
        ("cuda_runtime", "cudaGraphLaunch", 1060, 3),  # the reduction's graph
        ("cuda_driver", "cuGraphLaunch", 1060.5, 1),  # under the runtime's replay
        ("cuda_runtime", "cudaMemcpyAsync", 1070, 1),  # no kernel
    ]
    assert _read("otsu_launches", _ctx(tmp_path, HARNESS + OTSU + launches)) == 2.0


def test_otsu_launches_reads_nothing_without_the_span_or_a_launch(tmp_path):
    launch = [("cuda_runtime", "cudaLaunchKernel", 1051, 2)]
    assert _read("otsu_launches", _ctx(tmp_path, HARNESS + launch)) is None
    assert _read("otsu_launches", _ctx(tmp_path, HARNESS + OTSU[:1] + launch)) is None
    assert _read("otsu_launches", _ctx(tmp_path, HARNESS + OTSU)) is None


def test_the_call_bytes_and_the_span_are_the_drivers():
    zstack = harness.load_module(harness.ROOT, "entries", "zstack")
    assert zstack.SPAN == "pcis.zstack"
    assert zstack.CALL_BYTES(50, 2048, 2048, {"max_regions": 4095}) == (
        50 * 2048 * 2048 * 7 + 50 * 4096 * 8)
