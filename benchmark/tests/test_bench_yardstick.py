"""The yardstick: the byte counts against the bounds the port's kernel
table gives, and the per-layer readers on a recorded toy trace."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness, roofline

PX32 = 32 * 2048 * 2048
PX8 = 8 * 2048 * 2048


@pytest.mark.parametrize("nbytes, bound_ms", [
    (roofline.k2_bytes(PX32, 1), 0.2003249671641791),  # K2, [32,2048²] uint8
    (roofline.k10_bytes(PX8), 0.0901462352238806),  # K10, [8,2048²]
    (roofline.k11_bytes(PX8), 0.17027622208955223),  # K11, [8,2048²]
])
def test_byte_counts_give_the_kernel_tables_bounds(nbytes, bound_ms):
    assert math.isclose(roofline.least_seconds(nbytes) * 1e3, bound_ms, rel_tol=1e-12)


# A toy trace as torch.profiler's Chrome export writes it: one call of
# 300 us and its readback of 20 us; K2 on uint8 and on int32, a PyTorch
# kernel, a copy back; 40 us idle inside the call while the host syncs.
K2U8 = "void (anonymous namespace)::ccl_local<unsigned char>(unsigned char const*, int*, " \
       "unsigned int*, int, int, int, int, int)"
K2I32 = "void (anonymous namespace)::ccl_local<int>(int const*, int*, unsigned int*, int, int, " \
        "int, int, int)"
EVENTS = [
    ("user_annotation", devtrace.CALL, 1000, 300),
    ("user_annotation", devtrace.READBACK, 1300, 20),
    ("cpu_op", "aten::item", 1150, 60),
    ("cuda_runtime", "cudaStreamSynchronize", 1160, 45),
    ("kernel", K2U8, 1010, 100),
    ("kernel", "void (anonymous namespace)::ccl_flatten4(int*, long long)", 1110, 30),
    ("kernel", K2I32, 1200, 50),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4, "
               "at::native::FillFunctor<int>, at::detail::Array<char*, 1> >(int, "
               "at::native::FillFunctor<int>, at::detail::Array<char*, 1>)", 1250, 40),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1300, 10),
    ("kernel", K2U8, 5000, 999),  # outside the window
]


@pytest.fixture
def ctx(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 0}
        for c, n, ts, d in EVENTS]}))
    trace = devtrace.load(path)
    spec = SimpleNamespace(options={"max_regions": 4095})
    entry_mod = harness.load_module(harness.ROOT, "entries", "refine")
    return harness._trace_context(harness.ROOT, trace, spec, entry_mod, 1, {"K2": 2, "K9": 1},
                                  [{"ws_passes": 9}], (1, 10, 10))


def test_the_window_and_busy_time(ctx):
    assert ctx.window == pytest.approx((1000e-6, 1320e-6))
    assert ctx.busy_s == pytest.approx(230e-6)  # 100 + 30 + 50 + 40 + 10
    assert devtrace.idle_gaps(ctx.busy, *ctx.window) == pytest.approx(
        [(1000e-6, 1010e-6), (1140e-6, 1200e-6), (1290e-6, 1300e-6), (1310e-6, 1320e-6)])


def _read(name, ctx):
    return harness.load_module(harness.ROOT, "metrics", name).read(ctx)


def test_the_readers_on_the_toy_trace(ctx):
    assert _read("device_idle_pct", ctx) == pytest.approx(100 * (1 - 230 / 320))
    assert _read("glue_device_pct", ctx) == pytest.approx(100 * 40 / 230)
    assert _read("launches_per_call", ctx) == 3
    assert _read("ws_passes", ctx) == 9
    assert _read("tunnel_steps", ctx) is None  # nothing to read
    k2 = roofline.least_seconds(roofline.k2_bytes(100, 1) + roofline.k2_bytes(100, 4))
    assert _read("ccl_roofline", ctx) == pytest.approx(100 * k2 / 180e-6)
    refine = harness.load_module(harness.ROOT, "entries", "refine")
    call = roofline.least_seconds(refine.CALL_BYTES(1, 10, 10, {"max_regions": 4095}))
    assert _read("call_roofline", ctx) == pytest.approx(100 * call / 230e-6)


def test_the_breakdown_names_kernels_and_what_the_host_did(ctx):
    out = harness._breakdown(ctx)
    ops = dict(out["device_ops"])
    assert ops["K2 ccl_local<unsigned char>"] == pytest.approx(100e-6)
    assert ops["K2 ccl_flatten4"] == pytest.approx(30e-6)
    assert "at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, " \
           "at::detail::Array<char*, 1> >" in ops
    gaps = dict(out["idle_gaps"])
    assert gaps["bench.call:cudaStreamSynchronize"] == pytest.approx(60e-6)


def test_the_program_kernels_are_read_from_its_sources():
    names, spaces = devtrace.program_kernels(harness.ROOT / harness.PROGRAM / "csrc")
    kernels = json.loads((harness.ROOT / "benchmark" / "kernels.json").read_text())
    assert {n for ns in kernels["kernels"].values() for n in ns} <= names
    assert devtrace.is_program_kernel(K2U8, names, spaces)
    assert devtrace.is_program_kernel("void edt::row_pass<5>(int const*)", names, spaces)
    assert not devtrace.is_program_kernel(
        "void at::native::(anonymous namespace)::finalize(int)", names, spaces)
