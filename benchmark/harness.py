"""One run of one benchmark cell, driven by ``BENCHMARK.json`` and the files
it names.

A cell names a configuration (``configs/<config>.json``: the program's
options, its entry driver ``entries/<entry>.py``, its plain reference
``reference/<reference>.py`` and the limits of the comparison) and a traffic
mix (``traffic/<traffic>.json``: the parameters of the input generator
``traffic/<generator>.py``, the batches staged, the warm-up, and any option
the mix sets).  Every metric is read by ``metrics/<name>.py``.  An entry
driver declares at module level what the readers need of its calls:
``CALL_BYTES(B, H, W, options)``, the least bytes of one call, and
``SPAN``, the name of the program's span around one call.  So a
configuration joins by new files and new entries in ``BENCHMARK.json``.

A run stages a few distinct batches on the card from the seed, warms every
one up (set-up), then calls the entry in a closed loop, one caller, cycling
through the batches, for the window: a call is dispatched, and its answers
read back to the host before the next is dispatched.  Once the window has
closed, the reference works every staged batch out again from the same
inputs, and every call's answers, and the last call's full outputs, are
compared with it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import devtrace

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "particle_col_image_segmentation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "particle_col_image_segmentation_tpu")
SAMPLE = 64  # window calls whose answers are compared, besides the last


class Refused(Exception):
    """A run that must print no result (exit code ``code``)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def load_module(root: Path, kind: str, name: str):
    """``<root>/benchmark/<kind>/<name>.py`` as a module."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_of(metric: str) -> str:
    """A metric's reader, ``metrics/<quantity>.py``: the quantity is its
    name before any '.', so that ``mps.host`` is read as ``mps`` is."""
    return metric.split(".")[0]


def load_spec(root: Path, cell: str) -> SimpleNamespace:
    """The cell, its configuration and traffic, the program's options (the
    configuration's, then the traffic's) and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise Refused(2, f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    options = {**config["program"], **traffic.get("program", {})}

    def mine(metrics):
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    return SimpleNamespace(cell=w, config=config, traffic=traffic, options=options,
                           end_to_end=mine(bench["end_to_end"]),
                           per_layer=mine(bench["per_layer"]))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _same(answer: dict, ref: dict) -> bool:
    return all(k in answer and np.shape(answer[k]) == np.shape(v)
               and np.array_equal(np.asarray(answer[k], np.int64), v) for k, v in ref.items())


def _wrong(t: torch.Tensor, r: torch.Tensor) -> int:
    """Elements of a held output that differ from the reference's."""
    if t.shape != r.shape:
        return max(t.numel(), r.numel())
    return int((t.to(torch.float64) != r.to(torch.float64)).sum())


def judge(ref_mod, batches, options, answers, held, last: int, limits: dict,
          control: bool = False) -> tuple:
    """(checks {name: (value, limit)}, answers wrong) of answers [(batch,
    fields)] and the ``held`` full outputs of a call on batch ``last``,
    against the reference (at a lower precision with ``control``)."""
    refs = {}
    for k in sorted({k for k, _ in answers} | {last}):
        refs[k] = ref_mod.compute(batches[k], options, control=control, full=(k == last))
    wrong = sum(not _same(a, refs[k][0]) for k, a in answers)
    checks = {"calls_wrong": wrong}
    for name, t in held.items():
        checks[f"{name}_wrong"] = _wrong(t, refs[last][1][name])
    return {k: (v, limits[k]) for k, v in checks.items()}, wrong


def _trace_context(root: Path, trace: devtrace.Trace, spec, entry_mod, calls: int,
                   launches: dict, per_call: list, shape: tuple) -> SimpleNamespace:
    """What the per-layer readers read: the trace and its window, the traced
    calls' counts, and the declarations of the entry driver's module
    ``entry_mod`` (None where it makes none): ``CALL_BYTES``, a call's least
    bytes, and ``SPAN``, the program's span around a call."""
    lo, hi = trace.window()
    busy = devtrace.busy(trace, lo, hi)
    kernels = json.loads((root / "benchmark" / "kernels.json").read_text())
    names, spaces = devtrace.program_kernels(ROOT / PROGRAM / "csrc")
    return SimpleNamespace(
        trace=trace, window=(lo, hi), window_s=hi - lo, busy=busy,
        busy_s=devtrace.busy_seconds(busy), calls=calls, launches=launches, per_call=per_call,
        shape=tuple(shape), options=spec.options,
        call_bytes=getattr(entry_mod, "CALL_BYTES", None), span=getattr(entry_mod, "SPAN", None),
        kernels=kernels, program_names=names, program_spaces=spaces)


def _breakdown(ctx) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, ten of each."""
    lo, hi = ctx.window
    by_op: dict = {}
    k_of = {n: k for k, ns in ctx.kernels["kernels"].items() for n in ns}
    for name, s, e in ctx.trace.kernels + ctx.trace.copies:
        if e <= lo or s >= hi:
            continue
        label = devtrace.display_name(name)
        if devtrace.is_program_kernel(name, ctx.program_names, ctx.program_spaces):
            label = f"{k_of.get(devtrace.kernel_base(name).split('::')[-1], 'csrc')} {label}"
        by_op[label] = by_op.get(label, 0.0) + (min(e, hi) - max(s, lo))
    by_host: dict = {}
    gaps = devtrace.idle_gaps(ctx.busy, lo, hi)
    for (s, e), what in zip(gaps, devtrace.host_at(ctx.trace, [(s + e) / 2 for s, e in gaps])):
        by_host[what] = by_host.get(what, 0.0) + (e - s)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def run_cell(root: Path, spec, seed: int, seconds: float, trace: bool, device, t0: float,
             chips: int = 1) -> dict:
    """One run of a cell on ``device``; the result line as a dict."""
    opts, traffic = spec.options, spec.traffic
    entry_mod = load_module(root, "entries", spec.config["entry"])
    entry = entry_mod.Entry(opts)
    ref_mod = load_module(root, "reference", spec.config["reference"])
    t_imported = time.perf_counter()
    batches = load_module(root, "traffic", traffic["generator"]).make(traffic, seed, device)
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    t_staged = time.perf_counter()
    for _ in range(traffic["warmup_rounds"]):
        for x in batches:
            entry.readback(entry.call(x))
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    prof = None
    if trace:
        from particle_col_image_segmentation_tpu_torch import _kernels
        reset_launches, read_launches = _kernels.launch_counters()
        reset_launches()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    span = torch.profiler.record_function if trace else (lambda _: contextlib.nullcontext())
    max_calls = traffic["trace_calls"] if trace else None
    # the answers compared: a uniform sample of the window's calls drawn
    # from the seed (reservoir sampling), and the last call's
    pick = random.Random(seed)
    sample, latencies, per_call = [], [], []
    gc.collect()
    gc.disable()  # the harness's own garbage is collected after the window
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        k = i % len(batches)
        t = time.perf_counter()
        with span(devtrace.CALL):
            out = entry.call(batches[k])
        with span(devtrace.READBACK):
            host = entry.readback(out)
        done = time.perf_counter()
        latencies.append(done - t)
        if i < SAMPLE:
            sample.append((k, host))
        elif (j := pick.randrange(i + 1)) < SAMPLE:
            sample[j] = (k, host)
        if trace:
            per_call.append(entry.counters())
        i += 1
        if done >= deadline or (max_calls and i >= max_calls):
            break
        del out
    window_s = done - start
    gc.enable()
    launches = None
    if trace:
        prof.stop()
        launches = read_launches()
    loaded = forbidden_modules()
    if loaded:
        raise Refused(3, f"modules that the benchmark may not load are loaded: {loaded}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    held = entry.held(out)
    del out
    t_ref = time.perf_counter()
    answers = [(b, entry.answer(h)) for b, h in sample + [(k, host)]]
    checks, wrong = judge(ref_mod, batches, opts, answers, held, k, spec.config["limits"])
    print(f"benchmark: set-up {setup_s:.3f} s (imports {t_imported - t0:.3f}, inputs "
          f"{t_staged - t_imported:.3f}, warm-up {t0 + setup_s - t_staged:.3f}), window {window_s:.3f} s of {i} calls "
          f"({len(answers)} compared), reference {time.perf_counter() - t_ref:.3f} s; median "
          f"call ms by tenths of the window: "
          f"{[round(float(np.median(c)) * 1e3, 4) for c in np.array_split(latencies, 10) if len(c)]}",
          file=sys.stderr)
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": i,
        "failed": wrong,
        "metrics": {},
        "device": {
            "platform": "gpu" if cuda else torch.device(device).type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": chips,
            "memory_peak_bytes": int(max(setup_peak, peak)),
        },
    }
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            tr = devtrace.load(path)
        ctx = _trace_context(root, tr, spec, entry_mod, i, launches, per_call, batches[0].shape)
        result["device"]["busy_s"] = ctx.busy_s
        result["device"]["window_s"] = ctx.window_s
        metrics = spec.per_layer
    else:
        ctx = SimpleNamespace(latencies=latencies, window_s=window_s, calls=i,
                              megapixels=batches[0].numel() / 1e6, peak_bytes=peak,
                              setup_s=setup_s)
        metrics = spec.end_to_end
    for m in metrics:
        value = load_module(root, "metrics", reader_of(m["name"])).read(ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        result["breakdown"] = _breakdown(ctx)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None, t0: float | None = None, root: Path = ROOT) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_spec(root, args.workload)
        chips = spec.cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(2, f"{args.workload} needs {chips} CUDA card(s); "
                             f"{torch.cuda.device_count()} visible")
        result = run_cell(root, spec, args.seed, args.seconds, bool(args.trace), "cuda:0", t0,
                          chips)
        loaded = forbidden_modules()
        if loaded:
            raise Refused(3, f"modules that the benchmark may not load are loaded: {loaded}")
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
