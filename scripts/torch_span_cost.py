#!/usr/bin/env python3
"""What the port's spans cost on this host, and how many a call of each
benchmark cell opens.

Run from the root of a checkout that holds the port and ``benchmark/``:

    python3 scripts/torch_span_cost.py [--device cuda:0]

Prints the card's name and power limit, then one JSON line: µs a span
(``with stage(...)``) off, under a recording ``torch.profiler`` (CPU and
CUDA activities, as the benchmark's traced runs), and kept after
``profiling.enable()``, each the best of 5 rounds of 100,000 spans, beside
an empty ``with`` on a shared null context and the unconditional
``torch.profiler.record_function`` of the earlier tracer; then, for each
cell of ``BENCHMARK.json``, the spans and the host syncs (``pcis.sync.*``)
of one call of its entry on its staged inputs.
"""

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import timeit

sys.path.insert(0, os.getcwd())


def per_span_us(fn, number: int = 100_000) -> float:
    return min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e6


def costs() -> dict:
    import torch

    from particle_col_image_segmentation_tpu_torch.utils import profiling

    null = contextlib.nullcontext()

    def bare():
        with null:
            pass

    def span():
        with profiling.stage("pcis.cost"):
            pass

    def record_function():
        with torch.profiler.record_function("pcis.cost"):
            pass

    out = {"null_with_us": per_span_us(bare), "off_us": per_span_us(span),
           "record_function_off_us": per_span_us(record_function)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["profiler_us"] = per_span_us(span, 20_000)
    profiling.enable()
    try:
        out["kept_us"] = per_span_us(span)
    finally:
        profiling.disable()
        profiling.reset()
    return out


def spans_per_call(device) -> dict:
    import torch

    from benchmark import harness
    from particle_col_image_segmentation_tpu_torch.utils import profiling

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    out = {}
    for w in bench["workloads"]:
        spec = harness.load_spec(harness.ROOT, w["name"])
        entry = harness.load_module(harness.ROOT, "entries", spec.config["entry"]).Entry(
            spec.options)
        batches = harness.load_module(harness.ROOT, "traffic", spec.traffic["generator"]).make(
            spec.traffic, 2**31 + 3, device)
        for x in batches:
            entry.readback(entry.call(x))
        profiling.reset()
        profiling.enable()
        try:
            entry.readback(entry.call(batches[0]))
        finally:
            profiling.disable()
        names = collections.Counter(s.name for s in profiling.records())
        profiling.reset()
        out[w["name"]] = {
            "spans": sum(names.values()),
            "syncs": sum(n for k, n in names.items() if k.startswith(profiling.SYNC)),
            "by_name": dict(names), "counters": entry.counters()}
        del batches, entry
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    record = {"card": card, "torch": torch.__version__, "costs": costs(),
              "cells": spans_per_call(torch.device(args.device))}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
