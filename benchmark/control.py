"""The comparison's control, and the program's readings beside it.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--program-seeds 4 5 ...]

For each of ``--seeds``, the cell's staged batches at the cell's own size go
through the plain reference computed one precision below the one the
configuration states (``compute(..., control=True)``: int16 for the int32
labels and tables of ``labels2048``, bfloat16 for the float32 maps of
``prob2048``), put in the program's place: its answers for every batch and
its full outputs for the last are judged as a run judges the program's.
Each must come out not correct.  For each of ``--program-seeds``, the
program itself answers every staged batch once after a warm-up, judged
the same way: the readings that sound runs give.  One JSON line a reading.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def control_readings(root: Path, spec, seed: int, device) -> dict:
    """The control's checks on ``seed``'s staged batches."""
    ref_mod = harness.load_module(root, "reference", spec.config["reference"])
    batches = harness.load_module(root, "traffic", spec.traffic["generator"]).make(
        spec.traffic, seed, device)
    last = len(batches) - 1
    answers, held = [], None
    for k, x in enumerate(batches):
        answer, full = ref_mod.compute(x, spec.options, control=True, full=(k == last))
        answers.append((k, answer))
        held = full or held
    checks, _ = harness.judge(ref_mod, batches, spec.options, answers, held, last,
                              spec.config["limits"])
    return checks


def program_readings(root: Path, spec, seed: int, device) -> dict:
    """The program's checks on ``seed``'s staged batches, a call each."""
    entry = harness.load_module(root, "entries", spec.config["entry"]).Entry(spec.options)
    ref_mod = harness.load_module(root, "reference", spec.config["reference"])
    batches = harness.load_module(root, "traffic", spec.traffic["generator"]).make(
        spec.traffic, seed, device)
    entry.readback(entry.call(batches[0]))
    answers = []
    for k, x in enumerate(batches):
        out = entry.call(x)
        answers.append((k, entry.answer(entry.readback(out))))
    held = entry.held(out)
    del out
    checks, _ = harness.judge(ref_mod, batches, spec.options, answers, held, len(batches) - 1,
                              spec.config["limits"])
    return checks


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(harness.ROOT, args.workload)
    for who, seeds, fn in (("program", args.program_seeds, program_readings),
                           ("control", args.seeds, control_readings)):
        for seed in seeds:
            t = time.perf_counter()
            checks = fn(harness.ROOT, spec, seed, "cuda:0")
            print(json.dumps({
                "workload": args.workload, "who": who, "seed": seed,
                "correct": all(v <= lim for v, lim in checks.values()),
                "seconds": time.perf_counter() - t,
                "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
