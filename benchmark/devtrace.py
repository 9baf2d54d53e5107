"""Reading a torch.profiler Chrome trace of the measured window.

Device activity is the kernels, copies and memsets on the card; host
activity is the CPU ops, CUDA runtime calls and the harness's own
annotations (``bench.call``, ``bench.readback``).  Times are in seconds on
the trace's clock, which kineto shares between host and device.
"""

from __future__ import annotations

import heapq
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
CALL = "bench.call"
READBACK = "bench.readback"


@dataclass
class Trace:
    kernels: list = field(default_factory=list)  # (name, start, end)
    copies: list = field(default_factory=list)  # (name, start, end): memcpy and memset
    host: list = field(default_factory=list)  # (cat, name, start, end)

    def window(self):
        """(start, end) of the traced calls: the first call's start to the
        last readback's end."""
        spans = [(s, e) for c, n, s, e in self.host
                 if c == "user_annotation" and n in (CALL, READBACK)]
        return min(s for s, _ in spans), max(e for _, e in spans)


def load(path) -> Trace:
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    t = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts = float(ev["ts"])
        span = (name, ts * 1e-6, (ts + float(ev["dur"])) * 1e-6)
        if cat == "kernel":
            t.kernels.append(span)
        elif cat in DEVICE_CATS:
            t.copies.append(span)
        elif cat in HOST_CATS:
            t.host.append((cat,) + span)
    return t


def busy(trace: Trace, lo: float, hi: float) -> list:
    """The union of device activity inside [lo, hi], as sorted disjoint
    (start, end) intervals."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.kernels + trace.copies
                   if e > lo and s < hi)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_seconds(intervals) -> float:
    return sum(e - s for s, e in intervals)


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] with no device activity, (start, end)."""
    gaps, t = [], lo
    for s, e in intervals:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_at(trace: Trace, times) -> list:
    """What the host was doing at each of ``times``: the harness's
    annotation and the innermost op or runtime call running then.  One
    sweep over the host spans, sorted by start."""
    spans = sorted((s, e, c, n) for c, n, s, e in trace.host)
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [""] * len(times)
    open_, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            heapq.heappush(open_, (spans[j][1], j))
            j += 1
        while open_ and open_[0][0] <= t:
            heapq.heappop(open_)
        around = sorted((spans[k][1] - spans[k][0], spans[k][2], spans[k][3]) for _, k in open_)
        phase = next((n for _, c, n in around
                      if c == "user_annotation" and n.startswith("bench.")), "bench.between")
        inner = [n for _, c, n in around if not n.startswith("bench.")]
        out[i] = f"{phase}:{inner[0]}" if inner else phase
    return out


_ANON = "(anonymous namespace)::"


def kernel_base(name: str) -> str:
    """A demangled kernel name's qualified name without its return type,
    template arguments, parameters or anonymous namespaces:
    ``void (anonymous namespace)::ccl_local<unsigned char>(...)`` ->
    ``ccl_local``."""
    s = name.replace(_ANON, "")
    if s.startswith("void "):
        s = s[5:]
    return re.split(r"[<(]", s, maxsplit=1)[0].strip()


def template_args(name: str) -> str:
    """The text between a kernel name's first template brackets."""
    s = name.replace(_ANON, "")
    i = s.find("<")
    if i < 0:
        return ""
    depth = 0
    for j in range(i, len(s)):
        depth += {"<": 1, ">": -1}.get(s[j], 0)
        if depth == 0:
            return s[i + 1:j]
    return s[i + 1:]


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)\s*)?(\w+)\s*\(")
_NAMESPACE = re.compile(r"namespace\s+(\w+)\s*\{")


def program_kernels(csrc: Path) -> tuple:
    """(kernel names, named namespaces) declared in the program's CUDA
    sources: the kernels it builds by hand."""
    names, spaces = set(), set()
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        names.update(_GLOBAL.findall(text))
        spaces.update(_NAMESPACE.findall(text))
    return names, spaces


def is_program_kernel(name: str, names: set, spaces: set) -> bool:
    """Whether a traced kernel is one of the program's own, not PyTorch's."""
    parts = kernel_base(name).split("::")
    return parts[-1] in names and all(p in spaces for p in parts[:-1])


def display_name(name: str, width: int = 120) -> str:
    """A kernel's name for the breakdown: no return type, no anonymous
    namespaces, no parameter list, at most ``width`` characters."""
    s = name.replace(_ANON, "")
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, ch in enumerate(s):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            s = s[:i]
            break
    return s[:width]
