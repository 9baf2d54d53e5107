"""The port's spans: one context manager, ``stage``, around each step of a
pipeline and around each place where the host waits on the card
(counterpart of the JAX package's ``utils/profiling.stage``).

A span named ``pcis.sync.<site>`` marks a host sync: the host blocks there
until the card has run the work queued before it (a readback of a flag, a
count or a chunk's rows).  Their number is the port's count of host syncs;
no other counter keeps it.

What a span costs follows the tracer's state:

- off (no ``torch.profiler`` recording, ``enable`` not called): one check
  and a shared null context; nothing is allocated or recorded;
- under a recording ``torch.profiler``: an annotation in the profiler's
  own trace, beside the kernels on kineto's clock;
- after ``enable()`` (the verbs' ``--profile``): besides, a ``Span``
  record in memory, stamped on the same clock (the system clock, in ns),
  with its parent span and the id of the outermost span open on its thread
  when it began (the call it belongs to).  Each thread keeps its own stack:
  the data axis runs the entries on one thread a device.

The tracer never synchronises the card.  A span's time is the host's, from
entering the block to leaving it: device work that it enqueued and did not
wait for falls outside it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections.abc import Mapping
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

SYNC = "pcis.sync."  # the prefix of a host sync's span


class Span(NamedTuple):
    """One kept span: ``start_ns``/``end_ns`` on the system clock, the
    ``parent`` span's id (None at the top of its thread's stack) and the
    ``call``, the id of the outermost span open on its thread."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    thread: int


_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_records: List[Span] = []
_keep = False


def enable() -> None:
    """Keep every span from now on (``records``, ``report``)."""
    global _keep
    _keep = True


def disable() -> None:
    """Stop keeping spans; the records stay until ``reset``."""
    global _keep
    _keep = False


def reset() -> None:
    """Drop the kept records."""
    with _lock:
        _records.clear()


def records() -> List[Span]:
    """The kept spans, in the order they ended."""
    with _lock:
        return list(_records)


class _Kept:
    """A span that ``enable`` keeps, annotated as well in a recording
    profiler's trace."""

    __slots__ = ("name", "id", "parent", "call", "start", "note")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.note = _RecordFunctionFast(self.name) if _profiler_enabled() else None
        if self.note is not None:
            self.note.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.note is not None:
            self.note.__exit__(*exc)
        _local.stack.pop()
        span = Span(self.id, self.name, self.start, end, self.parent, self.call,
                    threading.get_ident())
        with _lock:
            _records.append(span)
        return False


def stage(name: str, megapixels: Optional[float] = None):
    """A span named ``name`` around a ``with`` block (module docstring).
    ``megapixels`` is kept for the JAX package's signature and not read."""
    if _keep:
        return _Kept(name)
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


class _Totals(Mapping):
    """Host seconds by span name over the kept records, a live view."""

    def _sums(self) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        for s in records():
            sums[s.name] = sums.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
        return sums

    def __getitem__(self, name: str) -> float:
        return self._sums()[name]

    def __iter__(self):
        return iter(self._sums())

    def __len__(self) -> int:
        return len(self._sums())


STAGE_TOTALS = _Totals()


def report(spans: Optional[List[Span]] = None) -> List[str]:
    """``--profile``'s lines from the kept spans: for each name, the host ms
    in all, the spans and the self ms (less the spans directly inside it);
    the host syncs (``pcis.sync.*``) after the steps, with their wait."""
    spans = records() if spans is None else spans
    total: Dict[str, float] = {}
    count: Dict[str, int] = {}
    inner: Dict[int, float] = {}
    for s in spans:
        ms = (s.end_ns - s.start_ns) * 1e-6
        total[s.name] = total.get(s.name, 0.0) + ms
        count[s.name] = count.get(s.name, 0) + 1
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0.0) + ms
    own: Dict[str, float] = {}
    for s in spans:
        own[s.name] = own.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6 - inner.get(s.id, 0.0)
    steps = sorted((n for n in total if not n.startswith(SYNC)), key=lambda n: -total[n])
    syncs = sorted((n for n in total if n.startswith(SYNC)), key=lambda n: -total[n])
    lines = [f"profile: {'span (host time)':36s} {'ms':>10s} {'spans':>7s} {'self ms':>10s}"]
    lines += [f"profile: {n:36s} {total[n]:10.3f} {count[n]:7d} {own[n]:10.3f}" for n in steps]
    if syncs:
        lines.append(f"profile: host syncs, the host waiting on the card: {sum(count[n] for n in syncs)}"
                     f" in {sum(total[n] for n in syncs):.3f} ms")
        lines += [f"profile: {n:36s} {total[n]:10.3f} {count[n]:7d}" for n in syncs]
    return lines
