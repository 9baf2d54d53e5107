"""Pipeline-stage tracing: a ``torch.profiler`` range plus wall-time and MP/s
logging (counterpart of the JAX package's ``utils/profiling.stage``)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger

_log = get_logger("profile")

# cumulative time per stage name for this process (``analyze --profile``)
STAGE_TOTALS: Dict[str, float] = {}


def timing_device(device=None) -> torch.device:
    """The device whose clock times a stage: ``device``, or by default the
    current CUDA device where CUDA is present, else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def stage(
    name: str, megapixels: Optional[float] = None, *, device=None
) -> Iterator[None]:
    """Annotate a pipeline stage for ``torch.profiler`` traces and log its
    time.  On a CUDA device the time runs between two CUDA events on the
    current stream and the exit waits for the second, so it covers the
    device work the stage enqueued, not just its launch.

    ``device`` defaults to the current CUDA device where CUDA is present
    (so a stage that enqueues work on the card is never timed by the host
    clock alone), else to the CPU's wall clock."""
    device = timing_device(device)
    cuda = device.type == "cuda"
    with torch.profiler.record_function(name):
        if cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.perf_counter()
        yield
        if cuda:
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
    STAGE_TOTALS[name] = STAGE_TOTALS.get(name, 0.0) + dt
    if megapixels is not None and dt > 0:
        _log.debug("%s: %.1f ms (%.1f MP/s)", name, dt * 1e3, megapixels / dt)
    else:
        _log.debug("%s: %.1f ms", name, dt * 1e3)
