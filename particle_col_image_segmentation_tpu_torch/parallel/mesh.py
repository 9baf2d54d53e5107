"""The device mesh, and the worker threads that run its data axis.

Counterpart of ``particle_col_image_segmentation_tpu/parallel/mesh.py``: a
2-axis grid of devices, "data" (the batch of planes) by "space" (plane
rows).  ``run_per_device`` runs one call on each device of a list, one
thread a device, as ``torch.nn.parallel.parallel_apply`` does: refine syncs
the host inside a call (a chunk of watershed passes), so only a thread per
device lets the devices overlap.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger

DATA_AXIS = "data"
SPACE_AXIS = "space"

_log = get_logger("mesh")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``[n_data][n_space]`` grid of ``torch.device``.  ``shape`` maps
    the axis names to their sizes, as JAX's ``mesh.shape`` does; ``flat``
    lists the devices row by row."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), SPACE_AXIS: len(self.devices[0])}

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        return tuple(d for row in self.devices for d in row)


def make_mesh(
    n_data: Optional[int] = None,
    n_space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over ``n_data × n_space`` devices (defaults to every CUDA card,
    ``cuda:0`` … ``cuda:{device_count() - 1}``, on the data axis).

    An explicit ``devices`` list may name one device more than once: each
    entry is one mesh position, with a worker of its own.  ``["cpu"] * n``
    runs the mesh path on the CPU, and ``["cuda:0"] * n`` runs it on one
    card (its workers then share the card's stream and run one after the
    other)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    derived = n_data is None
    if n_data is None:
        n_data = len(devices) // n_space
    use = n_data * n_space
    if use == 0 or use > len(devices) or (derived and use != len(devices)):
        # an empty or oversubscribed mesh would fail later and opaquely, and
        # a DERIVED n_data silently dropping the remainder devices runs the
        # job degraded with no signal
        raise ValueError(
            f"mesh {n_data}×{n_space} needs {use or n_space} devices, have "
            f"{len(devices)} — pick axis sizes that divide the device count "
            "(or pass explicit n_data for an intentional subset)"
        )
    if use < len(devices):  # explicit subset: allowed, but never silent
        _log.info("mesh %d×%d uses %d of %d devices", n_data, n_space, use, len(devices))
    return Mesh(tuple(tuple(devices[i * n_space:(i + 1) * n_space]) for i in range(n_data)))


def run_per_device(fn: Callable, devices: Sequence, args: Sequence[tuple]) -> list:
    """``[fn(*args[i]) for i]``, call ``i`` on ``devices[i]``, one thread a
    device (the caller's thread when there is one device); results in
    device order.

    A worker on a CUDA device runs under ``torch.cuda.device`` of it and on
    the caller's current stream of that device, so what the caller enqueued
    there before (the loader's copies) is ordered before the worker's
    launches.  Every worker is joined before the first failure (in device
    order) is raised in the caller as it was raised, its device logged (and
    added as a note, on Python ≥ 3.11)."""
    devices = [torch.device(d) for d in devices]
    if len(args) != len(devices):
        raise ValueError(f"run_per_device: {len(args)} argument tuples for {len(devices)} devices")
    if any(d.type == "cuda" for d in devices):
        from particle_col_image_segmentation_tpu_torch import _kernels

        _kernels.library()  # build once here, not under the workers' lock
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in devices]
    results: list = [None] * len(devices)
    errors: list = [None] * len(devices)

    def work(i: int) -> None:
        try:
            with contextlib.ExitStack() as ctx:
                if streams[i] is not None:
                    ctx.enter_context(torch.cuda.device(devices[i]))
                    ctx.enter_context(torch.cuda.stream(streams[i]))
                results[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 — raised in the caller below
            errors[i] = e

    if len(devices) == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(i,), name=f"pcis-data-{i}")
                   for i in range(len(devices))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for i, e in enumerate(errors):
        if e is not None:
            note = f"raised by the data-axis worker {i} on {devices[i]}"
            _log.error("%s: %r", note, e)
            if hasattr(e, "add_note"):  # Python ≥ 3.11
                e.add_note(note)
            raise e
    return results
