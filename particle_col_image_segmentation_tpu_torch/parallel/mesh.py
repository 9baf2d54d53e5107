"""The device mesh, the processes that own its rows, and the worker threads
that run its data axis.

Counterpart of ``particle_col_image_segmentation_tpu/parallel/mesh.py``: a
2-axis grid of devices, "data" (the batch of planes) by "space" (plane
rows).  ``run_per_device`` runs one call on each device of a list, one
thread a device, as ``torch.nn.parallel.parallel_apply`` does: refine syncs
the host inside a call (a chunk of watershed passes), so only a thread per
device lets the devices overlap.

Across processes (``initialize_multihost``), each data row of the global
mesh is one process's devices: the space axis stays within a process, and
the only traffic between processes is the host gather of per-plane outputs
(``process_allgather``, over ``torch.distributed``'s gloo backend).  A
process names the other processes' devices but never touches them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger

DATA_AXIS = "data"
SPACE_AXIS = "space"

_log = get_logger("mesh")


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the ``torch.distributed`` group, 1 without one."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``[n_data][n_space]`` grid of ``torch.device``.  ``shape`` maps
    the axis names to their sizes, as JAX's ``mesh.shape`` does; ``flat``
    lists the devices row by row.  ``processes`` holds the rank of the
    process that owns each data row (all 0 by default: a one-process
    mesh); ``local()`` is the mesh of this process's rows."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    processes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.processes is None:
            object.__setattr__(self, "processes", (0,) * len(self.devices))
        elif len(self.processes) != len(self.devices):
            raise ValueError(f"{len(self.processes)} process ranks for {len(self.devices)} "
                             "data rows")

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), SPACE_AXIS: len(self.devices[0])}

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        return tuple(d for row in self.devices for d in row)

    @property
    def spans_processes(self) -> bool:
        """Whether the rows belong to more than one process."""
        return len(set(self.processes)) > 1

    def local_rows(self) -> Tuple[int, ...]:
        """The indices of the data rows this process owns: every row of a
        one-process mesh."""
        if not self.spans_processes:
            return tuple(range(len(self.devices)))
        rank = process_index()
        return tuple(i for i, p in enumerate(self.processes) if p == rank)

    def local(self) -> "Mesh":
        """The mesh of this process's rows (a one-process mesh itself)."""
        rows = self.local_rows()
        if len(rows) == len(self.devices):
            return self
        return Mesh(tuple(self.devices[i] for i in rows), tuple(self.processes[i] for i in rows))


def require_one_process(mesh, caller: str) -> None:
    """Refuse a mesh whose rows span processes: only the band-sharded
    functions of ``parallel.sharded`` (and ``models.batch``'s
    ``make_fused_segment_fn``) run their own rows of such a mesh."""
    if mesh is not None and mesh.spans_processes:
        raise ValueError(
            f"{caller} runs in one process, but this mesh's rows span processes "
            f"{sorted(set(mesh.processes))}: run make_sharded_segment_fn, "
            "make_sharded_analysis_fn, make_sharded_full_analysis_fn, "
            "sharded_segment_batch, make_sharded_dapi_dedup_fn, make_sharded_refine_fn or "
            "make_sharded_watershed_fn (parallel.sharded) in each process, and gather "
            "their outputs with process_allgather"
        )


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


INIT_TIMEOUT_S = 60.0


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
    timeout: float = INIT_TIMEOUT_S,
) -> Mesh:
    """Join the processes of a multi-process run, then build the global
    mesh: one data row a process, in rank order, each row this process's
    ``devices`` (default every CUDA card, ``cuda:0`` …) on the space axis.

    With a coordinator (``host:port``) or ``num_processes`` not in (None,
    1), the ``torch.distributed`` gloo group is started over TCP at the
    coordinator (without one, at ``MASTER_ADDR:MASTER_PORT``), with this
    ``process_id`` as the rank (JAX's explicit
    ``jax.distributed.initialize``).  With no arguments, torchrun's
    environment (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) takes the place of JAX's pod auto-detection; without
    it the run stays in one process and returns the local 1 × n mesh.  A
    group that was asked for and does not form within ``timeout`` seconds
    raises: it never becomes a one-process run.

    The data axis crosses processes and the space axis stays within one, so
    gloo carries only the host gather (``process_allgather``).  Each
    process must hold as many devices as the others (a row is one
    process); devices of other processes are names only."""
    dist = torch.distributed
    if coordinator_address is not None or num_processes not in (None, 1):
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout),
        )
    elif num_processes is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout))
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in devices]
    if process_count() > 1:
        per_process: list = [None] * process_count()
        dist.all_gather_object(per_process, local)
    else:
        per_process = [local]
    counts = [len(x) for x in per_process]
    if len(set(counts)) > 1:
        raise ValueError(f"processes hold unequal device counts {counts}: each mesh row is "
                         "one process, so every process must name as many devices")
    n_space = counts[0]
    flat = [d for x in per_process for d in x]
    mesh = make_mesh(n_data=len(flat) // max(n_space, 1), n_space=n_space, devices=flat)
    return dataclasses.replace(mesh, processes=tuple(range(len(per_process))))


def process_allgather(x, tiled: bool = False):
    """Gather ``x`` from every process: a tensor or an array, or a tuple,
    list or dict of them (None passes through), each the same shape in
    every process.  Returns NumPy arrays, as
    ``jax.experimental.multihost_utils.process_allgather`` does: with
    ``tiled`` the processes' arrays concatenated along axis 0 in rank
    order, without it stacked on a new axis 0 (a scalar is always
    stacked across processes).  In one process: the array itself with
    ``tiled``, under a new axis without."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: process_allgather(v, tiled) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(process_allgather(v, tiled) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(process_allgather(v, tiled) for v in x)
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if process_count() == 1:
        return a if tiled else a[None]
    if a.ndim == 0 or not tiled:
        a = a[None]
    parts: list = [None] * process_count()
    torch.distributed.all_gather_object(parts, a)
    return np.concatenate(parts, axis=0)


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
