"""Prefetching batch loader: host decode and host-to-device copies
overlapped with device compute.

Counterpart of ``prefetch_map_paths`` and ``batched_device_iterator`` in
``particle_col_image_segmentation_tpu/io/loader.py``: a thread pool decodes
planes ahead of use (``prefetch_map_paths``, the same host code).  On a
CUDA device each batch is stacked into a fresh pinned host buffer and copied
with ``non_blocking=True`` on a side stream, enqueued before the previous
batch is handed to the consumer, so the copy overlaps that batch's compute.
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from typing import Callable, Iterator, Sequence, Tuple

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch._relay import refuse_relay_arg
from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger

_log = get_logger("loader")


def prefetch_map_paths(
    load_fn: Callable[[str], np.ndarray],
    paths: Sequence[str],
    num_workers: int = 4,
    prefetch: int = 8,
    on_error: str = "raise",
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(path, load_fn(path))`` in order with ``prefetch`` in flight.

    ``on_error="skip"`` logs a failing decode and continues with the next
    path instead of killing the stream — one corrupt file in a 100k-plane
    overnight batch must not drop the remaining work (the un-yielded path
    stays unmarked in any manifest, so a resume after fixing the file
    retries it).  The default ``"raise"`` re-raises, after cancelling the
    queued loads so the exception surfaces without draining the pipeline.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    pool = cf.ThreadPoolExecutor(num_workers)
    try:
        futures: deque = deque()
        it = iter(paths)

        def submit() -> None:
            try:
                p = next(it)
            except StopIteration:
                return
            futures.append((p, pool.submit(load_fn, p)))

        for _ in range(prefetch):
            submit()
        while futures:
            path, done = futures.popleft()
            submit()
            try:
                plane = done.result()
            except Exception:
                if on_error == "skip":
                    _log.exception("skipping %s: decode failed", path)
                    continue
                raise
            yield path, plane
    finally:
        # On exception or early consumer exit, drop queued decodes and do
        # not block on in-flight ones — the error/exit should surface now,
        # not after 2·batch_size decodes drain
        pool.shutdown(wait=False, cancel_futures=True)


def prefetch_map(
    load_fn: Callable[[str], np.ndarray],
    paths: Sequence[str],
    num_workers: int = 4,
    prefetch: int = 8,
    on_error: str = "raise",
) -> Iterator[np.ndarray]:
    """Yield ``load_fn(path)`` in order with ``prefetch`` loads in flight."""
    for _, plane in prefetch_map_paths(
        load_fn, paths, num_workers=num_workers, prefetch=prefetch,
        on_error=on_error,
    ):
        yield plane


def batched_device_iterator(
    load_fn: Callable[[str], np.ndarray],
    paths: Sequence[str],
    batch_size: int,
    num_workers: int = 4,
    sharding=None,
    pad_to_full: bool = True,
    pack: bool = False,
    on_error: str = "raise",
    with_paths: bool = False,
    *,
    devices: Sequence[torch.device] = ("cuda",),
    n_space: int = 1,
) -> Iterator[tuple]:
    """Yield (chunks, count) with decode + transfer pipelined: ``chunks``
    holds each padded [B,H,W] batch split over ``devices`` (one device, or
    the data axis of a mesh) in contiguous chunks, rows
    ``[i·B/n, (i+1)·B/n)`` on ``devices[i]``; a device may get only padding
    rows.  With ``n_space`` > 1, ``devices`` is a mesh's ``flat`` list:
    device ``i·n_space + j`` gets data chunk ``i``'s band ``j`` of plane
    rows, ``[j·H/n_space, (j+1)·H/n_space)``.

    The final short batch is padded by repeating its last plane (``count``
    tells the consumer how many rows are real) so every step sees one shape.
    ``on_error="skip"`` drops files whose decode fails (logged) instead of
    killing the stream; ``with_paths=True`` appends the tuple of the
    ``count`` real source paths to each yield — REQUIRED under "skip", where
    positional path↔plane alignment no longer holds.

    A yielded CUDA chunk is ready for use on the consumer's current
    stream of its device (which waits for the copy) and is owned by it.

    The arguments bind in the JAX package's order, ``devices`` (default the
    card, ``cuda``) and ``n_space`` after them by keyword; ``sharding``,
    ``pad_to_full`` and ``pack`` are its relay arguments, and only their
    defaults bind (every batch is padded to full).
    """
    refuse_relay_arg("batched_device_iterator", "sharding", sharding, None)
    refuse_relay_arg("batched_device_iterator", "pad_to_full", pad_to_full, True)
    refuse_relay_arg("batched_device_iterator", "pack", pack, False)
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    if on_error == "skip" and not with_paths:
        raise ValueError("on_error='skip' shifts plane positions; consume with_paths=True")
    targets = [torch.device(d) for d in devices]
    if len(targets) % n_space:
        raise ValueError(f"{len(targets)} devices do not form rows of {n_space}")
    n_data = len(targets) // n_space
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} does not split over {n_data} devices")
    per = batch_size // n_data
    # one copy stream a card, shared by the mesh positions on that card
    copy_streams = {d: torch.cuda.Stream(d) for d in targets if d.type == "cuda"}

    def ship(batch, batch_paths):
        n = len(batch)
        if n < batch_size:
            batch = batch + [batch[-1]] * (batch_size - n)
        host = torch.from_numpy(np.stack(batch))
        H, W = host.shape[-2:]
        if H % n_space:
            raise ValueError(
                f"plane height {H} is not a multiple of the mesh's space axis ({n_space})"
            )
        h = H // n_space
        # each device's part contiguous: [data chunk, band, plane, row, col]
        host = host.view(n_data, per, n_space, h, W).transpose(1, 2)
        # a fresh pinned buffer per batch: the caching host allocator does
        # not hand it out again until its copies have completed
        host = torch.empty(host.shape, dtype=host.dtype,
                           pin_memory=bool(copy_streams)).copy_(host)
        chunks = []
        for k, d in enumerate(targets):
            part = host[k // n_space, k % n_space]
            if d.type != "cuda":
                chunks.append((part.to(d), None))
                continue
            with torch.cuda.stream(copy_streams[d]):
                dev = part.to(d, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(copy_streams[d])
            chunks.append((dev, ready))
        return chunks, n, tuple(batch_paths)

    def hand_over(item):
        chunks, n, batch_paths = item
        out = []
        for dev, ready in chunks:
            if ready is not None:
                consumer = torch.cuda.current_stream(dev.device)
                consumer.wait_event(ready)
                # allocated on the copy stream, used on the consumer's
                dev.record_stream(consumer)
            out.append(dev)
        return (out, n, batch_paths) if with_paths else (out, n)

    batch, batch_paths = [], []
    pending = None
    for path, plane in prefetch_map_paths(
        load_fn, paths, num_workers=num_workers, prefetch=2 * batch_size,
        on_error=on_error,
    ):
        batch.append(plane)
        batch_paths.append(path)
        if len(batch) == batch_size:
            # enqueue this copy before handing the previous batch over
            shipped = ship(batch, batch_paths)
            if pending is not None:
                yield hand_over(pending)
            pending = shipped
            batch, batch_paths = [], []
    if batch:
        shipped = ship(batch, batch_paths)
        if pending is not None:
            yield hand_over(pending)
        pending = shipped
    if pending is not None:
        yield hand_over(pending)
