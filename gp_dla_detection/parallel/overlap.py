"""Compute/transfer overlap for the sharded drivers.

The reference processes quasars strictly serially and saves once at the
end (process_qsos.m:88-220, :234-249).  A batched driver that runs

    device_put -> execute -> block -> fetch -> savez -> next batch

on one critical path leaves the device idle while the host transfers
and writes.  This module supplies the two pieces that break that
serialization:

  - :func:`run_pipelined` — a bounded in-flight dispatch/complete loop:
    batch i+1's host->device transfer and execution are enqueued before
    batch i's results are fetched, so the device computes while the host
    waits on the result transfer.  JAX dispatch is async, so "dispatch"
    really is enqueue-and-return — except for the device_put uploads,
    which can block the host, so ``threaded=True`` runs dispatch on its
    own thread and the uploads overlap the fetches too.
  - :class:`BackgroundWriter` — a single-worker ordered writer moving
    np.savez_compressed checkpoint/manifest writes off the critical
    path (zlib releases the GIL, so compression genuinely overlaps).

Checkpoint files are written atomically (tmp + os.replace): a SIGKILL
mid-write leaves either the old state or the new state, never a corrupt
npz/manifest — load-bearing for the kill/resume contract.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ..utils.atomic_io import atomic_savez, atomic_write_json

__all__ = [
    "BackgroundWriter",
    "atomic_savez",
    "atomic_write_json",
    "run_pipelined",
    "run_pipelined_split",
]


def run_pipelined(items, dispatch, complete, depth: int = 2,
                  threaded: bool = False):
    """Run ``complete(item, dispatch(item))`` over ``items`` with up to
    ``depth`` dispatched items in flight.

    ``dispatch`` should enqueue device work and return without blocking
    (its return value is handed to ``complete`` unchanged); ``complete``
    fetches results and does host-side bookkeeping.  ``depth=1``
    degenerates to the serial loop; ``depth=2`` is classic double
    buffering (one batch computing while the previous one drains).

    ``threaded=True`` moves ``dispatch`` to a dedicated thread:
    ``jax.device_put`` can block the host for the upload just as the
    result fetch does, and running them on one thread re-serializes the
    two transfer directions the pipeline exists to overlap.  Guarantees preserved from the synchronous mode: dispatch
    order is strictly sequential (one dispatcher thread, so per-batch
    device-stream enqueue order is unchanged — load-bearing for
    pack-at-dispatch), ``complete`` runs on the calling thread in item
    order, at most ``depth`` items are dispatched-but-not-completed, and
    an exception from either callback propagates to the caller (the
    dispatcher is stopped and joined first).  ``dispatch`` must be safe
    to run concurrently with ``complete`` — the sharded drivers' are.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if not threaded or depth == 1:
        inflight: deque = deque()
        for item in items:
            inflight.append((item, dispatch(item)))
            while len(inflight) >= depth:
                done_item, state = inflight.popleft()
                complete(done_item, state)
        while inflight:
            done_item, state = inflight.popleft()
            complete(done_item, state)
        return

    import queue
    import threading

    slots = threading.Semaphore(depth)  # dispatched-but-not-completed
    results: queue.SimpleQueue = queue.SimpleQueue()  # unbounded: put never blocks
    stop = threading.Event()

    def dispatcher():
        try:
            for item in items:
                # acquire BEFORE dispatching so the in-flight bound is
                # strict; poll so a failed consumer can't strand us
                while not slots.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                results.put(("item", item, dispatch(item)))
            results.put(("done", None, None))
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            results.put(("raise", exc, None))

    worker = threading.Thread(
        target=dispatcher, name="gpdla-dispatch", daemon=True
    )
    worker.start()
    try:
        while True:
            kind, item, state = results.get()
            if kind == "done":
                break
            if kind == "raise":
                raise item
            complete(item, state)
            slots.release()
    finally:
        stop.set()
        # Bounded join: the dispatcher polls `stop` between items (<=
        # 0.1 s), but a dispatch() blocked INSIDE a stalled transfer
        # can hang indefinitely — an unbounded join here would then
        # swallow the caller's exception behind a frozen shutdown.  The
        # thread is a daemon: leak it with a warning and let the error
        # propagate.
        worker.join(timeout=15.0)
        if worker.is_alive():
            import warnings

            warnings.warn(
                "dispatcher thread still blocked in a device transfer "
                "after 15 s; abandoning it (daemon) so the original "
                "error can propagate",
                stacklevel=2,
            )


def run_pipelined_split(items, upload, issue, complete, depth: int = 2,
                        threaded: bool = False):
    """:func:`run_pipelined` with the dispatch stage split into
    ``upload`` (host slice/pad + ``jax.device_put`` — blocking host
    transfers, NO collectives) and ``issue`` (the jit computation
    dispatch + on-device packing — enqueue-and-return, but its program
    may carry collectives).

    The split exists for MULTI-CONTROLLER overlap: every controller
    must enqueue collective-bearing operations (the batch computation,
    ``fetch_global``'s allgather) in one identical order, or the
    cross-process collectives pair up wrong and the backend (gloo on
    CPU, NCCL on GPUs) deadlocks.  ``run_pipelined``'s dispatcher thread
    violates that — the thread interleaves batch-compute issuance with
    the main thread's fetch collectives at OS scheduling whim — so it
    would have to run unthreaded whenever ``jax.process_count() > 1``,
    serializing uploads against fetches on multi-host deployments.

    Here ``threaded=True`` moves only the uploads to a side thread.
    ``jax.device_put`` of host data to addressable shards issues no
    collective, so upload timing cannot perturb collective order; the
    main thread consumes uploaded batches strictly in item order and
    runs ``issue``/``complete`` on the EXACT schedule of the serial
    path (issue_0 .. issue_{d-1}, then complete_{i-d+1}, issue_i, ...,
    a deterministic program order on every controller) — while batch
    i+1's upload proceeds concurrently with batch i's fetch, which is
    the overlap the pipeline exists for.  Guarantees: at most
    ``depth + 1`` items uploaded-but-not-completed (an item's slot
    frees as it BEGINS completing, so the next upload overlaps the
    blocking fetch even at depth 2), ``issue``/``complete`` run on the
    calling thread in item order, and worker exceptions propagate.

    ``threaded=False`` degenerates to ``run_pipelined`` with
    ``dispatch = issue(item, upload(item))``.
    """
    if not threaded or depth == 1:
        run_pipelined(
            items, lambda item: issue(item, upload(item)), complete,
            depth=depth, threaded=False,
        )
        return
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")

    import queue
    import threading

    slots = threading.Semaphore(depth)  # uploaded-but-not-completed
    results: queue.SimpleQueue = queue.SimpleQueue()
    stop = threading.Event()

    def uploader():
        try:
            for item in items:
                while not slots.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                results.put(("item", item, upload(item)))
            results.put(("done", None, None))
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            results.put(("raise", exc, None))

    worker = threading.Thread(
        target=uploader, name="gpdla-upload", daemon=True
    )
    worker.start()
    inflight: deque = deque()
    try:
        while True:
            kind, item, state = results.get()
            if kind == "done":
                break
            if kind == "raise":
                raise item
            inflight.append((item, issue(item, state)))
            while len(inflight) >= depth:
                done_item, st = inflight.popleft()
                # free the slot BEFORE the blocking fetch so the side
                # thread can upload the next batch during it
                slots.release()
                complete(done_item, st)
        while inflight:
            done_item, st = inflight.popleft()
            slots.release()
            complete(done_item, st)
    finally:
        stop.set()
        # bounded join, same rationale as run_pipelined: an upload
        # frozen inside a stalled transfer must not swallow the
        # caller's exception behind an unbounded shutdown
        worker.join(timeout=15.0)
        if worker.is_alive():
            import warnings

            warnings.warn(
                "upload thread still blocked in a device transfer "
                "after 15 s; abandoning it (daemon) so the original "
                "error can propagate",
                stacklevel=2,
            )


class BackgroundWriter:
    """Ordered background execution of checkpoint writes.

    One worker thread keeps writes (and the manifest updates that must
    follow them) in submission order.  Worker exceptions surface at the
    next :meth:`submit` or at :meth:`close` — never silently.  As a
    context manager, the success path closes (waits + re-raises); an
    exceptional exit abandons pending writes without masking the
    original error.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gpdla-ckpt"
        )
        self._pending: deque = deque()

    def submit(self, fn, *args) -> None:
        while self._pending and self._pending[0].done():
            self._pending.popleft().result()  # re-raise worker errors
        self._pending.append(self._pool.submit(fn, *args))

    def close(self) -> None:
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "BackgroundWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            self._pool.shutdown(wait=True, cancel_futures=True)
        return False


