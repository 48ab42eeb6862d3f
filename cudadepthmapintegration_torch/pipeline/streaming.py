"""Streamed, prefetched view loading.

The reference performs disk I/O for every view *inside* the hot loop,
serialized with the kernel (``CudaReconstruction.cu:343-365``: read VTI+KRTD,
flatten, cudaMemcpy, launch — strictly sequential). Here a background thread
pool reads and decodes views ahead of the consumer, so host I/O overlaps
device fusion — the double-buffered streaming called out in SURVEY.md
section 2 (pipeline-parallel slot).
"""

from __future__ import annotations

import threading
from collections.abc import Iterator, Sequence

from ..core.view import DepthMapView

__all__ = ["prefetch_views", "batched"]


def prefetch_views(
    dataset: Sequence[DepthMapView],
    prefetch: int = 8,
    num_threads: int = 2,
) -> Iterator[DepthMapView]:
    """Iterate `dataset` (e.g. a DepthMapDataset) with background loading.

    Maintains up to `prefetch` decoded views in flight. Exceptions raised by
    loader threads propagate to the consumer at the failed index, preserving
    order.
    """
    n = len(dataset)
    if n == 0:
        return
    results: dict[int, object] = {}
    results_lock = threading.Condition()
    next_load = {"i": 0}
    load_lock = threading.Lock()
    consumed = {"i": 0}

    def worker():
        while True:
            with load_lock:
                i = next_load["i"]
                if i >= n:
                    return
                next_load["i"] = i + 1
            # Backpressure: don't run more than `prefetch` ahead. Pure
            # condition signaling — the consumer notifies after every
            # consume and (via finally) on early exit, so no poll timeout.
            with results_lock:
                while i - consumed["i"] >= prefetch:
                    if consumed["i"] >= n:
                        return
                    results_lock.wait()
                if consumed["i"] >= n:
                    return
            try:
                item: object = dataset[i]
            except Exception as e:  # propagate to consumer in order
                item = e
            with results_lock:
                results[i] = item
                results_lock.notify_all()

    threads = [
        threading.Thread(target=worker, daemon=True)
        for _ in range(max(1, num_threads))
    ]
    for t in threads:
        t.start()
    try:
        for i in range(n):
            with results_lock:
                while i not in results:
                    results_lock.wait()
                item = results.pop(i)
                consumed["i"] = i + 1
                results_lock.notify_all()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        with results_lock:
            consumed["i"] = n
            results_lock.notify_all()


def batched(iterable, batch_size: int):
    """Group an iterable into lists of `batch_size` (last may be short)."""
    batch = []
    for item in iterable:
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
