"""Background prefetch for host-side data work (counterpart of
``wssdl_bus_tpu/data/loader.py:prefetch_iter``).

The epoch-shuffled training layers (``RoIDataLayer``,
``RoIDataLayerJoint``), ``Prefetcher`` and ``get_data_layer`` come with the
solver slice (ROADMAP.md)."""

from __future__ import annotations

import queue
import threading


def prefetch_iter(gen, depth: int = 2):
    """Run a generator on a background thread with a bounded queue, so
    host-side work (file IO, decode, resize, packing) overlaps whatever the
    consumer does between ``next()`` calls (a device step).

    Worker exceptions re-raise at the consumer.  Abandoning the iterator
    early (the consumer raises or breaks) stops the worker promptly: puts
    are timeout-bounded against a stop event that the generator's close
    hook sets, so no thread or buffer outlives the consumer loop."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            err.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise RuntimeError(
                        "prefetch_iter worker failed") from err[0]
                return
            yield item
    finally:
        # the consumer finished or abandoned the loop: unblock the worker
        # and drop any buffered items
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
