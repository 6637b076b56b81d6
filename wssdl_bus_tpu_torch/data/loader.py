"""Epoch-shuffled training data layers and background prefetch
(counterpart of ``wssdl_bus_tpu/data/loader.py``).

``RoIDataLayer`` (the reference's ``layer_bus.py:9-78``) and
``RoIDataLayerJoint`` (``layer_bus_joint.py:8-104``): independent shuffled
cursors per roidb, re-shuffled at each epoch's end in training and
iterated in order otherwise.  Every draw (permutations, augmentation) comes
from one ``np.random.RandomState`` per layer in the JAX package's order,
so the same seed gives the same indices and the same blobs in both
packages.  ``Prefetcher`` runs a layer on a host thread (numpy, PIL and the
native library only; it never touches CUDA); ``prefetch_iter`` does the
same for a generator.  The worker is a thread that a profiler started
later does not see, so the ``Prefetcher`` keeps its own clock of each
batch's assembly (``stamps``, on ``time.time_ns()``'s clock, the one the
profiler's events carry); what the consumer waits is the span
``feed_wait`` (``utils/logging.py:span``).

``slots`` > 1 makes the global batch of a device mesh, as the JAX package
does: ``slots`` minibatches drawn serially (the cursor, then one
``RandomState(self.rng.randint(2**31))`` per slot), assembled in parallel
on a thread pool and stacked along axis 0, slot ``d``'s rows at
[d * n_local, (d + 1) * n_local).  A rank of the mesh asks for its own
slot (``slot=d``): every slot's draws are made, so the layer's state (and
``state_dict()``) is the same on every rank and equals the JAX layer's,
and only slot ``d``'s minibatch is assembled.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.minibatch import (get_minibatch,
                                                get_minibatch_joint)
from wssdl_bus_tpu_torch.utils.logging import span

WINDOW = 100    # recent samples a training loop's clocks keep: the
                # Prefetcher's stamps, train/solver.py:_StepClock's series


class _Cursor:
    def __init__(self, n: int, shuffle: bool, rng: np.random.RandomState):
        self.n = n
        self.shuffle = shuffle
        self.rng = rng
        self._reset()

    def _reset(self):
        self.perm = (self.rng.permutation(self.n) if self.shuffle
                     else np.arange(self.n))
        self.cur = 0

    def next(self, k: int) -> np.ndarray:
        if self.cur + k > self.n:
            self._reset()
        idx = self.perm[self.cur:self.cur + k]
        self.cur += k
        return idx

    def state_dict(self) -> dict:
        # no copy: perm is only ever rebound (_reset / load_state_dict),
        # never changed in place
        return {"perm": self.perm, "cur": self.cur}

    def matches(self, sd: dict) -> bool:
        """Whether a saved state belongs to a roidb of this size (another
        size means other splits or flips: restored indices would be
        wrong)."""
        return len(np.asarray(sd["perm"])) == self.n

    def load_state_dict(self, sd: dict) -> None:
        self.perm = np.asarray(sd["perm"]).copy()
        self.cur = int(sd["cur"])


def _raw_canvas(*roidbs):
    """The device-prep staging canvas: the largest ORIGINAL image extent
    over the roidbs (a weak image's rotation keeps its size and the crop
    only shrinks it), rounded up to a multiple of 8."""
    h = max(e["height"] for db in roidbs for e in db)
    w = max(e["width"] for db in roidbs for e in db)
    return (-(-h // 8) * 8, -(-w // 8) * 8)


def _concat_slots(blobs: list) -> dict:
    """Per-slot blob dicts stacked along axis 0: the global batch layout
    ``parallel/engine.py`` takes (slot i's images at rows
    [i * n_local, (i + 1) * n_local))."""
    if len(blobs) == 1:
        return blobs[0]
    return {k: np.concatenate([b[k] for b in blobs], axis=0)
            for k in blobs[0]}


def _slot_pool(slots: int, slot):
    """Threads for assembling the slots in parallel (imread, resize and the
    photometric work run in native code or GIL-releasing numpy); none for
    one slot or when only one slot is assembled."""
    return (ThreadPoolExecutor(max_workers=min(slots, 8),
                               thread_name_prefix="slotprep")
            if slots > 1 and slot is None else None)


def _check_slot(slots: int, slot) -> None:
    if slots < 1 or (slot is not None and not 0 <= slot < slots):
        raise ValueError(f"slot {slot} of {slots} slots")


class RoIDataLayer:
    """Single-regime loader (supervised or weak).  ``device_prep`` stages
    raw uint8 blobs (``data/minibatch.py``, ``ops/device_prep.py``);
    ``slots`` / ``slot`` as in the module docstring."""

    def __init__(self, roidb, net_name: str, cfg: Config, canvas_hw,
                 is_training: bool, is_ws: bool = False,
                 rng: np.random.RandomState = None, slots: int = 1,
                 device_prep: bool = False, slot: int = None):
        _check_slot(slots, slot)
        self.slots, self.slot = slots, slot
        self.roidb = roidb
        self.net_name = net_name
        self.cfg = cfg
        self.canvas_hw = canvas_hw
        self.is_training = is_training
        self.is_ws = is_ws
        self.rng = rng or np.random.RandomState(cfg.RNG_SEED)
        per = cfg.TRAIN.WS_IMS_PER_BATCH if is_ws else cfg.TRAIN.IMS_PER_BATCH
        self.ims_per_batch = per if is_training else 1
        self.raw_hw = _raw_canvas(roidb) if device_prep else None
        self.cursor = _Cursor(len(roidb), is_training, self.rng)
        self._pool = _slot_pool(slots, slot)

    def _assemble(self, job) -> dict:
        entries, rng = job
        return get_minibatch(entries, self.net_name, self.cfg,
                             self.canvas_hw, self.is_training, self.is_ws,
                             rng, raw_hw=self.raw_hw)

    def forward(self) -> dict:
        if self.slots == 1:
            idx = self.cursor.next(self.ims_per_batch)
            return self._assemble(([self.roidb[i] for i in idx], self.rng))
        # the draws serially, in the layer's stream; each slot assembled
        # with a RandomState of its own (one is not thread-safe)
        jobs = []
        for _ in range(self.slots):
            idx = self.cursor.next(self.ims_per_batch)
            jobs.append(([self.roidb[i] for i in idx],
                         np.random.RandomState(self.rng.randint(2 ** 31))))
        if self.slot is not None:
            return self._assemble(jobs[self.slot])
        return _concat_slots(list(self._pool.map(self._assemble, jobs)))

    def state_dict(self) -> dict:
        """The draw state (RNG stream + cursor) right after a
        ``forward()``: restoring it makes the next ``forward()`` give what
        an uninterrupted run would have given."""
        return {"rng": self.rng.get_state(),
                "cursor": self.cursor.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """All or nothing: if the roidb's size changed since the snapshot,
        nothing is restored (a restored RNG stream alone would give a
        trajectory neither the snapshot nor the seed reproduces)."""
        if not self.cursor.matches(sd["cursor"]):
            print(f"resume: draw state is for a {len(sd['cursor']['perm'])}-"
                  f"entry roidb but this one has {self.cursor.n}; "
                  "starting from a fresh shuffle")
            return
        self.rng.set_state(sd["rng"])
        self.cursor.load_state_dict(sd["cursor"])

    def close(self):
        """Release the slot pool (``Prefetcher.close`` calls this)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


class RoIDataLayerJoint:
    """Joint loader: IMS_PER_BATCH supervised + WS_IMS_PER_BATCH weak images
    per step from two independent shuffled cursors on one RNG stream
    (layer_bus_joint.py:29-91); ``slots`` / ``slot`` as in the module
    docstring, each slot's minibatch [n_s supervised, n_ws weak]."""

    def __init__(self, roidb_s, roidb_ws, net_name: str, cfg: Config,
                 canvas_hw, is_training: bool = True,
                 rng: np.random.RandomState = None, slots: int = 1,
                 device_prep: bool = False, slot: int = None):
        _check_slot(slots, slot)
        self.slots, self.slot = slots, slot
        self.roidb_s = roidb_s
        self.roidb_ws = roidb_ws
        self.net_name = net_name
        self.cfg = cfg
        self.canvas_hw = canvas_hw
        self.rng = rng or np.random.RandomState(cfg.RNG_SEED)
        self.is_training = is_training
        self.raw_hw = (_raw_canvas(roidb_s, roidb_ws) if device_prep
                       else None)
        self.cursor_s = _Cursor(len(roidb_s), is_training, self.rng)
        self.cursor_ws = _Cursor(len(roidb_ws), is_training, self.rng)
        self._pool = _slot_pool(slots, slot)

    def _draw(self):
        ids = self.cursor_s.next(self.cfg.TRAIN.IMS_PER_BATCH)
        idw = self.cursor_ws.next(self.cfg.TRAIN.WS_IMS_PER_BATCH)
        return [self.roidb_s[i] for i in ids], [self.roidb_ws[i] for i in idw]

    def _assemble(self, job) -> dict:
        sup, weak, rng = job
        return get_minibatch_joint(sup, weak, self.net_name, self.cfg,
                                   self.canvas_hw, rng,
                                   is_training=self.is_training,
                                   raw_hw=self.raw_hw)

    def forward(self) -> dict:
        if self.slots == 1:
            return self._assemble((*self._draw(), self.rng))
        # serial draws, parallel assembly: see RoIDataLayer.forward
        jobs = [(*self._draw(),
                 np.random.RandomState(self.rng.randint(2 ** 31)))
                for _ in range(self.slots)]
        if self.slot is not None:
            return self._assemble(jobs[self.slot])
        return _concat_slots(list(self._pool.map(self._assemble, jobs)))

    def state_dict(self) -> dict:
        """As ``RoIDataLayer.state_dict``: one RNG, two cursors."""
        return {"rng": self.rng.get_state(),
                "cursor_s": self.cursor_s.state_dict(),
                "cursor_ws": self.cursor_ws.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """All or nothing across both cursors (see RoIDataLayer)."""
        if not (self.cursor_s.matches(sd["cursor_s"])
                and self.cursor_ws.matches(sd["cursor_ws"])):
            print("resume: draw state is for differently-sized roidbs "
                  f"(saved {len(sd['cursor_s']['perm'])}s/"
                  f"{len(sd['cursor_ws']['perm'])}ws, have {self.cursor_s.n}s/"
                  f"{self.cursor_ws.n}ws); starting from a fresh shuffle")
            return
        self.rng.set_state(sd["rng"])
        self.cursor_s.load_state_dict(sd["cursor_s"])
        self.cursor_ws.load_state_dict(sd["cursor_ws"])

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


class Prefetcher:
    """Bounded-queue background prefetch around a layer with ``forward()``.

    A worker exception is re-raised from the consumer's next ``forward()``
    instead of hanging it.  The worker pairs every batch with the layer's
    state right after drawing it, and ``state_dict()`` returns the state
    paired with the last CONSUMED batch (the layer itself runs up to
    ``depth`` batches ahead): a snapshot through the Prefetcher records a
    draw position in step with consumption, so a resume re-draws exactly
    the batches the interrupted run never consumed.  Load a state into the
    layer BEFORE constructing the Prefetcher: the worker starts drawing at
    once.

    ``stamps``: (start, end) of the last ``WINDOW`` batches' ``forward()``
    on the worker, in the order drawn, in ``time.time_ns()``
    nanoseconds."""

    def __init__(self, layer, depth: int = 2):
        self.layer = layer
        self.stamps: "deque[tuple[int, int]]" = deque(maxlen=WINDOW)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None
        self._get_state = getattr(layer, "state_dict", lambda: None)
        self._consumed_state = self._get_state()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                start = time.time_ns()
                blobs = self.layer.forward()
                self.stamps.append((start, time.time_ns()))
                state = self._get_state()
            except BaseException as e:  # noqa: BLE001 - relayed to consumer
                self._error = e
                self._stop.set()
                return
            while not self._stop.is_set():
                try:
                    self.q.put((blobs, state), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def forward(self) -> dict:
        with span("feed_wait"):
            while True:
                if self._error is not None:
                    raise RuntimeError("prefetch worker failed") \
                        from self._error
                try:
                    blobs, state = self.q.get(timeout=0.5)
                    self._consumed_state = state
                    return blobs
                except queue.Empty:
                    if self._stop.is_set():   # closed with no pending error
                        raise RuntimeError("prefetcher is closed") from None
                    continue

    def state_dict(self):
        return self._consumed_state

    def close(self):
        """Stop the worker and wait for it (so no thread outlives the
        training loop), then close the layer."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join()
        self.layer.close()


def get_data_layer(roidbs, net_name, cfg, canvas_hw, is_training,
                   is_ws=False, is_joint=False, rng=None, slots=1,
                   device_prep=False, slot=None):
    """The data-layer factory (reference ``get_data_layer``,
    train_bus.py:1037-1053): joint -> ``RoIDataLayerJoint`` over (roidb_s,
    roidb_ws); otherwise one ``RoIDataLayer``."""
    if is_joint:
        return RoIDataLayerJoint(roidbs[0], roidbs[1], net_name, cfg,
                                 canvas_hw, is_training=is_training, rng=rng,
                                 slots=slots, device_prep=device_prep,
                                 slot=slot)
    return RoIDataLayer(roidbs, net_name, cfg, canvas_hw,
                        is_training=is_training, is_ws=is_ws, rng=rng,
                        slots=slots, device_prep=device_prep, slot=slot)


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
