"""The solver: training loops with periodic in-training evaluation
(counterpart of ``wssdl_bus_tpu/train/solver.py``; the reference's
``SolverWrapper``, ``lib/fast_rcnn/train_bus.py:96-957``).

  * ``train_combined``: joint supervised + weak minibatches, one update per
    iteration (train_model, :595-957);
  * ``train_alternating``: separate supervised and weak steps, each with
    its own optimizer state (train_model_alter, :175-592);
  * ``periodic_eval``: the whole test set through ``Engine.eval_step``
    (losses and detections from the sampled ROIs, NMS, CorLoc / AP), which
    also drives the 'rop' LR schedule;
  * snapshots every SNAPSHOT_ITERS and at the end (``train/checkpoint.py``)
    and an exact ``--resume``;
  * stdout / ``log.txt`` / TensorBoard with the reference's cadence
    (DISPLAY, TEST_ITERS) and tags (:901-948); DEBUG_TIMELINE traces steps
    1-3 with ``torch.profiler``.

On a device mesh (``engine`` a ``parallel/engine.py:ParallelEngine``, in
one of the ranks ``parallel/launch.py`` started) every rank runs this
solver: its data layers assemble only the rank's slot of the global batch,
the parallel steps average what the slots computed, and the in-loop
evaluation is collective (every rank calls ``eval_step`` on the same
global batch, from the same ``eval_rng``).  Rank 0 alone logs, runs VOC AP
/ CorLoc / FROC and writes detections and snapshots; a snapshot gathers a
tensor-parallel head first and has the single-device format, and every
rank resumes from it.

As in the JAX package, the losses stay on the device in the loop: the
detached loss tensors are read at the DISPLAY, TEST_ITERS and SNAPSHOT
boundaries (and every 25 steps at most), not every step.  Every random
draw comes from a stream the snapshot saves, in a fixed order: the data
layers' and the evaluation's ``np.random.RandomState`` and the engine's
``torch.Generator`` (one stream for both steps of the alternating regime,
as the JAX package has one key), so a resumed run reproduces the
uninterrupted one.  ``stats`` records the loop's host and device times,
the feed's host time and the bytes each step uploads (``_StepClock``: the
recent samples and the run's means).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.loader import (WINDOW, Prefetcher,
                                             RoIDataLayer, RoIDataLayerJoint)
from wssdl_bus_tpu_torch.data.minibatch import get_minibatch
from wssdl_bus_tpu_torch.evaluate.detect import (apply_nms_per_class,
                                                 unnormalize_bbox_pred)
from wssdl_bus_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from wssdl_bus_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                  load_checkpoint,
                                                  load_host_state,
                                                  make_snapshot_writers,
                                                  save_checkpoint,
                                                  wait_snapshot_writers)
from wssdl_bus_tpu_torch.train.engine import Engine
from wssdl_bus_tpu_torch.train.schedules import build_schedule
from wssdl_bus_tpu_torch.utils.logging import MetricLogger, TraceContext
from wssdl_bus_tpu_torch.utils.timer import Timer

_TAGS = ("total", "rpn_loss_cls", "rpn_loss_box", "loss_cls", "loss_box",
         "mil_loss_cls")
_DRAIN_CAP = 25     # loss reads are drained at least this often
_WINDOW = WINDOW    # recent samples the step clock keeps of each series
_SERIES = ("iter_ms_host", "iter_ms_cuda", "feed_ms_host", "upload_bytes",
           "losses")


def _upload_bytes(blobs: dict) -> int:
    return int(sum(np.asarray(v).nbytes for v in blobs.values()))


class _StepClock:
    """The loop's numbers: each iteration's host time, the device time of
    its training steps by CUDA events and its six losses (as drained), and
    each batch's feed host time and upload bytes.  Every series keeps its
    last ``_WINDOW`` samples, with a count and (times, bytes) a sum over the
    whole run.

    Each step's launches get their own pair of events and the batches are
    drawn outside them, so the event time is the steps' device time alone.
    An iteration's pairs are read once its last event has completed
    (``Event.query``): timing adds no synchronisation and holds only the
    iterations the device has not finished."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.recent = {k: deque(maxlen=_WINDOW) for k in _SERIES}
        self.count = dict.fromkeys(_SERIES, 0)
        self.sum = dict.fromkeys(_SERIES[:4], 0.0)
        self._pairs = []            # this iteration's (start, end) events
        self._unread = deque()      # earlier iterations' pairs, oldest first

    def add(self, key: str, value):
        self.recent[key].append(value)
        self.count[key] += 1
        if key in self.sum:
            self.sum[key] += value

    @contextlib.contextmanager
    def step(self):
        """Brackets one training step's launches with CUDA events."""
        if not self.cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pairs.append((start, end))

    def end_iter(self, host_ms: float):
        self.add("iter_ms_host", host_ms)
        if self._pairs:
            self._unread.append(self._pairs)
            self._pairs = []
        self._read(wait=False)

    def _read(self, wait: bool):
        while self._unread and (wait or self._unread[0][-1][1].query()):
            pairs = self._unread.popleft()
            pairs[-1][1].synchronize()
            self.add("iter_ms_cuda",
                     sum(s.elapsed_time(e) for s, e in pairs))

    def summary(self) -> dict:
        """-> each series' recent samples, plus ``count`` and ``mean``
        over the run."""
        self._read(wait=True)
        out = {k: list(v) for k, v in self.recent.items()}
        out["count"] = dict(self.count)
        out["mean"] = {k: self.sum[k] / self.count[k] for k in self.sum
                       if self.count[k]}
        return out


class _QuietLogger:
    """The logger of a mesh rank other than 0: writes nothing."""

    def text(self, line: str):
        pass

    def scalars(self, step: int, **values: float):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class Solver:
    """Drives one training run (one model, one canvas, one output dir).

    ``engine``: the supervised (combined) step's Engine (or one rank's
    ``ParallelEngine``); its model is initialised here from ``seed``
    (``models/convert.py:reference_init_``) and then from ``pretrained``
    (``models/pretrained.py``) and, with ``resume``, from the newest
    snapshot in ``output_dir``; on a mesh then set to rank 0's everywhere
    (``ParallelEngine.replicate``)."""

    def __init__(self, engine: Engine, cfg: Config, net_name: str,
                 roidb_train_s, roidb_train_ws, imdb_test, roidb_test,
                 output_dir: str, lr_scheduling: str = "const",
                 max_iters: int = 60000, pretrained: Optional[str] = None,
                 use_prefetch: Optional[bool] = None,
                 seed: Optional[int] = None, vis: bool = False,
                 resume: bool = False, eval_batch: int = 1):
        from wssdl_bus_tpu_torch.data.targets import \
            add_bbox_regression_targets
        from wssdl_bus_tpu_torch.models.convert import reference_init_

        self.eng = engine
        # a mesh: the data layers assemble this rank's slot of the global
        # batch (JAX's solver.py:56-62); rank 0 leads
        self.mesh = getattr(engine, "mesh", None)
        self.n_slots = 1 if self.mesh is None else self.mesh.n_data
        self.cfg = cfg
        self.net_name = net_name
        self.roidb_train_s = roidb_train_s
        self.roidb_train_ws = roidb_train_ws
        self.imdb_test = imdb_test
        self.roidb_test = roidb_test
        self.output_dir = output_dir
        self.max_iters = max_iters
        # None defers to cfg.TRAIN.USE_PREFETCH; --prefetch /
        # --no_prefetch win
        self.use_prefetch = (cfg.TRAIN.USE_PREFETCH if use_prefetch is None
                             else use_prefetch)
        # test images per eval_step; per-image losses keep the reference's
        # per-image normalisation (train_bus.py:800-816)
        self.eval_batch = max(1, int(eval_batch))
        self.vis = vis
        os.makedirs(output_dir, exist_ok=True)
        self.logger = MetricLogger(output_dir) if self.lead \
            else _QuietLogger()
        self.schedule = build_schedule(lr_scheduling, cfg.TRAIN.LEARNING_RATE,
                                       max_iters)
        # bbox-regression target means / stds over the supervised roidb,
        # like SolverWrapper's constructor (train_bus.py:125-128)
        if roidb_train_s and "max_classes" in roidb_train_s[0]:
            self.bbox_means, self.bbox_stds = add_bbox_regression_targets(
                roidb_train_s, cfg)
        else:  # an unprepared roidb (synthetic entries)
            self.bbox_means = self.bbox_stds = None

        seed = cfg.RNG_SEED if seed is None else seed
        self.rng = np.random.RandomState(seed)
        # the evaluation's own stream (the prefetch threads draw from the
        # layers' streams; a RandomState is not thread-safe)
        self.eval_rng = np.random.RandomState(self.rng.randint(2 ** 31))
        reference_init_(self.eng.model, seed)
        if pretrained:
            from wssdl_bus_tpu_torch.models.pretrained import \
                load_pretrained_model
            # min_loaded=1: a checkpoint whose scopes match nothing fails
            # instead of training from scratch while claiming success
            load_pretrained_model(pretrained, self.eng.model, verbose=True,
                                  min_loaded=1, pixel_mean=cfg.PIXEL_MEAN)

        self.stats = {}
        self.start_iter = 0
        self._snap_writer = None
        self._trace = None
        self._saved_opt_ws = None
        self._saved = {}
        if resume:
            ckpt = latest_checkpoint(output_dir)
            if ckpt is not None:
                variables, step, opt_state, self._saved_opt_ws = \
                    load_checkpoint(ckpt, self.eng.device, opt_state=True,
                                    opt_state_ws=True)
                self.eng.load_full_state(variables)
                if opt_state is not None:
                    self.eng.load_opt_state(opt_state)
                self.start_iter = step
                host = load_host_state(ckpt) or {}
                self._saved = host
                self.schedule.load_state_dict(host.get("schedule", {}))
                if "eval_rng" in host:
                    self.eval_rng.set_state(host["eval_rng"])
                self._restore_streams(host)
                print(f"Resumed from {ckpt} at iter {step}")
        if self.mesh is not None:
            self.eng.replicate()

    def _restore_streams(self, host: dict) -> None:
        """The engine's generators from a snapshot: each rank's own where
        the snapshot is of a mesh of this shape, else (a single-device
        snapshot) the one generator, which a mesh with one data slot
        draws from."""
        streams = host.get("mesh_streams")
        shape = None if self.mesh is None else (self.mesh.n_data,
                                                self.mesh.n_model)
        if streams is not None and streams["shape"] == shape:
            self.eng.load_stream_states(streams["ranks"])
        elif "generator" in host and self.n_slots == 1:
            self.eng.generator.set_state(host["generator"])
        elif "generator" in host:
            print("resume: the snapshot's random streams are of another "
                  "mesh; this run's streams start fresh")

    @property
    def lead(self) -> bool:
        """Whether this solver logs and writes: off a mesh, or its rank
        0."""
        mesh = getattr(self, "mesh", None)
        return mesh is None or mesh.rank == 0

    # ------------------------------------------------------------------ #
    def _maybe_trace(self, it: int):
        """DEBUG_TIMELINE (the reference dumps Chrome traces per step,
        train_bus.py:353-355): steps 1-3 under torch.profiler, the trace
        in <output_dir>/torch_trace.  Called before each step."""
        if not self.cfg.TRAIN.DEBUG_TIMELINE or self._trace is not None:
            return
        if it == (1 if self.max_iters > 1 else 0):
            self._trace = TraceContext(self.output_dir, enabled=True)
            self._trace.__enter__()

    def _maybe_trace_stop(self, it: int, force: bool = False):
        if self._trace is not None and (force
                                        or it >= min(3, self.max_iters - 1)):
            self._trace.__exit__(None, None, None)
            self._trace = False     # one window per run

    def _regime_restore(self, key: str, layers: dict):
        """Apply the saved resume state of this regime to its data layers
        and return its (training_loss, carry) accumulators.  ``key``: the
        draw-state key the regime saves under ('joint' combined, 's'
        alternating).  A snapshot of the OTHER regime leaks neither its
        draw state nor its partial loss sums (parameters and optimizer
        state are reused)."""
        saved = self._saved.get("data_layers")
        same = bool(saved and key in saved)
        if saved and not same:
            print("resume: snapshot is from the other training regime; "
                  "data-layer state and loss accumulators start fresh")
        if same:
            for k, layer in layers.items():
                if saved.get(k) is not None:
                    layer.load_state_dict(saved[k])
        tl, carry = self._saved.get("training_loss"), self._saved.get("carry")
        training_loss = (np.asarray(tl).copy() if same and tl is not None
                         else np.zeros((6,)))
        carry = (np.asarray(carry).copy() if same and carry is not None
                 else np.array([0, 0, 0, 0, 0, float(np.log(3.0))]))
        return training_loss, carry

    def snapshot(self, step: int, opt_state_ws=None, test_loss_logs=None,
                 ws_step: int = 0, data_layer_state=None, training_loss=None,
                 carry=None):
        t = self.cfg.TRAIN
        host = {"schedule": self.schedule.state_dict(),
                "test_loss_logs": list(test_loss_logs or []),
                "eval_rng": self.eval_rng.get_state(),
                "generator": self.eng.generator.get_state(),
                "ws_step": int(ws_step),
                # the layers' draw state, in step with consumption
                # (Prefetcher.state_dict)
                "data_layers": data_layer_state,
                "training_loss": (None if training_loss is None
                                  else np.asarray(training_loss)),
                "carry": None if carry is None else np.asarray(carry)}
        # collective on a mesh: a TP head's fc6 / fc7 and their moments
        # gathered, every rank's random streams
        variables = self.eng.full_state_dict()
        opt_state = self.eng.full_opt_state()
        if self.mesh is not None:
            host["mesh_streams"] = {
                "shape": (self.mesh.n_data, self.mesh.n_model),
                "ranks": self.eng.stream_states()}
            self.mesh.barrier()
        if not self.lead:
            return
        if self._snap_writer is None:
            self._snap_writer = make_snapshot_writers()
        # the tensors are copied to the CPU here; the files are written on
        # a background thread while training goes on
        path = save_checkpoint(self.output_dir, t.SNAPSHOT_PREFIX,
                               t.SNAPSHOT_INFIX, step + 1, variables,
                               opt_state, opt_state_ws=opt_state_ws,
                               host_state=host,
                               checkpointers=self._snap_writer)
        print(f"Writing snapshot to: {path}")

    def _finish_snapshots(self):
        """Wait until the last snapshot is on disk (a caller may resume
        from it or evaluate it right away); on a mesh every rank waits for
        rank 0's writes."""
        wait_snapshot_writers(self._snap_writer)
        if self.mesh is not None:
            self.mesh.barrier()

    # ------------------------------------------------------------------ #
    def _display(self, it: int, loss_vals):
        print(f"iter: {it + 1} / {self.max_iters}")
        print(f"total_loss: {loss_vals[0]:.4f}")
        print("rpn_loss_cls: {:.4f}, rpn_loss_box: {:.4f}, loss_cls: {:.4f}, "
              "loss_box: {:.4f}, mil_loss_cls: {:.4f}".format(*loss_vals[1:]))

    @staticmethod
    def _losses_np(ls) -> np.ndarray:
        """One step's six losses (device tensors) -> numpy, with the
        reference's total that excludes the MIL term (:769-771)."""
        v = torch.stack([x.reshape(()) for x in ls]).double().cpu().numpy()
        return np.array([v[1] + v[2] + v[3] + v[4], v[1], v[2], v[3], v[4],
                         v[5]])

    @staticmethod
    def _losses_np_rows(ls) -> np.ndarray:
        """Per-image eval losses ([B] per field) -> [B, 6], the total
        excluding MIL."""
        cols = [np.asarray(x, np.float64).reshape(-1) for x in ls]
        return np.stack([cols[1] + cols[2] + cols[3] + cols[4], cols[1],
                         cols[2], cols[3], cols[4], cols[5]], axis=1)

    def _maybe_vis_eval(self, idx, all_boxes, num_classes, test_dir):
        if not self.vis:
            return
        # qualitative overlays like train_bus.py:824-871
        from wssdl_bus_tpu_torch.data.minibatch import _load_gray
        from wssdl_bus_tpu_torch.evaluate.visualize import save_qualitative
        entry = self.roidb_test[idx]
        save_qualitative(
            _load_gray(entry),
            {j: all_boxes[j][idx] for j in range(1, num_classes)},
            test_dir,
            os.path.splitext(os.path.basename(entry["image"]))[0],
            gt_boxes=entry["boxes"], gt_classes=entry["gt_classes"])

    # ------------------------------------------------------------------ #
    def periodic_eval(self, it: int, cur_lr: float, training_loss,
                      test_loss_logs):
        """A pass over the whole test set with the training pipeline at
        is_training=False; -> the averaged test losses
        (train_bus.py:792-892).  On a mesh every rank runs the evaluation
        steps (collective) and rank 0 alone decodes, writes and scores the
        detections and logs."""
        cfg = self.cfg
        t0 = time.perf_counter()
        len_test = len(self.roidb_test)
        num_classes = self.imdb_test.num_classes
        all_boxes = [[[] for _ in range(len_test)]
                     for _ in range(num_classes)]
        test_loss = np.zeros((6,))
        test_dir = os.path.join(self.output_dir, "test")
        if self.lead:
            os.makedirs(test_dir, exist_ok=True)

        B = self.eval_batch
        r = cfg.TRAIN.BATCH_SIZE
        for start in range(0, len_test, B):
            idxs = list(range(start, min(start + B, len_test)))
            # pad the tail to the batch size; the padded rows are dropped
            # (per-image losses make the padding free)
            entries = [self.roidb_test[i] for i in idxs]
            entries += [entries[-1]] * (B - len(idxs))
            blobs = get_minibatch(entries, self.net_name, cfg,
                                  self.eng.canvas_hw, is_training=False,
                                  is_ws=False, rng=self.eval_rng)
            ls, rois_b, cls_prob_b, bbox_pred_b, labels_b = \
                self.eng.eval_step(blobs, it)
            rows = self._losses_np_rows([x.cpu().numpy() for x in ls])
            test_loss += rows[:len(idxs)].sum(axis=0)
            if not self.lead:
                continue

            rois_b = np.asarray(rois_b.cpu()).reshape(B, r, 5)
            cls_prob_b = np.asarray(cls_prob_b.cpu()).reshape(B, r, -1)
            bbox_pred_b = np.asarray(bbox_pred_b.cpu()).reshape(B, r, -1)
            labels_b = np.asarray(labels_b.cpu()).reshape(B, r)
            for k, idx in enumerate(idxs):
                im_h = self.roidb_test[idx]["height"]
                im_w = self.roidb_test[idx]["width"]
                scale = blobs["im_info"][k, 2]
                # only the sampled slots (label >= 0): an unfilled slot
                # holds an unselected candidate, and the reference
                # evaluates only the sampled ROIs (train_bus.py:811-850)
                filled = labels_b[k] >= 0
                rois = rois_b[k][filled]
                cls_prob = cls_prob_b[k][filled]
                bbox_pred = bbox_pred_b[k][filled]
                boxes = rois[:, 1:5] / scale
                bp = unnormalize_bbox_pred(bbox_pred, cfg)
                # an explicit column count: reshape(0, -1) raises where the
                # sampler filled no slot
                pred = clip_boxes(
                    bbox_transform_inv(torch.from_numpy(boxes),
                                       torch.from_numpy(bp)).reshape(-1, 4),
                    im_h, im_w).numpy().reshape(len(boxes), bp.shape[1])
                per_class = apply_nms_per_class(
                    cls_prob, pred, num_classes, 0.05, cfg.TEST.NMS,
                    cls_agnostic=cfg.TEST.CLS_AGNOSTIC_NMS)
                for j in range(1, num_classes):
                    all_boxes[j][idx] = per_class[j]
                self._maybe_vis_eval(idx, all_boxes, num_classes, test_dir)

        corloc_list = []
        if self.lead:
            with open(os.path.join(test_dir, "detections.pkl"), "wb") as f:
                pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
            print("Evaluating detections")
            corloc_list = self.imdb_test.evaluate_detections(
                all_boxes, test_dir, f"{it + 1}")

        training_loss /= cfg.TRAIN.TEST_ITERS
        test_loss /= max(len_test, 1)
        test_loss_logs.append(float(test_loss[0]))
        self.schedule.on_val_end(test_loss_logs)

        scalars = {f"training_loss_{n}": training_loss[i]
                   for i, n in enumerate(_TAGS)}
        scalars.update({f"test_loss_{n}": test_loss[i]
                        for i, n in enumerate(_TAGS)})
        if len(corloc_list) >= 3:
            scalars["corloc_benign"] = corloc_list[0]
            scalars["corloc_malignant"] = corloc_list[1]
            scalars["corloc"] = corloc_list[2]
        scalars["lr"] = cur_lr
        self.logger.scalars(it + 1, **scalars)
        self.logger.flush()

        self.logger.text(f"iter: {it + 1} / {self.max_iters}")
        self.logger.text(f"training loss\ntotal_loss: {training_loss[0]}")
        self.logger.text(
            f"rpn_loss_cls: {training_loss[1]}\trpn_loss_box: "
            f"{training_loss[2]}\tloss_cls: {training_loss[3]}\tloss_box: "
            f"{training_loss[4]}\nmil_loss_cls: {training_loss[5]}")
        self.logger.text(f"test loss\ntotal_loss: {test_loss[0]}")
        self.logger.text(
            f"rpn_loss_cls: {test_loss[1]}\trpn_loss_box: {test_loss[2]}\t"
            f"loss_cls: {test_loss[3]}\tloss_box: {test_loss[4]}\n"
            f"mil_loss_cls: {test_loss[5]}")
        self.logger.text(f"lr: {cur_lr}")
        self.stats.setdefault("eval", []).append(
            {"iter": it + 1, "images": len_test,
             "seconds": time.perf_counter() - t0,
             "test_loss": test_loss.tolist(),
             "corloc": [float(c) for c in corloc_list]})
        return test_loss

    # ------------------------------------------------------------------ #
    def _layer(self, cls, *args, **kw):
        """A training layer on its own stream, seeded from the solver's
        (the JAX package's order of draws); on a mesh it assembles this
        rank's slot."""
        return cls(*args, rng=np.random.RandomState(self.rng.randint(2 ** 31)),
                   device_prep=self.cfg.TRAIN.DEVICE_PREP,
                   slots=self.n_slots,
                   slot=None if self.mesh is None else self.mesh.d, **kw)

    def _feed(self, layer, clock: _StepClock):
        t0 = time.perf_counter()
        blobs = layer.forward()
        clock.add("feed_ms_host", (time.perf_counter() - t0) * 1e3)
        clock.add("upload_bytes", _upload_bytes(blobs))
        return blobs

    def train_combined(self):
        """The combined-minibatch regime (train_model,
        train_bus.py:595-957)."""
        cfg = self.cfg
        layer = self._layer(RoIDataLayerJoint, self.roidb_train_s,
                            self.roidb_train_ws, self.net_name, cfg,
                            self.eng.canvas_hw)
        training_loss, _ = self._regime_restore("joint", {"joint": layer})
        if self.use_prefetch:
            layer = Prefetcher(layer)
        timer, clock = Timer(), _StepClock(self.eng.device)
        test_loss_logs = list(self._saved.get("test_loss_logs", []))
        last_snapshot_iter = -1
        pending = []

        def drain():
            nonlocal training_loss
            for ls in pending:
                v = self._losses_np(ls)
                training_loss += v
                clock.add("losses", v.tolist())
            pending.clear()

        def snap(it):
            drain()
            self.snapshot(it, test_loss_logs=test_loss_logs,
                          data_layer_state={"joint": layer.state_dict()},
                          training_loss=training_loss)

        try:
            for it in range(self.start_iter, self.max_iters):
                self._maybe_trace(it)
                timer.tic()
                blobs = self._feed(layer, clock)
                cur_lr = self.schedule(it)
                with clock.step():
                    ls = self.eng.train_step(blobs, cur_lr, it)
                pending.append(ls)
                if len(pending) >= _DRAIN_CAP:
                    drain()
                self._maybe_trace_stop(it)
                clock.end_iter(timer.toc(average=False) * 1e3)

                if (it + 1) % cfg.TRAIN.DISPLAY == 0:
                    drain()
                    self._display(it, self._losses_np(ls))
                    print(f"speed: {timer.average_time:.3f}s / iter")
                if (it + 1) % cfg.TRAIN.TEST_ITERS == 0:
                    drain()
                    self.periodic_eval(it, cur_lr, training_loss,
                                       test_loss_logs)
                    training_loss = np.zeros((6,))
                # the snapshot comes AFTER the in-loop eval: the eval
                # draws from eval_rng and the generator and appends the
                # test loss that drives 'rop'
                if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
                    last_snapshot_iter = it
                    snap(it)

            # the final snapshot only if this run stepped: resuming a
            # finished run must not overwrite its snapshot
            if (last_snapshot_iter != self.max_iters - 1
                    and self.start_iter < self.max_iters):
                snap(self.max_iters - 1)
            self._finish_snapshots()
        finally:
            self._maybe_trace_stop(self.max_iters, force=True)
            layer.close()
            self.logger.close()
        self.stats["train"] = clock.summary()

    # ------------------------------------------------------------------ #
    def train_alternating(self, s_start: int, s_end: int,
                          ws_start: int, ws_end: int,
                          eng_ws: Optional[Engine] = None):
        """The alternating regime (train_model_alter, train_bus.py:175-592):
        a supervised step when s_start <= it <= s_end, and a weak MIL-only
        step every WS_TRAIN_INTERVAL iterations when ws_start <= it <=
        ws_end, each with its OWN optimizer state (:286-301).

        ``eng_ws``: the weak step's Engine (no supervised image,
        WS_IMS_PER_BATCH weak ones); by default one over the same model
        with the alternating MIL selector pair (:241-247), its own
        Optimizer and the supervised Engine's generator."""
        cfg = self.cfg
        if eng_ws is None:
            kw = dict(plain_ops=self.eng.plain_ops, num_supervised=0,
                      num_ws=cfg.TRAIN.WS_IMS_PER_BATCH,
                      dataset=self.eng._at_kwargs["dataset"],
                      opt_name=self.eng.opt_name,
                      selector_pair=("mass_max", "mal_max"))
            if self.mesh is not None:
                from wssdl_bus_tpu_torch.parallel.engine import \
                    ParallelEngine
                eng_ws = ParallelEngine(self.eng.model, cfg,
                                        self.eng.canvas_hw, self.mesh, **kw)
                eng_ws.share_streams(self.eng)
            else:
                eng_ws = Engine(self.eng.model, cfg, self.eng.canvas_hw,
                                device=self.eng.device, **kw)
                eng_ws.generator = self.eng.generator
        if self._saved_opt_ws is not None:
            # the weak optimizer's moments too: a reset would leave the
            # uninterrupted trajectory
            eng_ws.load_opt_state(self._saved_opt_ws)

        layer_s = self._layer(RoIDataLayer, self.roidb_train_s, self.net_name,
                              cfg, self.eng.canvas_hw, is_training=True,
                              is_ws=False)
        layer_ws = self._layer(RoIDataLayer, self.roidb_train_ws,
                               self.net_name, cfg, self.eng.canvas_hw,
                               is_training=True, is_ws=True)
        training_loss, carry = self._regime_restore(
            "s", {"s": layer_s, "ws": layer_ws})
        if self.use_prefetch:
            layer_s, layer_ws = Prefetcher(layer_s), Prefetcher(layer_ws)

        timer, clock = Timer(), _StepClock(self.eng.device)
        test_loss_logs = list(self._saved.get("test_loss_logs", []))
        last_snapshot_iter = -1
        # the reference counts weak optimizer steps apart: the adaptive MIL
        # scale decays on that count, not on the loop iteration
        # (train_bus.py:287-301); restored across a resume
        ws_step = int(self._saved.get("ws_step", 0))
        pending = []

        # carry-forward logging like the reference (train_bus.py:362-399):
        # an iteration without a supervised step repeats the last losses;
        # the MIL slot starts at -log(1/3)
        def to_np(pair):
            ls_i, mil_i = pair
            v = carry.copy()
            if ls_i is not None:
                v[:5] = self._losses_np(ls_i)[:5]
            if mil_i is not None:
                v[5] = float(mil_i)
            carry[:] = v
            return v

        def drain():
            nonlocal training_loss
            for p in pending:
                v = to_np(p)
                training_loss += v
                clock.add("losses", v.tolist())
            pending.clear()

        def snap(it):
            drain()
            self.snapshot(it, opt_state_ws=eng_ws.full_opt_state(),
                          test_loss_logs=test_loss_logs, ws_step=ws_step,
                          data_layer_state={"s": layer_s.state_dict(),
                                            "ws": layer_ws.state_dict()},
                          training_loss=training_loss, carry=carry)

        try:
            for it in range(self.start_iter, self.max_iters):
                self._maybe_trace(it)
                timer.tic()
                cur_lr = self.schedule(it)
                ls = mil = None
                if s_start <= it <= s_end:
                    blobs = self._feed(layer_s, clock)
                    with clock.step():
                        ls = self.eng.train_step(blobs, cur_lr, it)
                if (ws_start <= it <= ws_end
                        and (it + 1) % cfg.TRAIN.WS_TRAIN_INTERVAL == 0):
                    blobs = self._feed(layer_ws, clock)
                    with clock.step():
                        mil = eng_ws.train_step_mil(blobs, cur_lr, ws_step)
                    ws_step += 1
                last = (ls, mil)
                pending.append(last)
                if len(pending) >= _DRAIN_CAP:
                    drain()
                self._maybe_trace_stop(it)
                clock.end_iter(timer.toc(average=False) * 1e3)

                if (it + 1) % cfg.TRAIN.DISPLAY == 0:
                    drain()
                    self._display(it, to_np(last))
                    print(f"speed: {timer.average_time:.3f}s / iter")
                if (it + 1) % cfg.TRAIN.TEST_ITERS == 0:
                    drain()
                    self.periodic_eval(it, cur_lr, training_loss,
                                       test_loss_logs)
                    training_loss = np.zeros((6,))
                if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
                    last_snapshot_iter = it
                    snap(it)

            if (last_snapshot_iter != self.max_iters - 1
                    and self.start_iter < self.max_iters):
                snap(self.max_iters - 1)
            self._finish_snapshots()
        finally:
            self._maybe_trace_stop(self.max_iters, force=True)
            layer_s.close()
            layer_ws.close()
            self.logger.close()
        self.ws_step = ws_step
        self.eng_ws = eng_ws
        self.stats["train"] = clock.summary()


# ---------------------------------------------------------------------- #
# Function-level entry points (reference train_bus.py:1055-1088)
# ---------------------------------------------------------------------- #
def _build_solver(network, model, roidb_train_s, roidb_train_ws, imdb_test,
                  roidb_test, output_dir, pretrained_model, opt, lr,
                  lr_scheduling, vis, max_iters, cfg, dataset, canvas_hw,
                  num_ws, selector_pair, use_prefetch, resume, seed=None,
                  eval_batch=1, device=None, plain_ops=False, mesh_data=1,
                  mesh_model=1):
    from wssdl_bus_tpu_torch.data.augment import max_canvas
    from wssdl_bus_tpu_torch.models.detector import stem_is_frozen
    from wssdl_bus_tpu_torch.parallel import build_engine

    cfg = (Config() if cfg is None else cfg).with_overrides(
        ["TRAIN.LEARNING_RATE", str(lr)])
    if canvas_hw is None:
        sizes = [(e["height"], e["width"])
                 for e in roidb_train_s + roidb_train_ws + roidb_test]
        canvas_hw = max_canvas(sizes, cfg.TRAIN.SCALES[0], cfg.TRAIN.MAX_SIZE,
                               crop_margin=(cfg.TRAIN.CROPPING_MAX_MARGIN
                                            if cfg.TRAIN.USE_CROPPING
                                            else 0.0))
    if network.startswith("VGGnet") and pretrained_model is None \
            and stem_is_frozen(model):
        print("WARNING: training VGG FROM SCRATCH with conv1/conv2 frozen "
              "at their random init: the trunk cannot develop features "
              "(the reference's freezing assumes the ImageNet .npy init, "
              "VGGnet_train_bus.py:45-49).  Pass --unfreeze_stem for "
              "from-scratch runs.")
    eng = build_engine(model, cfg, canvas_hw, mesh_data, mesh_model,
                       device=device, plain_ops=plain_ops, num_ws=num_ws,
                       dataset=dataset, opt_name=opt,
                       selector_pair=selector_pair, seed=seed)
    return Solver(eng, cfg, network, roidb_train_s, roidb_train_ws, imdb_test,
                  roidb_test, output_dir, lr_scheduling=lr_scheduling,
                  max_iters=max_iters, pretrained=pretrained_model,
                  use_prefetch=use_prefetch, vis=vis, resume=resume,
                  seed=seed, eval_batch=eval_batch)


def train_net(network, roidb_train_s, roidb_train_ws, imdb_test, roidb_test,
              output_dir, pretrained_model=None, max_iters=80000,
              s_start_iter=0, s_end_iter=80000, ws_start_iter=0,
              ws_end_iter=80000, opt="adam", lr=5e-4, lr_scheduling="const",
              vis=False, *, model, cfg=None, dataset="SNUBH", canvas_hw=None,
              use_prefetch=None, resume=False, seed=None, eval_batch=1,
              device=None, mesh_data=1, mesh_model=1) -> Solver:
    """Combined-minibatch training (reference ``train_net``,
    train_bus.py:1073-1088).  The s/ws window arguments are accepted for
    signature parity and unused, as in the reference's ``train_model``.
    ``model``: the detector ``network`` names, built by the caller
    (``main/common.py:build_model``; its ``freeze_stem`` decides whether
    conv1/conv2 train, its compute dtype whether the step runs in bf16,
    the JAX package's ``compute_dtype`` argument); ``device``: CUDA unless
    named.  ``mesh_data`` x ``mesh_model`` > 1 trains on that mesh; call it
    in every rank ``parallel/launch.py:run`` started (``main.train``
    does)."""
    del s_start_iter, s_end_iter, ws_start_iter, ws_end_iter  # parity only
    solver = _build_solver(
        network, model, roidb_train_s, roidb_train_ws, imdb_test, roidb_test,
        output_dir, pretrained_model, opt, lr, lr_scheduling, vis, max_iters,
        cfg, dataset, canvas_hw, num_ws=None,
        selector_pair=("mal_max", "mal_max"), use_prefetch=use_prefetch,
        resume=resume, seed=seed, eval_batch=eval_batch, device=device,
        mesh_data=mesh_data, mesh_model=mesh_model)
    print("Solving...")
    solver.train_combined()
    print("done solving")
    return solver


def train_net_alter(network, roidb_train_s, roidb_train_ws, imdb_test,
                    roidb_test, output_dir, pretrained_model=None,
                    max_iters=80000, s_start_iter=0, s_end_iter=80000,
                    ws_start_iter=0, ws_end_iter=80000, opt="adam", lr=5e-4,
                    lr_scheduling="const", vis=False, *, model, cfg=None,
                    dataset="SNUBH", canvas_hw=None, use_prefetch=None,
                    resume=False, seed=None, eval_batch=1,
                    device=None, mesh_data=1, mesh_model=1) -> Solver:
    """Alternating-minibatch training (reference ``train_net_alter``,
    train_bus.py:1055-1070), ``model`` and the mesh as in
    :func:`train_net`.  Supervised-only training: pass ``ws_start_iter >
    max_iters`` (train_alter.py:3-5)."""
    solver = _build_solver(
        network, model, roidb_train_s, roidb_train_ws, imdb_test, roidb_test,
        output_dir, pretrained_model, opt, lr, lr_scheduling, vis, max_iters,
        cfg, dataset, canvas_hw, num_ws=0,
        selector_pair=("mass_max", "mal_max"), use_prefetch=use_prefetch,
        resume=resume, seed=seed, eval_batch=eval_batch, device=device,
        mesh_data=mesh_data, mesh_model=mesh_model)
    print("Solving...")
    solver.train_alternating(s_start_iter, s_end_iter, ws_start_iter,
                             ws_end_iter)
    print("done solving")
    return solver
