"""Inference pipeline: ``im_detect`` / ``im_detect_batch`` and ``test_net``
(counterpart of ``wssdl_bus_tpu/evaluate/detect.py``).

Re-implements the reference's ``test_bus.py`` serving path: each image is
prepared on the host (``data/augment.py:prep_image``) and packed into the
engine's static canvas; one ``Engine.inference_step`` on the device gives
proposals and head outputs; boxes are decoded and clipped on the host and
divided by im_scale back to original pixels; per-class NMS (IoU >= 0.3)
runs on the host through the native C++ kernel (``native/``), or numpy
where it does not build, as the reference's Cython path did.  ``test_net``
runs an imdb through it: host reads and packing on a prefetch thread, a
double-buffered dispatch (batch k+1 is launched before batch k's outputs
are copied back), the per-image detection cap, ``detections.pkl`` and
``imdb.evaluate_detections``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import warnings

import numpy as np
import torch

from wssdl_bus_tpu_torch import native
from wssdl_bus_tpu_torch.data.augment import prep_image
from wssdl_bus_tpu_torch.data.loader import prefetch_iter
from wssdl_bus_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from wssdl_bus_tpu_torch.utils.logging import TraceContext
from wssdl_bus_tpu_torch.utils.timer import Timer


def _greedy_nms(dets: np.ndarray, thresh: float, containment: bool) -> list:
    """The greedy sweep.  Suppresses at IoU >= thresh (the reference's
    Cython convention, ``nms/cpu_nms.pyx:65``), +1 pixel areas; with
    ``containment`` also drops a box when either box covers >95% of the
    other (``utils/nms.pyx:118-120``).  -> kept indices, highest score
    first."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = dets[:, 4].argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = (np.maximum(0.0, xx2 - xx1 + 1)
                 * np.maximum(0.0, yy2 - yy1 + 1))
        ovr = inter / (areas[i] + areas[rest] - inter)
        drop = ovr >= thresh
        if containment:
            drop |= (inter / areas[i] > 0.95) | (inter / areas[rest] > 0.95)
        order = rest[~drop]
    return keep


def nms_numpy(dets: np.ndarray, thresh: float) -> list:
    """Greedy IoU NMS over dets [N, 5] (x1, y1, x2, y2, score): the
    reference's Cython kernel (``nms/cpu_nms.pyx:17-68``).  Runs the native
    C++ kernel when it builds, numpy otherwise.  -> kept indices, highest
    score first."""
    if len(dets) == 0:
        return []
    order0 = dets[:, 4].argsort()[::-1]
    kept = native.nms(dets[order0], thresh)
    if kept is not None:
        return [int(order0[i]) for i in kept]
    return _greedy_nms(dets, thresh, containment=False)


def nms_new_numpy(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS with containment suppression: besides IoU >= thresh, a
    lower-scoring box is dropped when either box covers >95% of the other
    (the reference's ``nms_new``, ``utils/nms.pyx:71-123``)."""
    if len(dets) == 0:
        return []
    return _greedy_nms(dets, thresh, containment=True)


def get_image_blob(im: np.ndarray, net_name: str, cfg, canvas_hw):
    """Single test image -> (padded [1, Hc, Wc, 3] blob, im_scale, (h', w'))."""
    prepared, im_scale = prep_image(im, net_name, cfg)
    h, w = prepared.shape
    if h > canvas_hw[0] or w > canvas_hw[1]:
        # an image larger than the canvas: truncate with a warning instead
        # of crashing the serving loop
        warnings.warn(f"image resized to {(h, w)} exceeds canvas "
                      f"{canvas_hw}; truncating")
        prepared = prepared[:canvas_hw[0], :canvas_hw[1]]
        h, w = prepared.shape
    blob = np.zeros((1, canvas_hw[0], canvas_hw[1], 3), np.float32)
    blob[0, :h, :w, :] = prepared[:, :, None]
    return blob, im_scale, (h, w)


def unnormalize_bbox_pred(bbox_pred: np.ndarray, cfg) -> np.ndarray:
    """Un-whiten regression outputs when targets were trained normalized
    (TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED)."""
    if not cfg.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED:
        return bbox_pred
    n_cls = bbox_pred.shape[1] // 4
    stds = np.tile(np.asarray(cfg.TRAIN.BBOX_NORMALIZE_STDS, np.float32),
                   n_cls)
    means = np.tile(np.asarray(cfg.TRAIN.BBOX_NORMALIZE_MEANS, np.float32),
                    n_cls)
    return bbox_pred * stds + means


def _decode_one(eng, im_shape, im_scale, rois, valid, cls_prob, bbox_pred):
    """Host outputs of ONE image -> (scores, pred_boxes) in original
    coords (test_bus.py:214-223)."""
    valid = np.asarray(valid).astype(bool)
    cls_prob = np.asarray(cls_prob)[valid]
    bbox_pred = np.asarray(bbox_pred)[valid]
    boxes = np.asarray(rois)[valid, 1:5] / im_scale
    if eng.cfg.TEST.BBOX_REG:
        bbox_pred = unnormalize_bbox_pred(bbox_pred, eng.cfg)
        pred = bbox_transform_inv(torch.from_numpy(boxes),
                                  torch.from_numpy(bbox_pred))
        pred = clip_boxes(pred.reshape(-1, 4), im_shape[0], im_shape[1])
        # explicit column count: every proposal may be masked invalid
        pred_boxes = pred.numpy().reshape(len(boxes), bbox_pred.shape[1])
    else:
        pred_boxes = np.tile(boxes, (1, cls_prob.shape[1]))
    return cls_prob, pred_boxes


def im_detect(eng, im: np.ndarray, net_name: str, canvas_hw) -> tuple:
    """-> (scores [N, C], pred_boxes [N, 4C]) in ORIGINAL image coords."""
    (out,) = im_detect_batch(eng, [im], net_name, canvas_hw)
    return out


def pack_image_batch(eng, images, net_name, canvas_hw):
    """Prepare a batch of raw images into (blob, infos, scales) for one
    device step."""
    n = len(images)
    blob = np.zeros((n, canvas_hw[0], canvas_hw[1], 3), np.float32)
    infos = np.zeros((n, 4), np.float32)
    scales = []
    for i, im in enumerate(images):
        b, s, (h, w) = get_image_blob(im, net_name, eng.cfg, canvas_hw)
        blob[i] = b[0]
        infos[i] = [h, w, s, 0.0]
        scales.append(s)
    return blob, infos, scales


def _decode_packed(eng, images, scales, outs):
    """Copy one packed batch's device outputs to the host (this waits for
    the device) and decode per image."""
    n = len(images)
    rois, valid, _, cls_prob, bbox_pred = (o.cpu().numpy() for o in outs)
    p = eng.cfg.TEST.RPN_POST_NMS_TOP_N
    rois = rois.reshape(n, p, 5)
    valid = valid.reshape(n, p)
    cls_prob = cls_prob.reshape(n, p, -1)
    bbox_pred = bbox_pred.reshape(n, p, -1)
    return [_decode_one(eng, images[i].shape, scales[i], rois[i], valid[i],
                        cls_prob[i], bbox_pred[i]) for i in range(n)]


def im_detect_batch(eng, images, net_name: str, canvas_hw):
    """Batched serving path: pack B images into the static canvas, one
    device step, split per image.  -> list of (scores, pred_boxes)."""
    blob, infos, scales = pack_image_batch(eng, images, net_name, canvas_hw)
    outs = eng.inference_step(blob, infos)
    return _decode_packed(eng, images, scales, outs)


def apply_nms_per_class(scores, boxes, num_classes, thresh, nms_thresh,
                        cls_agnostic=False):
    """-> dets_per_class[list of [n_j, 5]] for classes 1..C-1
    (test_bus.py:359-386): per-class score threshold + NMS; with
    ``cls_agnostic`` the per-class survivors are then suppressed jointly by
    a second NMS, like the reference."""
    out = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    for j in range(1, num_classes):
        inds = np.where(scores[:, j] > thresh)[0]
        cls_boxes = boxes[inds, j * 4:(j + 1) * 4]
        cls_scores = scores[inds, j]
        dets = np.hstack([cls_boxes, cls_scores[:, None]]).astype(np.float32)
        keep = nms_numpy(dets, nms_thresh)
        out[j] = dets[keep]
    if cls_agnostic:
        all_dets = np.zeros((0, 6), np.float32)
        for j in range(1, num_classes):
            tagged = np.hstack([out[j],
                                np.full((len(out[j]), 1), j, np.float32)])
            all_dets = np.concatenate([all_dets, tagged], axis=0)
        keep = nms_numpy(all_dets[:, :5], nms_thresh)
        all_dets = all_dets[keep]
        for j in range(1, num_classes):
            out[j] = all_dets[all_dets[:, 5] == j][:, :5]
    return out


class _StepEvents:
    """CUDA events around each device step (none on the CPU): the device
    time of the steps, read once at the end so no step waits on it."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    @contextlib.contextmanager
    def step(self):
        if not self.cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.pairs.append((start, end))

    def total_ms(self):
        if not self.cuda:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def test_net(eng, imdb, output_dir: str, net_name: str, canvas_hw,
             max_per_image: int = 300, thresh: float = 0.05,
             verbose: bool = True, vis: bool = False, batch_size: int = 1,
             timings: dict = None):
    """Detect over an imdb and evaluate (the reference's test_bus.py:300-413;
    ``wssdl_bus_tpu/evaluate/detect.py:test_net`` without ``variables``:
    the Engine holds its model).

    ``vis`` saves per-image qualitative overlays.  ``batch_size`` > 1 runs
    the batched serving path, the tail batch padded to the batch size.
    ``timings``, if given, receives the run's seconds by stage: host read
    and packing (``read_prep_s``, on the prefetch thread), copy-back and
    decode (``decode_s``, which waits for the device), NMS and the rest
    (``nms_s``), the device steps by CUDA events (``device_ms``, None on
    the CPU), the number of steps and the wall time (``wall_s``).
    Returns (all_boxes, the result of imdb.evaluate_detections)."""
    num_images = imdb.num_images
    num_classes = imdb.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(num_classes)]
    os.makedirs(output_dir, exist_ok=True)
    t_read, t_det, t_misc = Timer(), Timer(), Timer()
    events = _StepEvents(eng.device)
    wall = Timer()
    wall.tic()
    # TEST.DEBUG_TIMELINE: trace one post-warm-up detection (the reference
    # traced single sess.run calls, test_bus.py:186-188,233-237)
    trace = TraceContext(output_dir, enabled=eng.cfg.TEST.DEBUG_TIMELINE)

    def infer(blob, infos):
        with events.step():
            return eng.inference_step(blob, infos)

    def detections():
        """Yield (i, image, scores, boxes).  Host reads and packing run on
        a prefetch thread, overlapping the device step."""
        if batch_size > 1:
            # trace the second batch if there is one, else the only one
            trace_start = batch_size if num_images > batch_size else 0

            def host_batches():
                for start in range(0, num_images, batch_size):
                    t_read.tic()
                    idxs = list(range(start,
                                      min(start + batch_size, num_images)))
                    ims = [imdb.read_image(i) for i in idxs]
                    # pad the tail batch to the batch size
                    padded = ims + [ims[-1]] * (batch_size - len(ims))
                    packed = pack_image_batch(eng, padded, net_name,
                                              canvas_hw)
                    t_read.toc()
                    yield (start, idxs, ims, padded) + packed

            def emit(pend):
                """Copy back and decode one dispatched batch; only its
                ``idxs`` prefix is real."""
                idxs, ims, padded, scales, outs = pend
                t_det.tic()
                results = _decode_packed(eng, padded, scales, outs)
                t_det.toc()
                for k, i in enumerate(idxs):
                    yield (i, ims[k]) + results[k]

            # double-buffered dispatch: batch k+1 is launched before batch
            # k's outputs are copied back (the .cpu() in _decode_packed is
            # the one blocking point), so the host's decode and NMS of
            # batch k overlap the device's step k+1
            pending = None
            for start, idxs, ims, padded, blob, infos, scales \
                    in prefetch_iter(host_batches()):
                if start == trace_start:
                    # the traced batch runs alone, its copy-back inside the
                    # trace window and the consumer's NMS outside it
                    if pending is not None:
                        yield from emit(pending)
                        pending = None
                    with trace:
                        outs = infer(blob, infos)
                        t_det.tic()
                        results = _decode_packed(eng, padded, scales, outs)
                        t_det.toc()
                    for k, i in enumerate(idxs):
                        yield (i, ims[k]) + results[k]
                    continue
                outs = infer(blob, infos)
                if pending is not None:
                    yield from emit(pending)
                pending = (idxs, ims, padded, scales, outs)
            if pending is not None:
                yield from emit(pending)
        else:
            def host_images():
                for i in range(num_images):
                    t_read.tic()
                    im = imdb.read_image(i)
                    packed = pack_image_batch(eng, [im], net_name, canvas_hw)
                    t_read.toc()
                    yield (i, im) + packed

            for i, im, blob, infos, scales in prefetch_iter(host_images()):
                with trace if i == min(1, num_images - 1) \
                        else contextlib.nullcontext():
                    outs = infer(blob, infos)
                    t_det.tic()
                    (scores, boxes), = _decode_packed(eng, [im], scales, outs)
                    t_det.toc()
                yield i, im, scores, boxes

    for i, im, scores, boxes in detections():
        t_misc.tic()
        per_class = apply_nms_per_class(
            scores, boxes, num_classes, thresh, eng.cfg.TEST.NMS,
            cls_agnostic=eng.cfg.TEST.CLS_AGNOSTIC_NMS)
        for j in range(1, num_classes):
            all_boxes[j][i] = per_class[j]
        # cap the detections per image (test_bus.py:393-401)
        if max_per_image > 0:
            image_scores = np.hstack([all_boxes[j][i][:, -1]
                                      for j in range(1, num_classes)])
            if len(image_scores) > max_per_image:
                image_thresh = np.sort(image_scores)[-max_per_image]
                for j in range(1, num_classes):
                    keep = np.where(all_boxes[j][i][:, -1] >= image_thresh)[0]
                    all_boxes[j][i] = all_boxes[j][i][keep]
        if vis:
            from wssdl_bus_tpu_torch.evaluate.visualize import \
                save_qualitative
            # GT under the detections, as the reference's test-time
            # visualization (test_bus.py:345-355)
            entry = imdb.roidb[i] if imdb.roidb else None
            save_qualitative(
                im, {j: all_boxes[j][i] for j in range(1, num_classes)},
                os.path.join(output_dir, "qual"), imdb.image_index[i],
                thresh=0.5,
                gt_boxes=entry["boxes"] if entry is not None else None,
                gt_classes=entry["gt_classes"] if entry is not None else None)
        t_misc.toc()
        if verbose:
            print(f"im_detect: {i + 1:d}/{num_images:d} "
                  f"{t_det.average_time:.3f}s {t_misc.average_time:.3f}s")
    wall.toc()
    if timings is not None:
        timings.update(read_prep_s=t_read.total_time,
                       decode_s=t_det.total_time, nms_s=t_misc.total_time,
                       device_ms=events.total_ms(), steps=len(events.pairs)
                       if events.cuda else None, wall_s=wall.total_time,
                       images=num_images)

    with open(os.path.join(output_dir, "detections.pkl"), "wb") as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)

    result = imdb.evaluate_detections(all_boxes, output_dir)
    return all_boxes, result


test_net.__test__ = False    # a pipeline, not a pytest test
