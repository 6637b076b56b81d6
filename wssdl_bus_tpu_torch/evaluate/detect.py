"""Inference pipeline: ``im_detect`` / ``im_detect_batch`` (counterpart of
``wssdl_bus_tpu/evaluate/detect.py:35-229``).

Re-implements the reference's ``test_bus.py`` serving path: each image is
prepared on the host (``data/augment.py:prep_image``) and packed into the
engine's static canvas; one ``Engine.inference_step`` on the device gives
proposals and head outputs; boxes are decoded and clipped on the host and
divided by im_scale back to original pixels; per-class NMS (IoU >= 0.3)
runs on the host in numpy, as the reference's Cython path did.
``test_net`` (it needs the dataset) comes with a later slice.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from wssdl_bus_tpu_torch.data.augment import prep_image
from wssdl_bus_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes


def nms_numpy(dets: np.ndarray, thresh: float) -> list:
    """Greedy IoU NMS over dets [N, 5] (x1, y1, x2, y2, score): the reference
    Cython kernel (``nms/cpu_nms.pyx:17-68``), suppressing at IoU >= thresh
    with +1 pixel areas.  -> kept indices, highest score first."""
    if len(dets) == 0:
        return []
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
        order = rest[~(ovr >= thresh)]
    return keep


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
