"""Bounding-box regression target statistics over a roidb: the port's copy
of ``wssdl_bus_tpu/data/targets.py``.

Re-implements ``add_bbox_regression_targets`` / ``_compute_targets`` (the
reference detector's ``lib/roi_data_layer/roidb.py:48-135``): per-image
class-labeled regression targets from each GT box toward itself (with
PROPOSAL_METHOD='gt' every roi IS a gt box, so the deltas are zero — the
stats exist for the normalization machinery), plus per-class target
means/stds.  ``BBOX_NORMALIZE_TARGETS`` is OFF by default in the reference
(config.py:176) and the snapshot "unnormalization" there is an identity
dance (train_bus.py:133-173); we keep the same default and expose the stats
for anyone turning normalization on.
"""

from __future__ import annotations

import numpy as np

from wssdl_bus_tpu_torch.config import Config


def compute_targets(rois, max_overlaps, max_classes, bbox_thresh: float):
    """[N, 5] rows of (class, tx, ty, tw, th) for fg rois (roidb.py:112-135).
    With gt-only proposals each fg roi regresses to itself (zero deltas)."""
    n = len(rois)
    targets = np.zeros((n, 5), np.float32)
    ex_inds = np.where(max_overlaps >= bbox_thresh)[0]
    gt_inds = np.where(max_overlaps == 1)[0]
    if len(ex_inds) == 0 or len(gt_inds) == 0:
        return targets
    rois = rois.astype(np.float32)
    ex, gt = rois[ex_inds], rois[gt_inds]
    # dense IoU (+1 convention) ex x gt
    ix1 = np.maximum(ex[:, None, 0], gt[None, :, 0])
    iy1 = np.maximum(ex[:, None, 1], gt[None, :, 1])
    ix2 = np.minimum(ex[:, None, 2], gt[None, :, 2])
    iy2 = np.minimum(ex[:, None, 3], gt[None, :, 3])
    iw = np.maximum(ix2 - ix1 + 1, 0)
    ih = np.maximum(iy2 - iy1 + 1, 0)
    inter = iw * ih
    a_ex = (ex[:, 2] - ex[:, 0] + 1) * (ex[:, 3] - ex[:, 1] + 1)
    a_gt = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
    iou = inter / (a_ex[:, None] + a_gt[None, :] - inter)
    assign = gt[iou.argmax(axis=1)]

    ex_w = ex[:, 2] - ex[:, 0] + 1.0
    ex_h = ex[:, 3] - ex[:, 1] + 1.0
    ex_cx = ex[:, 0] + 0.5 * ex_w
    ex_cy = ex[:, 1] + 0.5 * ex_h
    gt_w = assign[:, 2] - assign[:, 0] + 1.0
    gt_h = assign[:, 3] - assign[:, 1] + 1.0
    gt_cx = assign[:, 0] + 0.5 * gt_w
    gt_cy = assign[:, 1] + 0.5 * gt_h
    targets[ex_inds, 0] = max_classes[ex_inds]
    targets[ex_inds, 1] = (gt_cx - ex_cx) / ex_w
    targets[ex_inds, 2] = (gt_cy - ex_cy) / ex_h
    targets[ex_inds, 3] = np.log(gt_w / ex_w)
    targets[ex_inds, 4] = np.log(gt_h / ex_h)
    return targets


def add_bbox_regression_targets(roidb, cfg: Config, num_classes: int = 3):
    """Attach 'bbox_targets' per image and return (means, stds) flattened to
    [num_classes * 4] (roidb.py:48-109)."""
    assert roidb and "max_classes" in roidb[0], "call prepare_roidb first"
    for entry in roidb:
        entry["bbox_targets"] = compute_targets(
            entry["boxes"], entry["max_overlaps"], entry["max_classes"],
            cfg.TRAIN.BBOX_THRESH)

    if cfg.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED:
        means = np.tile(np.array(cfg.TRAIN.BBOX_NORMALIZE_MEANS),
                        (num_classes, 1))
        stds = np.tile(np.array(cfg.TRAIN.BBOX_NORMALIZE_STDS),
                       (num_classes, 1))
    else:
        counts = np.zeros((num_classes, 1)) + cfg.EPS
        sums = np.zeros((num_classes, 4))
        sq = np.zeros((num_classes, 4))
        for entry in roidb:
            t = entry["bbox_targets"]
            for cls in range(1, num_classes):
                inds = np.where(t[:, 0] == cls)[0]
                if inds.size:
                    counts[cls] += inds.size
                    sums[cls] += t[inds, 1:].sum(axis=0)
                    sq[cls] += (t[inds, 1:] ** 2).sum(axis=0)
        means = sums / counts
        stds = np.sqrt(np.maximum(sq / counts - means ** 2, 0.0))

    if cfg.TRAIN.BBOX_NORMALIZE_TARGETS:
        for entry in roidb:
            t = entry["bbox_targets"]
            for cls in range(1, num_classes):
                inds = np.where(t[:, 0] == cls)[0]
                t[inds, 1:] = (t[inds, 1:] - means[cls]) / \
                    np.maximum(stds[cls], 1e-12)
    return means.ravel(), stds.ravel()
