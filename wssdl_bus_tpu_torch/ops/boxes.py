"""Box geometry: encode/decode, clipping, IoU matrices.

PyTorch counterparts of ``wssdl_bus_tpu/ops/boxes.py`` (the reference's
``lib/fast_rcnn/bbox_transform.py:10-77`` and ``lib/utils/bbox.pyx``), with
the same +1 pixel-extent convention (w = x2 - x1 + 1) and the same order of
f32 operations, so results agree with the JAX package to the last bit
wherever ``exp`` does.
"""

from __future__ import annotations

import torch


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode gt boxes w.r.t. example boxes as (dx, dy, dw, dh) deltas.

    ex_rois: [N, 4], gt_rois: [N, 4] -> [N, 4]."""
    ex_w = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    ex_h = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ex_cx = ex_rois[:, 0] + 0.5 * ex_w
    ex_cy = ex_rois[:, 1] + 0.5 * ex_h

    gt_w = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gt_h = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gt_cx = gt_rois[:, 0] + 0.5 * gt_w
    gt_cy = gt_rois[:, 1] + 0.5 * gt_h

    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w / ex_w)
    dh = torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=1)


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode [..., N, 4K] deltas against [..., N, 4] boxes -> [..., N, 4K]
    boxes (leading batch dims broadcast)."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0::4]
    dy = deltas[..., 1::4]
    dw = deltas[..., 2::4]
    dh = deltas[..., 3::4]

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    # (x1, y1, x2, y2) interleaved back into [..., 4K]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_h, im_w) -> torch.Tensor:
    """Clip [..., N, 4K] boxes to [0, im_w-1] x [0, im_h-1].

    ``im_h``/``im_w`` are numbers or tensors that broadcast against
    ``boxes[..., 0]`` (e.g. [B, 1] for a batch of images)."""
    im_h = torch.as_tensor(im_h, dtype=boxes.dtype, device=boxes.device)
    im_w = torch.as_tensor(im_w, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x = torch.minimum(torch.maximum(boxes[..., 0::2], zero),
                      (im_w - 1.0)[..., None])
    y = torch.minimum(torch.maximum(boxes[..., 1::2], zero),
                      (im_h - 1.0)[..., None])
    return torch.stack([x, y], dim=-1).reshape(boxes.shape)


def _pairwise_intersection(boxes: torch.Tensor, query: torch.Tensor):
    """[N, K] intersection areas under the +1 convention (0 if no overlap)."""
    iw = (torch.minimum(boxes[:, None, 2], query[None, :, 2])
          - torch.maximum(boxes[:, None, 0], query[None, :, 0]) + 1.0)
    ih = (torch.minimum(boxes[:, None, 3], query[None, :, 3])
          - torch.maximum(boxes[:, None, 1], query[None, :, 1]) + 1.0)
    return iw.clamp_min(0.0) * ih.clamp_min(0.0)


def iou_matrix(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Dense [N, K] IoU between boxes [N, 4] and query [K, 4]; 0 where the
    boxes do not overlap (``bbox_overlaps``, bbox.pyx:15-55)."""
    inter = _pairwise_intersection(boxes, query)
    area_n = ((boxes[:, 2] - boxes[:, 0] + 1.0)
              * (boxes[:, 3] - boxes[:, 1] + 1.0))
    area_k = ((query[:, 2] - query[:, 0] + 1.0)
              * (query[:, 3] - query[:, 1] + 1.0))
    union = area_n[:, None] + area_k[None, :] - inter
    return torch.where(inter > 0.0, inter / union, torch.zeros_like(inter))


def iou_ui_matrix(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Unidirectional overlap [N, K]: intersection / area(boxes[n]), "how
    much of each box the query box covers" (``bbox_ui.pyx:12-47``); the
    SNUBH anchor labelling marks anchors covered by annotated background
    boxes as negatives with it."""
    inter = _pairwise_intersection(boxes, query)
    area_n = ((boxes[:, 2] - boxes[:, 0] + 1.0)
              * (boxes[:, 3] - boxes[:, 1] + 1.0))
    return torch.where(inter > 0.0, inter / area_n[:, None],
                       torch.zeros_like(inter))
