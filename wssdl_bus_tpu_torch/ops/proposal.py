"""RPN proposal generation over a batch of images.

PyTorch counterpart of ``wssdl_bus_tpu/ops/proposal.py`` (the reference's
numpy ``proposal_layer_tf_bus.py:19-156``), with the JAX ``vmap`` written out
as a batch dimension:

  1. decode RPN box deltas against the shifted anchor grid,
  2. clip to each image's extent from ``im_info``,
  3. mark boxes with a side < RPN_MIN_SIZE * im_scale invalid,
  4. take the top ``pre_nms_top_n`` by score (a stable sort, so ties go to
     the lower anchor index as ``lax.sort`` does),
  5. greedy NMS at ``nms_thresh`` (``ops/nms_cuda.py:nms_keep``: the CUDA
     kernel on the card, one launch for the batch),
  6. keep the top ``post_nms_top_n`` survivors in score order, padded with a
     validity mask.

Every image yields exactly ``post_nms_top_n`` rows plus a mask.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from wssdl_bus_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
from wssdl_bus_tpu_torch.ops.roi_pool import rois_with_batch_index


class Proposals(NamedTuple):
    boxes: torch.Tensor   # [B, P, 4] in input-image coordinates
    scores: torch.Tensor  # [B, P]
    valid: torch.Tensor   # [B, P] bool


class Candidates(NamedTuple):
    """The score-sorted top ``pre_nms_top_n`` boxes: NMS's input."""
    boxes_t: torch.Tensor  # [B, 4, K] x1/y1/x2/y2 rows, score-descending
    scores: torch.Tensor   # [B, K]
    valid: torch.Tensor    # [B, K] bool


def top_candidates(rpn_cls_prob: torch.Tensor, rpn_bbox_pred: torch.Tensor,
                   im_info: torch.Tensor, anchors: torch.Tensor,
                   num_anchors: int, pre_nms_top_n: int,
                   min_size: float) -> Candidates:
    """Steps 1-4.  rpn_cls_prob [B, H, W, 2A] (channels [A:] foreground),
    rpn_bbox_pred [B, H, W, 4A], im_info [B, >=3] (height, width, scale),
    anchors [H*W*A, 4] in the (h, w, a) order of ``ops/anchors.py``."""
    b, _, _, twice_a = rpn_cls_prob.shape
    if twice_a != 2 * num_anchors:
        raise ValueError(f"rpn_cls_prob has {twice_a} channels, want "
                         f"{2 * num_anchors}")
    # foreground probabilities are the last A channels; flattening NHWC
    # row-major gives the (h, w, a) order the anchors are enumerated in
    scores = rpn_cls_prob[..., num_anchors:].reshape(b, -1)
    deltas = rpn_bbox_pred.reshape(b, -1, 4)

    proposals = bbox_transform_inv(anchors[None], deltas)
    proposals = clip_boxes(proposals, im_info[:, 0:1], im_info[:, 1:2])

    ws = proposals[..., 2] - proposals[..., 0] + 1.0
    hs = proposals[..., 3] - proposals[..., 1] + 1.0
    min_px = (min_size * im_info[:, 2])[:, None]
    valid = (ws >= min_px) & (hs >= min_px)

    k = min(pre_nms_top_n, scores.shape[1])
    masked = torch.where(valid, scores,
                         torch.tensor(float("-inf"), dtype=scores.dtype,
                                      device=scores.device))
    # ascending stable sort of the negated scores, exactly the JAX payload
    # sort's key and tie order
    _, order = torch.sort(-masked, dim=1, stable=True)
    order = order[:, :k]
    top_scores = torch.gather(masked, 1, order)
    boxes = torch.gather(proposals, 1, order[..., None].expand(b, k, 4))
    return Candidates(boxes.transpose(1, 2).contiguous(), top_scores,
                      torch.isfinite(top_scores))


def select_kept(cand: Candidates, keep: torch.Tensor,
                post_nms_top_n: int) -> Proposals:
    """Step 6: the first ``post_nms_top_n`` kept boxes in score order, then
    the suppressed ones (also in score order) as masked padding."""
    k = keep.shape[1]
    ar = torch.arange(k, device=keep.device)
    rank = torch.where(keep, ar, k + ar)        # unique: no tie to break
    kept_order = torch.argsort(rank, dim=1)[:, :post_nms_top_n]
    boxes = torch.gather(cand.boxes_t, 2,
                         kept_order[:, None, :].expand(-1, 4, -1))
    return Proposals(boxes.transpose(1, 2).contiguous(),
                     torch.gather(cand.scores, 1, kept_order),
                     torch.gather(keep, 1, kept_order))


def proposal_layer(rpn_cls_prob: torch.Tensor, rpn_bbox_pred: torch.Tensor,
                   im_info: torch.Tensor, anchors: torch.Tensor,
                   num_anchors: int = 9, pre_nms_top_n: int = 6000,
                   post_nms_top_n: int = 300, nms_thresh: float = 0.7,
                   min_size: float = 16.0,
                   nms: Callable = nms_keep) -> Proposals:
    """Batched proposal layer: [B, H, W, *] inputs -> Proposals with [B, P].

    ``nms`` is the keep-mask function; the default dispatches to the CUDA
    kernel on the card (``ops/nms.py:nms_mask`` is its plain version)."""
    cand = top_candidates(rpn_cls_prob, rpn_bbox_pred, im_info, anchors,
                          num_anchors, pre_nms_top_n, min_size)
    keep = nms(cand.boxes_t, cand.valid, nms_thresh)
    return select_kept(cand, keep, post_nms_top_n)


def proposals_to_rois(props: Proposals) -> torch.Tensor:
    """Flatten batched proposals into the reference's [N, 5] roi blob
    ``(batch_idx, x1, y1, x2, y2)``.  Rows where ``props.valid`` is False
    carry the coordinates of SUPPRESSED proposals, not zeros."""
    return rois_with_batch_index(props.boxes)
