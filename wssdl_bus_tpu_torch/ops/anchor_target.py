"""RPN anchor labelling and regression targets.

PyTorch counterpart of ``wssdl_bus_tpu/ops/anchor_target.py`` (the
reference's ``anchor_target_layer_tf_bus.py``), with the same three dataset
modes:

  * SNUBH: positives by IoU against the foreground GT boxes; negatives are
    anchors that annotated background (normal-tissue, class 0) boxes cover
    by at least RPN_POSITIVE_OVERLAP, by the unidirectional overlap;
  * SNUBH_FG: classic labelling against the foreground GT boxes only;
  * UDIAT (and any other name): classic labelling against every GT box.

Labels and targets are laid out [K = H*W*A] in (h, w, a) order; anchors
outside the image are ignored through a mask.  The random fg/bg subsampling
ranks each candidate by a uniform draw and keeps the largest: the JAX
package takes ``lax.top_k`` (ties to the lower index), this port a stable
descending sort, which selects the same set from the same draws.  Each
image's two uniform vectors may be passed in (the tests hand over the JAX
package's); otherwise they are drawn from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wssdl_bus_tpu_torch.ops.boxes import (bbox_transform, iou_matrix,
                                           iou_ui_matrix)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor           # [B, K] int32 in {-1, 0, 1}
    bbox_targets: torch.Tensor     # [B, K, 4]
    inside_weights: torch.Tensor   # [B, K, 4]
    outside_weights: torch.Tensor  # [B, K, 4]


def _masked_keep_topk(u: torch.Tensor, cand: torch.Tensor, limit,
                      cap: Optional[int] = None) -> torch.Tensor:
    """Keep the (at most ``limit``) candidates with the largest uniform
    draws ``u``; ``limit`` may be a 0-d tensor.  ``cap`` is a static bound
    on ``limit`` (the JAX package's ``static_cap``): only the first ``cap``
    ranks are considered, which changes nothing while limit <= cap."""
    n = cand.shape[0]
    r = torch.where(cand, u, torch.full_like(u, float("-inf")))
    order = torch.sort(r, descending=True, stable=True).indices
    if cap is not None and cap < n:
        order = order[:cap]
    pos = torch.arange(order.shape[0], device=u.device)
    sel = (pos < limit) & torch.isfinite(r[order])
    keep = torch.zeros(n, dtype=torch.bool, device=u.device)
    keep[order] = sel
    return cand & keep


def anchor_target_single(gt_boxes: torch.Tensor, num_gt, im_info,
                         anchors: torch.Tensor, u_fg: torch.Tensor,
                         u_bg: torch.Tensor, dataset: str = "SNUBH",
                         rpn_batchsize: int = 256,
                         rpn_fg_fraction: float = 0.5,
                         pos_overlap: float = 0.7, neg_overlap: float = 0.3,
                         clobber_positives: bool = False,
                         allowed_border: float = 0.0,
                         bbox_inside_weights=(1.0, 1.0, 1.0, 1.0),
                         positive_weight: float = -1.0):
    """Anchor targets for ONE supervised image: gt_boxes [G, 5], num_gt a
    count, im_info [>=2] (height, width), anchors [K, 4], u_fg/u_bg [K]
    uniforms.  -> (labels [K] int32, targets [K, 4], inside_w [K, 4],
    outside_w [K, 4])."""
    dev = anchors.device
    k = anchors.shape[0]
    g = gt_boxes.shape[0]
    gt_valid = torch.arange(g, device=dev) < num_gt
    is_fg_gt = gt_valid & (gt_boxes[:, 4] != 0)
    is_bg_gt = gt_valid & (gt_boxes[:, 4] == 0)

    inside = ((anchors[:, 0] >= -allowed_border)
              & (anchors[:, 1] >= -allowed_border)
              & (anchors[:, 2] < im_info[1] + allowed_border)
              & (anchors[:, 3] < im_info[0] + allowed_border))
    minus1 = torch.tensor(-1.0, dtype=anchors.dtype, device=dev)
    labels = torch.full((k,), -1, dtype=torch.int32, device=dev)

    def lab(cond, value):
        return torch.where(cond, torch.tensor(value, dtype=torch.int32,
                                              device=dev), labels)

    if dataset == "SNUBH":
        ov = iou_matrix(anchors, gt_boxes[:, :4])
        ov = torch.where(is_fg_gt[None, :], ov, minus1)
        ov = torch.where(inside[:, None], ov, minus1)
        max_ov, argmax = ov.max(dim=1).values, ov.argmax(dim=1)
        # negatives: anchors mostly covered by annotated background boxes
        ov_neg = iou_ui_matrix(anchors, gt_boxes[:, :4])
        ov_neg = torch.where(is_bg_gt[None, :], ov_neg, minus1)
        max_neg = ov_neg.max(dim=1).values
        if not clobber_positives:
            labels = lab(inside & (max_neg >= pos_overlap), 0)
        col_max = torch.where(inside[:, None], ov, minus1).max(dim=0).values
        is_col_best = (ov == col_max[None, :]) & is_fg_gt[None, :]
        labels = lab(inside & is_col_best.any(dim=1), 1)
        labels = lab(inside & (max_ov >= pos_overlap), 1)
    else:
        col_ok = is_fg_gt if dataset == "SNUBH_FG" else gt_valid
        ov = iou_matrix(anchors, gt_boxes[:, :4])
        ov = torch.where(col_ok[None, :], ov, minus1)
        ov = torch.where(inside[:, None], ov, minus1)
        max_ov, argmax = ov.max(dim=1).values, ov.argmax(dim=1)
        if not clobber_positives:
            labels = lab(inside & (max_ov < neg_overlap), 0)
        col_max = ov.max(dim=0).values
        is_col_best = (ov == col_max[None, :]) & col_ok[None, :]
        labels = lab(inside & is_col_best.any(dim=1), 1)
        labels = lab(inside & (max_ov >= pos_overlap), 1)
        if clobber_positives:
            labels = lab(inside & (max_ov < neg_overlap), 0)

    # subsample positives to RPN_FG_FRACTION * RPN_BATCHSIZE, then
    # negatives to RPN_BATCHSIZE - #positives
    num_fg_cap = int(rpn_fg_fraction * rpn_batchsize)
    fg = labels == 1
    fg_kept = _masked_keep_topk(u_fg, fg, num_fg_cap, cap=num_fg_cap)
    labels = lab(fg & ~fg_kept, -1)
    num_bg_cap = rpn_batchsize - (labels == 1).sum()
    bg = labels == 0
    bg_kept = _masked_keep_topk(u_bg, bg, num_bg_cap, cap=rpn_batchsize)
    labels = lab(bg & ~bg_kept, -1)

    # regression targets toward each inside anchor's best gt (an exact
    # gather: the JAX package's one-hot product at HIGHEST precision)
    targets = bbox_transform(anchors, gt_boxes[argmax, :4])
    targets = torch.where(inside[:, None], targets,
                          torch.zeros((), dtype=targets.dtype, device=dev))
    iw = torch.tensor(bbox_inside_weights, dtype=targets.dtype, device=dev)
    zero = torch.zeros((), dtype=targets.dtype, device=dev)
    inside_w = torch.where((labels == 1)[:, None], iw.expand(k, 4), zero)
    if positive_weight < 0:
        num_examples = (labels >= 0).sum().clamp_min(1)
        uniform_w = 1.0 / num_examples.to(targets.dtype)
        outside_w = torch.where((labels >= 0)[:, None], uniform_w,
                                zero).expand(k, 4)
    else:
        assert 0.0 < positive_weight < 1.0, positive_weight
        num_pos = (labels == 1).sum().clamp_min(1).to(targets.dtype)
        num_neg = (labels == 0).sum().clamp_min(1).to(targets.dtype)
        outside_w = torch.where(
            (labels == 1)[:, None], positive_weight / num_pos,
            torch.where((labels == 0)[:, None],
                        (1.0 - positive_weight) / num_neg, zero)
        ).expand(k, 4)
    return labels, targets, inside_w, outside_w.contiguous()


def anchor_target_layer_joint(gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                              im_info: torch.Tensor, anchors: torch.Tensor,
                              num_supervised: int,
                              uniforms: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              dataset: str = "SNUBH",
                              rpn_batchsize: int = 256,
                              rpn_fg_fraction: float = 0.5,
                              pos_overlap: float = 0.7,
                              neg_overlap: float = 0.3,
                              clobber_positives: bool = False,
                              bbox_inside_weights=(1.0, 1.0, 1.0, 1.0),
                              positive_weight: float = -1.0
                              ) -> AnchorTargets:
    """Joint batch: the first ``num_supervised`` images labelled, the weak
    ones after them all-ignore with zero targets and weights.

    gt_boxes [B, G, 5], num_gt [B], im_info [B, >=2], anchors [K, 4].
    ``uniforms``: [num_supervised, 2, K] (each image's fg then bg draws);
    drawn from ``generator`` on the anchors' device when None."""
    b = gt_boxes.shape[0]
    k = anchors.shape[0]
    dev = anchors.device
    if uniforms is None:
        uniforms = torch.rand((num_supervised, 2, k), generator=generator,
                              device=dev, dtype=anchors.dtype)
    labels = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    targets = torch.zeros((b, k, 4), dtype=anchors.dtype, device=dev)
    in_w = torch.zeros_like(targets)
    out_w = torch.zeros_like(targets)
    for i in range(num_supervised):
        labels[i], targets[i], in_w[i], out_w[i] = anchor_target_single(
            gt_boxes[i], num_gt[i], im_info[i], anchors, uniforms[i, 0],
            uniforms[i, 1], dataset=dataset, rpn_batchsize=rpn_batchsize,
            rpn_fg_fraction=rpn_fg_fraction, pos_overlap=pos_overlap,
            neg_overlap=neg_overlap, clobber_positives=clobber_positives,
            bbox_inside_weights=tuple(bbox_inside_weights),
            positive_weight=positive_weight)
    return AnchorTargets(labels, targets, in_w, out_w)
