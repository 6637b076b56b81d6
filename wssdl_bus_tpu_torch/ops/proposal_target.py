"""Proposal-to-GT assignment and ROI sampling for the RCNN head.

PyTorch counterpart of ``wssdl_bus_tpu/ops/proposal_target.py`` (the
reference's ``proposal_target_layer_tf_bus.py``): for each supervised image
the foreground GT boxes join the proposals, then ``rois_per_image`` (128)
ROIs are sampled with at most FG_FRACTION of them foreground (IoU >=
FG_THRESH) and the rest background (IoU in [BG_THRESH_LO, BG_THRESH_HI)).

Every image yields exactly ``rois_per_image`` slots, foreground first, then
background, then padding with label -1.  Sampling ranks the candidates by a
uniform draw with a stable argsort (ties to the lower index, as
``jnp.argsort``); each image's fg and bg draws may be passed in, otherwise
they come from ``generator``.  Weak images bypass this layer: their
proposals go to the head as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wssdl_bus_tpu_torch.ops.boxes import bbox_transform, iou_matrix


class RoiSamples(NamedTuple):
    rois: torch.Tensor             # [B, R, 4] sampled boxes (image coords)
    labels: torch.Tensor           # [B, R] int32; -1 = unfilled slot
    bbox_targets: torch.Tensor     # [B, R, 4*num_classes]
    inside_weights: torch.Tensor   # [B, R, 4*num_classes]
    outside_weights: torch.Tensor  # [B, R, 4*num_classes]


def num_candidates(num_proposals: int, num_gt_slots: int,
                   rois_per_image: int, include_gt: bool = True) -> int:
    """Rows of the candidate set the uniforms are drawn over: proposals,
    plus the GT slots when ``include_gt``, padded to ``rois_per_image``."""
    n = num_proposals + (num_gt_slots if include_gt else 0)
    return max(n, rois_per_image)


def _rank(u: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Each row's position in the descending order of ``u`` among the
    candidates (non-candidates last), by a stable ascending sort of -u."""
    r = torch.where(cand, u, torch.full_like(u, float("-inf")))
    order = torch.argsort(-r, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=u.device)
    return rank


def sample_rois_single(prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                       gt_boxes: torch.Tensor, num_gt, u_fg: torch.Tensor,
                       u_bg: torch.Tensor, num_classes: int,
                       rois_per_image: int = 128, fg_fraction: float = 0.25,
                       fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                       bg_thresh_lo: float = 0.0, include_gt: bool = True,
                       bbox_inside_weights=(1.0, 1.0, 1.0, 1.0),
                       normalize_targets: bool = False,
                       normalize_means=(0.0, 0.0, 0.0, 0.0),
                       normalize_stds=(0.1, 0.1, 0.2, 0.2)):
    """Sample ROIs for ONE supervised image: prop_boxes [P, 4], prop_valid
    [P], gt_boxes [G, 5], num_gt a count, u_fg/u_bg [num_candidates]."""
    dev = prop_boxes.device
    g = gt_boxes.shape[0]
    gt_valid = torch.arange(g, device=dev) < num_gt
    is_fg_gt = gt_valid & (gt_boxes[:, 4] != 0)

    if include_gt:
        all_boxes = torch.cat([prop_boxes, gt_boxes[:, :4]])
        all_valid = torch.cat([prop_valid, is_fg_gt])
    else:
        all_boxes, all_valid = prop_boxes, prop_valid
    if all_boxes.shape[0] < rois_per_image:
        short = rois_per_image - all_boxes.shape[0]
        all_boxes = torch.cat([all_boxes, all_boxes.new_zeros((short, 4))])
        all_valid = torch.cat([all_valid,
                               all_valid.new_zeros((short,))])
    n = all_boxes.shape[0]

    ov = iou_matrix(all_boxes, gt_boxes[:, :4])
    ov = torch.where(is_fg_gt[None, :], ov,
                     torch.tensor(-1.0, dtype=ov.dtype, device=dev))
    gt_assignment = ov.argmax(dim=1)
    max_ov = ov.max(dim=1).values
    roi_labels = gt_boxes[gt_assignment, 4].to(torch.int32)

    fg_cand = all_valid & (max_ov >= fg_thresh)
    bg_cand = all_valid & (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo)

    fg_per_image = int(round(fg_fraction * rois_per_image))
    fg_rank = _rank(u_fg, fg_cand)
    fg_sel = fg_cand & (fg_rank < fg_per_image)
    n_fg = fg_sel.sum()
    bg_rank = _rank(u_bg, bg_cand)
    bg_sel = bg_cand & (bg_rank < rois_per_image - n_fg)
    n_bg = bg_sel.sum()

    # pack: fg slots first, then bg, then padding (all keys distinct)
    big = 1 << 20
    ar = torch.arange(n, device=dev)
    sort_key = torch.where(fg_sel, fg_rank,
                           torch.where(bg_sel, big + bg_rank, 2 * big + ar))
    order = torch.argsort(sort_key, stable=True)[:rois_per_image]

    slot = torch.arange(rois_per_image, device=dev)
    filled = slot < n_fg + n_bg
    is_fg_slot = slot < n_fg
    rois = all_boxes[order]
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    labels = torch.where(is_fg_slot, roi_labels[order], zero_i)
    labels = torch.where(filled, labels, zero_i - 1)

    tgt = bbox_transform(rois, gt_boxes[gt_assignment[order], :4])
    if normalize_targets:
        tgt = ((tgt - torch.tensor(normalize_means, dtype=tgt.dtype,
                                   device=dev))
               / torch.tensor(normalize_stds, dtype=tgt.dtype, device=dev))
    has_reg = (labels > 0)[:, None]
    cols = (labels.clamp(0, num_classes - 1)[:, None].long() * 4
            + torch.arange(4, device=dev)[None, :])
    zero = torch.zeros((), dtype=tgt.dtype, device=dev)
    bbox_targets = tgt.new_zeros((rois_per_image, 4 * num_classes))
    bbox_targets.scatter_(1, cols, torch.where(has_reg, tgt, zero))
    iw = torch.tensor(bbox_inside_weights, dtype=tgt.dtype,
                      device=dev).expand(rois_per_image, 4)
    inside_w = tgt.new_zeros((rois_per_image, 4 * num_classes))
    inside_w.scatter_(1, cols, torch.where(has_reg, iw, zero))
    outside_w = (inside_w > 0).to(tgt.dtype)
    return rois, labels, bbox_targets, inside_w, outside_w


def proposal_target_layer(prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                          gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                          num_classes: int,
                          uniforms: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          rois_per_image: int = 128,
                          fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                          bg_thresh_hi: float = 0.5,
                          bg_thresh_lo: float = 0.0, include_gt: bool = True,
                          bbox_inside_weights=(1.0, 1.0, 1.0, 1.0),
                          normalize_targets: bool = False,
                          normalize_means=(0.0, 0.0, 0.0, 0.0),
                          normalize_stds=(0.1, 0.1, 0.2, 0.2)) -> RoiSamples:
    """Batched supervised ROI sampling: prop_boxes [B, P, 4], prop_valid
    [B, P], gt_boxes [B, G, 5], num_gt [B].  ``uniforms``: [B, 2, n] with n
    = :func:`num_candidates` (each image's fg then bg draws); drawn from
    ``generator`` on the proposals' device when None."""
    b, p, _ = prop_boxes.shape
    n = num_candidates(p, gt_boxes.shape[1], rois_per_image, include_gt)
    if uniforms is None:
        uniforms = torch.rand((b, 2, n), generator=generator,
                              device=prop_boxes.device,
                              dtype=prop_boxes.dtype)
    out = [sample_rois_single(
        prop_boxes[i], prop_valid[i], gt_boxes[i], num_gt[i],
        uniforms[i, 0], uniforms[i, 1], num_classes,
        rois_per_image=rois_per_image, fg_fraction=fg_fraction,
        fg_thresh=fg_thresh, bg_thresh_hi=bg_thresh_hi,
        bg_thresh_lo=bg_thresh_lo, include_gt=include_gt,
        bbox_inside_weights=bbox_inside_weights,
        normalize_targets=normalize_targets,
        normalize_means=normalize_means, normalize_stds=normalize_stds)
        for i in range(b)]
    return RoiSamples(*(torch.stack(t) for t in zip(*out)))
