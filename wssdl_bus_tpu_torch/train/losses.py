"""Loss functions, term for term as ``wssdl_bus_tpu/train/losses.py`` (the
reference's loss graph, ``lib/fast_rcnn/train_bus.py:605-678``):

  * RPN cross entropy over non-ignored anchors;
  * RPN "smooth L1" with sigma 3, x10, summed over (H, W) and meaned over
    (B_s, 4A), including the reference's quirk that the linear branch uses
    the RAW delta, not the inside-weighted one;
  * RCNN cross entropy and l1 box loss over the filled ROI slots;
  * the MIL bag cross entropy with class weights [0, WS_MAL_PCT,
    1 - WS_MAL_PCT] and the adaptive scale 1 - 0.99 * 0.9^floor(step/2000);
  * L2 weight decay over conv/fc weights only (no biases).

Padded rows are masked, never gathered away.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row sparse softmax cross entropy; labels outside [0, C) are
    clamped (the caller masks those rows)."""
    logp = F.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return -logp.gather(-1, safe[..., None])[..., 0]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def rpn_class_loss(rpn_cls_score: torch.Tensor, labels: torch.Tensor,
                   num_anchors: int) -> torch.Tensor:
    """Mean CE over anchors with label != -1.  rpn_cls_score [B, H, W, 2A]
    (channel a the bg logit, A+a the fg logit of anchor a); labels [B, K]
    in (h, w, a) order."""
    b, h, w, _ = rpn_cls_score.shape
    pair = rpn_cls_score.reshape(b, h, w, 2, num_anchors)
    logits = pair.movedim(3, 4).reshape(b, -1, 2)
    ce = softmax_ce(logits, labels.clamp_min(0))
    return _masked_mean(ce, labels != -1)


def rpn_box_loss(rpn_bbox_pred, targets, inside_w, outside_w,
                 num_supervised: int, num_anchors: int, sigma: float = 3.0,
                 scale: float = 10.0) -> torch.Tensor:
    """The reference smooth-L1 over the supervised images: rpn_bbox_pred
    [B, H, W, 4A]; targets and weights [B, K, 4] in (h, w, a) order.
    scale * sum(elementwise) / (B_s * 4A)."""
    b = rpn_bbox_pred.shape[0]
    pred = rpn_bbox_pred.reshape(b, -1, 4)[:num_supervised]
    diff = pred - targets[:num_supervised]
    sign = (diff.abs() < 1.0).to(diff.dtype)
    quad = 0.5 * torch.square(inside_w[:num_supervised] * diff * sigma) * sign
    # the linear branch takes the raw |diff| (reference quirk)
    lin = (diff.abs() - 0.5 / (sigma * sigma)) * (1.0 - sign)
    elem = outside_w[:num_supervised] * (quad + lin)
    return scale * elem.sum() / (num_supervised * 4 * num_anchors)


def rcnn_class_loss(cls_score: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over filled ROI slots: cls_score [N, C], labels [N] (-1 for
    padding)."""
    return _masked_mean(softmax_ce(cls_score, labels), labels >= 0)


def rcnn_box_loss(bbox_pred, targets, inside_w, outside_w,
                  labels) -> torch.Tensor:
    """l1 box loss: summed over the 4C columns, meaned over filled rows."""
    per_roi = (outside_w * inside_w * (bbox_pred - targets).abs()).sum(-1)
    return _masked_mean(per_roi, labels >= 0)


def mil_adaptive_scale(step, decay_base: float = 0.99,
                       decay_steps: int = 2000,
                       decay_rate: float = 0.9) -> torch.Tensor:
    """1 - 0.99 * 0.9^floor(step / 2000) in f32 (staircase)."""
    e = torch.floor(torch.tensor(float(step), dtype=torch.float32)
                    / decay_steps)
    return 1.0 - decay_base * torch.pow(
        torch.tensor(decay_rate, dtype=torch.float32), e)


def mil_class_loss(bag_logits: torch.Tensor, bag_labels: torch.Tensor,
                   ws_mal_pct: float, scale) -> torch.Tensor:
    """Weighted bag CE, meaned over bags: class weights [0, WS_MAL_PCT,
    1 - WS_MAL_PCT] indexed by the bag label, times ``scale``."""
    weights = torch.tensor([0.0, ws_mal_pct, 1.0 - ws_mal_pct],
                           dtype=bag_logits.dtype, device=bag_logits.device)
    w = weights[bag_labels.long()]
    scale = torch.as_tensor(scale, dtype=bag_logits.dtype,
                            device=bag_logits.device)
    return (scale * w * softmax_ce(bag_logits, bag_labels)).mean()


def weight_decay_loss(model: torch.nn.Module, decay: float) -> torch.Tensor:
    """0.5 * decay * sum ||W||^2 over every conv/fc weight (the reference's
    '*weights:0' variables: biases are excluded; frozen weights add a
    constant)."""
    total = sum(0.5 * torch.sum(torch.square(p))
                for name, p in model.named_parameters()
                if name.rsplit(".", 1)[-1] == "weight")
    return decay * total
