"""Detector assembly: trunk + RPN head + RCNN head (counterpart of
``wssdl_bus_tpu/models/detector.py``).

``FasterRCNN`` holds two modules, ``trunk`` (applied to images) and ``head``
(applied to ROI-pooled features); the detection geometry between them lives
in ``ops/``.  Public tensors keep the JAX package's NHWC layout: images
enter as [B, H, W, 3], and ``apply_trunk`` returns the feature map and RPN
outputs as [B, h, w, C], so the proposal layer flattens scores in the
(h, w, a) order the anchors are enumerated in.
"""

from __future__ import annotations

import torch
from torch import nn

from wssdl_bus_tpu_torch.models.layers import ConvBlock
from wssdl_bus_tpu_torch.models.vgg import VGG16Backbone, VGGRCNNHead
from wssdl_bus_tpu_torch.utils import resolve_device


class TrunkRPN(nn.Module):
    """VGG16 features + RPN convs: a 3x3 conv to 512, then 1x1 convs to 2A
    class logits and 4A box deltas (reference VGGnet_train_bus.py:63-73)."""

    def __init__(self, num_anchors: int = 9):
        super().__init__()
        self.backbone = VGG16Backbone()
        c = VGG16Backbone.out_channels
        self.rpn_conv = ConvBlock(c, 512, 3)
        self.rpn_cls_score = ConvBlock(512, 2 * num_anchors, 1,
                                       padding="VALID", relu=False)
        self.rpn_bbox_pred = ConvBlock(512, 4 * num_anchors, 1,
                                       padding="VALID", relu=False)

    def forward(self, data):
        """data [B, H, W, 3] -> (feat, rpn_cls_score, rpn_bbox_pred), each
        NHWC and contiguous."""
        # the NCHW view of an NHWC tensor is channels_last memory: no copy
        x = data.permute(0, 3, 1, 2)
        feat = self.backbone(x)
        rpn = self.rpn_conv(feat)
        score = self.rpn_cls_score(rpn)
        bbox = self.rpn_bbox_pred(rpn)
        return tuple(t.permute(0, 2, 3, 1).contiguous()
                     for t in (feat, score, bbox))


def rpn_softmax(rpn_cls_score: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """Per-anchor bg/fg softmax over the paired channels (a, A+a) of an NHWC
    score map: channel ``a`` is anchor a's background logit, ``A+a`` its
    foreground logit (reference network.py:283-291,398-404)."""
    bg = rpn_cls_score[..., :num_anchors]
    fg = rpn_cls_score[..., num_anchors:]
    m = torch.maximum(bg, fg)
    eb = torch.exp(bg - m)
    ef = torch.exp(fg - m)
    s = eb + ef
    return torch.cat([eb / s, ef / s], dim=-1)


class FasterRCNN(nn.Module):
    """The VGG16 detector: ``trunk`` (TrunkRPN) and ``head`` (VGGRCNNHead).
    State-dict keys mirror the JAX variable tree (``models/convert.py``)."""

    backbone = "VGGnet"

    def __init__(self, num_classes: int = 3, num_anchors: int = 9):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.trunk = TrunkRPN(num_anchors)
        self.head = VGGRCNNHead(num_classes)

    def apply_trunk(self, data):
        """-> (feat, rpn_cls_score, rpn_bbox_pred), NHWC."""
        return self.trunk(data)

    def apply_head(self, roi_feats, keep=None, generator=None):
        """-> (cls_score [N, C], bbox_pred [N, 4C]).  In training mode the
        head's dropouts use the masks ``keep`` (fc6, fc7) or draw from
        ``generator`` (models/vgg.py:VGGRCNNHead)."""
        return self.head(roi_feats, keep, generator)


def freeze_vgg_stem(model: FasterRCNN) -> FasterRCNN:
    """conv1_* and conv2_* never train (the reference's trainable=False,
    VGGnet_train_bus.py:45-49; the JAX package's ``vgg_frozen_mask``):
    their parameters stop requiring gradients, so the optimizer, which
    takes only parameters that do, leaves them bit for bit."""
    for name, module in model.trunk.backbone.named_children():
        if name.startswith(("conv1_", "conv2_")):
            module.requires_grad_(False)
    return model


def build_detector(name: str, num_classes: int = 3,
                   device=None) -> FasterRCNN:
    """Factory mirroring the JAX package's ``build_detector`` names:
    'VGGnet_test' builds the VGG16 detector in eval mode, 'VGGnet_train'
    (and '_alter' variants) in training mode with conv1/conv2 frozen
    (:func:`freeze_vgg_stem`), on ``device`` (CUDA unless named; raises
    without a card).  Weights are PyTorch's default init: load converted or
    seeded weights with ``models/convert.py``."""
    if name.startswith("Resnet"):
        raise NotImplementedError(
            f"{name}: the ResNet backbones are not ported yet (the ResNet "
            "slice, ROADMAP.md)")
    if not name.startswith("VGGnet"):
        raise KeyError(f"unknown network name {name}")
    dev = resolve_device(device)
    model = FasterRCNN(num_classes=num_classes).to(
        device=dev, memory_format=torch.channels_last)
    if "_train" in name:
        return freeze_vgg_stem(model).train()
    return model.eval()
