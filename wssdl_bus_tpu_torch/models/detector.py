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
from wssdl_bus_tpu_torch.ops.conv1 import fused_stem_ok, vgg_stem_plain
from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
from wssdl_bus_tpu_torch.ops.conv2_pool import (conv2_pool_ok, vgg_conv1_1,
                                                vgg_conv2_pool_plain)
from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool
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

    def forward(self, data, stem_done: bool = False):
        """data [B, H, W, 3] -> (feat, rpn_cls_score, rpn_bbox_pred), each
        NHWC and contiguous.  With ``stem_done`` ``data`` is the pooled
        conv1 output [B, H/2, W/2, 64] (models/vgg.py:VGG16Backbone)."""
        # the NCHW view of an NHWC tensor is channels_last memory: no copy
        x = data.permute(0, 3, 1, 2)
        feat = self.backbone(x, stem_done)
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

    def apply_trunk(self, data, stem_frozen: bool = True,
                    plain_ops: bool = False):
        """-> (feat, rpn_cls_score, rpn_bbox_pred), NHWC.

        The VGG stem dispatch of the JAX package's ``apply_trunk``
        (``wssdl_bus_tpu/models/detector.py:182-216``).  The default is the
        library stem (cuDNN convs).  Only in eval mode or with
        ``stem_frozen``, and on a CUDA device:

          * with ``WSSDL_FUSED_STEM=1`` and ``fused_stem_ok``: the whole
            stem in the kernel ``vgg_stem_fused`` (``ops/conv1_cuda.py``);
          * otherwise with ``WSSDL_STEM_TAIL=1`` and ``conv2_pool_ok``:
            conv1_1 as a library conv stored in bf16, then conv1_2 + pool
            in the kernel ``vgg_conv2_pool`` (``ops/conv2_pool_cuda.py``).

        Both round to bf16 as the JAX package's kernels do (``ops/conv1.py``)
        and have no backward: their output is computed under
        ``torch.no_grad()``, as the JAX package wraps it in
        ``stop_gradient``, which is sound only while conv1/conv2 never train
        (the Engine passes :func:`stem_is_frozen`).  An unfrozen stem in
        training runs the library stem with real gradients.  ``plain_ops``
        takes the kernels' plain versions instead (``vgg_stem_plain``,
        ``vgg_conv2_pool_plain``).  (The JAX tail also requires the f32
        compute path; the port has no other compute dtype yet.)"""
        stem = None
        if stem_frozen or not self.training:
            stem = self._stem(data, plain_ops)
        if stem is None:
            return self.trunk(data)
        return self.trunk(stem, stem_done=True)

    def _stem(self, data, plain_ops: bool):
        """The pooled conv1 output from a stem kernel, or None when neither
        gate passes."""
        bb = self.trunk.backbone
        if fused_stem_ok(tuple(data.shape), data.device):
            fn = vgg_stem_plain if plain_ops else vgg_stem_fused
            with torch.no_grad():
                return fn(data, *_hwio(bb.conv1_1), *_hwio(bb.conv1_2))
        if conv2_pool_ok(tuple(data.shape), data.device):
            fn = vgg_conv2_pool_plain if plain_ops else vgg_conv2_pool
            with torch.no_grad():
                a1 = vgg_conv1_1(data, *_hwio(bb.conv1_1),
                                 out_dtype=torch.bfloat16)
                return fn(a1, *_hwio(bb.conv1_2))
        return None

    def apply_head(self, roi_feats, keep=None, generator=None):
        """-> (cls_score [N, C], bbox_pred [N, 4C]).  In training mode the
        head's dropouts use the masks ``keep`` (fc6, fc7) or draw from
        ``generator`` (models/vgg.py:VGGRCNNHead)."""
        return self.head(roi_feats, keep, generator)


def _hwio(block: ConvBlock):
    """A 3x3 ConvBlock's (kernel HWIO [3, 3, C_in, C_out], bias), f32,
    contiguous (the stem kernels' layout)."""
    w = block.conv.weight.detach()
    return w.permute(2, 3, 1, 0).contiguous(), block.conv.bias.detach()


def stem_is_frozen(model: FasterRCNN) -> bool:
    """True iff every conv1_* / conv2_* parameter has ``requires_grad``
    False: the optimizer never updates them, so the stem kernels (no
    backward) may run in training.  The JAX package's
    ``stem_mask_is_frozen`` (``train/engine.py:95-110``)."""
    params = [p for n, p in model.trunk.backbone.named_parameters()
              if n.startswith(("conv1_", "conv2_"))]
    return bool(params) and not any(p.requires_grad for p in params)


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
