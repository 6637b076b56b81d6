"""Detector assembly: trunk + RPN head + RCNN head (counterpart of
``wssdl_bus_tpu/models/detector.py``).

``FasterRCNN`` holds two modules, ``trunk`` (applied to images) and ``head``
(applied to ROI-pooled features); the detection geometry between them lives
in ``ops/``.  Public tensors keep the JAX package's NHWC layout: images
enter as [B, H, W, 3], and ``apply_trunk`` returns the feature map and RPN
outputs as [B, h, w, C], so the proposal layer flattens scores in the
(h, w, a) order the anchors are enumerated in.  Both return f32 whatever
the compute dtype (``build_detector(compute_dtype=torch.bfloat16)``,
``models/layers.py``), as the JAX package's ``apply_trunk`` /
``apply_head`` cast their outputs back.

``FasterRCNN.remat`` (False, True, "trunk" or "head") recomputes the
chosen parts' activations in the backward instead of keeping them, in
training only, a residual block (or a VGG16 conv stage) at a time
(``models/layers.py:checkpoint``); ``build_detector`` turns it on for
every ResNet and off for VGG16, the JAX package's defaults
(``wssdl_bus_tpu/models/detector.py:261-280``).
"""

from __future__ import annotations

import torch
from torch import nn

from wssdl_bus_tpu_torch.models.layers import ConvBlock, set_compute_dtype
from wssdl_bus_tpu_torch.models.resnet import (RESNET_DEFS, ResNetBackbone,
                                               ResNetRCNNHead,
                                               feature_channels)
from wssdl_bus_tpu_torch.models.vgg import VGG16Backbone, VGGRCNNHead
from wssdl_bus_tpu_torch.ops.conv1 import fused_stem_ok, vgg_stem_plain
from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
from wssdl_bus_tpu_torch.ops.conv2_pool import (conv2_pool_ok, vgg_conv1_1,
                                                vgg_conv2_pool_plain)
from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool
from wssdl_bus_tpu_torch.utils import resolve_device
from wssdl_bus_tpu_torch.utils.logging import span


class TrunkRPN(nn.Module):
    """Backbone features + RPN convs: a 3x3 conv (512 for VGG16 with a
    bias; for ResNet 256 basic / 1024 bottleneck, with the backbone's
    norm), then 1x1 convs to 2A class logits and 4A box deltas (reference
    VGGnet_train_bus.py:63-73, Resnet_train_bus.py:66-74)."""

    def __init__(self, num_anchors: int = 9, backbone: str = "VGGnet",
                 depth: int = 50, norm=None, gn_params=(8, 4)):
        super().__init__()
        if backbone == "VGGnet":
            self.backbone = VGG16Backbone()
            c, rpn_ch, rpn_norm = VGG16Backbone.out_channels, 512, None
        else:
            self.backbone = ResNetBackbone(depth, norm, gn_params)
            c = rpn_ch = feature_channels(depth)
            rpn_norm = norm
        self.rpn_conv = ConvBlock(c, rpn_ch, 3, norm=rpn_norm,
                                  gn_params=gn_params)
        self.rpn_cls_score = ConvBlock(rpn_ch, 2 * num_anchors, 1,
                                       padding="VALID", relu=False)
        self.rpn_bbox_pred = ConvBlock(rpn_ch, 4 * num_anchors, 1,
                                       padding="VALID", relu=False)

    def forward(self, data, stem_done: bool = False, remat: bool = False):
        """data [B, H, W, 3] -> (feat, rpn_cls_score, rpn_bbox_pred), each
        NHWC and contiguous.  With ``stem_done`` (VGG16 only) ``data`` is
        the pooled conv1 output [B, H/2, W/2, 64]
        (models/vgg.py:VGG16Backbone).  ``remat``: the backbone's
        activation remat (its stages or residual blocks in checkpoints)."""
        # the NCHW view of an NHWC tensor is channels_last memory: no copy
        x = data.permute(0, 3, 1, 2)
        if isinstance(self.backbone, VGG16Backbone):
            feat = self.backbone(x, stem_done, remat)
        elif stem_done:
            raise ValueError("stem_done is a VGG-only fast path")
        else:
            feat = self.backbone(x, remat)
        return self.heads(feat)

    def heads(self, feat, f32: bool = False):
        """The RPN convs over the NCHW (channels_last) feature map ->
        (feat, rpn_cls_score, rpn_bbox_pred), each NHWC f32 and contiguous;
        also the tail of the int8 trunk (``models/quantize.py``), which
        runs them in f32 (``f32``) whatever the compute dtype."""
        rpn = self.rpn_conv(feat, f32)
        score = self.rpn_cls_score(rpn, f32)
        bbox = self.rpn_bbox_pred(rpn, f32)
        return tuple(t.permute(0, 2, 3, 1).float().contiguous()
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
    """The detector: ``trunk`` (TrunkRPN) and ``head`` (``VGGRCNNHead``, or
    ``ResNetRCNNHead`` for ``backbone="Resnet"`` at ``depth`` with ``norm``
    "BN" / "GN" / None).  ``gn_params``: (GN_MIN_NUM_G, GN_MIN_CHS_PER_G),
    the group heuristic of every ``GroupNormRef``.  State-dict keys mirror
    the JAX variable tree (``models/convert.py``); BatchRenorm's running
    statistics are buffers, so ``state_dict()`` carries them.
    ``compute_dtype``: None (f32) or ``torch.bfloat16``, the compute dtype
    of every conv and dense layer (``models/layers.py``).

    ``remat``: False, True (both parts), "trunk" or "head", the parts whose
    activations are recomputed in the backward of a training step rather
    than kept (the JAX package's ``FasterRCNN.remat``,
    ``wssdl_bus_tpu/models/detector.py:104-117``).  The JAX package
    checkpoints each part whole, where XLA's fusion keeps few
    intermediates; eager PyTorch keeps every op's, and a checkpoint
    recomputes all of its part at once in the backward, so the port takes
    one checkpoint per residual block (per conv stage of VGG16's trunk;
    VGG16's head is one): the peak then holds one block's activations, not
    a part's (PERF.md §5).  The trunk's checkpoints start after the VGG
    stem kernels and the head's after the ROI pool, so every kernel
    launches as often a step as without remat; and the step's numbers are
    those without it, bit for bit (``models/layers.py:checkpoint``)."""

    def __init__(self, num_classes: int = 3, num_anchors: int = 9,
                 backbone: str = "VGGnet", depth: int = 50, norm=None,
                 gn_params=(8, 4), compute_dtype=None, remat=False):
        super().__init__()
        if backbone not in ("VGGnet", "Resnet"):
            raise KeyError(f"unknown backbone {backbone!r}")
        if remat not in (False, True, "trunk", "head"):
            raise ValueError(f"remat must be False, True, 'trunk' or "
                             f"'head', got {remat!r}")
        if backbone == "Resnet" and depth not in RESNET_DEFS:
            raise KeyError(f"unsupported ResNet depth {depth}")
        self.backbone = backbone
        self.depth = depth
        self.norm = norm if backbone == "Resnet" else None
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.trunk = TrunkRPN(num_anchors, backbone, depth, self.norm,
                              gn_params)
        self.head = (VGGRCNNHead(num_classes) if backbone == "VGGnet" else
                     ResNetRCNNHead(depth, self.norm, num_classes, gn_params))
        self.compute_dtype = compute_dtype
        set_compute_dtype(self, compute_dtype)
        self.remat = remat

    def _remat(self, part: str) -> bool:
        """Whether ``part`` ("trunk" / "head") runs under a checkpoint now:
        in training, with gradients recorded, and chosen by ``remat``."""
        return (self.training and torch.is_grad_enabled()
                and (self.remat is True or self.remat == part))

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
        ``vgg_conv2_pool_plain``).  The tail also requires the f32 compute
        dtype, as in the JAX package (``detector.py:198``); the fused stem
        does not, and hands its f32 output to conv2_1 under bf16 too.  A
        ResNet trunk has no stem kernel and runs its modules as they
        are.  Under trunk remat the backbone's stages or blocks after the
        stem run in checkpoints (the stem kernels' output is the first
        one's input)."""
        stem = None
        if self.backbone == "VGGnet" and (stem_frozen or not self.training):
            stem = self._stem(data, plain_ops)
        remat = self._remat("trunk")
        if stem is None:
            return self.trunk(data, remat=remat)
        return self.trunk(stem, stem_done=True, remat=remat)

    def _stem(self, data, plain_ops: bool):
        """The pooled conv1 output from a stem kernel (in the span ``stem``,
        as the library stem's stages are), or None when neither gate
        passes."""
        bb = self.trunk.backbone
        if fused_stem_ok(tuple(data.shape), data.device):
            fn = vgg_stem_plain if plain_ops else vgg_stem_fused
            with span("stem"), torch.no_grad():
                return fn(data, *_hwio(bb.conv1_1), *_hwio(bb.conv1_2))
        if conv2_pool_ok(tuple(data.shape), data.device) \
                and self.compute_dtype is None:
            fn = vgg_conv2_pool_plain if plain_ops else vgg_conv2_pool
            with span("stem"), torch.no_grad():
                a1 = vgg_conv1_1(data, *_hwio(bb.conv1_1),
                                 out_dtype=torch.bfloat16)
                return fn(a1, *_hwio(bb.conv1_2))
        return None

    def apply_head(self, roi_feats, keep=None, generator=None):
        """-> (cls_score [N, C], bbox_pred [N, 4C]) of the flat fc6 operand
        [N, 7*7*C] (VGG16) or the pooled [N, 7, 7, C] (ResNet).  In
        training mode the VGG head's dropouts use the masks ``keep`` (fc6,
        fc7) or draw from ``generator`` (models/vgg.py:VGGRCNNHead); the
        ResNet head has no dropout.  Both outputs f32.  Under head remat
        the head runs in checkpoints whose first input is the pooled
        operand (the ROI pool stays outside them)."""
        cls, bbox = self.head(roi_feats, keep, generator,
                              remat=self._remat("head"))
        return cls.float(), bbox.float()


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


def build_detector(name: str, num_classes: int = 3, device=None,
                   freeze_stem: bool = True, depth: int = 50, norm=None,
                   gn_params=(8, 4), compute_dtype=None,
                   remat=None) -> FasterRCNN:
    """Factory mirroring the JAX package's ``build_detector`` names:
    '*_test' builds the detector in eval mode, '*_train' (and '_alter'
    variants) in training mode.  'VGGnet_*' is VGG16, with conv1/conv2
    frozen in training (:func:`freeze_vgg_stem`) unless ``freeze_stem`` is
    False (from-scratch runs: a frozen random stem leaves the trunk
    featureless).  'Resnet_*' is the ResNet of ``depth`` (18, 34, 50, 101)
    with ``norm`` ("BN", "GN" or None) and ``gn_params``; nothing of it is
    frozen (``freeze_stem`` is ignored, as the JAX package's
    ``Engine.init`` ignores it).  ``compute_dtype`` None (f32) or
    ``torch.bfloat16`` (the ``--bf16`` option): the convs and dense layers
    compute in it, parameters stay f32.  ``remat`` (``FasterRCNN.remat``;
    the ``--remat`` option): None picks the JAX package's default, off for
    VGG16 and full remat (True) for every ResNet; False, True, "trunk" or
    "head" choose.  On ``device`` (CUDA unless named; raises without a
    card), channels_last.  Weights are PyTorch's default init: load
    converted or seeded weights with ``models/convert.py``."""
    if name.startswith("Resnet"):
        kw = dict(backbone="Resnet", depth=depth, norm=norm,
                  gn_params=tuple(gn_params),
                  remat=True if remat is None else remat)
    elif name.startswith("VGGnet"):
        kw = dict(backbone="VGGnet", remat=False if remat is None else remat)
    else:
        raise KeyError(f"unknown network name {name}")
    dev = resolve_device(device)
    model = FasterRCNN(num_classes=num_classes, compute_dtype=compute_dtype,
                       **kw).to(
        device=dev, memory_format=torch.channels_last)
    if "_train" in name:
        if model.backbone == "VGGnet" and freeze_stem:
            freeze_vgg_stem(model)
        return model.train()
    return model.eval()
