"""Pre-activation ResNet backbones and the per-ROI head (counterparts of
``wssdl_bus_tpu/models/resnet.py``; the reference's
``Resnet_train_bus.py:55-101`` graphs and ``network.py:418-468`` blocks).

  * depth table {18: [2,2,2,2] basic, 34: [3,4,6,3] basic, 50: [3,4,6,3]
    bottleneck, 101: [3,4,23,3] bottleneck};
  * conv0 7x7/2 (+ norm + ReLU) -> 3x3/2 VALID max-pool -> groups 0-2 as
    the shared stride-16 features, then a norm + ReLU (``group2_norm``);
  * group3 runs on the 7x7 ROI-pooled features as the per-ROI head (stride
    2, so 4x4), then a norm + ReLU, the mean over H and W, and the
    ``cls_score`` / ``bbox_pred`` dense layers;
  * the pre-activation quirk exactly: in "default" blocks the shortcut
    input is taken BEFORE the preact norm, in "both_preact" blocks after
    it, and group0's block0 has no preact.

The bottleneck puts the stride on conv2; ``convshortcut`` exists only where
the block changes the channel count.  Norm "BN" (``BatchRenorm``), "GN"
(``GroupNormRef``, ``gn_params`` = (GN_MIN_NUM_G, GN_MIN_CHS_PER_G)) or
None.  Module names are the JAX package's, so state-dict keys follow its
variable tree (``models/convert.py``).  Tensors are NCHW.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from wssdl_bus_tpu_torch.models.layers import ConvBlock, Fc, make_norm

RESNET_DEFS = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
}


def feature_channels(depth: int) -> int:
    """Channels of the stride-16 map (and of the RPN conv): 256 for the
    basic blocks, 1024 for the bottleneck ones."""
    return 256 if RESNET_DEFS[depth][1] == "basic" else 1024


def _norm_relu(norm_name, x, module):
    if norm_name is not None:
        x = getattr(module, norm_name)(x)
    return F.relu(x)


class _Block(nn.Module):
    """One preact residual block, basic or bottleneck."""

    def __init__(self, c_in: int, features: int, stride: int, preact: str,
                 kind: str, norm, gn_params):
        super().__init__()
        self.preact = preact
        conv = dict(norm=norm, gn_params=gn_params)
        self.has_norm = preact != "no_preact" and norm is not None
        if self.has_norm:
            self.preact_prev = make_norm(norm, c_in, gn_params)
        if kind == "basic":
            self.conv1 = ConvBlock(c_in, features, 3, stride=stride, **conv)
            self.conv2 = ConvBlock(features, features, 3, relu=False, **conv)
            c_out = features
        else:
            self.conv1 = ConvBlock(c_in, features, 1, **conv)
            self.conv2 = ConvBlock(features, features, 3, stride=stride,
                                   **conv)
            self.conv3 = ConvBlock(features, features * 4, 1, relu=False,
                                   **conv)
            c_out = features * 4
        self.kind = kind
        if c_in != c_out:
            self.convshortcut = ConvBlock(c_in, c_out, 1, stride=stride,
                                          relu=False, **conv)
        else:
            self.convshortcut = None

    def forward(self, x):
        if self.preact == "no_preact":
            x_ori = x
        else:
            pre = _norm_relu("preact_prev" if self.has_norm else None, x,
                             self)
            # both_preact: the shortcut takes the normalised input
            x_ori = pre if self.preact == "both_preact" else x
            x = pre
        y = self.conv2(self.conv1(x))
        if self.kind != "basic":
            y = self.conv3(y)
        sc = x_ori if self.convshortcut is None else self.convshortcut(x_ori)
        return y + sc


class _Group(nn.Module):
    """A stack of blocks (network.py:459-468): block0 at ``stride``
    ("no_preact" for group0, else "both_preact"), the rest "default"."""

    def __init__(self, c_in: int, features: int, count: int, stride: int,
                 first: bool, kind: str, norm, gn_params):
        super().__init__()
        c_out = features * (1 if kind == "basic" else 4)
        self.add_module("block0", _Block(
            c_in, features, stride, "no_preact" if first else "both_preact",
            kind, norm, gn_params))
        for i in range(1, count):
            self.add_module(f"block{i}", _Block(c_out, features, 1, "default",
                                                kind, norm, gn_params))
        self.out_channels = c_out

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class ResNetBackbone(nn.Module):
    """[B, 3, H, W] -> [B, C, h, w] at stride 16 (C = 256 basic, 1024
    bottleneck): conv0, the max-pool, groups 0-2, ``group2_norm`` + ReLU."""

    def __init__(self, depth: int = 50, norm="BN", gn_params=(8, 4)):
        super().__init__()
        defs, kind = RESNET_DEFS[depth]
        self.conv0 = ConvBlock(3, 64, 7, stride=2, norm=norm,
                               gn_params=gn_params)
        c = 64
        for g, (features, stride) in enumerate(((64, 1), (128, 2),
                                                (256, 2))):
            group = _Group(c, features, defs[g], stride, g == 0, kind, norm,
                           gn_params)
            self.add_module(f"group{g}", group)
            c = group.out_channels
        self.out_channels = c
        self.group2_norm = make_norm(norm, c, gn_params)

    def forward(self, x):
        x = self.conv0(x)
        x = F.max_pool2d(x, 3, 2)      # 3x3/2 VALID
        x = self.group2(self.group1(self.group0(x)))
        if self.group2_norm is not None:
            x = self.group2_norm(x)
        return F.relu(x)


class ResNetRCNNHead(nn.Module):
    """group3 (stride 2) on the ROI features [N, 7, 7, C] (NHWC), its norm
    + ReLU, the mean over H and W, then ``cls_score`` and ``bbox_pred``
    (the JAX package initialises the latter with std 0.001)."""

    def __init__(self, depth: int = 50, norm="BN", num_classes: int = 3,
                 gn_params=(8, 4)):
        super().__init__()
        defs, kind = RESNET_DEFS[depth]
        self.group3 = _Group(feature_channels(depth), 512, defs[3], 2, False,
                             kind, norm, gn_params)
        c = self.group3.out_channels
        self.group3_norm = make_norm(norm, c, gn_params)
        self.cls_score = Fc(c, num_classes, relu=False)
        self.bbox_pred = Fc(c, num_classes * 4, relu=False)

    def forward(self, roi_feats, keep=None, generator=None):
        """-> (cls_score, bbox_pred); ``keep`` and ``generator`` are the
        VGG head's dropout arguments, unused here (no dropout)."""
        # the NCHW view of an NHWC tensor is channels_last memory: no copy
        x = self.group3(roi_feats.permute(0, 3, 1, 2))
        if self.group3_norm is not None:
            x = self.group3_norm(x)
        x = F.relu(x).mean(dim=(2, 3))
        return self.cls_score(x), self.bbox_pred(x)
