"""VGG16 trunk and RCNN head (counterparts of ``wssdl_bus_tpu/models/vgg.py``).

conv1-conv5 with 2x2 VALID max-pools and biased convs without
normalisation, and the fc6(512) -> dropout -> fc7(512) -> dropout ->
cls_score / bbox_pred head (dropout rate 0.5 in training, the identity in
eval mode).  Module names match the JAX package's (and so the reference's
variable scopes); ``models/convert.py`` maps one onto the other.
"""

from __future__ import annotations

from torch import nn

from wssdl_bus_tpu_torch.models.layers import ConvBlock, Dropout, Fc, max_pool

# (name, out channels), with a 2x2 max-pool after each stage but the last
VGG16_STAGES = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)


class VGG16Backbone(nn.Module):
    """[B, 3, H, W] -> [B, 512, H/16, W/16] (floor at every pool).

    ``stem_done=True`` means ``x`` is already the pooled conv1 output
    [B, 64, H/2, W/2] (the stem kernels, ``ops/conv1_cuda.py`` /
    ``ops/conv2_pool_cuda.py``) and conv1_1 / conv1_2 / pool1 are skipped;
    the parameters are the same either way."""

    out_channels = 512

    def __init__(self):
        super().__init__()
        in_ch = 3
        for stage in VGG16_STAGES:
            for name, ch in stage:
                self.add_module(name, ConvBlock(in_ch, ch, 3))
                in_ch = ch

    def forward(self, x, stem_done: bool = False):
        for s, stage in enumerate(VGG16_STAGES):
            if stem_done and s == 0:
                continue
            for name, _ in stage:
                x = getattr(self, name)(x)
            if s < len(VGG16_STAGES) - 1:
                x = max_pool(x, 2, 2)
        return x


class VGGRCNNHead(nn.Module):
    """fc6 -> drop6 -> fc7 -> drop7 -> (cls_score, bbox_pred) over flat NHWC
    pooled features [N, 7*7*512] (or [N, 7, 7, 512])."""

    def __init__(self, num_classes: int = 3, in_features: int = 7 * 7 * 512):
        super().__init__()
        self.fc6 = Fc(in_features, 512)
        self.fc7 = Fc(512, 512)
        self.cls_score = Fc(512, num_classes, relu=False)
        self.bbox_pred = Fc(512, num_classes * 4, relu=False)
        self.drop6 = Dropout(0.5)
        self.drop7 = Dropout(0.5)

    def forward(self, roi_feats, keep=None, generator=None):
        """``keep``: optional (fc6 mask, fc7 mask), bool [N, 512] each, for
        the two dropouts in training; drawn from ``generator`` when None."""
        k6, k7 = keep if keep is not None else (None, None)
        x = self.drop6(self.fc6(roi_feats), k6, generator)
        x = self.drop7(self.fc7(x), k7, generator)
        return self.cls_score(x), self.bbox_pred(x)
