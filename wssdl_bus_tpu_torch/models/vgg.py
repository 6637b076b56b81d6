"""VGG16 trunk and RCNN head (counterparts of ``wssdl_bus_tpu/models/vgg.py``).

conv1-conv5 with 2x2 VALID max-pools and biased convs without
normalisation, and the fc6(512) -> dropout -> fc7(512) -> dropout ->
cls_score / bbox_pred head (dropout rate 0.5 in training, the identity in
eval mode).  Module names match the JAX package's (and so the reference's
variable scopes); ``models/convert.py`` maps one onto the other.  The stem
(conv1-conv2 with pool1-2, frozen in training) runs in the span ``stem``
(``utils/logging.py:span``).  Under
activation remat (``models/detector.py:FasterRCNN.remat``) each conv stage
of the trunk runs in a checkpoint of its own, and the head in one, its
dropout masks drawn first (``models/layers.py:checkpoint``).
"""

from __future__ import annotations

from torch import nn

from wssdl_bus_tpu_torch.models.layers import (ConvBlock, Dropout, Fc,
                                               checkpoint, max_pool)
from wssdl_bus_tpu_torch.utils.logging import span

# (name, out channels), with a 2x2 max-pool after each stage but the last
VGG16_STAGES = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)
STEM_STAGES = 2     # conv1 and conv2 with their pools: the frozen stem


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

    def forward(self, x, stem_done: bool = False, remat: bool = False):
        """``remat``: each stage (its convs and pool) in a checkpoint of its
        own.  The stem's stages that run here run in the span ``stem``."""
        with span("stem"):
            for s in range(1 if stem_done else 0, STEM_STAGES):
                x = self._run_stage(x, s, remat)
        for s in range(STEM_STAGES, len(VGG16_STAGES)):
            x = self._run_stage(x, s, remat)
        return x

    def _run_stage(self, x, s: int, remat: bool):
        return checkpoint(self._stage, x, s) if remat else self._stage(x, s)

    def _stage(self, x, s: int):
        for name, _ in VGG16_STAGES[s]:
            x = getattr(self, name)(x)
        return max_pool(x, 2, 2) if s < len(VGG16_STAGES) - 1 else x


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

    def draw_keep(self, n: int, generator=None, device=None) -> tuple:
        """The (fc6, fc7) keep masks, bool [n, 512] each, that
        :meth:`forward` would draw from ``generator`` for ``n`` ROIs, in its
        order: drawn ahead of a checkpointed head
        (``models/detector.py:FasterRCNN.apply_head``)."""
        return tuple(drop.draw((n, fc.dense.out_features), generator, device)
                     for drop, fc in ((self.drop6, self.fc6),
                                      (self.drop7, self.fc7)))

    def forward(self, roi_feats, keep=None, generator=None,
                remat: bool = False):
        """``keep``: optional (fc6 mask, fc7 mask), bool [N, 512] each, for
        the two dropouts in training; drawn from ``generator`` when None.
        ``remat``: the head in a checkpoint, the masks drawn before it in
        the head's order (the recompute cannot restore an explicit
        generator's state)."""
        if remat:
            if keep is None:
                keep = self.draw_keep(roi_feats.shape[0], generator,
                                      roi_feats.device)
            return checkpoint(self, roi_feats, keep)
        k6, k7 = keep if keep is not None else (None, None)
        x = self.drop6(self.fc6(roi_feats), k6, generator)
        x = self.drop7(self.fc7(x), k7, generator)
        return self.cls_score(x), self.bbox_pred(x)
