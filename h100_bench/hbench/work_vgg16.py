"""The work a VGG16 joint step needs, counted from shapes by ``work.py``'s
rules: convolutions and dense layers only, a training step's forward once
and its backward twice (the gradients of the input and of the weights).
The frozen stem (conv1-conv2) has no backward at all, and conv3_1 no input
gradient, since nothing below it trains.  ``work.roi_pool_bytes`` counts
the pool's bytes at the map's 512 channels.
"""

from __future__ import annotations

from . import reference_vgg16 as RV
from . import work as W

CHANNELS = 512


def feature_hw(canvas_hw):
    """The stride-16 map of a canvas: four 2x2 VALID pools, each
    flooring."""
    h, w = canvas_hw
    for _ in range(len(RV.STAGES) - 1):
        h, w = h // 2, w // 2
    return h, w


def trunk_macs(canvas_hw) -> dict:
    """Per image: {"stem" (conv1-conv2), "conv3_1", "trunk" (all thirteen
    convolutions), "rpn"} multiply-adds."""
    (h, w), c = canvas_hw, 3
    out = {"stem": 0, "trunk": 0}
    for s, stage in enumerate(RV.STAGES):
        for name, cout in stage:
            macs = h * w * 9 * c * cout
            out["trunk"] += macs
            if name in RV.FROZEN:
                out["stem"] += macs
            if name == "conv3_1":
                out["conv3_1"] = macs
            c = cout
        if s < len(RV.STAGES) - 1:
            h, w = h // 2, w // 2
    out["rpn"] = h * w * (9 * c * 512 + 512 * 6 * 9)
    return out


def head_macs_per_roi(num_classes: int = 3) -> int:
    """fc6 over the flat 7x7x512 operand, fc7, and the two output layers."""
    return (W.POOLED * W.POOLED * CHANNELS * RV.FC + RV.FC * RV.FC
            + RV.FC * 5 * num_classes)


def step_flops(canvas_hw, images: int, rois: int, train: bool) -> float:
    """Model operations of one step over ``images`` images and ``rois``
    ROIs: 2 per multiply-add; a training step three passes less the stem's
    two backward passes and conv3_1's input gradient."""
    t = trunk_macs(canvas_hw)
    fwd = images * (t["trunk"] + t["rpn"]) + rois * head_macs_per_roi()
    if not train:
        return 2.0 * fwd
    return 2.0 * (3 * fwd - images * (2 * t["stem"] + t["conv3_1"]))
