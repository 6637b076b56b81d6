"""The work a step needs, counted from shapes: the model's multiply-adds
and the bytes of the ROI-pool kernels, and the card's published peaks.

Only convolutions and dense layers count toward the model's operations
(norms, activations and the detection geometry are left out).  A training
step counts its forward once and its backward twice (the gradients of the
input and of the weights), less the first convolution's input gradient,
which nothing needs; what activation remat computes again is not counted.
A kernel's bytes are each input read once and each output written once.
"""

from __future__ import annotations

from . import reference as R

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
POOLED = 7


def _same(n: int, stride: int) -> int:
    return -(-n // stride)


def feature_hw(canvas_hw):
    """The stride-16 map of a canvas: conv0 7x7/2 SAME, max-pool 3x3/2
    VALID, groups 1 and 2 at stride 2 SAME."""
    h, w = (_same(s, 2) for s in canvas_hw)
    h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    for _ in range(2):
        h, w = _same(h, 2), _same(w, 2)
    return h, w


def _block_macs(cin, f, stride, hw_in):
    """A bottleneck block's multiply-adds at input extent ``hw_in``
    (stride on the 3x3 conv and on the shortcut) -> (macs, hw_out)."""
    h, w = hw_in
    ho, wo = _same(h, stride), _same(w, stride)
    macs = h * w * cin * f + ho * wo * 9 * f * f + ho * wo * f * 4 * f
    if cin != 4 * f:
        macs += ho * wo * cin * 4 * f
    return macs, (ho, wo)


def trunk_macs(depth: int, canvas_hw) -> dict:
    """Per image: {"conv0", "trunk" (every conv of groups 0-2 and conv0),
    "rpn"} multiply-adds."""
    h, w = (_same(s, 2) for s in canvas_hw)
    conv0 = h * w * 7 * 7 * 3 * 64
    hw = ((h - 3) // 2 + 1, (w - 3) // 2 + 1)
    macs = conv0
    for g, _, cin, f, stride, _ in R._block_plan(depth):
        if g < 3:
            m, hw = _block_macs(cin, f, stride, hw)
            macs += m
    fh, fw = hw
    rpn = fh * fw * (9 * 1024 * 1024 + 1024 * 18 + 1024 * 36)
    return {"conv0": conv0, "trunk": macs, "rpn": rpn}


def head_macs_per_roi(depth: int, num_classes: int = 3) -> int:
    """group3 on one 7x7 ROI (stride 2, so 4x4 after its first block) and
    the two dense layers."""
    hw, macs = (POOLED, POOLED), 0
    for g, _, cin, f, stride, _ in R._block_plan(depth):
        if g == 3:
            m, hw = _block_macs(cin, f, stride, hw)
            macs += m
    return macs + 2048 * num_classes * 5


def step_flops(depth: int, canvas_hw, images: int, rois: int,
               train: bool) -> float:
    """Model operations of one step over ``images`` images and ``rois``
    ROIs: 2 per multiply-add; a training step three passes (forward, the
    input and the weight gradients) less conv0's input gradient."""
    t = trunk_macs(depth, canvas_hw)
    fwd = images * (t["trunk"] + t["rpn"]) + rois * head_macs_per_roi(depth)
    if not train:
        return 2.0 * fwd
    return 2.0 * (3 * fwd - images * t["conv0"])


def roi_pool_bytes(images: int, feat_hw, channels: int, rois: int,
                   backward: bool) -> int:
    """Bytes of one pool launch over ``images`` f32 maps and ``rois``
    ROIs: forward reads the map and the boxes and writes the pooled
    [rois, 7, 7, C]; backward reads the cotangent, the map and the boxes
    and writes the map's gradient."""
    fmap = images * feat_hw[0] * feat_hw[1] * channels * 4
    pooled = rois * POOLED * POOLED * channels * 4
    boxes = rois * 4 * 4
    return pooled + fmap + boxes + (fmap if backward else 0)
