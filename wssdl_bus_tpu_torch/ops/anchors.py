"""Anchor generation (the port's own copy of ``wssdl_bus_tpu/ops/anchors.py``).

Produces the same 9 base anchors (3 ratios x 3 scales on a 16-px base window)
as the reference's MATLAB-derived recipe
(the reference's ``lib/rpn_msr/generate_anchors.py:37-97``), and the full
shifted anchor grid used by the proposal / anchor-target layers
(``proposal_layer_tf_bus.py:49-72``, ``anchor_target_layer_tf_bus.py:57-74``).

Everything here is plain numpy, evaluated once per canvas; the Engine moves
the anchor grid to its device.
"""

from __future__ import annotations

import numpy as np


def generate_anchors(base_size: int = 16,
                     ratios=(0.5, 1.0, 2.0),
                     scales=(8, 16, 32)) -> np.ndarray:
    """Enumerate anchor windows (ratios x scales) around a base window.

    Uses the original +1 pixel-extent convention: a (0,0,15,15) window has
    width 16.  Returns float64 [A, 4] in (x1, y1, x2, y2).
    """
    base = np.array([0.0, 0.0, base_size - 1.0, base_size - 1.0])
    ratio_anchors = _ratio_enum(base, np.asarray(ratios, dtype=np.float64))
    return np.vstack([
        _scale_enum(ratio_anchors[i], np.asarray(scales, dtype=np.float64))
        for i in range(ratio_anchors.shape[0])
    ])


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1.0
    h = anchor[3] - anchor[1] + 1.0
    return w, h, anchor[0] + 0.5 * (w - 1.0), anchor[1] + 0.5 * (h - 1.0)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack((
        x_ctr - 0.5 * (ws - 1.0),
        y_ctr - 0.5 * (hs - 1.0),
        x_ctr + 0.5 * (ws - 1.0),
        y_ctr + 0.5 * (hs - 1.0),
    ))


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size_ratios = (w * h) / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    return _mkanchors(w * scales, h * scales, x_ctr, y_ctr)


def shifted_anchors(feat_height: int, feat_width: int, feat_stride: int = 16,
                    ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32)) -> np.ndarray:
    """All anchors over an H x W feature grid, ordered (h, w, a) fastest-last.

    Matches the reference enumeration exactly: shifts enumerated row-major over
    the grid, base anchors broadcast per cell (proposal_layer_tf_bus.py:54-71).
    Returns float32 [H*W*A, 4].
    """
    base = generate_anchors(feat_stride, ratios, scales)
    shift_x = np.arange(feat_width) * feat_stride
    shift_y = np.arange(feat_height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = (base[None, :, :] + shifts[:, None, :].astype(np.float64))
    return all_anchors.reshape(-1, 4).astype(np.float32)
