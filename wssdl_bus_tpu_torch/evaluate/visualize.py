"""Qualitative detection overlays (the reference's qual_res output): the
port's copy of ``wssdl_bus_tpu/evaluate/visualize.py``.

Re-implements ``vis_detections`` (the reference detector's
``lib/fast_rcnn/test_bus.py:244-267``) and the in-training qualitative dump
(train_bus.py:824-871) with PIL instead of matplotlib: GT boxes solid
(red = malignant, blue = benign), detections >= ``thresh`` dashed with a
"class score" label, saved as ``<image>.png`` in the output dir.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

COLORS = {"malignant": (255, 32, 32), "benign": (48, 48, 255)}


def _dashed_rect(draw: "ImageDraw.ImageDraw", box, color, width=3, dash=8):
    x1, y1, x2, y2 = [float(v) for v in box]
    segs = []
    x = x1
    while x < x2:
        segs.append(((x, y1), (min(x + dash, x2), y1)))
        segs.append(((x, y2), (min(x + dash, x2), y2)))
        x += 2 * dash
    y = y1
    while y < y2:
        segs.append(((x1, y), (x1, min(y + dash, y2))))
        segs.append(((x2, y), (x2, min(y + dash, y2))))
        y += 2 * dash
    for a, b in segs:
        draw.line([a, b], fill=color, width=width)


def draw_detections(im_gray: np.ndarray,
                    dets_per_class: dict,
                    gt_boxes: Optional[np.ndarray] = None,
                    gt_classes: Optional[Sequence[int]] = None,
                    class_names=("__background__", "benign", "malignant"),
                    thresh: float = 0.5, max_dets: int = 10) -> Image.Image:
    """-> RGB PIL image.  ``dets_per_class``: {class_index: [N, 5]}."""
    if im_gray.ndim == 2:
        rgb = np.repeat(im_gray[:, :, None], 3, axis=2).astype(np.uint8)
    else:
        rgb = im_gray.astype(np.uint8)
    img = Image.fromarray(rgb)
    draw = ImageDraw.Draw(img)

    if gt_boxes is not None:
        for k, box in enumerate(gt_boxes):
            cls = int(gt_classes[k]) if gt_classes is not None else 1
            if cls == 0:
                continue
            color = COLORS[class_names[cls]]
            draw.rectangle([float(box[0]), float(box[1]),
                            float(box[2]), float(box[3])],
                           outline=color, width=3)

    for ci, dets in dets_per_class.items():
        name = class_names[ci]
        color = COLORS.get(name, (255, 255, 0))
        dets = np.asarray(dets).reshape(-1, 5)
        for row in dets[:max_dets]:
            if row[4] <= thresh:
                continue
            _dashed_rect(draw, row[:4], color)
            draw.text((float(row[0]) + 2, float(row[1]) + 2),
                      f"{name} {row[4]:.3f}", fill=color)
    return img


def save_qualitative(im_gray, dets_per_class, out_dir, image_name,
                     gt_boxes=None, gt_classes=None, thresh=0.5):
    os.makedirs(out_dir, exist_ok=True)
    img = draw_detections(im_gray, dets_per_class, gt_boxes, gt_classes,
                          thresh=thresh)
    path = os.path.join(out_dir, image_name + ".png")
    img.save(path)
    return path
