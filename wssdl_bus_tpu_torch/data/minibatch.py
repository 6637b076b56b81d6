"""Fixed-shape minibatch blobs for training (counterpart of
``wssdl_bus_tpu/data/minibatch.py``; the reference's
``roi_data_layer/minibatch_bus.py:15-139``).

Images are packed into a STATIC canvas (``augment.max_canvas``) instead of
the per-batch maximum, so every step sees the same shapes.  Per batch
(supervised images first, then weak ones):

  data          [B, Hc, Wc, 3] float32, zero-padded
  gt_boxes      [B, MAX_GT_PER_IMAGE, 5] scaled by im_scale (x1, y1, x2,
                y2, class)
  num_gt_boxes  [B] int32 (0 for weak images)
  im_info       [B, 4] = (resized h, resized w, im_scale, BIRADS label)

im_info[:2] holds each image's own resized extent (the reference stores
the padded blob's), so anchors and proposal clipping stay out of the
padding.  The host layout only: the JAX package's device-prep staging
layout (``raw``/``prep``) is not ported.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
from PIL import Image

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import prep_image

_DECODE_CACHE: dict = {}
_DECODE_CACHE_MAX = 256


def _load_gray(entry) -> np.ndarray:
    """The decoded grayscale image of a roidb entry (``entry["image"]`` a
    path; ``flipped`` mirrors it), from a bounded in-memory cache."""
    key = (entry["image"], bool(entry.get("flipped")))
    im = _DECODE_CACHE.get(key)
    if im is None:
        im = np.asarray(Image.open(entry["image"]))
        if entry.get("flipped"):
            im = np.ascontiguousarray(im[:, ::-1])
        if len(_DECODE_CACHE) >= _DECODE_CACHE_MAX:
            _DECODE_CACHE.pop(next(iter(_DECODE_CACHE)))
        _DECODE_CACHE[key] = im
    return im


def _pack(images: List[np.ndarray], canvas_hw) -> np.ndarray:
    """Gray images -> [B, Hc, Wc, 3] zero-padded at the bottom and right;
    an image past the canvas is truncated with a warning."""
    h, w = canvas_hw
    blob = np.zeros((len(images), h, w, 3), np.float32)
    for i, im in enumerate(images):
        if im.shape[0] > h or im.shape[1] > w:
            warnings.warn(
                f"image {im.shape} exceeds static canvas {canvas_hw}; "
                "truncating: recompute the canvas for this dataset/config")
            im = im[:h, :w]
        blob[i, :im.shape[0], :im.shape[1], :] = im[:, :, None]
    return blob


def _prep_all(pairs, net_name, cfg, is_training, rng):
    """[(entry, is_ws)] -> (images, [(im_scale, (h, w))]) in order, so the
    draws come off ``rng`` in the reference's sequence."""
    images, scales = [], []
    for entry, ws in pairs:
        im, s = prep_image(_load_gray(entry), net_name, cfg, is_training, ws,
                           rng)
        images.append(im)
        scales.append((s, im.shape))
    return images, scales


def _blobs(roidb, scales, n_supervised, cfg):
    n = len(roidb)
    g = cfg.TRAIN.MAX_GT_PER_IMAGE
    gt_boxes = np.zeros((n, g, 5), np.float32)
    num_gt = np.zeros((n,), np.int32)
    im_info = np.zeros((n, 4), np.float32)
    for i, entry in enumerate(roidb):
        s, (sh, sw) = scales[i]
        if i < n_supervised:
            k = len(entry["gt_classes"])
            gt_boxes[i, :k, :4] = entry["boxes"] * s
            gt_boxes[i, :k, 4] = entry["gt_classes"]
            num_gt[i] = k
        im_info[i] = [sh, sw, s, entry["birads_diag"]]
    return {"gt_boxes": gt_boxes, "num_gt_boxes": num_gt, "im_info": im_info}


def get_minibatch(roidb, net_name: str, cfg: Config, canvas_hw,
                  is_training: bool, is_ws: bool,
                  rng: np.random.RandomState) -> dict:
    """Single-regime minibatch, supervised OR weak (minibatch_bus.py:15-94):
    weak images carry no GT boxes."""
    images, scales = _prep_all([(e, is_ws) for e in roidb], net_name, cfg,
                               is_training, rng)
    out = _blobs(roidb, scales, 0 if is_ws else len(roidb), cfg)
    out["data"] = _pack(images, canvas_hw)
    return out


def get_minibatch_joint(roidb_s, roidb_ws, net_name: str, cfg: Config,
                        canvas_hw, rng: np.random.RandomState,
                        is_training: bool = True) -> dict:
    """Joint minibatch (minibatch_bus.py:96-139): the supervised images
    (photometric augmentation only), then the weak ones (rotation and crop
    as well).  ``is_training=False`` turns every random augmentation off."""
    pairs = [(e, False) for e in roidb_s] + [(e, is_training)
                                             for e in roidb_ws]
    images, scales = _prep_all(pairs, net_name, cfg, is_training, rng)
    out = _blobs(list(roidb_s) + list(roidb_ws), scales, len(roidb_s), cfg)
    out["data"] = _pack(images, canvas_hw)
    return out
