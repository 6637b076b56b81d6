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
padding.

With ``raw_hw`` the blobs carry the device-prep staging layout instead of
``data`` (``ops/device_prep.py``):

  raw           [B, Hr, Wr] uint8, each image top-left with its last row
                and column replicated to the edge (the resize's clamp taps)
  prep          [B, 8] float32 (IH, IW, OH, OW, DELTA, FACTOR, CMEAN, 0)

The random draws are the same in both layouts (``augment.sample_prep``).
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
from PIL import Image

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import prep_image, sample_prep
from wssdl_bus_tpu_torch.ops.device_prep import (CMEAN, DELTA, FACTOR, IH, IW,
                                                 N_PREP, OH, OW)

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


def _pack_raw(images01, prep_list, raw_hw):
    """Device-prep staging blobs: [B, Hr, Wr] uint8 (the [0, 1] images
    quantised with ``np.rint``, packed top-left, the padding replicating
    each image's last column and row) + [B, 8] f32 parameters."""
    h, w = raw_hw
    raw = np.zeros((len(images01), h, w), np.uint8)
    prep = np.zeros((len(images01), N_PREP), np.float32)
    for i, (im, p) in enumerate(zip(images01, prep_list)):
        if im.shape[0] > h or im.shape[1] > w:
            warnings.warn(
                f"image {im.shape} exceeds raw canvas {raw_hw}; truncating: "
                "recompute the raw canvas for this dataset")
            im = im[:h, :w]
        ih, iw = im.shape
        # exact for unrotated images (values k/255); at most 1/510 for a
        # rotated weak image (ops/device_prep.py)
        raw[i, :ih, :iw] = np.rint(im * 255.0).astype(np.uint8)
        raw[i, :ih, iw:] = raw[i, :ih, iw - 1:iw]
        raw[i, ih:, :] = raw[i, ih - 1:ih, :]
        prep[i, IH], prep[i, IW] = ih, iw
        prep[i, OH], prep[i, OW] = p["oh"], p["ow"]
        prep[i, DELTA] = p["delta"]
        prep[i, FACTOR] = p["factor"]
        prep[i, CMEAN] = p["cmean"]
    return raw, prep


def _prep_all(pairs, net_name, cfg, is_training, rng, raw_hw=None):
    """[(entry, is_ws)] -> (images, [(im_scale, (h, w))], prep params or
    None) in order, so the draws come off ``rng`` in the reference's
    sequence.  With ``raw_hw`` the images are the [0, 1] geometry-only
    images of ``sample_prep`` and the photometric tail is left to the
    device."""
    images, scales, preps = [], [], []
    for entry, ws in pairs:
        if raw_hw is not None:
            im, p = sample_prep(_load_gray(entry), net_name, cfg,
                                is_training, ws, rng)
            preps.append(p)
            scales.append((p["im_scale"], (p["oh"], p["ow"])))
        else:
            im, s = prep_image(_load_gray(entry), net_name, cfg,
                               is_training, ws, rng)
            scales.append((s, im.shape))
        images.append(im)
    return images, scales, (preps if raw_hw is not None else None)


def _finish(out, images, preps, canvas_hw, raw_hw):
    if raw_hw is not None:
        out["raw"], out["prep"] = _pack_raw(images, preps, raw_hw)
    else:
        out["data"] = _pack(images, canvas_hw)
    return out


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
                  rng: np.random.RandomState, raw_hw=None) -> dict:
    """Single-regime minibatch, supervised OR weak (minibatch_bus.py:15-94):
    weak images carry no GT boxes.  ``raw_hw`` switches to the device-prep
    staging layout (``raw`` + ``prep`` instead of ``data``)."""
    images, scales, preps = _prep_all([(e, is_ws) for e in roidb], net_name,
                                      cfg, is_training, rng, raw_hw)
    out = _blobs(roidb, scales, 0 if is_ws else len(roidb), cfg)
    return _finish(out, images, preps, canvas_hw, raw_hw)


def get_minibatch_joint(roidb_s, roidb_ws, net_name: str, cfg: Config,
                        canvas_hw, rng: np.random.RandomState,
                        is_training: bool = True, raw_hw=None) -> dict:
    """Joint minibatch (minibatch_bus.py:96-139): the supervised images
    (photometric augmentation only), then the weak ones (rotation and crop
    as well).  ``is_training=False`` turns every random augmentation off;
    ``raw_hw`` as in :func:`get_minibatch`."""
    pairs = [(e, False) for e in roidb_s] + [(e, is_training)
                                             for e in roidb_ws]
    images, scales, preps = _prep_all(pairs, net_name, cfg, is_training,
                                      rng, raw_hw)
    out = _blobs(list(roidb_s) + list(roidb_ws), scales, len(roidb_s), cfg)
    return _finish(out, images, preps, canvas_hw, raw_hw)
