"""Host-side image preparation and training augmentation (counterpart of
``wssdl_bus_tpu/data/augment.py``).

``prep_image`` re-implements the reference's ``prep_im_for_blob``
(``lib/utils/blob.py:34-79``) on a single-channel image (the BUS images are
grayscale; the channel is replicated at pack time):

  * weak images in training: rotation within +/-ROTATION_MAX_ANGLE degrees
    (bilinear, the native kernel or ``scipy.ndimage.rotate``, background
    filled with the pixel mean) and a random crop of up to CROPPING_MAX_MARGIN per side;
  * every training image: brightness shift and contrast scaling about the
    image mean, both clipped to [0, 1];
  * mean subtraction, shortest-side / longest-side-capped bilinear resize
    (one random TRAIN scale per image in training);
  * x255 for VGG, /(std/255) for ResNet.

The random draws come from a ``np.random.RandomState`` in exactly the JAX
package's sequence (``sample_prep``), so the same seed gives the same
crops, shifts and scales in both packages.
"""

from __future__ import annotations

import numpy as np
from PIL import Image
from scipy import ndimage

from wssdl_bus_tpu_torch import native
from wssdl_bus_tpu_torch.config import Config


def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of a single-channel float image: the native C++
    kernel (``native/``, the JAX package's code) when it builds, PIL
    otherwise (the same triangle-filter convention), as the JAX package
    dispatches."""
    out = native.resize_bilinear(im, out_h, out_w)
    if out is not None:
        return out
    pil = Image.fromarray(np.ascontiguousarray(im, dtype=np.float32))
    return np.asarray(pil.resize((out_w, out_h), Image.BILINEAR))


def rotate_bilinear(im: np.ndarray, angle: float, cval: float) -> np.ndarray:
    """Bilinear rotation about the centre, same shape, ``cval`` outside:
    the native kernel when it builds, ``scipy.ndimage.rotate`` otherwise."""
    out = native.rotate_bilinear(im, angle, cval)
    if out is not None:
        return out
    return ndimage.rotate(im, angle, reshape=False, order=1, mode="constant",
                          cval=cval)


def compute_scale(h: int, w: int, target_size: int, max_size: int) -> float:
    """shortest-side target with a longest-side cap (blob.py:63-68)."""
    im_scale = float(target_size) / min(h, w)
    if np.round(im_scale * max(h, w)) > max_size:
        im_scale = float(max_size) / max(h, w)
    return im_scale


def sample_prep(im: np.ndarray, net_name: str, cfg: Config,
                is_training: bool, is_ws: bool,
                rng: np.random.RandomState):
    """The geometric transforms (weak-image rotation and crop) and every
    random draw, in the reference's draw order (blob.py:39-58,
    minibatch_bus.py:24-25).  -> (im [h, w] float32 in [0, 1], params)
    with params ``delta`` (brightness, 0.0 when off), ``factor`` (contrast,
    1.0 when off), ``cmean`` (the post-brightness mean contrast pivots
    on), the resized extent ``oh``/``ow`` and ``im_scale``."""
    t = cfg.TRAIN
    im = im.astype(np.float32) / 255.0

    if is_ws and is_training:
        if t.USE_ROTATION:
            angle = rng.uniform(-t.ROTATION_MAX_ANGLE, t.ROTATION_MAX_ANGLE)
            im = rotate_bilinear(im, angle, cfg.PIXEL_MEAN / 255.0)
        if t.USE_CROPPING:
            mh = t.CROPPING_MAX_MARGIN * im.shape[0]
            mw = t.CROPPING_MAX_MARGIN * im.shape[1]
            u = rng.randint(0, int(mh) + 1)
            d = rng.randint(1, max(int(mh), 1) + 1)
            left = rng.randint(0, int(mw) + 1)
            r = rng.randint(1, max(int(mw), 1) + 1)
            im = im[u:-d, left:-r]

    delta, factor, cmean = 0.0, 1.0, 0.0
    if is_training:
        if t.USE_BRIGHTNESS_ADJUSTMENT:
            delta = rng.uniform(-t.BRIGHTNESS_ADJUSTMENT_MAX_DELTA,
                                t.BRIGHTNESS_ADJUSTMENT_MAX_DELTA)
        if t.USE_CONTRAST_ADJUSTMENT:
            cmean = (np.clip(im + delta, 0.0, 1.0).mean() if delta != 0.0
                     else im.mean())
            factor = rng.uniform(t.CONTRAST_ADJUSTMENT_LOWER_FACTOR,
                                 t.CONTRAST_ADJUSTMENT_UPPER_FACTOR)
        scales, max_size = t.SCALES, t.MAX_SIZE
        target = (scales[rng.randint(len(scales))] if len(scales) > 1
                  else scales[0])
    else:
        scales, max_size = cfg.TEST.SCALES, cfg.TEST.MAX_SIZE
        if len(scales) != 1:
            raise NotImplementedError(
                f"TEST.SCALES={list(scales)}: the RPN test path is "
                "single-scale (reference test_bus.py:209)")
        target = scales[0]
    h, w = im.shape
    im_scale = compute_scale(h, w, target, max_size)
    return im, {"delta": delta, "factor": factor, "cmean": cmean,
                "im_scale": im_scale, "oh": int(np.round(h * im_scale)),
                "ow": int(np.round(w * im_scale))}


def prep_image(im: np.ndarray, net_name: str, cfg: Config,
               is_training: bool = False, is_ws: bool = False,
               rng: np.random.RandomState = None):
    """-> (prepared [H', W'] float32, im_scale).  Test-time preparation by
    default; ``is_training`` draws the augmentation from ``rng``."""
    im, p = sample_prep(im, net_name, cfg, is_training, is_ws, rng)
    if p["delta"] != 0.0:
        im = np.clip(im + p["delta"], 0.0, 1.0)
    if p["factor"] != 1.0:
        im = np.clip((im - p["cmean"]) * p["factor"] + p["cmean"], 0.0, 1.0)
    im = im - cfg.PIXEL_MEAN / 255.0
    im = resize_bilinear(im, p["oh"], p["ow"])
    if net_name[:6] == "Resnet":
        im = im / (cfg.PIXEL_STD / 255.0)
    else:  # VGGnet
        im = im * 255.0
    return im.astype(np.float32), p["im_scale"]


def max_canvas(image_sizes, target_size: int, max_size: int,
               multiple: int = 16, margin: int = 4,
               crop_margin: float = 0.0):
    """Static canvas (H, W) covering every resized image, rounded up to a
    multiple of the feature stride.  ``crop_margin`` (TRAIN.
    CROPPING_MAX_MARGIN when weak images are cropped) enumerates the four
    crop-extreme shapes of each image: a crop of the shorter side raises
    the resize scale, which a fixed margin cannot cover."""
    best_h = best_w = 0
    shrink = max(0.0, 1.0 - 2.0 * crop_margin)
    for (h, w) in image_sizes:
        for fh in (1.0, shrink):
            for fw in (1.0, shrink):
                ch, cw = h * fh, w * fw
                s = compute_scale(ch, cw, target_size, max_size)
                best_h = max(best_h, int(np.round(ch * s)))
                best_w = max(best_w, int(np.round(cw * s)))
    rh = -(-(best_h + margin) // multiple) * multiple
    rw = -(-(best_w + margin) // multiple) * multiple
    return rh, rw
