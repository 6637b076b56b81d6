"""Host-side test-time image preparation (counterpart of the test-time path
of ``wssdl_bus_tpu/data/augment.py``; the training augmentation arrives
with the training slice).

``prep_image`` re-implements the reference's ``prep_im_for_blob``
(``lib/utils/blob.py:34-79``) at test time on a single-channel image (the
BUS images are grayscale; the channel is replicated at pack time):
mean subtraction, shortest-side-600 / longest-side-1000 bilinear resize,
then x255 for VGG or /(std/255) for ResNet.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from wssdl_bus_tpu_torch.config import Config


def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of a single-channel float image through PIL (the JAX
    package may use its native C++ kernel, which follows PIL's
    triangle-filter convention)."""
    pil = Image.fromarray(np.ascontiguousarray(im, dtype=np.float32))
    return np.asarray(pil.resize((out_w, out_h), Image.BILINEAR))


def compute_scale(h: int, w: int, target_size: int, max_size: int) -> float:
    """shortest-side target with a longest-side cap (blob.py:63-68)."""
    im_scale = float(target_size) / min(h, w)
    if np.round(im_scale * max(h, w)) > max_size:
        im_scale = float(max_size) / max(h, w)
    return im_scale


def prep_image(im: np.ndarray, net_name: str, cfg: Config):
    """Test-time preparation -> (prepared [H', W'] float32, im_scale)."""
    scales = cfg.TEST.SCALES
    if len(scales) != 1:
        raise NotImplementedError(
            f"TEST.SCALES={list(scales)}: the RPN test path is single-scale "
            "(reference test_bus.py:209)")
    im = im.astype(np.float32) / 255.0
    h, w = im.shape
    im_scale = compute_scale(h, w, scales[0], cfg.TEST.MAX_SIZE)
    out_h = int(np.round(h * im_scale))
    out_w = int(np.round(w * im_scale))
    im = im - cfg.PIXEL_MEAN / 255.0
    im = resize_bilinear(im, out_h, out_w)
    if net_name[:6] == "Resnet":
        im = im / (cfg.PIXEL_STD / 255.0)
    else:  # VGGnet
        im = im * 255.0
    return im.astype(np.float32), im_scale


def max_canvas(image_sizes, target_size: int, max_size: int,
               multiple: int = 16, margin: int = 4):
    """Static canvas (H, W) covering every resized image, rounded up to a
    multiple of the feature stride.  The training crop margin of the JAX
    package's ``max_canvas`` comes with the training slice."""
    best_h = best_w = 0
    for (h, w) in image_sizes:
        s = compute_scale(h, w, target_size, max_size)
        best_h = max(best_h, int(np.round(h * s)))
        best_w = max(best_w, int(np.round(w * s)))
    rh = -(-(best_h + margin) // multiple) * multiple
    rw = -(-(best_w + margin) // multiple) * multiple
    return rh, rw
