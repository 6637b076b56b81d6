"""The port's device-side feed preparation (``ops/device_prep.py``)
against the JAX package's ``prep_device_batch`` on the same staged rows,
and against the port's own host preparation.

``resize_weights`` rebuilds ``jax.image.scale_and_translate``'s linear
antialiased weights (``compute_weight_mat``); the two f32 products sum in
another order than XLA's einsum, so the blobs agree to f32 rounding:
within 1e-4 absolute in VGG units (x255) for an upscale, a downscale (the
widened, antialiasing kernel) and scale 1, each with brightness and
contrast applied.  Against the host path (``prep_image``, the native or
PIL half-pixel resize) the unrotated images of a supervised batch agree
within 2e-5 x 255 (the bound ``chip_smoke.py`` holds on the card), and a
rotated weak batch within the uint8 re-quantisation bound of the JAX
package's docstring: 0.5 / 255 of the range times the contrast factor (at
most CONTRAST_ADJUSTMENT_UPPER_FACTOR), x255, plus the same 2e-5 x 255."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wssdl_bus_tpu.ops.device_prep import \
    prep_device_batch as jax_prep_device_batch
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.minibatch import _pack_raw, get_minibatch
from wssdl_bus_tpu_torch.ops.device_prep import (net_divisor_for,
                                                 prep_device_batch,
                                                 resize_weights)

RAW = (72, 96)
OUT = (128, 176)
MEAN = Config().PIXEL_MEAN / 255.0
VGG_ATOL = 1e-4
HOST_ATOL = 2e-5 * 255


def _rows(rng, shapes):
    """Images in [0, 1] (k/255 values) with their prep params."""
    images, params = [], []
    for (ih, iw), (oh, ow) in shapes:
        images.append(rng.randint(0, 256, (ih, iw)).astype(np.float32)
                      / 255.0)
        params.append({"oh": oh, "ow": ow, "delta": rng.uniform(-0.2, 0.2),
                       "factor": rng.uniform(0.2, 1.8),
                       "cmean": rng.uniform(0.2, 0.6)})
    return _pack_raw(images, params, RAW)


@pytest.mark.parametrize("case", ["upscale", "downscale", "scale1", "mixed"])
def test_device_prep_matches_jax(case):
    rng = np.random.RandomState(["upscale", "downscale", "scale1",
                                 "mixed"].index(case))
    shapes = {"upscale": [((60, 80), (90, 120)), ((50, 70), (113, 158))],
              "downscale": [((70, 90), (40, 50)), ((64, 96), (21, 37))],
              "scale1": [((50, 70), (50, 70)), ((72, 96), (72, 96))],
              "mixed": [((60, 80), (90, 120)), ((70, 90), (40, 50)),
                        ((50, 70), (50, 70))]}[case]
    raw, prep = _rows(rng, shapes)
    got = prep_device_batch(torch.from_numpy(raw), torch.from_numpy(prep),
                            OUT, MEAN, 255.0).numpy()
    want = np.asarray(jax_prep_device_batch(
        jnp.asarray(raw), jnp.asarray(prep), OUT, MEAN, 255.0))
    assert got.shape == want.shape == (len(shapes), *OUT, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=VGG_ATOL)
    for i, (_, (oh, ow)) in enumerate(shapes):
        assert (got[i, oh:] == 0).all() and (got[i, :, ow:] == 0).all()
        assert np.abs(got[i, :oh, :ow]).max() > 1.0


def test_resize_weights_normalised():
    """Every sample point inside the image gets weights summing to 1; a
    downscale widens the kernel (more taps per output)."""
    w = resize_weights(40, 30, torch.tensor([0.5, 2.0])).numpy()
    np.testing.assert_allclose(w[0, :, :20].sum(0), 1.0, rtol=1e-6)
    np.testing.assert_allclose(w[1].sum(0), 1.0, rtol=1e-6)
    assert (w[0, :, 5] > 0).sum() == 4 and (w[1, :, 5] > 0).sum() == 2
    assert (w[0, :, 21:] == 0).all()   # sample points past the image


@pytest.fixture(scope="module")
def roidb(tmp_path_factory):
    d = tmp_path_factory.mktemp("prep")
    rng = np.random.RandomState(2)
    entries = []
    for i, (h, w) in enumerate([(64, 90), (61, 85), (58, 80)]):
        path = str(d / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (h, w)).astype(np.uint8)).save(
            path)
        entries.append({"image": path, "flipped": i == 1, "height": h,
                        "width": w, "boxes": np.array([[5, 5, 40, 30]],
                                                      np.float32),
                        "gt_classes": np.array([1]), "birads_diag": 1})
    return entries


@pytest.mark.parametrize("is_ws", [False, True])
def test_device_prep_matches_host_prep(roidb, is_ws):
    cfg = Config().with_overrides(["TRAIN.SCALES", "(96,)",
                                   "TRAIN.MAX_SIZE", "170"])
    host = get_minibatch(roidb, "VGGnet_train", cfg, OUT, True, is_ws,
                         np.random.RandomState(7))
    dev = get_minibatch(roidb, "VGGnet_train", cfg, OUT, True, is_ws,
                        np.random.RandomState(7), raw_hw=RAW)
    np.testing.assert_array_equal(host["im_info"], dev["im_info"])
    np.testing.assert_array_equal(host["gt_boxes"], dev["gt_boxes"])
    assert dev["raw"].dtype == np.uint8 and "data" not in dev
    got = prep_device_batch(
        torch.from_numpy(dev["raw"]), torch.from_numpy(dev["prep"]), OUT,
        MEAN, net_divisor_for("VGGnet_train", cfg.PIXEL_STD)).numpy()
    err = np.abs(got - host["data"])
    if not is_ws:
        assert err.max() <= HOST_ATOL, err.max()
    else:
        bound = 0.5 * cfg.TRAIN.CONTRAST_ADJUSTMENT_UPPER_FACTOR + HOST_ATOL
        assert err.max() <= bound, err.max()
        assert err.max() > HOST_ATOL     # the re-quantisation shows
