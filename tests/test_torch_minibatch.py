"""The port's training minibatch (``data/minibatch.py`` on ``data/augment.py``)
against the JAX package's ``get_minibatch_joint`` / ``get_minibatch`` from
the same ``np.random.RandomState`` seed, on grayscale images read from
files as the real path reads them.

The draw stream must be identical: the generators' states after two
batches, and the GT boxes, extents and scales (which depend on the crops
and scale draws), are compared exactly.  Pixels get a tolerance: the port
resizes with PIL and rotates with ``scipy.ndimage.rotate``, the JAX package
with its native C++ kernels when they are built.  Unrotated images agree to
1e-4 (x255 units, summation order of the resize); rotated weak images
differ on a ring of about one pixel at the image edge, where the two
rotations treat the source image's boundary differently (up to 0.5 in
[0, 1] units).  After a rotation of up to 5 degrees that boundary runs
within ~9 px of the output edge (~12 px after the resize), so the test
holds the pixels 16 px inside the edge to 0.1, and at most 3% of all
pixels may differ by more: the mean the contrast pivots on moves by ~2e-4
with the ring."""

import numpy as np
import pytest
from PIL import Image

from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.data.augment import max_canvas as jax_max_canvas
from wssdl_bus_tpu.data.minibatch import get_minibatch as jax_minibatch
from wssdl_bus_tpu.data.minibatch import \
    get_minibatch_joint as jax_minibatch_joint
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import max_canvas
from wssdl_bus_tpu_torch.data.minibatch import (get_minibatch,
                                                get_minibatch_joint)

OVERRIDES = ["TRAIN.SCALES", "(160, 192)", "TRAIN.MAX_SIZE", "256"]
NET = "VGGnet_train"
SIZES = [(150, 200), (120, 180), (170, 150), (140, 210), (160, 160)]


def _speckle(rng, h, w):
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    tissue = 110.0 * np.exp(-yy / (1.5 * h))
    return np.clip(tissue * rng.rayleigh(1.0, (h, w)), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def roidb(tmp_path_factory):
    d = tmp_path_factory.mktemp("bus")
    rng = np.random.RandomState(11)
    entries = []
    for i, (h, w) in enumerate(SIZES):
        path = str(d / f"im{i}.png")
        Image.fromarray(_speckle(rng, h, w)).save(path)
        x1, y1 = rng.uniform(10, w / 2), rng.uniform(10, h / 2)
        boxes = np.array([[x1, y1, x1 + w / 3, y1 + h / 3],
                          [0, 0, w - 1, h - 1]], np.float32)
        entries.append({"image": path, "flipped": i % 2 == 1,
                        "boxes": boxes, "gt_classes": np.array([1 + i % 2, 0]),
                        "birads_diag": 1 + i % 2})
    return entries


def _check_batch(got, want, n_s, border=16):
    for k in ("gt_boxes", "num_gt_boxes", "im_info"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["data"].shape == want["data"].shape
    for i, info in enumerate(want["im_info"]):
        h, w = int(info[0]), int(info[1])
        g, ww = got["data"][i, :h, :w], want["data"][i, :h, :w]
        if i < n_s:
            np.testing.assert_allclose(g, ww, rtol=0, atol=1e-4)
        else:
            inner = (slice(border, h - border), slice(border, w - border))
            np.testing.assert_allclose(g[inner], ww[inner], rtol=0, atol=0.1)
            assert (np.abs(g - ww) > 0.1).mean() < 0.03
            assert np.isfinite(g).all()
        assert (got["data"][i, h:] == 0).all() and \
            (got["data"][i, :, w:] == 0).all()


def test_canvas_with_crop_margin_matches_jax():
    for target, cap in ((600, 1000), (192, 256)):
        assert max_canvas(SIZES, target, cap, crop_margin=0.05) == \
            jax_max_canvas(SIZES, target, cap, crop_margin=0.05)


def test_get_minibatch_joint_matches_jax(roidb):
    cfg = Config().with_overrides(OVERRIDES)
    jcfg = JaxConfig().with_overrides(OVERRIDES)
    canvas = max_canvas(SIZES, 192, 256, crop_margin=0.05)
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    for sup, ws in ((roidb[:1], roidb[1:3]), (roidb[3:4], roidb[4:] +
                                              roidb[:1])):
        got = get_minibatch_joint(sup, ws, NET, cfg, canvas, rng_t)
        want = jax_minibatch_joint(sup, ws, NET, jcfg, canvas, rng_j)
        _check_batch(got, want, n_s=1)
        assert got["num_gt_boxes"].tolist() == [2, 0, 0]
    # the same number of draws, in the same order
    st, sj = rng_t.get_state(), rng_j.get_state()
    np.testing.assert_array_equal(st[1], sj[1])
    assert st[2:] == sj[2:]


@pytest.mark.parametrize("is_ws", [False, True])
def test_get_minibatch_matches_jax(roidb, is_ws):
    cfg = Config().with_overrides(OVERRIDES)
    jcfg = JaxConfig().with_overrides(OVERRIDES)
    canvas = max_canvas(SIZES, 192, 256, crop_margin=0.05)
    rng_t, rng_j = np.random.RandomState(5), np.random.RandomState(5)
    got = get_minibatch(roidb[:3], NET, cfg, canvas, True, is_ws, rng_t)
    want = jax_minibatch(roidb[:3], NET, jcfg, canvas, True, is_ws, rng_j)
    _check_batch(got, want, n_s=0 if is_ws else 3)
    assert (got["num_gt_boxes"] == 0).all() == is_ws
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)
