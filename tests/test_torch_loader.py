"""The port's training data layers (``data/loader.py``: ``RoIDataLayer``,
``RoIDataLayerJoint``, ``Prefetcher``, ``get_data_layer``) against the JAX
package's, from the same ``np.random.RandomState`` seed, over a synthetic
SNUBH-layout imdb (``tests/test_torch_dataset.py:write_bus_imdb``) read as
the training path reads it (``get_training_roidb``, flips included).

The draws are numpy in both packages, so the index sequence (the shuffled
cursors across an epoch boundary), the GT boxes, extents, scales and the
device-prep staging blobs (``raw``, ``prep``) are compared exactly.  Pixels
of the host ``data`` blob and ``raw`` of rotated weak images: exact where
both native libraries build (the same C++ resize and rotation); otherwise
``tests/test_torch_minibatch.py``'s tolerances (unrotated 1e-4 in x255
units; rotated: a ring about one pixel wide at the image edge differs, so
16 px inside the edge to 0.1 of the range and at most 3% of the pixels
beyond it)."""

import numpy as np
import pytest

from tests.test_torch_dataset import write_bus_imdb
from wssdl_bus_tpu import native as jax_native
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.data import dataset as jax_dataset
from wssdl_bus_tpu.data import loader as jax_loader
from wssdl_bus_tpu_torch import native
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data import dataset, loader
from wssdl_bus_tpu_torch.data.augment import max_canvas

OVERRIDES = ["TRAIN.SCALES", "(160, 192)", "TRAIN.MAX_SIZE", "256"]
NET = "VGGnet_train"
SIZES = [(150, 200), (120, 180), (170, 150), (140, 210), (160, 160)]
STEPS = 7           # past the end of the first epoch of every cursor
EXACT = jax_native.available() and native.available()


@pytest.fixture(scope="module")
def roidbs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bus"))
    write_bus_imdb(root, seed=4, sizes=SIZES)
    port = dataset.get_training_roidb(dataset.get_imdb("bus_test", root))
    jax = jax_dataset.get_training_roidb(
        jax_dataset.get_imdb("bus_test", root))
    sizes = [(e["height"], e["width"]) for e in port]
    canvas = max_canvas(sizes, 192, 256, crop_margin=0.05)
    return port, jax, canvas


def _close_pixels(got, want, rotated, scale):
    if EXACT or not rotated:
        if EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
        return
    inner = (slice(16, -16), slice(16, -16))
    np.testing.assert_allclose(got[inner], want[inner], rtol=0,
                               atol=0.1 * scale)
    assert (np.abs(got - want) > 0.1 * scale).mean() < 0.03


def _check(got, want, n_s, raw_hw):
    assert set(got) == set(want)
    for k in ("gt_boxes", "num_gt_boxes", "im_info"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = len(want["im_info"])
    if raw_hw is None:
        assert got["data"].dtype == want["data"].dtype == np.float32
        for i in range(n):
            _close_pixels(got["data"][i, ..., 0], want["data"][i, ..., 0],
                          i >= n_s, 1.0)
        return
    np.testing.assert_array_equal(got["prep"], want["prep"])
    assert got["raw"].dtype == want["raw"].dtype == np.uint8
    assert got["raw"].shape == want["raw"].shape == (n, *raw_hw)
    for i in range(n):
        _close_pixels(got["raw"][i].astype(np.float32),
                      want["raw"][i].astype(np.float32), i >= n_s, 255.0)


@pytest.mark.parametrize("device_prep", [False, True])
@pytest.mark.parametrize("kind", ["joint", "single_s", "single_ws"])
def test_layers_match_jax(roidbs, kind, device_prep):
    port_db, jax_db, canvas = roidbs
    cfg = Config().with_overrides(OVERRIDES)
    jcfg = JaxConfig().with_overrides(OVERRIDES)
    if kind == "joint":
        args = dict(is_joint=True)
        got_l = loader.get_data_layer((port_db, port_db[:5]), NET, cfg,
                                      canvas, True, rng=np.random.RandomState(
                                          8), device_prep=device_prep, **args)
        want_l = jax_loader.get_data_layer((jax_db, jax_db[:5]), NET, jcfg,
                                           canvas, True,
                                           rng=np.random.RandomState(8),
                                           device_prep=device_prep, **args)
        n_s = cfg.TRAIN.IMS_PER_BATCH
    else:
        ws = kind == "single_ws"
        got_l = loader.get_data_layer(port_db, NET, cfg, canvas, True,
                                      is_ws=ws, rng=np.random.RandomState(8),
                                      device_prep=device_prep)
        want_l = jax_loader.get_data_layer(jax_db, NET, jcfg, canvas, True,
                                           is_ws=ws,
                                           rng=np.random.RandomState(8),
                                           device_prep=device_prep)
        n_s = 0 if ws else cfg.TRAIN.IMS_PER_BATCH
    assert got_l.raw_hw == want_l.raw_hw
    for _ in range(STEPS):
        _check(got_l.forward(), want_l.forward(), n_s, got_l.raw_hw)
        gs, ws_ = got_l.state_dict(), want_l.state_dict()
        for k in gs:
            if k == "rng":
                np.testing.assert_array_equal(gs[k][1], ws_[k][1])
                assert gs[k][2:] == ws_[k][2:]
            else:   # a cursor: the index sequence
                np.testing.assert_array_equal(gs[k]["perm"], ws_[k]["perm"])
                assert gs[k]["cur"] == ws_[k]["cur"]


@pytest.mark.parametrize("joint", [False, True])
def test_state_dict_round_trip(roidbs, joint):
    """A layer restored from another's state draws the same next batches;
    a state of a differently sized roidb is not applied."""
    port_db, _, canvas = roidbs
    cfg = Config().with_overrides(OVERRIDES)

    def make(seed):
        return loader.get_data_layer(
            (port_db, port_db[:5]) if joint else port_db, NET, cfg, canvas,
            True, is_ws=not joint, is_joint=joint,
            rng=np.random.RandomState(seed), device_prep=True)

    a = make(1)
    for _ in range(3):
        a.forward()
    b = make(2)
    b.load_state_dict(a.state_dict())
    for _ in range(4):
        ga, gb = a.forward(), b.forward()
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k])
    small = loader.get_data_layer(
        (port_db[:3], port_db[:2]) if joint else port_db[:3], NET, cfg,
        canvas, True, is_ws=not joint, is_joint=joint,
        rng=np.random.RandomState(3), device_prep=True)
    before = small.state_dict()
    small.load_state_dict(a.state_dict())
    after = small.state_dict()
    np.testing.assert_array_equal(before["rng"][1], after["rng"][1])


def test_prefetcher_consumed_state_and_errors(roidbs):
    """``Prefetcher.state_dict`` is the state paired with the last consumed
    batch (the worker runs ahead), so a layer restored from it continues
    with the batch the consumer would get next; a worker error re-raises
    at the consumer; more than one slot raises."""
    port_db, _, canvas = roidbs
    cfg = Config().with_overrides(OVERRIDES)

    def make(seed):
        return loader.RoIDataLayerJoint(port_db, port_db[:5], NET, cfg,
                                        canvas,
                                        rng=np.random.RandomState(seed),
                                        device_prep=True)

    pf = loader.Prefetcher(make(5), depth=2)
    try:
        first = [pf.forward() for _ in range(3)]
        state = pf.state_dict()
        nxt = pf.forward()
    finally:
        pf.close()
    assert not pf.thread.is_alive()
    plain = make(5)
    for want in first:
        np.testing.assert_array_equal(plain.forward()["raw"], want["raw"])
    resumed = make(9)
    resumed.load_state_dict(state)
    got = resumed.forward()
    for k in got:
        np.testing.assert_array_equal(got[k], nxt[k])

    class Broken:
        def forward(self):
            raise ValueError("bad image")

        def close(self):
            pass

    pf = loader.Prefetcher(Broken())
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        pf.forward()
    pf.close()
    with pytest.raises(NotImplementedError, match="A10"):
        loader.RoIDataLayer(port_db, NET, cfg, canvas, True, slots=2)
