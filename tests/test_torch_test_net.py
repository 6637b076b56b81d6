"""The evaluation entry point end to end on the CPU: the port's
``evaluate/detect.py:test_net`` against the JAX package's ``test_net`` on
the same weights and the same synthetic SNUBH-layout imdb (four 150 x 200
images, written as ``tests/test_torch_dataset.py`` writes them), at batch
1 and batch 2; and ``python -m wssdl_bus_tpu_torch.main.test`` (its
``main``) from a port snapshot.

The set-up is ``tests/test_torch_engine.py``'s: full VGG16 width, He
weights of seed 6 with the RPN class logits scaled by 0.1, a 192 x 256
canvas and TEST budgets of 32 -> 16 proposals, where that file shows the
keep sets agree and the drift between the two trunks leaves detection
boxes within its BOX_ATOL (2e-2 px) and class probabilities within 1e-5.
So here: the same number of detections per (class, image), boxes to 2e-2
px, scores to 1e-5, and the evaluation result (CorLoc per class and
overall) equal."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dataset import write_bus_imdb
from tests.test_torch_engine import (BOX_ATOL, CANVAS, NET, OVERRIDES, SEED,
                                     ultrasound_like)
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.data import dataset as jax_dataset
from wssdl_bus_tpu.evaluate.detect import test_net as jax_test_net
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import max_canvas
from wssdl_bus_tpu_torch.data import dataset
from wssdl_bus_tpu_torch.evaluate.detect import test_net as port_test_net
from wssdl_bus_tpu_torch.main import test as main_test
from wssdl_bus_tpu_torch.models.convert import he_tree, params_from_jax
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.checkpoint import save_checkpoint
from wssdl_bus_tpu_torch.train.engine import Engine

N_IMAGES = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("net")
    data = str(root / "data")
    write_bus_imdb(data, seed=SEED, sizes=[(150, 200)] * N_IMAGES)
    # the images of tests/test_torch_engine.py (its first two), then more
    rng = np.random.RandomState(SEED)
    from PIL import Image
    for k in range(N_IMAGES):
        Image.fromarray(ultrasound_like(rng)).save(
            os.path.join(data, "TIFFImages", f"test_{k:03d}.tif"))
    jm = JaxFasterRCNN(backbone="VGGnet")
    tree = jax.tree.map(np.asarray, jm.init_variables(jax.random.PRNGKey(0),
                                                      (32, 32)))
    he = he_tree(tree, SEED, input_scale=64.0)
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= 0.1
    jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
    model = build_detector(NET, device="cpu")
    model.load_state_dict(params_from_jax(he))
    eng = Engine(model, Config().with_overrides(OVERRIDES), CANVAS,
                 device="cpu")
    return dict(root=root, data=data, he=he, jeng=jeng, model=model, eng=eng)


def _same_detections(got, want, n_images=N_IMAGES):
    assert len(got) == len(want) == 3
    n = 0
    for j in (1, 2):
        for i in range(n_images):
            g, w = np.asarray(got[j][i]), np.asarray(want[j][i])
            assert g.shape == w.shape, (j, i)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0,
                                       atol=BOX_ATOL)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)
            n += len(g)
    assert n > 0


@pytest.mark.parametrize("batch_size", [1, 2])
def test_test_net_matches_jax(setup, batch_size):
    root = setup["root"]
    imdb = dataset.get_imdb("bus_test", setup["data"])
    jimdb = jax_dataset.get_imdb("bus_test", setup["data"])
    timings = {}
    got, got_res = port_test_net(setup["eng"], imdb,
                                 str(root / f"port{batch_size}"), NET,
                                 CANVAS, batch_size=batch_size,
                                 verbose=False, timings=timings)
    want, want_res = jax_test_net(setup["jeng"], setup["he"], jimdb,
                                  str(root / f"jax{batch_size}"), NET,
                                  CANVAS, batch_size=batch_size,
                                  verbose=False)
    _same_detections(got, want)
    assert got_res == want_res
    assert timings["images"] == N_IMAGES and timings["device_ms"] is None
    assert timings["read_prep_s"] > 0 and timings["wall_s"] > 0
    for name in ("detections.pkl", "eval.txt", "froc_curve_pts.npy",
                 "all_arr_ok.npy"):
        assert os.path.exists(root / f"port{batch_size}" / name)
    with open(root / f"port{batch_size}" / "detections.pkl", "rb") as f:
        _same_detections(pickle.load(f), got)


def test_main_end_to_end(setup):
    """A port snapshot of the converted weights, then the CLI's ``main`` on
    the CPU at batch 3 (the tail batch of one padded to three), with the
    DEBUG_TIMELINE trace and the qualitative overlays: the detections of
    ``test_net`` at batch 1 (to the drift between batch sizes), the files
    of the evaluation, the trace and the overlays.  The CLI sizes its
    canvas over the imdb with ``max_canvas``, and so does the reference
    run."""
    root = setup["root"]
    snap = save_checkpoint(str(root / "snap"), "vgg16", "", 7,
                           setup["model"].state_dict())
    out = str(root / "cli")
    all_boxes, result = main_test.main([
        "--model", snap, "--imdb_test", "bus_test", "--data_dir",
        setup["data"], "--network", NET, "--device", "cpu", "--output_dir",
        out, "--batch_size", "3", "--qual_res", "--set_cfgs", *OVERRIDES,
        "TEST.DEBUG_TIMELINE", "True"])
    imdb = dataset.get_imdb("bus_test", setup["data"])
    cfg = Config().with_overrides(OVERRIDES)
    canvas = max_canvas([(150, 200)], cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
    eng = Engine(setup["model"], cfg, canvas, device="cpu")
    want, want_res = port_test_net(eng, imdb, str(root / "ref"), NET,
                                   canvas, verbose=False)
    _same_detections(all_boxes, want)
    assert result == want_res
    names = set(os.listdir(out))
    assert {"detections.pkl", "eval.txt", "froc_curve_pts.npy",
            "all_arr_ok.npy", "torch_trace", "qual"} <= names
    assert os.listdir(os.path.join(out, "torch_trace"))
    assert len(os.listdir(os.path.join(out, "qual"))) == N_IMAGES


@pytest.mark.parametrize("extra,match", [
    # --int8 and --bf16 are ported; what they still refuse takes their
    # places (the ids keep the cases' places in the list)
    pytest.param(["--int8", "--network", "Resnet_test", "--norm_type", "GN"],
                 "GroupNorm", id="extra0-A7"),
    pytest.param(["--int8", "--mesh_data", "2"], "single-device",
                 id="extra1-A7"),
    (["--mesh_data", "2"], "A10"),
    # the ResNet detectors are ported; the JAX package's ResNet default of
    # full remat is not (the id keeps the case's place in the list)
    pytest.param(["--network", "Resnet_test", "--remat", "head"], "remat",
                 id="extra3-A6"),
    (["--remat", "true"], "remat")])
def test_main_refuses_what_is_not_ported(setup, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        main_test.main(["--model", "unused", "--data_dir", setup["data"],
                        "--device", "cpu", "--network", NET, *extra])
