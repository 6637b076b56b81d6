"""The entry points with the precision options, end to end on the CPU:
``main.test --int8`` and ``main.test --bf16`` over the four-image imdb of
``tests/test_torch_test_net.py`` (its weights and TEST budgets), and one
``main.train --bf16`` step at ``tests/test_torch_solver.py``'s 64-px
config.  The CLI's detections equal those of the library path it stands
for (the same engine, calibration blob and ``test_net``); the numerics of
the quantized and the bf16 models against the JAX package are held in
``tests/test_torch_quantize.py`` and ``tests/test_torch_bf16.py``."""

import os

import numpy as np
import torch
from PIL import Image

from tests.test_torch_solver import _argv
from tests.test_torch_solver import data_dir  # noqa: F401 (fixture)
from tests.test_torch_solver import runs  # noqa: F401 (fixture)
from tests.test_torch_test_net import NET, OVERRIDES, setup  # noqa: F401
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data import dataset
from wssdl_bus_tpu_torch.data.augment import max_canvas
from wssdl_bus_tpu_torch.evaluate.detect import pack_image_batch, test_net
from wssdl_bus_tpu_torch.main import test as main_test
from wssdl_bus_tpu_torch.main import train
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.models.quantize import QuantServingEngine
from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint, \
    save_checkpoint
from wssdl_bus_tpu_torch.train.engine import Engine


def _same(got, want):
    assert len(got) == len(want) == 3
    n = 0
    for j in (1, 2):
        for g, w in zip(got[j], want[j], strict=True):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            n += len(g)
    assert n > 0


def _cli(setup, tmp, *extra):    # noqa: F811
    snap = save_checkpoint(str(tmp / "snap"), "vgg16", "", 7,
                           setup["model"].state_dict())
    return main_test.main([
        "--model", snap, "--imdb_test", "bus_test", "--data_dir",
        setup["data"], "--network", NET, "--device", "cpu", "--output_dir",
        str(tmp / "cli"), "--batch_size", "2", *extra, "--set_cfgs",
        *OVERRIDES])


def _canvas(cfg):
    return max_canvas([(150, 200)], cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)


def test_main_test_int8(setup, tmp_path):    # noqa: F811
    """``--int8`` calibrates on the evaluated split's images (all four,
    under ``--calib_images``' 16) packed as one blob, quantizes and
    evaluates through ``QuantServingEngine``: the library path's
    detections exactly."""
    all_boxes, result = _cli(setup, tmp_path, "--int8")
    cfg = Config().with_overrides(OVERRIDES)
    canvas = _canvas(cfg)
    imdb = dataset.get_imdb("bus_test", setup["data"])
    eng = Engine(setup["model"], cfg, canvas, device="cpu")
    images = [np.asarray(Image.open(imdb.image_path_at(i)))
              for i in range(imdb.num_images)]
    blob, _, _ = pack_image_batch(eng, images, NET, canvas)
    q = eng.quantize_for_serving([blob])
    want, want_res = test_net(QuantServingEngine(eng, q), imdb,
                              str(tmp_path / "lib"), NET, canvas,
                              batch_size=2, verbose=False)
    _same(all_boxes, want)
    assert result == want_res
    assert os.path.exists(tmp_path / "cli" / "eval.txt")


def test_main_test_bf16(setup, tmp_path):    # noqa: F811
    """``--bf16`` builds the bf16 detector: ``test_net`` of a bf16 model
    with the same weights, exactly."""
    all_boxes, result = _cli(setup, tmp_path, "--bf16")
    cfg = Config().with_overrides(OVERRIDES)
    canvas = _canvas(cfg)
    model = build_detector(NET, device="cpu", compute_dtype=torch.bfloat16)
    model.load_state_dict(setup["model"].state_dict())
    want, want_res = test_net(Engine(model, cfg, canvas, device="cpu"),
                              dataset.get_imdb("bus_test", setup["data"]),
                              str(tmp_path / "lib"), NET, canvas,
                              batch_size=2, verbose=False)
    _same(all_boxes, want)
    assert result == want_res


def test_main_train_bf16_step(data_dir, runs):    # noqa: F811
    """``main.train --bf16``: the solver trains the bf16 model it is given,
    finite losses, f32 parameters in the snapshot."""
    out = str(runs / "bf16")
    solver = train.main(_argv(data_dir, out, "--unfreeze_stem", "--bf16",
                              iters=2, test_iters=2))
    assert solver.eng.model.compute_dtype == torch.bfloat16
    snap = os.path.join(out, "VGGnet_fast_rcnn_iter_2")
    params, step = load_checkpoint(snap)
    assert step == 2
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in params.values())
