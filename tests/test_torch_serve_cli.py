"""The port's serving CLIs, ``main.export`` (f32 and ``--int8``) from a
port snapshot and ``main.predict`` (``--artifact`` and ``--model``, with
``--vis``), on the CPU at ``tests/test_torch_engine.py``'s full-width
VGG16 configuration: its He weights (seed 6, RPN class kernel x 0.1), two
of its 150x200 requests written as PNGs and its TEST scale and budgets
(192 / 256, 32 -> 16 proposals).  ``predict --model`` sizes the canvas over the
requests (``max_canvas``: 192x256 and a 4-pixel margin, rounded up to
208x272), so the artifacts are exported at that canvas too.
``predictions.json`` is held against the JAX package's
``report_detections(im_detect_batch(...))`` on the same converted weights
at that canvas, with ``tests/test_torch_engine.py``'s tolerances (scores
1e-5, boxes ``BOX_ATOL`` px) behind its near-tie guard
(``tests/test_torch_serve.py:_assert_no_near_ties``), which the requests
of seed 9 clear 44x at this canvas (that file's seed 6: 3.5x)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_dataset import write_bus_imdb
from tests.test_torch_engine import BOX_ATOL, ultrasound_like
from tests.test_torch_serve import _assert_no_near_ties
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.evaluate.detect import get_image_blob as jax_image_blob
from wssdl_bus_tpu.evaluate.detect import im_detect_batch as jax_detect
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_rpn_softmax
from wssdl_bus_tpu.serve import report_detections as jax_report
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import (im_detect_batch,
                                                 pack_image_batch)
from wssdl_bus_tpu_torch.main import export as main_export
from wssdl_bus_tpu_torch.main import predict as main_predict
from wssdl_bus_tpu_torch.models.convert import he_tree, params_from_jax
from wssdl_bus_tpu_torch.models.detector import build_detector, rpn_softmax
from wssdl_bus_tpu_torch.models.quantize import QuantServingEngine
from wssdl_bus_tpu_torch.serve import report_detections
from wssdl_bus_tpu_torch.train.checkpoint import save_checkpoint
from wssdl_bus_tpu_torch.train.engine import Engine

CANVAS = (208, 272)   # max_canvas of the requests at the TEST scale
NET = "VGGnet_test"
SEED = 6            # weights
IMAGE_SEED = 9      # requests
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TEST.RPN_PRE_NMS_TOP_N", "32", "TEST.RPN_POST_NMS_TOP_N", "16"]
THRESH = 0.3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("cli")
    jm = JaxFasterRCNN(backbone="VGGnet")
    tree = jax.tree.map(np.asarray, jm.init_variables(jax.random.PRNGKey(0),
                                                      (32, 32)))
    he = he_tree(tree, SEED, input_scale=64.0)
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= 0.1
    port = build_detector(NET, device="cpu")
    port.load_state_dict(params_from_jax(he))
    snap = save_checkpoint(str(root / "snapshots"), "vgg16", "", 0,
                           port.state_dict())
    rng = np.random.RandomState(IMAGE_SEED)
    images = [ultrasound_like(rng) for _ in range(2)]
    paths = []
    for k, im in enumerate(images):
        paths.append(str(root / f"req{k}.png"))
        Image.fromarray(im).save(paths[-1])
    data = str(root / "imdb")
    write_bus_imdb(data, 3, sizes=[(150, 200)] * 2)
    common = ["--network", NET, "--device", "cpu", "--data_dir", data,
              "--canvas", str(CANVAS[0]), str(CANVAS[1])]
    arts = {}
    for tag, extra in (("f32", []), ("int8", ["--int8", "--calib_images",
                                             "2"])):
        arts[tag] = str(root / f"artifact_{tag}")
        arts[f"{tag}_meta"] = main_export.main(
            ["--model", snap, "--out", arts[tag], "--batch_sizes", "1,2"]
            + extra + common + ["--set_cfgs"] + OVERRIDES)
    jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
    blob = np.concatenate([jax_image_blob(im, NET, jeng.cfg, CANVAS)[0]
                           for im in images])
    jt = jax.jit(lambda v, d: jm.apply_trunk(v, d, train=False)[:3])(
        he, blob)
    with torch.no_grad():
        _, score, _ = port.apply_trunk(torch.from_numpy(blob))
    _assert_no_near_ties(jax_rpn_softmax(jt[1], 9),
                         rpn_softmax(score, 9).numpy(),
                         jeng.cfg.TEST.RPN_PRE_NMS_TOP_N)
    jax_results = jax_detect(jeng, he, images, NET, CANVAS)
    jax_reports = [jax_report(s, b, jeng.cfg, thresh=THRESH)[0]
                   for s, b in jax_results]
    return dict(root=root, snap=snap, port=port, images=images, paths=paths,
                data=data, common=common, arts=arts, jeng=jeng,
                jax_reports=jax_reports)


def _predict(s, out, *args):
    report = main_predict.main(list(s["paths"]) + ["--out", str(out),
                                                   "--thresh", str(THRESH),
                                                   "--vis", "--device",
                                                   "cpu"] + list(args))
    with open(os.path.join(out, "predictions.json")) as f:
        assert json.load(f) == report
    for p in s["paths"]:
        stem = os.path.splitext(os.path.basename(p))[0]
        assert os.path.isfile(os.path.join(out, f"{stem}_pred.png"))
    return report


def _assert_reports_close(got, want):
    """The same classes in the same order; scores 1e-5, boxes BOX_ATOL; the
    JAX CLI's key order."""
    n = 0
    for g, w in zip(got, want, strict=True):
        assert [d["class"] for d in g] == [d["class"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g],
                                   [d["score"] for d in w], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(np.reshape([d["box"] for d in g], -1),
                                   np.reshape([d["box"] for d in w], -1),
                                   rtol=0, atol=BOX_ATOL)
        assert all(list(d) == ["class", "score", "box"] for d in g)
        n += len(g)
    assert n > 0


def test_export_cli_writes_artifacts(setup):
    """f32 and int8 artifacts from the snapshot: meta, files, and the int8
    weights under 0.7x the f32 ones."""
    f32, q = setup["arts"]["f32_meta"], setup["arts"]["int8_meta"]
    for meta in (f32, q):
        assert meta["batch_sizes"] == [1, 2]
        assert meta["canvas_hw"] == list(CANVAS)
        assert (meta["net_name"], meta["platform"]) == (NET, "cpu")
        assert meta["config"]["TEST.RPN_POST_NMS_TOP_N"] == 16
    assert (f32["quantized"], q["quantized"]) == (False, True)
    size = {t: os.path.getsize(os.path.join(setup["arts"][t],
                                            "variables.pt"))
            for t in ("f32", "int8")}
    assert size["int8"] < 0.7 * size["f32"], size


@pytest.mark.parametrize("mode", ["artifact", "model"])
def test_predict_matches_jax_report(setup, mode, tmp_path):
    """``predictions.json`` from the artifact (padded to the exported
    batch 2) and from the snapshot at ``--batch 2``: per image the JAX
    package's report, with the JAX CLI's keys in its order."""
    s = setup
    if mode == "artifact":
        report = _predict(s, tmp_path, "--artifact", s["arts"]["f32"])
    else:
        report = _predict(s, tmp_path, "--model", s["snap"], "--network",
                          NET, "--batch", "2", "--set_cfgs", *OVERRIDES)
    assert [list(e) for e in report] == [["image", "detections"]] * 2
    assert [e["image"] for e in report] == s["paths"]
    _assert_reports_close([e["detections"] for e in report],
                          s["jax_reports"])


def test_predict_int8_artifact_matches_live_engine(setup, tmp_path):
    """The int8 artifact's predictions equal the report of the live
    ``QuantServingEngine`` calibrated on the same imdb images."""
    s = setup
    report = _predict(s, tmp_path, "--artifact", s["arts"]["int8"])
    eng = Engine(s["port"], Config().with_overrides(OVERRIDES), CANVAS,
                 device="cpu")
    calib = [np.asarray(Image.open(os.path.join(s["data"], "TIFFImages",
                                                f"test_{k:03d}.tif")))
             for k in range(2)]
    blob, _, _ = pack_image_batch(eng, calib, NET, CANVAS)
    qeng = QuantServingEngine(eng, eng.quantize_for_serving([blob]))
    want = [report_detections(sc, bx, eng.cfg, thresh=THRESH)[0]
            for sc, bx in im_detect_batch(qeng, s["images"], NET, CANVAS)]
    assert [e["detections"] for e in report] == json.loads(json.dumps(want))


def test_predict_rejects_cfg_with_artifact(setup, tmp_path):
    """--cfg and the model options the artifact decides are errors with
    --artifact; exactly one of --artifact / --model is required."""
    cfg = tmp_path / "x.yml"
    cfg.write_text("TEST:\n  NMS: 0.4\n")
    art = ["--artifact", setup["arts"]["f32"]]
    for args in (art + ["--cfg", str(cfg)], art + ["--network", NET],
                 art + ["--bf16"], art + ["--norm_type", "GN"],
                 art + ["--net_depth", "50"],
                 art + ["--model", setup["snap"]], []):
        with pytest.raises(SystemExit) as e:
            main_predict.main(setup["paths"][:1] + ["--out", str(tmp_path)]
                              + args)
        assert e.value.code == 2


@pytest.mark.parametrize("option", [["--mesh_data", "2"], ["--remat", "true"]])
@pytest.mark.parametrize("mode", ["artifact", "model"])
def test_predict_refuses_unported_options(setup, tmp_path, option, mode):
    """The options the port has no path for raise in both modes."""
    src = (["--artifact", setup["arts"]["f32"]] if mode == "artifact"
           else ["--model", setup["snap"], "--network", NET])
    with pytest.raises(NotImplementedError):
        main_predict.main(setup["paths"][:1] + ["--out", str(tmp_path),
                                                "--device", "cpu"]
                          + src + option)
