"""The serving artifact (``wssdl_bus_tpu_torch/serve/__init__.py``:
``export_serving``, ``load_serving``, ``ServingModel``) against the live
port ``Engine`` / ``QuantServingEngine`` and against the JAX package's
``ServingModel`` and ``Engine`` on the same converted weights, at full
VGG16 width on ``tests/test_torch_engine.py``'s 192x256 canvas, TEST
budgets (32 -> 16 proposals), seeded He weights and images.

The JAX ``ServingModel`` is run without StableHLO: it is built from the
port's artifact directory and ``meta.json`` (so the JAX package's
``_config_from_flat`` reads the port's config) with the JAX variables,
and ``jax.jit(Engine._inference_impl)`` stands in its program table for
each exported batch size.  That runs the JAX padding and decode code with
no export compile.

The JAX int8 step runs eagerly on the artifact's own int8 tree
(:func:`_into_jax_tree`; why eagerly: the test's comment).

Tolerances are ``tests/test_torch_engine.py``'s for the f32 step (scores
1e-5, boxes ``BOX_ATOL`` px) and ``tests/test_torch_quantize.py``'s for
the int8 step (class probabilities 1e-4), each behind its near-tie guard:
the smallest gap between neighbouring top-ranked RPN scores must exceed
10x the measured drift between the two trunks.  Against the live port
engine the artifact is exact."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import BOX_ATOL, ultrasound_like
from tests.test_torch_quantize import _models
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.evaluate.detect import get_image_blob as jax_image_blob
from wssdl_bus_tpu.models import quantize as JQ
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_rpn_softmax
from wssdl_bus_tpu.serve import ServingModel as JaxServingModel
from wssdl_bus_tpu.serve import _config_from_flat as jax_config_from_flat
from wssdl_bus_tpu.serve import report_detections as jax_report
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import im_detect, pack_image_batch
from wssdl_bus_tpu_torch.models import quantize as Q
from wssdl_bus_tpu_torch.models.convert import he_tree, params_from_jax
from wssdl_bus_tpu_torch.models.detector import build_detector, rpn_softmax
from wssdl_bus_tpu_torch.models.quantize import (QuantServingEngine,
                                                replaced_state_keys)
from wssdl_bus_tpu_torch.ops.int8_conv import unpack_weight
from wssdl_bus_tpu_torch.serve import (_config_from_flat, export_serving,
                                       load_serving, report_detections)
from wssdl_bus_tpu_torch.train.engine import Engine

CANVAS = (192, 256)
NET = "VGGnet_test"
SEED = 6            # tests/test_torch_engine.py's: its near-tie guard holds
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TEST.RPN_PRE_NMS_TOP_N", "32", "TEST.RPN_POST_NMS_TOP_N", "16"]
A = 9
OUTPUTS = ("rois", "valid", "cls_score", "cls_prob", "bbox_pred")
INT8_IMAGE_SEEDS = {"VGGnet": 9, "Resnet": 0}
META_KEYS = {"format", "net_name", "backbone", "num_classes", "canvas_hw",
             "batch_sizes", "platform", "torch_version", "quantized",
             "config", "net_depth", "norm_type", "compute_dtype"}


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    """Both VGG16 engines on one He tree, two requests, and the port's f32
    artifact at batch sizes (1, 2)."""
    torch.set_num_threads(2)
    jm = JaxFasterRCNN(backbone="VGGnet")
    tree = jax.tree.map(np.asarray, jm.init_variables(jax.random.PRNGKey(0),
                                                      (32, 32)))
    he = he_tree(tree, SEED, input_scale=64.0)
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= 0.1
    jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
    port = build_detector(NET, device="cpu")
    port.load_state_dict(params_from_jax(he))
    eng = Engine(port, Config().with_overrides(OVERRIDES), CANVAS,
                 device="cpu")
    rng = np.random.RandomState(SEED)
    images = [ultrasound_like(rng) for _ in range(2)]
    art = str(tmp_path_factory.mktemp("artifact"))
    meta = export_serving(eng, art, NET, batch_sizes=(2, 1))
    return dict(jm=jm, he=he, jeng=jeng, eng=eng, images=images, art=art,
                meta=meta, served=load_serving(art, device="cpu"))


def _jax_served(path, meta, jeng, variables, impl=None):
    """The JAX package's ServingModel over the port's artifact, its program
    table filled with the jitted step instead of deserialized StableHLO."""
    served = JaxServingModel(path, meta, variables)
    step = jax.jit(impl or jeng._inference_impl)
    served._programs = {b: step for b in served.batch_sizes}
    return served


def _assert_no_near_ties(jprob, prob, k):
    """The fg probabilities of both trunks: every gap between neighbouring
    top-(k + 1) JAX scores exceeds 10x their largest difference."""
    jprob = np.asarray(jprob)[..., A:]
    drift = np.abs(jprob - prob[..., A:]).max()
    gaps = [np.abs(np.diff(np.sort(p.reshape(-1))[-(k + 1):])).min()
            for p in jprob]
    assert 0 < drift and min(gaps) > 10 * drift, (min(gaps), drift)


def _vgg_guard(s, images):
    blob = np.concatenate([jax_image_blob(im, NET, s["jeng"].cfg, CANVAS)[0]
                           for im in images])
    jt = jax.jit(lambda v, d: s["jm"].apply_trunk(v, d, train=False)[:3])(
        s["he"], blob)
    with torch.no_grad():
        _, score, _ = s["eng"].model.apply_trunk(torch.from_numpy(blob))
    _assert_no_near_ties(jax_rpn_softmax(jt[1], A),
                         rpn_softmax(score, A).numpy(),
                         s["eng"].cfg.TEST.RPN_PRE_NMS_TOP_N)


def _assert_detect_close(got, want, jcfg, cfg) -> int:
    """Per image: scores 1e-5, boxes BOX_ATOL, and the same report; -> the
    number of reported detections."""
    n_reported = 0
    for (gs, gb), (ws, wb) in zip(got, want, strict=True):
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
        g, _ = report_detections(gs, gb, cfg, thresh=0.3)
        w, _ = jax_report(ws, wb, jcfg, thresh=0.3)
        assert [e["class"] for e in g] == [e["class"] for e in w]
        np.testing.assert_allclose([e["score"] for e in g],
                                   [e["score"] for e in w], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(np.reshape([e["box"] for e in g], -1),
                                   np.reshape([e["box"] for e in w], -1),
                                   rtol=0, atol=BOX_ATOL)
        n_reported += len(g)
    return n_reported


def _batch(b, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(b, *CANVAS, 3).astype(np.float32) - 0.5) * 128.0
    infos = np.tile(np.array([[*CANVAS, 1.5, 0.0]], np.float32), (b, 1))
    return data, infos


def test_artifact_files_and_meta(vgg):
    """The two files, the JAX package's meta keys and the port's, and a
    config that the JAX package's ``_config_from_flat`` reads back equal to
    the JAX Config with the same overrides (but DATA_DIR, whose default
    the port changed)."""
    art, meta = vgg["art"], vgg["meta"]
    assert sorted(os.listdir(art)) == ["meta.json", "variables.pt"]
    with open(os.path.join(art, "meta.json")) as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    assert set(meta) == META_KEYS
    assert meta["format"] == 1
    assert meta["batch_sizes"] == [1, 2]
    assert meta["canvas_hw"] == list(CANVAS)
    assert (meta["platform"], meta["backbone"], meta["num_classes"]) == \
        ("cpu", "VGGnet", 3)
    assert (meta["quantized"], meta["compute_dtype"], meta["net_depth"],
            meta["norm_type"]) == (False, "float32", None, None)
    assert meta["torch_version"] == torch.__version__
    assert _config_from_flat(meta["config"]) == vgg["eng"].cfg
    jcfg = jax_config_from_flat(meta["config"])
    want = vgg["jeng"].cfg
    assert jcfg != want and jcfg.DATA_DIR == "SNUBH_BUS"
    assert dataclasses.replace(jcfg, DATA_DIR=want.DATA_DIR) == want
    served = vgg["served"]
    assert served.cfg == vgg["eng"].cfg and served.canvas_hw == CANVAS
    assert isinstance(served.engine, Engine)


@pytest.mark.parametrize("b", [1, 2])
def test_roundtrip_bitwise(vgg, b):
    data, infos = _batch(b, seed=b)
    want = vgg["eng"].inference_step(data, infos)
    got = vgg["served"].inference_step(data, infos)
    for w, g, name in zip(want, got, OUTPUTS, strict=True):
        assert torch.equal(w, g), name


def test_detect_matches_jax_serving_model(vgg):
    """The port's ``detect`` against the JAX ``ServingModel.detect`` at
    batch 1 and 2, and against the live engine's ``im_detect`` bit for
    bit."""
    s = vgg
    _vgg_guard(s, s["images"])
    jserved = _jax_served(s["art"], s["meta"], s["jeng"], s["he"])
    n_reported = sum(
        _assert_detect_close(s["served"].detect(ims), jserved.detect(ims),
                             s["jeng"].cfg, s["eng"].cfg)
        for ims in (s["images"][:1], s["images"]))
    assert n_reported > 0
    (gs, gb), = s["served"].detect(s["images"][1:])
    ws, wb = im_detect(s["eng"], s["images"][1], NET, CANVAS)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gb, wb)


def test_detect_pads_a_single_image(vgg, tmp_path):
    """A batch-2-only artifact serves one image in a padded batch: the
    same detections as the live single-image path (within f32 drift: the
    batch size may change oneDNN's convolution algorithm) and as the JAX
    ``ServingModel``'s padded batch."""
    s = vgg
    meta = export_serving(s["eng"], str(tmp_path), NET, batch_sizes=(2,))
    served = load_serving(str(tmp_path), device="cpu")
    im = s["images"][0]
    (gs, gb), = served.detect([im])
    ws, wb = im_detect(s["eng"], im, NET, CANVAS)
    assert gs.shape == ws.shape
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
    jserved = _jax_served(str(tmp_path), meta, s["jeng"], s["he"])
    _assert_detect_close([(gs, gb)], jserved.detect([im]), s["jeng"].cfg,
                         s["eng"].cfg)


def test_bf16_artifact_roundtrip(vgg, tmp_path):
    """A bf16-compute model's artifact records the dtype and is rebuilt in
    it: its step equals the live bf16 engine's bit for bit."""
    model = build_detector(NET, device="cpu", compute_dtype=torch.bfloat16)
    model.load_state_dict(vgg["eng"].model.state_dict())
    eng = Engine(model, vgg["eng"].cfg, CANVAS, device="cpu")
    meta = export_serving(eng, str(tmp_path), NET, batch_sizes=(1,))
    assert meta["compute_dtype"] == "bfloat16"
    served = load_serving(str(tmp_path), device="cpu")
    assert served.engine.model.compute_dtype == torch.bfloat16
    data, infos = _batch(1, seed=4)
    for w, g, name in zip(eng.inference_step(data, infos),
                          served.inference_step(data, infos), OUTPUTS,
                          strict=True):
        assert torch.equal(w, g), name


def test_unexported_batch_raises(vgg):
    served = vgg["served"]
    data, infos = _batch(3, seed=3)
    with pytest.raises(ValueError, match="batch size 3"):
        served.inference_step(data, infos)
    with pytest.raises(ValueError, match="exceed"):
        served.detect([np.full((50, 60), 128, np.uint8)] * 3)


def test_load_needs_a_card_unless_told(vgg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving(vgg["art"])


# --------------------------------------------------------------------- #
# int8 artifacts
# --------------------------------------------------------------------- #
def _int8_case(backbone, tmp_path_factory):
    """The engines of ``tests/test_torch_quantize.py``'s ``engines``
    fixture, a request blob, the port's int8 artifact calibrated on it, and
    the JAX package's int8 tree holding the artifact's int8 layers and
    norms (:func:`_into_jax_tree`).  The requests' seed clears the near-tie
    guard: for VGG16 that fixture's seed 6 does with the JAX package's
    calibration but leaves two ranked scores 3e-7 apart with the port's
    (the drift is 2.4e-7); seed 9 clears it 144x."""
    seed, kw, scale = ((6, {}, 0.1) if backbone == "VGGnet" else
                       (0, dict(depth=18, norm="BN"), 0.03))
    image_seed = INT8_IMAGE_SEEDS[backbone]
    jm, _, port, he = _models(backbone, seed, canvas=(32, 32), **kw)
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= scale
    if backbone == "Resnet":
        he["trunk"]["params"]["rpn_bbox_pred"]["conv"]["kernel"] *= 0.03
    port.load_state_dict(params_from_jax(he))
    jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
    eng = Engine(port, Config().with_overrides(OVERRIDES), CANVAS,
                 device="cpu")
    net = f"{backbone}_test"
    rng = np.random.RandomState(image_seed)
    blob, infos, _ = pack_image_batch(
        eng, [ultrasound_like(rng) for _ in range(2)], net, CANVAS)
    f32_art = str(tmp_path_factory.mktemp(f"{backbone}_f32"))
    export_serving(eng, f32_art, net, batch_sizes=(2,))
    art = str(tmp_path_factory.mktemp(f"{backbone}_int8"))
    meta = export_serving(eng, art, net, batch_sizes=(1, 2),
                          calib_batches=[blob])
    if backbone == "VGGnet":
        scales = Q.calibrate_vgg_trunk(port, [blob])
    else:
        scales = Q.calibrate_resnet(port, [blob],
                                    spatial_scale=1.0 / 16, pool=eng._pool)
    jv = jax.tree.map(jnp.asarray, he)
    served = load_serving(art, device="cpu")
    jq = _into_jax_tree(jeng.quantize_for_serving(jv, act_scales=scales),
                        served.engine._qtrunk)
    return dict(jeng=jeng, eng=eng, jv=jv, blob=blob, infos=infos, art=art,
                f32_art=f32_art, meta=meta, jq=jq, served=served)


def _into_jax_tree(jq, q):
    """The JAX package's int8 tree ``jq`` (its f32 RPN and dense copies
    kept) with every int8 layer and norm replaced by the port's ``q``:
    both packages then run the artifact's own quantization.  Quantized
    apart from the same absmaxes, VGG16's trees are equal, ResNet's folded
    scales differ by up to 4 ulp (``tests/test_torch_quantize.py``), which
    can move a requantized value by one int8 code."""
    def layer(jl, pl):
        k, _, cin, _ = np.shape(jl["qkernel"])
        return dict(jl, qkernel=jnp.asarray(
            unpack_weight(pl["qkernel"], k, k, cin).numpy()), **{
                f: jnp.asarray(pl[f].numpy())
                for f in ("scale", "bias", "in_scale")})

    if "layers" in q:                                     # VGG16
        return dict(jq, layers=[layer(jl, pl) for jl, pl in zip(
            jq["layers"], q["layers"], strict=True)])
    out = dict(jq)
    for part in ("trunk", "head"):
        jp, pp = jq[part], q[part]
        assert jp["layers"].keys() == pp["layers"].keys()
        out[part] = dict(jp, layers={
            path: layer(jl, pp["layers"][path])
            for path, jl in jp["layers"].items()}, norms={
            path: {f: jnp.asarray(pp["norms"][path][f].numpy())
                   for f in ("g", "c")} for path in jp["norms"]})
    return out


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    return {b: _int8_case(b, tmp_path_factory) for b in ("VGGnet", "Resnet")}


@pytest.mark.parametrize("backbone", ["VGGnet", "Resnet"])
def test_int8_artifact_meta_size_and_nan_fill(int8, backbone):
    """int8 meta; the weights file under 0.7x the f32 one (as the JAX
    package's ``test_quant_artifact_meta_and_size``); the replaced
    parameters NaN after loading, every other one the live model's."""
    s = int8[backbone]
    assert s["meta"]["quantized"] is True
    assert s["meta"]["norm_type"] == (None if backbone == "VGGnet"
                                      else "BN")
    size = {k: os.path.getsize(os.path.join(s[k], "variables.pt"))
            for k in ("art", "f32_art")}
    assert size["art"] < 0.7 * size["f32_art"], size
    served = s["served"]
    assert isinstance(served.engine, QuantServingEngine)
    model = served.engine._eng.model
    replaced = replaced_state_keys(model)
    live = s["eng"].model.state_dict()
    n_nan = 0
    for k, v in model.state_dict().items():
        if k in replaced:
            assert torch.isnan(v).all(), k
            n_nan += v.numel()
        else:
            assert torch.equal(v, live[k]), k
    assert n_nan > 0 and any(k.startswith("trunk.rpn_") for k in live)
    assert all(k.startswith(("trunk.backbone.", "head.group3"))
               for k in replaced)


@pytest.mark.parametrize("backbone", ["VGGnet", "Resnet"])
def test_int8_artifact_matches_live_engine_and_jax(int8, backbone):
    """The int8 artifact's step bit for bit against the live
    ``QuantServingEngine`` quantized from the same blob, and against the
    JAX package's ``_inference_quant_impl`` on the artifact's int8
    tree (test_torch_quantize.py's tolerances, behind its guard)."""
    s = int8[backbone]
    eng = s["eng"]
    live = QuantServingEngine(eng, eng.quantize_for_serving([s["blob"]]))
    got = s["served"].inference_step(s["blob"], s["infos"])
    for w, g, name in zip(live.inference_step(s["blob"], s["infos"]), got,
                          OUTPUTS, strict=True):
        assert torch.equal(w, g), name

    jq, jv = s["jq"], s["jv"]
    head = jv["head"] if backbone == "VGGnet" else None
    # eagerly: under jit XLA fuses the int8 epilogue's multiply-add, so a
    # value on a rounding boundary requantizes one code apart, and through
    # ResNet's chain of requantized residual adds such flips grow to 1-3e-2
    # in the class probabilities (request seeds 1-7); eagerly the int8
    # features of both packages are equal
    want = [np.asarray(o) for o in s["jeng"]._inference_quant_impl(
        jq, head, s["blob"], s["infos"])]
    if backbone == "VGGnet":
        jt = JQ.quant_trunk_apply(jq, jnp.asarray(s["blob"]))
    else:
        jt = JQ.quant_resnet_trunk_apply(jq, jnp.asarray(s["blob"]), "BN",
                                         18)
    with torch.no_grad():
        trunk = (Q.quant_trunk_apply if backbone == "VGGnet"
                 else Q.quant_resnet_trunk_apply)
        _, score, _ = trunk(eng.model, s["served"].engine._qtrunk,
                            torch.from_numpy(s["blob"]))
    _assert_no_near_ties(jax_rpn_softmax(jt[1], A),
                         rpn_softmax(score, A).numpy(),
                         eng.cfg.TEST.RPN_PRE_NMS_TOP_N)
    got = [o.numpy() for o in got]
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum() > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[4], want[4], rtol=0,
                               atol=1e-4 * np.abs(want[4]).max())


def test_int8_artifact_refuses_a_foreign_state_dict(int8, tmp_path):
    """A state dict that ships a replaced key (or lacks one the int8 tree
    does not replace) is not an int8 artifact's: load raises."""
    s = int8["VGGnet"]
    saved = torch.load(os.path.join(s["art"], "variables.pt"),
                       weights_only=True)
    for k in os.listdir(s["art"]):
        if k != "variables.pt":
            with open(os.path.join(s["art"], k), "rb") as f, \
                    open(os.path.join(tmp_path, k), "wb") as g:
                g.write(f.read())
    live = s["eng"].model.state_dict()
    for change in ("extra", "missing"):
        sd = dict(saved["state_dict"])
        if change == "extra":
            sd["trunk.backbone.conv1_1.conv.bias"] = \
                live["trunk.backbone.conv1_1.conv.bias"]
        else:
            del sd["trunk.rpn_conv.conv.bias"]
        torch.save({"state_dict": sd, "qtrunk": saved["qtrunk"]},
                   os.path.join(tmp_path, "variables.pt"))
        with pytest.raises(ValueError, match="does not complement"):
            load_serving(str(tmp_path), device="cpu")
