"""int8 serving (``models/quantize.py``, ``Engine.quantize_for_serving`` /
``inference_step_quant``) against the JAX package's ``models/quantize.py``
and ``Engine``, on the CPU (the int8 conv through its plain version,
``ops/int8_conv.py``, exact: ``tests/test_torch_int8_conv.py``).

Weights: He-normal trees (``models/convert.py:he_tree``) drawn on the JAX
variable tree and loaded into both packages; ResNet's gamma / beta and
running statistics drawn away from their init
(``tests/test_torch_resnet_model.py:_perturbed``) so the BN folding is
exercised.

Tolerances.
  * Calibration absmaxes: the two f32 trunks agree to f32 drift through the
    convs (``tests/test_torch_engine.py``: ~1e-6 of the max, oneDNN 3-4e-6)
    -> 2e-5 relative.
  * The port's own quantization against the JAX package's, from the same
    recorded absmaxes: int8 kernels and input scales exactly (the same
    numpy arithmetic); VGG16's fused scales and biases exactly; ResNet's
    folded scales / biases and norm affines within 4 ulp (BatchRenorm's
    ``rsqrt`` rounds differently in the two frameworks).
  * The int8 trunks given the same quantized tree (``qtrunk_from_jax``):
    bit for bit on power-of-two grids (every value exact, so no order or
    fusion can differ); on general data the JAX side may fuse the epilogue's
    multiply-add where the port rounds twice, and a requantized value on a
    rounding boundary then moves by one int8 code, so features agree to
    2e-3 of their max (VGG16) and the RPN outputs with them.
  * The engines' quantized serving steps: the int8 trunks' drift in the
    RPN probabilities is measured and every gap between neighbouring
    ranked scores must exceed 10x it (as ``tests/test_torch_engine.py``
    guards the f32 step); then keep sets are identical, ROIs agree to
    ``BOX_ATOL`` and class probabilities to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import BOX_ATOL, ultrasound_like
from tests.test_torch_resnet_model import _perturbed
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.evaluate.detect import get_image_blob as jax_image_blob
from wssdl_bus_tpu.models import quantize as JQ
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_rpn_softmax
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models import quantize as Q
from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                qtrunk_from_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector, rpn_softmax
from wssdl_bus_tpu_torch.ops.int8_conv import unpack_weight
from wssdl_bus_tpu_torch.train.engine import Engine

CAL = (32, 32)      # VGG16 calibration canvas (2x2 after four pools)
RCAL = (64, 64)     # ResNet canvas (4x4 at stride 16)
CANVAS = (192, 256)
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TEST.RPN_PRE_NMS_TOP_N", "32", "TEST.RPN_POST_NMS_TOP_N", "16"]
A = 9


def _models(backbone, seed, depth=18, norm=None, canvas=CAL):
    """(JAX model, its variables as jnp, the port model) from one He tree."""
    torch.set_num_threads(2)
    kw = dict(depth=depth, norm=norm, remat=False) \
        if backbone == "Resnet" else {}
    jm = JaxFasterRCNN(backbone=backbone, **kw)
    tree = jax.tree.map(np.asarray, jm.init_variables(
        jax.random.PRNGKey(0), canvas))
    he = he_tree(tree, seed, input_scale=64.0 if backbone == "VGGnet"
                 else 1.0)
    if backbone == "Resnet":
        he = _perturbed(he, seed)
        name = "Resnet_test"
    else:
        name = "VGGnet_test"
    port = build_detector(name, device="cpu", depth=depth, norm=norm)
    port.load_state_dict(params_from_jax(he))
    return jm, jax.tree.map(jnp.asarray, he), port, he


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a, b):
    a, b = (np.asarray(t, np.float32) for t in (a, b))
    return (np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
            ).max()


@pytest.fixture(scope="module")
def vgg():
    jm, jv, port, he = _models("VGGnet", 3)
    rng = np.random.RandomState(3)
    batches = [(rng.randn(1, *CAL, 3) * 64).astype(np.float32),
               (rng.randn(1, *CAL, 3) * 128).astype(np.float32)]
    return dict(jm=jm, jv=jv, port=port, batches=batches,
                scales=JQ.calibrate_vgg_trunk(jm, jv, batches))


@pytest.fixture(scope="module")
def resnet():
    jm, jv, port, he = _models("Resnet", 4, depth=18, norm="BN",
                               canvas=RCAL)
    rng = np.random.RandomState(4)
    batches = [rng.randn(2, *RCAL, 3).astype(np.float32)]
    return dict(jm=jm, jv=jv, port=port, batches=batches,
                scales=JQ.calibrate_resnet(jm, jv, batches))


def test_vgg_calibration_matches_jax(vgg):
    got = Q.calibrate_vgg_trunk(vgg["port"], vgg["batches"])
    want = vgg["scales"]
    assert got.keys() == want.keys() and len(got) == 14
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=2e-5), k
    assert got["data"] == want["data"]      # the input: no arithmetic


def test_resnet_calibration_matches_jax(resnet):
    got = Q.calibrate_resnet(resnet["port"], resnet["batches"])
    want = resnet["scales"]
    assert got.keys() == want.keys()
    assert len(got) == len(Q._resnet_conv_paths(18, "trunk")) \
        + len(Q._resnet_conv_paths(18, "head"))
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=2e-5), k
    assert got["conv0"] == want["conv0"]


def test_vgg_quantize_matches_jax(vgg):
    """From the same absmaxes: every field of every layer equal."""
    mine = Q.quantize_vgg_trunk(vgg["port"], vgg["scales"])
    theirs = qtrunk_from_jax(_np(JQ.quantize_vgg_trunk(vgg["jv"],
                                                       vgg["scales"])))
    for a, b in zip(mine["layers"], theirs["layers"], strict=True):
        assert a["k"] == b["k"] == 3
        for f in ("qkernel", "scale", "bias", "in_scale"):
            assert torch.equal(a[f], b[f]), f
    assert mine.keys() == theirs.keys() == {"layers"}


def test_resnet_quantize_matches_jax(resnet):
    """int8 kernels and input scales exactly; the BN-folded scales and the
    norms' g within 4 ulp (products: BatchRenorm's ``rsqrt`` rounds
    differently in the two frameworks), the folded biases and the norms' c
    (``beta - mean * g``, which cancels) within 2 ulp of each tensor's
    largest value."""
    mine = Q.quantize_resnet(resnet["port"], resnet["scales"])
    jq = _np(JQ.quantize_resnet(resnet["jv"], "BN", 18, resnet["scales"]))
    theirs = qtrunk_from_jax(jq)
    prod, shift = [], []
    for part in ("trunk", "head"):
        assert mine[part]["layers"].keys() == theirs[part]["layers"].keys()
        for path, a in mine[part]["layers"].items():
            b = theirs[part]["layers"][path]
            assert torch.equal(a["qkernel"], b["qkernel"]), path
            assert torch.equal(a["in_scale"], b["in_scale"]), path
            prod.append((a["scale"], b["scale"]))
            shift.append((a["bias"], b["bias"]))
        assert mine[part]["norms"].keys() == theirs[part]["norms"].keys()
        for path, a in mine[part]["norms"].items():
            b = theirs[part]["norms"][path]
            prod.append((a["g"], b["g"]))
            shift.append((a["c"], b["c"]))
    assert mine.keys() == theirs.keys() == {"trunk", "head"}
    assert max(_ulps(a, b) for a, b in prod) <= 4
    for a, b in shift:
        a, b = a.numpy(), b.numpy()
        assert np.abs(a - b).max() <= 2 * np.spacing(np.abs(b).max())


def test_qtrunk_from_jax_round_trip(resnet):
    """Every int8 layer and norm of the JAX tree is in the converted one:
    int8 kernels unpack to the JAX HWIO arrays, the f32 fields equal; the
    JAX tree's f32 RPN and dense copies are left out (the port runs the
    model's own)."""
    jq = _np(JQ.quantize_resnet(resnet["jv"], "BN", 18, resnet["scales"]))
    q = qtrunk_from_jax(jq)
    for part in ("trunk", "head"):
        for path, l in jq[part]["layers"].items():
            ql = q[part]["layers"][path]
            k, cin = l["qkernel"].shape[0], l["qkernel"].shape[2]
            np.testing.assert_array_equal(
                unpack_weight(ql["qkernel"], k, k, cin).numpy(),
                l["qkernel"])
            for f in ("scale", "bias", "in_scale"):
                np.testing.assert_array_equal(ql[f].numpy(), l[f])
        for path, a in jq[part]["norms"].items():
            for f in ("g", "c"):
                np.testing.assert_array_equal(
                    q[part]["norms"][path][f].numpy(), a[f])
    assert q.keys() == {"trunk", "head"}


@pytest.mark.parametrize("depth,norm", [(18, None), (50, "BN")])
def test_resnet_f32_walk_matches_port_modules(depth, norm):
    """The walk that calibration and the int8 path share reproduces the
    port's ResNetBackbone and ResNetRCNNHead (eval mode) to 1e-4 of each
    output's max, the JAX package's 1e-4 for its walk against its flax
    modules (another op order: the folded affine x * g + c against
    BatchRenorm's (x - mean) * inv * gamma + beta), scaled to He weights'
    growing activations."""
    _, _, port, _ = _models("Resnet", 5, depth=depth, norm=norm, canvas=RCAL)
    rng = np.random.RandomState(5)
    data = torch.from_numpy(rng.randn(1, *RCAL, 3).astype(np.float32))
    with torch.no_grad():
        feat_ref, _, _ = port.apply_trunk(data)
        feat = Q._walk_resnet_trunk(
            Q._ResnetF32(port.trunk.backbone, norm), data, depth)
        np.testing.assert_allclose(feat.numpy(), feat_ref.numpy(), rtol=0,
                                   atol=1e-4 * feat_ref.abs().max().item())
        pooled = torch.from_numpy(
            rng.randn(4, 7, 7, feat.shape[-1]).astype(np.float32))
        cls_h, bbox_h = port.apply_head(pooled)
        x = Q._walk_resnet_head_group(Q._ResnetF32(port.head, norm), pooled,
                                      depth).mean(dim=(1, 2))
        cls_w = port.head.cls_score(x)
        bbox_w = port.head.bbox_pred(x)
    for got, want in ((cls_w, cls_h), (bbox_w, bbox_h)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item())


def _pow2_vgg(rng):
    """The JAX package's power-of-two construction
    (tests/test_quantize.py:test_quant_apply_exact_on_pow2_grids): pow2
    kernels (each channel's absmax pinned to 127 * 2^-7), biases, data and
    activation scales chosen from an exact float64 forward."""
    from tests.test_quantize import conv2d_np, pool2_np

    jm, jv, port, he = _models("VGGnet", 3)
    backbone = he["trunk"]["params"]["backbone"]
    for name, _ in JQ.VGG_LAYERS:
        shape = backbone[name]["conv"]["kernel"].shape
        ints = rng.randint(-5, 6, size=shape).astype(np.float32)
        ints[0, 0, 0, :] = np.where(ints[0, 0, 0, :] >= 0, 127.0, -127.0)
        backbone[name]["conv"]["kernel"] = ints * np.float32(2.0 ** -7)
        backbone[name]["conv"]["bias"] = rng.randint(
            -16, 17, size=shape[3]).astype(np.float32) * np.float32(2.0 ** -9)
    port.load_state_dict(params_from_jax(he))
    data = rng.randint(-8, 9, size=(1, *CAL, 3)).astype(np.float32) \
        * np.float32(2.0 ** -2)
    scales = {"data": float(127.0 * 2.0 ** -2)}
    x, s_in = data.astype(np.float64), 2.0 ** -2
    for name, pool in JQ.VGG_LAYERS:
        k = backbone[name]["conv"]["kernel"].astype(np.float64)
        w_scale = np.abs(k).max(axis=(0, 1, 2)) / 127.0
        acc = conv2d_np(np.clip(np.round(x / s_in), -127, 127),
                        np.round(k / w_scale), "SAME", np.float64)
        y = np.maximum(acc * (s_in * w_scale) + backbone[name]["conv"]["bias"],
                       0.0)
        x = pool2_np(y) if pool else y
        e = np.ceil(np.log2(max(x.max(), 2.0 ** -20) / 127.0))
        scales[name] = float(127.0 * 2.0 ** e)
        s_in = 2.0 ** e
    return jm, jax.tree.map(jnp.asarray, he), port, data, scales


def test_vgg_quant_apply_exact_on_pow2_grids():
    rng = np.random.RandomState(11)
    jm, jv, port, data, scales = _pow2_vgg(rng)
    jq = JQ.quantize_vgg_trunk(jv, scales)
    want = [np.asarray(t) for t in jax.jit(JQ.quant_trunk_apply)(jq, data)]
    q = Q.quantize_vgg_trunk(port, scales)
    got = [t.numpy() for t in Q.quant_trunk_apply(port, q,
                                                  torch.from_numpy(data))]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].any(), "degenerate all-zero features"
    # the f32 RPN convs on identical features: f32 drift only
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_resnet_quant_apply_exact_on_pow2_grids():
    """ResNet-18 without norms (conv biases): pow2 kernels, biases, data and
    activation scales (each calibrated absmax rounded up to 127 * 2^e), so
    every quantize step, int8 conv, epilogue and residual add is exact:
    the int8 trunk's features and the group3 head's output equal the JAX
    package's bit for bit."""
    rng = np.random.RandomState(12)
    jm, jv, port, he = _models("Resnet", 6, depth=18, norm=None,
                               canvas=RCAL)
    for part in ("trunk", "head"):
        for path, a in list(_leaf_paths(he[part]["params"])):
            node = he[part]["params"]
            for k in path[:-1]:
                node = node[k]
            if path[-1] == "kernel" and a.ndim == 4 and path[0] in (
                    "backbone", "group3"):
                ints = rng.randint(-3, 4, size=a.shape).astype(np.float32)
                ints[0, 0, 0, :] = 127.0
                node["kernel"] = ints * np.float32(2.0 ** -9)
            elif path[-1] == "bias" and path[0] in ("backbone", "group3"):
                node["bias"] = rng.randint(-8, 9, a.shape).astype(
                    np.float32) * np.float32(2.0 ** -8)
    port.load_state_dict(params_from_jax(he))
    jv = jax.tree.map(jnp.asarray, he)
    data = rng.randint(-8, 9, (1, *RCAL, 3)).astype(np.float32) \
        * np.float32(2.0 ** -3)
    recorded = Q.calibrate_resnet(port, [data])
    scales = {k: float(127.0 * 2.0 ** np.ceil(np.log2(v / 127.0)))
              for k, v in recorded.items()}
    jq = JQ.quantize_resnet(jv, None, 18, scales)
    q = Q.quantize_resnet(port, scales)
    for part in ("trunk", "head"):
        for layer in q[part]["layers"].values():
            s = float(layer["in_scale"])
            assert 2.0 ** np.round(np.log2(s)) == s
    feat_j = np.asarray(JQ.quant_resnet_trunk_apply(jq, jnp.asarray(data),
                                                    None, 18)[0])
    feat = Q.quant_resnet_trunk_apply(port, q, torch.from_numpy(data))[0]
    np.testing.assert_array_equal(feat.numpy(), feat_j)
    assert feat_j.any()
    pooled = np.repeat(feat_j[:, :2, :2], 4, axis=1)[:, :7]
    pooled = np.repeat(pooled, 4, axis=2)[:, :, :7]
    pooled = np.concatenate([pooled, pooled[:, ::-1]])
    jx = JQ._walk_resnet_head_group(JQ._ResnetInt8(jq["head"], None),
                                    jnp.asarray(pooled), 18)
    x = Q._walk_resnet_head_group(Q._ResnetInt8(q["head"], None),
                                  torch.from_numpy(pooled.copy()), 18)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    cls, bbox = Q.quant_resnet_head_apply(port, q,
                                          torch.from_numpy(pooled.copy()))
    jcls, jbbox = JQ.quant_resnet_head_apply(jq, jnp.asarray(pooled), None,
                                             18)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bbox.numpy(), np.asarray(jbbox), rtol=1e-6,
                               atol=1e-6)


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_quant_apply_close_to_jax_on_general_data(vgg, resnet):
    """The same quantized trees on general data: features within 2e-3 of
    their max, RPN outputs and the group3 head's logits with them."""
    data = vgg["batches"][1]
    jq = JQ.quantize_vgg_trunk(vgg["jv"], vgg["scales"])
    want = [np.asarray(t) for t in jax.jit(JQ.quant_trunk_apply)(jq, data)]
    got = Q.quant_trunk_apply(vgg["port"], qtrunk_from_jax(_np(jq)),
                              torch.from_numpy(data))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-3 * np.abs(w).max())

    data = resnet["batches"][0]
    jq = JQ.quantize_resnet(resnet["jv"], "BN", 18, resnet["scales"])
    q = qtrunk_from_jax(_np(jq))
    want = [np.asarray(t) for t in JQ.quant_resnet_trunk_apply(
        jq, jnp.asarray(data), "BN", 18)]
    got = Q.quant_resnet_trunk_apply(resnet["port"], q,
                                     torch.from_numpy(data))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-3 * np.abs(w).max())
    rng = np.random.RandomState(8)
    pooled = (rng.rand(4, 7, 7, 256) * float(want[0].max())).astype(
        np.float32)
    jcls, jbbox = JQ.quant_resnet_head_apply(jq, jnp.asarray(pooled), "BN",
                                             18)
    cls, bbox = Q.quant_resnet_head_apply(resnet["port"], q,
                                          torch.from_numpy(pooled))
    for g, w in ((cls, jcls), (bbox, jbbox)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-3 * np.abs(w).max())


@pytest.fixture(scope="module")
def engines():
    """Both engines at the serving slice's canvas and budgets, VGG16 and
    ResNet-18 BN, the RPN class kernel scaled so the ranked probabilities
    are neither saturated nor crowded (as tests/test_torch_engine.py)."""
    out = {}
    for backbone, seed, kw, scale in (("VGGnet", 6, {}, 0.1),
                                      ("Resnet", 0, dict(depth=18, norm="BN"),
                                       0.03)):
        jm, _, port, he = _models(backbone, seed, canvas=(32, 32), **kw)
        he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= scale
        if backbone == "Resnet":
            he["trunk"]["params"]["rpn_bbox_pred"]["conv"]["kernel"] *= 0.03
        port.load_state_dict(params_from_jax(he))
        jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
        eng = Engine(port, Config().with_overrides(OVERRIDES), CANVAS,
                     device="cpu")
        rng = np.random.RandomState(seed)
        net = "VGGnet_test" if backbone == "VGGnet" else "Resnet_test"
        blob = np.concatenate([jax_image_blob(ultrasound_like(rng), net,
                                              jeng.cfg, CANVAS)[0]
                               for _ in range(2)])
        out[backbone] = dict(jeng=jeng, eng=eng, jv=jax.tree.map(
            jnp.asarray, he), blob=blob, im_info=np.array(
                [[*CANVAS, 192 / 150, 0.0]] * 2, np.float32))
    return out


@pytest.mark.parametrize("backbone", ["VGGnet", "Resnet"])
def test_inference_step_quant_matches_jax(engines, backbone):
    """The quantized serving step of both engines on the same quantized
    tree (the JAX engine's, calibrated on the request blob), guarded
    against near-ties in the ranked RPN scores."""
    s = engines[backbone]
    jeng, eng = s["jeng"], s["eng"]
    jq = jeng.quantize_for_serving(s["jv"], [s["blob"]])
    q = qtrunk_from_jax(_np(jq))
    want = [np.asarray(o) for o in jeng.inference_step_quant(
        jq, s["jv"], s["blob"], s["im_info"])]
    got = [o.numpy() for o in eng.inference_step_quant(q, s["blob"],
                                                       s["im_info"])]
    if backbone == "VGGnet":
        jt = jax.jit(JQ.quant_trunk_apply)(jq, s["blob"])
        pt = Q.quant_trunk_apply(eng.model, q, torch.from_numpy(s["blob"]))
    else:
        jt = JQ.quant_resnet_trunk_apply(jq, jnp.asarray(s["blob"]), "BN",
                                         18)
        pt = Q.quant_resnet_trunk_apply(eng.model, q,
                                        torch.from_numpy(s["blob"]))
    jprob = np.asarray(jax_rpn_softmax(jt[1], A))[..., A:]
    drift = np.abs(jprob - rpn_softmax(pt[1], A)[..., A:].numpy()).max()
    k = eng.cfg.TEST.RPN_PRE_NMS_TOP_N
    gaps = [np.abs(np.diff(np.sort(p.reshape(-1))[-(k + 1):])).min()
            for p in jprob]
    assert drift < 1e-3 and min(gaps) > 10 * drift, (min(gaps), drift)
    np.testing.assert_array_equal(got[1], want[1])              # valid
    assert want[1].sum() > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[4], want[4], rtol=0,
                               atol=1e-4 * np.abs(want[4]).max())
    # the port's own quantization serves the same way
    mine = eng.quantize_for_serving([s["blob"]])
    out = eng.inference_step_quant(mine, s["blob"], s["im_info"])
    assert [tuple(o.shape) for o in out] == [w.shape for w in want]
    assert all(torch.isfinite(o.float()).all() for o in out)


def test_groupnorm_resnet_rejected():
    """GroupNorm is data-dependent at serving time: the engine's
    calibration, ``quantize_resnet`` given recorded absmaxes, and the CLI's
    check all raise, as the JAX package does."""
    port = build_detector("Resnet_test", device="cpu", depth=18, norm="GN")
    eng = Engine(port, Config(), RCAL, device="cpu")
    with pytest.raises(NotImplementedError, match="GroupNorm"):
        eng.quantize_for_serving([np.zeros((1, *RCAL, 3), np.float32)])
    with pytest.raises(NotImplementedError, match="GroupNorm"):
        Q.quantize_resnet(port, {"conv0": 1.0})
    with pytest.raises(NotImplementedError, match="GroupNorm"):
        Q.check_int8_norm("GN")
    Q.check_int8_norm("BN")
    Q.check_int8_norm(None)
