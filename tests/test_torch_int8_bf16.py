"""int8 serving on a bf16 model (``main.test --int8 --bf16``): the int8
path runs the RPN convs and, for ResNet, the head's dense layers in f32
from the f32 weights whatever the model's compute dtype, as the JAX
package's ``quant_trunk_apply`` / ``quant_resnet_*_apply`` do
(``wssdl_bus_tpu/models/quantize.py:165-171``, ``:519-547``); VGG16's fc
head follows the model's dtype in both packages
(``wssdl_bus_tpu/train/engine.py:726-728``).

Tolerances.
  * The RPN convs on the same int8 features: within ``RPN_REL`` = 1e-5 of
    each output's max of the JAX package's f32 convs (f32 drift only); the
    control, the model's bf16 ``TrunkRPN.heads``, misses it (bf16 keeps
    about three digits).
  * ResNet: every output of the quantized serving step of a bf16 model
    equals that of the same model in f32 bit for bit (nothing on the int8
    path follows the compute dtype).
  * The serving steps against the JAX package's ``QuantServingEngine`` on a
    bf16 model (``tests/test_torch_quantize.py``'s engines, guarded
    against near-ties in the ranked RPN scores the same way): keep sets
    identical, ROIs within ``BOX_ATOL``; ResNet's class probabilities within
    1e-4 and box deltas within 1e-4 of their max (f32 after the int8
    head, as the f32 test); VGG16's bf16 fc head as a bf16 chain
    (``tests/test_torch_bf16.py``): logits and box deltas within 2e-2 of
    their max, probabilities within 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import BOX_ATOL, ultrasound_like
from tests.test_torch_quantize import A, CANVAS, OVERRIDES, _np
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
from wssdl_bus_tpu_torch.models.layers import set_compute_dtype
from wssdl_bus_tpu_torch.train.engine import Engine

BF16 = torch.bfloat16
RPN_REL = 1e-5


@pytest.fixture(scope="module")
def bf16_engines():
    """Both packages' engines on bf16 models from one He tree, VGG16 and
    ResNet-18 BN, at the serving slice's canvas and budgets, with the JAX
    engine's quantized tree calibrated on the request blob."""
    torch.set_num_threads(2)
    out = {}
    for backbone, seed, kw, scale in (("VGGnet", 6, {}, 0.1),
                                      ("Resnet", 0, dict(depth=18, norm="BN"),
                                       0.03)):
        jm = JaxFasterRCNN(backbone=backbone, compute_dtype="bfloat16",
                           remat=False, **kw)
        tree = jax.tree.map(np.asarray, jm.init_variables(
            jax.random.PRNGKey(0), (32, 32)))
        he = he_tree(tree, seed, input_scale=64.0 if backbone == "VGGnet"
                     else 1.0)
        if backbone == "Resnet":
            he = _perturbed(he, seed)
            he["trunk"]["params"]["rpn_bbox_pred"]["conv"]["kernel"] *= 0.03
        he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= scale
        net = f"{backbone}_test"
        port = build_detector(net, device="cpu", compute_dtype=BF16, **kw)
        port.load_state_dict(params_from_jax(he))
        jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
        eng = Engine(port, Config().with_overrides(OVERRIDES), CANVAS,
                     device="cpu")
        rng = np.random.RandomState(seed)
        blob = np.concatenate([jax_image_blob(ultrasound_like(rng), net,
                                              jeng.cfg, CANVAS)[0]
                               for _ in range(2)])
        jv = jax.tree.map(jnp.asarray, he)
        jq = jeng.quantize_for_serving(jv, [blob])
        out[backbone] = dict(jeng=jeng, eng=eng, jv=jv, jq=jq,
                             q=qtrunk_from_jax(_np(jq)), blob=blob,
                             im_info=np.array([[*CANVAS, 192 / 150, 0.0]] * 2,
                                              np.float32))
    return out


def _jax_trunk(s, backbone):
    if backbone == "VGGnet":
        return jax.jit(JQ.quant_trunk_apply)(s["jq"], s["blob"])
    return JQ.quant_resnet_trunk_apply(s["jq"], jnp.asarray(s["blob"]), "BN",
                                       18)


@pytest.mark.parametrize("backbone", ["VGGnet", "Resnet"])
def test_int8_rpn_runs_in_f32_under_bf16(bf16_engines, backbone):
    """On the JAX int8 trunk's features, the port's int8-path RPN of a bf16
    model meets the JAX package's f32 RPN convs to f32 drift; the model's
    own bf16 RPN (the control) does not."""
    s = bf16_engines[backbone]
    model = s["eng"].model
    assert model.compute_dtype == BF16
    feat, cls, bbox = (np.array(t) for t in _jax_trunk(s, backbone))
    x = torch.from_numpy(feat)
    with torch.no_grad():
        got = Q._rpn(model, x)[1:]
        ctl = model.trunk.heads(x.permute(0, 3, 1, 2))[1:]
    for g, c, w in zip(got, ctl, (cls, bbox), strict=True):
        tol = RPN_REL * np.abs(w).max()
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        assert np.abs(c.numpy() - w).max() > tol


def test_int8_resnet_step_ignores_the_compute_dtype(bf16_engines):
    """ResNet-18 BN: the quantized serving step of the bf16 model equals the
    same model's in f32 in all five outputs: the int8 convs, the RPN convs
    and the dense layers take no part of the compute dtype."""
    s = bf16_engines["Resnet"]
    eng = s["eng"]
    got = eng.inference_step_quant(s["q"], s["blob"], s["im_info"])
    set_compute_dtype(eng.model, None)
    try:
        want = eng.inference_step_quant(s["q"], s["blob"], s["im_info"])
    finally:
        set_compute_dtype(eng.model, BF16)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backbone", ["VGGnet", "Resnet"])
def test_quant_serving_on_bf16_matches_jax(bf16_engines, backbone):
    """``Engine.inference_step_quant`` of a bf16 model (through the port's
    ``QuantServingEngine``) against the JAX ``QuantServingEngine`` of a bf16
    model on the same quantized tree, guarded against near-ties in the
    ranked RPN scores."""
    s = bf16_engines[backbone]
    jeng, eng = s["jeng"], s["eng"]
    want = [np.asarray(o) for o in JQ.QuantServingEngine(jeng, s["jq"])
            .inference_step(s["jv"], s["blob"], s["im_info"])]
    got = [o.numpy() for o in Q.QuantServingEngine(eng, s["q"])
           .inference_step(s["blob"], s["im_info"])]
    jt = _jax_trunk(s, backbone)
    trunk = Q.quant_trunk_apply if backbone == "VGGnet" \
        else Q.quant_resnet_trunk_apply
    pt = trunk(eng.model, s["q"], torch.from_numpy(s["blob"]))
    jprob = np.asarray(jax_rpn_softmax(jt[1], A))[..., A:]
    drift = np.abs(jprob - rpn_softmax(pt[1], A)[..., A:].numpy()).max()
    k = eng.cfg.TEST.RPN_PRE_NMS_TOP_N
    gaps = [np.abs(np.diff(np.sort(p.reshape(-1))[-(k + 1):])).min()
            for p in jprob]
    assert drift < 1e-3 and min(gaps) > 10 * drift, (min(gaps), drift)
    np.testing.assert_array_equal(got[1], want[1])              # valid
    assert want[1].sum() > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_ATOL)
    assert all(g.dtype == np.float32 for i, g in enumerate(got) if i != 1)
    if backbone == "Resnet":
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[4], want[4], rtol=0,
                                   atol=1e-4 * np.abs(want[4]).max())
    else:
        for i in (2, 4):
            np.testing.assert_allclose(got[i], want[i], rtol=0,
                                       atol=2e-2 * np.abs(want[i]).max())
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-2)
