"""The whole training slice: the port's ``Engine.train_step`` (combined
supervised + MIL step) and ``Engine.train_step_mil`` (the alternating
regime's weak step) against the JAX package's ``Engine._train_step_impl``
and ``_train_step_mil_impl``, from the same He weights and Adam state, at
full VGG16 width, a 192x256 canvas, 1 supervised + 2 weak images and
reduced budgets (RPN 32 -> 16 proposals, 16 ROIs per supervised image).

Every random draw is the JAX package's: the anchor and ROI sampling
uniforms are reproduced from the key splits (train/engine.py:300 and the
helpers of test_torch_targets.py), the dropout masks are read off flax's
``nn.Dropout`` calls with ``nn.intercept_methods`` in an eager forward
(mask = output != 0; where the input is 0 the mask does not matter: the
output is 0 either way and ReLU's gradient at 0 is 0 on both sides).

The JAX side runs on the CPU, where it pools with the jit ``roi_pool``
whose autograd splits tied maxima between cells; the port's backward puts
a tie on one cell, as the Pallas kernel does.  Tied maxima here are the
post-ReLU zeros of conv5_3, where the gradient dies in the ReLU backward
either way, so the parameter gradients agree.

Tolerances.  The two trunks agree only to f32 rounding (about 1e-6 of the
feature maximum per side, test_torch_engine.py), so the guards of that
test are repeated for training: the gaps between neighbouring ranked RPN
scores and between each bag's best and second-best malignant logit must
exceed 10x the measured drift, and every pooled ROI corner must quantise
to the same feature cell on both sides; then keep sets, labels and the
selected instances are identical.  Losses agree to 1e-4 relative
(rpn_box sums the drift of 1728*4 deltas).  Adam with eps = 0.1 moves a
parameter by lr * g / (|g| + 0.1), so a gradient drift dg moves the
update by at most lr * |dg| / 0.1.  Where gradients only drift, updates
agree to 3e-5 * lr (measured: conv4_3 and everything above it).  Below
that, a few ReLU units whose pre-activation lies within the drift of 0
take opposite signs in the two frameworks (expected: ~1e-5 of 1.2M
conv4_2 outputs), and each flip moves the gradients of every earlier
layer by one unit's contribution: measured up to 1.9e-2 * lr at conv4_2,
3.8e-3 * lr at conv3, and 99.9% of conv3's elements within 1.4e-3 * lr
(4.3e-3 * lr in the MIL step, whose conv3 gradient comes from two ROIs).
So each updated tensor is held to 5e-2 * lr in every element and to
5e-3 * lr in 99.9% of them.  conv1/conv2 are bitwise unchanged; every
other parameter moved.  The MIL step that follows starts both sides from
the JAX package's state after the first step (weights, Adam moments and
count), so it is held to the same tolerances."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_targets import anchor_uniforms, roi_uniforms
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.evaluate.detect import get_image_blob as jax_image_blob
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_softmax
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu.train.engine import make_optimizer, vgg_frozen_mask
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models.convert import (he_tree, opt_state_from_jax,
                                                params_from_jax, params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector, rpn_softmax
from wssdl_bus_tpu_torch.ops.proposal_target import num_candidates
from wssdl_bus_tpu_torch.train.engine import Engine, StepDraws

CANVAS = (192, 256)
SEED = 6
STEP = 40000        # MIL scale 1 - 0.99 * 0.9^20 = 0.88
LR = 5e-4
R, P = 16, 16
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TRAIN.RPN_PRE_NMS_TOP_N", "32", "TRAIN.RPN_POST_NMS_TOP_N",
             str(P), "TRAIN.BATCH_SIZE", str(R)]
LOSS_RTOL = 1e-4
PARAM_ATOL = 5e-2 * LR     # every element
PARAM_P999 = 5e-3 * LR     # 99.9% of the elements
A = 9


def _speckle(rng, h=150, w=200):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tissue = 110.0 * np.exp(-yy / (1.5 * h))
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    mass = (((yy - cy) / (0.15 * h)) ** 2 + ((xx - cx) / (0.15 * w)) ** 2
            < 1.0)
    tissue[mass] *= 0.25
    return (np.clip(tissue * rng.rayleigh(1.0, (h, w)), 0, 255)
            .astype(np.uint8), (cx, cy))


def _dropout_masks(fn):
    """Run ``fn()`` eagerly and return the keep masks of its nn.Dropout
    calls, in call order, as bool numpy arrays."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) \
                and context.method_name == "__call__":
            masks.append(np.asarray(out) != 0)
        return out

    with fnn.intercept_methods(interceptor):
        fn()
    return masks


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    jcfg = JaxConfig().with_overrides(OVERRIDES)
    cfg = Config().with_overrides(OVERRIDES)
    jm = JaxFasterRCNN(backbone="VGGnet")
    jeng = JaxEngine(jm, jcfg, CANVAS)
    port = build_detector("VGGnet_train", device="cpu")
    # the JAX variable tree, read off the port's modules (flax's init pass
    # builds the same tree, slowly)
    he = he_tree(params_to_jax(port.state_dict()), SEED, input_scale=64.0)
    # unsaturated RPN scores, as in test_torch_engine.py
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= 0.1
    jvars = jax.tree.map(jnp.asarray, he)
    params = {"trunk": jvars["trunk"]["params"],
              "head": jvars["head"]["params"]}
    # what Engine.init builds, without its full-canvas init pass; set
    # past the tx setter, which would mark the stem trainable
    jeng._tx = make_optimizer("adam", jcfg, vgg_frozen_mask(params))
    opt_state = jeng.tx.init(params)

    rng = np.random.RandomState(SEED)
    blobs, gts = [], np.zeros((3, 20, 5), np.float32)
    for i in range(3):
        im, (cx, cy) = _speckle(rng)
        blobs.append(jax_image_blob(im, "VGGnet_test", jcfg, CANVAS)[0])
        if i == 0:
            s = 192 / 150
            gts[0, 0] = [(cx - 30) * s, (cy - 22) * s, (cx + 30) * s,
                         (cy + 22) * s, 2]
            gts[0, 1] = [0, 0, 255, 191, 0]   # whole-image background box
    batch = {"data": np.concatenate(blobs), "gt_boxes": gts,
             "num_gt_boxes": np.array([2, 0, 0], np.int32),
             "im_info": np.array([[192, 256, 192 / 150, 2],
                                  [192, 256, 192 / 150, 2],
                                  [192, 256, 192 / 150, 1]], np.float32)}
    port.load_state_dict(params_from_jax(he))
    eng = Engine(port, cfg, CANVAS, device="cpu")
    return dict(jeng=jeng, jvars=jvars, opt_state=opt_state, he=he,
                batch=batch, eng=eng, port=port)


def _combined_draws(s, key):
    jeng, batch = s["jeng"], s["batch"]
    k_at, k_pt, _ = jax.random.split(key, 3)
    k = len(jeng.anchors)
    n = num_candidates(P, 20, R)
    params = {"trunk": s["jvars"]["trunk"]["params"],
              "head": s["jvars"]["head"]["params"]}
    jb = {k_: jnp.asarray(v) for k_, v in batch.items()}
    out = {}

    def fwd():
        out["fwd"] = jeng._forward_train(params, s["jvars"], jb, key,
                                         jnp.int32(STEP))

    m6, m7 = _dropout_masks(fwd)
    draws = StepDraws(
        anchor_u=torch.from_numpy(anchor_uniforms(k_at, 3, 1, k)),
        roi_u=torch.from_numpy(roi_uniforms(k_pt, 1, n)),
        keep_sup=(torch.from_numpy(m6[:R]), torch.from_numpy(m7[:R])),
        keep_ws=(torch.from_numpy(m6[R:]), torch.from_numpy(m7[R:])))
    return draws, out["fwd"]


def _load_jax_state(eng, jvars, jopt):
    """Put the JAX side's parameters and Adam state into the port
    (``models/convert.py:opt_state_from_jax``)."""
    eng.model.load_state_dict(params_from_jax(
        {p: {"params": jax.tree.map(np.asarray, jvars[p]["params"])}
         for p in ("trunk", "head")}))
    eng.opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray,
                                                            jopt)))


def _check_params(port, jvars, before):
    got = params_to_jax(port.state_dict())
    n_moved = 0
    for part in ("trunk", "head"):
        want = dict(_flat(jax.tree.map(np.asarray, jvars[part]["params"])))
        prev = dict(_flat(before[part]["params"]))
        for path, g in _flat(got[part]["params"]):
            name = "/".join((part,) + path)
            if any(p.startswith(("conv1_", "conv2_")) for p in path):
                np.testing.assert_array_equal(g, prev[path], err_msg=name)
                continue
            assert not np.array_equal(g, prev[path]), name
            n_moved += 1
            du = np.abs((g - prev[path]) - (want[path] - prev[path]))
            assert du.max() <= PARAM_ATOL, (name, du.max() / LR)
            assert np.quantile(du, 0.999) <= PARAM_P999, (name, du.max() / LR)
    return n_moved


def test_train_steps_match_jax(setup):
    s = setup
    jeng, eng, batch = s["jeng"], s["eng"], s["batch"]
    key = jax.random.PRNGKey(SEED)
    draws, jfwd = _combined_draws(s, key)
    (_, jscore, _, _, jprops, jsamples, _, jcls, _, _) = jfwd

    # the near-tie guards (see the module docstring)
    with torch.no_grad():
        _, _, details = eng.forward_train(batch, STEP, draws)
    score = details["rpn_cls_score"]
    jprob = np.asarray(jax_softmax(jscore, A))[..., A:]
    drift = np.abs(jprob - rpn_softmax(score, A)[..., A:].numpy()).max()
    gaps = [np.abs(np.diff(np.sort(p.reshape(-1))[-33:])).min()
            for p in jprob]
    assert 0 < drift < 1e-4 and min(gaps) > 10 * drift, (gaps, drift)
    props, samples = details["props"], details["samples"]
    np.testing.assert_array_equal(props.valid.numpy(),
                                  np.asarray(jprops.valid))
    np.testing.assert_array_equal(samples.labels.numpy(),
                                  np.asarray(jsamples.labels))
    # every pooled ROI quantises to the same feature cells on both sides
    def cells(rois, weak):
        return np.floor(np.concatenate([rois.reshape(-1),
                                        weak.reshape(-1)]) / 16.0 + 0.5)
    np.testing.assert_array_equal(
        cells(samples.rois.numpy(), props.boxes[1:].numpy()),
        cells(np.asarray(jsamples.rois), np.asarray(jprops.boxes[1:])))
    mal = np.asarray(jcls)[R:].reshape(2, P, 3)[..., 2]
    valid_ws = np.asarray(jprops.valid)[1:]
    for bag in range(2):
        top2 = np.sort(mal[bag][valid_ws[bag]])[-2:]
        assert top2[1] - top2[0] > 1e-4, top2

    # one combined step on each side
    before = jax.tree.map(np.asarray, s["he"])
    jvars, jopt, jls = jeng._train_step_impl(
        s["jvars"], s["opt_state"], {k: jnp.asarray(v) for k, v in
                                     batch.items()},
        key, jnp.float32(LR), jnp.int32(STEP))
    ls = eng.train_step(batch, LR, STEP, draws)
    for name, got, want in zip(ls._fields, ls, jls):
        assert np.isfinite(float(got)), name
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    assert float(ls.mil_cls) > 0 and float(ls.rcnn_box) > 0
    assert _check_params(s["port"], jvars, before) == 32

    # then one MIL-only step on the weak images, both from the JAX state
    _load_jax_state(eng, jvars, jopt)
    wbatch = {k: batch[k][1:] for k in ("data", "im_info")}
    jwb = {k: jnp.asarray(v) for k, v in wbatch.items()}
    key2 = jax.random.PRNGKey(SEED + 1)
    params = {"trunk": jvars["trunk"]["params"],
              "head": jvars["head"]["params"]}
    m6, m7 = _dropout_masks(lambda: jeng._mil_loss(params, jvars, jwb, key2,
                                                   jnp.int32(STEP)))
    before = params_to_jax(s["port"].state_dict())
    jvars2, _, jmil = jeng._train_step_mil_impl(
        jvars, jopt, jwb, key2, jnp.float32(LR), jnp.int32(STEP))
    mil = eng.train_step_mil(wbatch, LR, STEP, StepDraws(
        keep_ws=(torch.from_numpy(m6), torch.from_numpy(m7))))
    np.testing.assert_allclose(float(mil), float(jmil), rtol=LOSS_RTOL)
    assert float(mil) > 0
    # parameters without a gradient in this step (the RPN convs, bbox_pred)
    # still move: Adam's moments from the first step carry them
    assert _check_params(s["port"], jvars2, before) == 32
