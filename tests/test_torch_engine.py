"""The whole serving slice: the port's ``Engine.inference_step``,
``im_detect_batch`` and ``report_detections`` against the JAX package's on
the same converted weights, at full VGG16 width, a 192x256 canvas, batch 2
and reduced TEST budgets (32 -> 16 proposals).
On the CPU the JAX side runs ``ops/nms.py:nms_mask`` and the jit
``roi_pool``, which have the Pallas kernels' semantics; test_torch_nms.py
and test_torch_roi_pool.py hold the kernels themselves.

Tolerances.  The two trunks agree only to f32 rounding: measured against a
float64 run of the same weights, each side's feature map is off by about
1e-6 of its max (PyTorch's oneDNN convolutions 3-4e-6), which leaves
|d rpn_prob| near 1e-6 and |d rpn deltas| near 2e-5.  Proposal order and
keep sets must still match exactly, so the test guards against near-ties:
the smallest gap between neighbouring top-ranked scores must exceed 10x
the measured drift (2x already rules out any swap).  That needs few ranked
candidates and unsaturated scores: with 200 candidates per image the
smallest gap is ~1e-7 at any seed, and He-scaled RPN logits push the top
probabilities into f32 ties at 1.0; hence the 32-candidate budget and RPN
class logits scaled by 0.1 (seed 6 clears the guard 23x).  Box coordinates
move by the delta drift times box sizes up to the canvas, so ROIs and
detection boxes agree to 2e-2 px; class probabilities to 1e-5; box deltas
to 1e-5 of their max.  The exact contract at the full budgets is held where
the drift is removed: the second test feeds both proposal layers the JAX
trunk's own outputs, and test_torch_proposal.py runs 6000 -> 300."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu import native as jax_native
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.data.augment import max_canvas as jax_max_canvas
from wssdl_bus_tpu.evaluate.detect import get_image_blob as jax_image_blob
from wssdl_bus_tpu.evaluate.detect import im_detect as jax_detect_one
from wssdl_bus_tpu.evaluate.detect import im_detect_batch as jax_detect
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_rpn_softmax
from wssdl_bus_tpu.ops.proposal import proposal_layer as jax_proposal_layer
from wssdl_bus_tpu.ops.roi_pool_pallas import roi_pool_grouped as jax_pool
from wssdl_bus_tpu.serve import report_detections as jax_report
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch import native
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.augment import max_canvas
from wssdl_bus_tpu_torch.evaluate.detect import (get_image_blob, im_detect,
                                                 im_detect_batch)
from wssdl_bus_tpu_torch.models.convert import he_tree, params_from_jax
from wssdl_bus_tpu_torch.models.detector import build_detector, rpn_softmax
from wssdl_bus_tpu_torch.ops.proposal import proposal_layer
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_fc
from wssdl_bus_tpu_torch.serve import report_detections
from wssdl_bus_tpu_torch.train.engine import Engine

CANVAS = (192, 256)
NET = "VGGnet_test"
SEED = 6            # weights and images; the near-tie guard holds for it
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TEST.RPN_PRE_NMS_TOP_N", "32", "TEST.RPN_POST_NMS_TOP_N", "16"]
BOX_ATOL = 2e-2     # px, see the module docstring
A = 9


def ultrasound_like(rng, h=150, w=200):
    """A grayscale uint8 image: Rayleigh speckle, depth attenuation, one
    dark elliptical mass (resized to exactly 192x256 by the TEST scale)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tissue = 110.0 * np.exp(-yy / (1.5 * h))
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    mass = (((yy - cy) / (0.15 * h)) ** 2 + ((xx - cx) / (0.15 * w)) ** 2
            < 1.0)
    tissue[mass] *= 0.25
    return np.clip(tissue * rng.rayleigh(1.0, (h, w)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def both():
    torch.set_num_threads(2)
    jm = JaxFasterRCNN(backbone="VGGnet")
    tree = jax.tree.map(np.asarray, jm.init_variables(jax.random.PRNGKey(0),
                                                      (32, 32)))
    # the serving blob is in pixel units: see he_tree's input_scale
    he = he_tree(tree, SEED, input_scale=64.0)
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= 0.1
    jeng = JaxEngine(jm, JaxConfig().with_overrides(OVERRIDES), CANVAS)
    port = build_detector(NET, device="cpu")
    port.load_state_dict(params_from_jax(he))
    eng = Engine(port, Config().with_overrides(OVERRIDES), CANVAS,
                 device="cpu")
    rng = np.random.RandomState(SEED)
    images = [ultrasound_like(rng) for _ in range(2)]
    blob = np.concatenate([jax_image_blob(im, NET, jeng.cfg, CANVAS)[0]
                           for im in images])
    im_info = np.array([[*CANVAS, 192 / 150, 0.0]] * 2, np.float32)
    return dict(jm=jm, he=he, jeng=jeng, port=port, eng=eng, images=images,
                blob=blob, im_info=im_info)


def _jax_trunk(s):
    return jax.jit(lambda v, d: s["jm"].apply_trunk(v, d, train=False)[:3])(
        s["he"], s["blob"])


def test_prep_image_matches_jax(both):
    """Both packages resize through the same native C++ triangle filter
    (the port's ``native/`` is its own copy of the JAX package's source)
    when both libraries build: pixels equal.  Otherwise the port resizes
    through PIL, the same bilinear convention in f32 with another summation
    order, and pixel values (in x255 units) agree to 1e-4."""
    exact = jax_native.available() and native.available()
    for im in both["images"]:
        want, want_scale, want_hw = jax_image_blob(im, NET, both["jeng"].cfg,
                                                   CANVAS)
        got, scale, hw = get_image_blob(im, NET, both["eng"].cfg, CANVAS)
        assert (scale, hw) == (want_scale, want_hw) == (192 / 150, CANVAS)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_max_canvas_matches_jax():
    """The serving canvas from the request sizes, at the default TEST
    scale (600 / 1000) and a capped one."""
    sizes = [(450, 600), (480, 640), (300, 1200), (777, 513)]
    for target, cap in ((600, 1000), (192, 256)):
        assert max_canvas(sizes, target, cap) == \
            jax_max_canvas(sizes, target, cap)
    assert max_canvas(sizes[:2], 600, 1000) == (608, 816)


def test_inference_step_matches_jax(both):
    s = both
    want = [np.asarray(o) for o in s["jeng"].inference_step(
        s["he"], s["blob"], s["im_info"])]
    got = [o.numpy() for o in s["eng"].inference_step(s["blob"],
                                                      s["im_info"])]

    # the near-tie guard: measured drift of the fg probabilities against
    # the gaps between the JAX ranking's neighbours (top pre_nms + 1)
    jt = _jax_trunk(s)
    with torch.no_grad():
        _, score, _ = s["port"].apply_trunk(torch.from_numpy(s["blob"]))
    jprob = np.asarray(jax_rpn_softmax(jt[1], A))[..., A:]
    drift = np.abs(jprob - rpn_softmax(score, A)[..., A:].numpy()).max()
    k = s["eng"].cfg.TEST.RPN_PRE_NMS_TOP_N
    gaps = [np.abs(np.diff(np.sort(p.reshape(-1))[-(k + 1):])).min()
            for p in jprob]
    assert 0 < drift < 1e-4
    assert min(gaps) > 10 * drift, (min(gaps), drift)

    np.testing.assert_array_equal(got[1], want[1])              # valid
    assert want[1].sum() > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=0,
                               atol=1e-5 * np.abs(want[4]).max())


def test_proposals_pool_head_exact_on_jax_trunk(both):
    """The JAX trunk's own outputs through both proposal layers, at a budget
    that ranks most of the 1728 anchors (1000 -> 100): identical keep sets
    and order; then pool + head on the JAX feature map."""
    s = both
    feat, score, bbox = (np.asarray(t) for t in _jax_trunk(s))
    prob = np.asarray(jax_rpn_softmax(score, A))
    kw = dict(num_anchors=A, pre_nms_top_n=1000, post_nms_top_n=100,
              nms_thresh=0.7, min_size=16.0)
    want = jax_proposal_layer(prob, bbox, s["im_info"],
                              jnp.asarray(s["jeng"].anchors), **kw)
    got = proposal_layer(torch.tensor(prob), torch.tensor(bbox),
                         torch.tensor(s["im_info"]), s["eng"].anchors,
                         **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=2.4e-4)   # an ulp of exp
    pooled = jax_pool(jnp.asarray(feat), want.boxes)
    jcls, jbbox, _ = s["jm"].apply_head(
        s["he"], pooled.reshape(-1, 7, 7, feat.shape[-1]), train=False)
    with torch.no_grad():
        flat = roi_pool_fc(torch.tensor(feat), got.boxes)
        cls, bb = s["port"].apply_head(flat.reshape(-1, flat.shape[-1]))
    np.testing.assert_allclose(torch.softmax(cls, -1).numpy(),
                               np.asarray(jax.nn.softmax(jcls, -1)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bb.numpy(), np.asarray(jbbox), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jbbox)).max())


def test_served_detections_match_jax(both):
    """``im_detect_batch`` + ``report_detections`` end to end from raw
    images, in both packages."""
    s = both
    want = jax_detect(s["jeng"], s["he"], s["images"], NET, CANVAS)
    got = im_detect_batch(s["eng"], s["images"], NET, CANVAS)
    n_reported = 0
    for (ws, wb), (gs, gb) in zip(want, got):
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
        w_entries, _ = jax_report(ws, wb, s["jeng"].cfg, thresh=0.3)
        g_entries, _ = report_detections(gs, gb, s["eng"].cfg, thresh=0.3)
        assert [e["class"] for e in g_entries] == \
            [e["class"] for e in w_entries]
        np.testing.assert_allclose([e["score"] for e in g_entries],
                                   [e["score"] for e in w_entries],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose([e["box"] for e in g_entries],
                                   [e["box"] for e in w_entries],
                                   rtol=0, atol=BOX_ATOL)
        n_reported += len(g_entries)
    assert n_reported > 0


def test_im_detect_single_image_matches_jax(both):
    s = both
    ws, wb = jax_detect_one(s["jeng"], s["he"], s["images"][1], NET, CANVAS)
    gs, gb = im_detect(s["eng"], s["images"][1], NET, CANVAS)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
