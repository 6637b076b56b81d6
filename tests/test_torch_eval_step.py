"""The port's ``Engine.eval_step`` (the in-training evaluation forward)
against the JAX package's ``Engine.eval_step`` on the same converted
weights, with the JAX draws injected (the anchor and ROI sampling uniforms
reproduced from the key splits, ``tests/test_torch_targets.py``), at batch
1 and 2: full VGG16 width, ``tests/test_engine.py:tiny_cfg``'s budgets
with TEST budgets of 32 -> 16 proposals, a 192 x 256 canvas, and
``tests/test_torch_engine.py``'s He weights of seed 6 (RPN class logits
scaled by 0.1).

Why 32 -> 16 and not tiny_cfg's 200 -> 32: the proposals come from each
side's own trunk, which agree only to f32 drift, and at 200 candidates the
smallest gap between neighbouring ranked scores falls below that drift at
any seed (``tests/test_torch_engine.py``'s docstring); its guard is
repeated here (gaps > 10x the measured drift).  Then the sampled ROIs
quantise to the same feature cells and the labels are identical; ROIs
agree to that file's BOX_ATOL (2e-2 px), class probabilities to 1e-5,
box deltas to 1e-5 of their max, and each per-image loss to 1e-4
relative (``tests/test_torch_train_step.py``'s LOSS_RTOL: rpn_box sums the
drift of many deltas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_engine import tiny_cfg
from tests.test_torch_engine import BOX_ATOL
from tests.test_torch_targets import anchor_uniforms, roi_uniforms
from tests.test_torch_train_step import _speckle
from wssdl_bus_tpu.evaluate.detect import get_image_blob as jax_image_blob
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import rpn_softmax as jax_softmax
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.ops.proposal_target import num_candidates
from wssdl_bus_tpu_torch.train.engine import Engine, StepDraws

CANVAS = (192, 256)
SEED = 6
STEP = 40000
A = 9
P = 16
LOSS_RTOL = 1e-4
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TEST.RPN_PRE_NMS_TOP_N", "32", "TEST.RPN_POST_NMS_TOP_N",
             str(P)]


def _cfgs():
    jcfg = tiny_cfg().with_overrides(OVERRIDES)
    flat = []
    for sec in ("TRAIN", "TEST"):
        for k, v in getattr(jcfg, sec).__dict__.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                flat += [f"{sec}.{k}", repr(v)]
    return jcfg, Config().with_overrides(flat)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    jcfg, cfg = _cfgs()
    assert cfg.TRAIN.BATCH_SIZE == jcfg.TRAIN.BATCH_SIZE == 32
    assert cfg.TEST.RPN_POST_NMS_TOP_N == P
    port = build_detector("VGGnet_test", device="cpu")
    he = he_tree(params_to_jax(port.state_dict()), SEED, input_scale=64.0)
    he["trunk"]["params"]["rpn_cls_score"]["conv"]["kernel"] *= 0.1
    port.load_state_dict(params_from_jax(he))
    # the alternating regime's selector pair, so that the bag's selector
    # is not the default's
    pair = ("mass_max", "mal_max")
    jeng = JaxEngine(JaxFasterRCNN(backbone="VGGnet"), jcfg, CANVAS,
                     selector_pair=pair)
    eng = Engine(port, cfg, CANVAS, device="cpu", selector_pair=pair)

    rng = np.random.RandomState(SEED)
    blobs, gts = [], np.zeros((2, 20, 5), np.float32)
    s = 192 / 150
    for i in range(2):
        im, (cx, cy) = _speckle(rng)
        blobs.append(jax_image_blob(im, "VGGnet_test", jcfg, CANVAS)[0])
        gts[i, 0] = [(cx - 30) * s, (cy - 22) * s, (cx + 30) * s,
                     (cy + 22) * s, 1 + i]
        gts[i, 1] = [0, 0, 255, 191, 0]   # whole-image background box

    batch = {"data": np.concatenate(blobs), "gt_boxes": gts,
             "num_gt_boxes": np.array([3, 3], np.int32),
             "im_info": np.array([[192, 256, s, 1], [192, 256, s, 2]],
                                 np.float32)}
    # a third GT box on one of the image's own proposals (shrunk by 2 px),
    # so that some sampled ROIs are foreground and the box loss counts
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _, score, deltas = port.apply_trunk(t["data"])
        props = eng._proposals(score, deltas, t["im_info"], cfg.TEST)
    for i in range(2):
        x1, y1, x2, y2 = props.boxes[i, 3].tolist()
        gts[i, 2] = [x1 + 2, y1 + 2, x2 - 2, y2 - 2, 2 - i]
    batch["num_gt_boxes"][:] = 3
    jvars = jax.tree.map(jnp.asarray, he)
    return dict(jeng=jeng, eng=eng, batch=batch, jvars=jvars, cfg=cfg)


@pytest.mark.parametrize("b", [1, 2])
def test_eval_step_matches_jax(setup, b):
    s = setup
    jeng, eng, cfg = s["jeng"], s["eng"], s["cfg"]
    batch = {k: v[:b] for k, v in s["batch"].items()}
    key = jax.random.PRNGKey(SEED + b)
    jls, jrois, jprob, jbbox, jlabels = jeng.eval_step(
        s["jvars"], {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.int32(STEP))
    k_at, k_pt = jax.random.split(key)
    n = num_candidates(P, 20, cfg.TRAIN.BATCH_SIZE, include_gt=False)
    draws = StepDraws(
        anchor_u=torch.from_numpy(anchor_uniforms(k_at, b, b,
                                                  len(eng.anchors))),
        roi_u=torch.from_numpy(roi_uniforms(k_pt, b, n)))
    ls, rois, prob, bbox, labels = eng.eval_step(batch, STEP, draws)

    # the near-tie guard on each side's own RPN scores
    with torch.no_grad():
        _, score, _ = eng.model.apply_trunk(torch.from_numpy(batch["data"]))
    jv = {"trunk": s["jvars"]["trunk"]}
    _, jscore, _, _ = jeng.model.apply_trunk(jv, jnp.asarray(batch["data"]),
                                             train=False)
    jfg = np.asarray(jax_softmax(jscore, A))[..., A:]
    fg = torch.softmax(torch.stack([score[..., :A], score[..., A:]]),
                       0)[1].numpy()
    drift = np.abs(jfg - fg).max()
    gaps = [np.abs(np.diff(np.sort(p.reshape(-1))[-33:])).min() for p in jfg]
    assert 0 < drift < 1e-4 and min(gaps) > 10 * drift, (gaps, drift)

    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert (labels.numpy() >= 0).sum() > 0 and (labels.numpy() > 0).any()
    np.testing.assert_array_equal(np.floor(rois.numpy() / 16.0 + 0.5),
                                  np.floor(np.asarray(jrois) / 16.0 + 0.5))
    np.testing.assert_allclose(rois.numpy(), np.asarray(jrois), rtol=0,
                               atol=BOX_ATOL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=0,
                               atol=1e-5)
    jb = np.asarray(jbbox)
    np.testing.assert_allclose(bbox.numpy(), jb, rtol=0,
                               atol=1e-5 * np.abs(jb).max())
    for name, got, want in zip(ls._fields, ls, jls):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (b,), name
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=name)
    assert (ls.mil_cls.numpy() > 0).all() and (ls.rcnn_cls.numpy() > 0).all()
