"""The port's VGG16 joint step (``Engine.train_step`` of
``build_detector("VGGnet_train")``: conv1-conv2 frozen, remat off) against
the benchmark's plain reference (``h100_bench/hbench/reference_vgg16.py``)
on the CPU, from the same seeded He weights (``hbench/weights.py``), the
same anchor and ROI draws and the same dropout masks: full VGG16 width, a
192x256 canvas (the smallest anchors, ~91x181 px, fit inside it), RPN 600
-> 64 proposals, 16 ROIs a supervised image.

The reference follows the program's RPN outputs for its proposals and the
program's weak logits for the MIL picks, as in the benchmark; everything
else it computes itself.  Both sides run f32 on the CPU and differ by
rounding (oneDNN's channels-last convolutions in the program, the default
layout in the reference), ~2e-5 of a conv5_3 value at most.  Measured over
the four cases: the RPN outputs and weak logits to 5.3e-6 of their
largest, the losses to 1.4e-5 relative.  A max-pool bin whose two largest
cells lie closer than that rounding sends its cotangent to a different
cell on each side (a few dozen of the millions of (bin, channel) pairs
here), so each trunk leaf's gradient differs by up to 6.5e-3 of its norm
and Adam's update (step 1: g / (|g| + 0.1), times the learning rate) by
up to 9.4e-3 of its norm.  The tolerances are three or more times those.
A mask the program draws for itself (the fault ``keep_altered``) must fail
the same comparison: measured, a gap of 1.06 in the weak logits and 1.45
in a leaf's gradient."""

import os
import sys

import numpy as np
import pytest
import torch

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.engine import Engine, StepDraws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100_bench"))

from hbench import reference as R  # noqa: E402
from hbench import reference_vgg16 as RV  # noqa: E402
from hbench.weights import make_weights  # noqa: E402

CANVAS = (192, 256)
PRE_N, POST_N, ROIS = 600, 64, 16
LR = 5e-4
TOL = {"rpn": 1e-4, "head": 1e-4, "loss": 1e-3, "grad": 3e-2,
       "update": 3e-2}


def _cfg(n_s, n_ws):
    return Config().with_overrides([
        "TRAIN.IMS_PER_BATCH", str(n_s), "TRAIN.WS_IMS_PER_BATCH", str(n_ws),
        "TRAIN.RPN_PRE_NMS_TOP_N", str(PRE_N),
        "TRAIN.RPN_POST_NMS_TOP_N", str(POST_N),
        "TRAIN.BATCH_SIZE", str(ROIS), "TRAIN.LEARNING_RATE", str(LR)])


def _batch(rng, n_s, n_ws):
    """A pixel-unit blob (VGG16's prep scale) with one mass and one
    whole-image background box on each supervised image."""
    n, (h, w) = n_s + n_ws, CANVAS
    gt = np.zeros((n, 20, 5), np.float32)
    for i in range(n_s):
        x1, y1 = rng.randint(10, 90), rng.randint(10, 60)
        gt[i, 0] = [x1, y1, x1 + rng.randint(60, 140),
                    y1 + rng.randint(50, 110), 1 + rng.randint(2)]
        gt[i, 1] = [0, 0, w - 1, h - 1, 0]
    return {"data": (50.0 * rng.standard_normal((n, h, w, 3)))
            .astype(np.float32),
            "gt_boxes": gt,
            "num_gt_boxes": np.array([2] * n_s + [0] * n_ws, np.int64),
            "im_info": np.array([[h, w, 1.0, 1 + rng.randint(2)]
                                 for _ in range(n)], np.float32)}


def _step(seed, n_s, n_ws, fault=None):
    """One step of each side -> (program, reference) dicts of the RPN
    outputs, weak logits, losses, gradients, updates and frozen leaves."""
    torch.set_num_threads(2)
    cfg = _cfg(n_s, n_ws)
    rng = np.random.RandomState(seed)
    batch = _batch(rng, n_s, n_ws)
    spec = RV.param_spec()
    init = make_weights(spec, seed, "cpu")
    model = build_detector("VGGnet_train", device="cpu")
    model.load_state_dict(init, strict=True)
    eng = Engine(model, cfg, CANVAS, device="cpu", dataset="SNUBH",
                 opt_name="adam", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    k = (CANVAS[0] // 16) * (CANVAS[1] // 16) * R.NUM_ANCHORS
    n_cand = max(POST_N + 20, ROIS)
    anchor_u = torch.rand((n_s, 2, k), generator=gen)
    roi_u = torch.rand((n_s, 2, n_cand), generator=gen)
    keep = tuple(tuple(torch.rand((rows, RV.FC), generator=gen) < 0.5
                       for _ in range(2))
                 for rows in (n_s * ROIS, n_ws * POST_N))
    draws = StepDraws(anchor_u, roi_u)
    if fault != "keep_altered":
        draws = draws._replace(keep_sup=keep[0], keep_ws=keep[1])

    seen = {}
    proposals, mil = eng._proposals, eng._mil

    def hook_proposals(score, deltas, *args):
        seen["rpn"] = (score.detach().clone(), deltas.detach().clone())
        return proposals(score, deltas, *args)

    def hook_mil(cls_ws, *args):
        seen["cls_ws"] = cls_ws.detach().clone()
        return mil(cls_ws, *args)

    eng._proposals, eng._mil = hook_proposals, hook_mil
    losses = eng.train_step(batch, LR, 0, draws)
    params = dict(model.named_parameters())
    prog = {"rpn": seen["rpn"], "cls_ws": seen["cls_ws"],
            "losses": {n: float(getattr(losses, n)) for n in (
                "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "mil_cls")},
            "grads": {n: p.grad for n, p in params.items()
                      if p.grad is not None},
            "params": {n: p.detach() for n, p in params.items()}}

    P = make_weights(spec, seed, "cpu")
    ref_batch = {"data": torch.as_tensor(batch["data"]),
                 "gt": torch.as_tensor(batch["gt_boxes"]),
                 "num_gt": torch.as_tensor(batch["num_gt_boxes"]),
                 "im_info": torch.as_tensor(batch["im_info"])}
    t = cfg.TRAIN
    rcfg = {"n_s": n_s, "pre_n": PRE_N, "post_n": POST_N,
            "rois_per_image": ROIS, "nms": t.RPN_NMS_THRESH,
            "min_size": float(t.RPN_MIN_SIZE), "ws_mal_pct": t.WS_MAL_PCT,
            "weight_decay": t.WEIGHT_DECAY}
    rl, grads, _, outs = RV.train_step(P, ref_batch, (anchor_u, roi_u),
                                       keep, seen["rpn"], seen["cls_ws"], 0,
                                       rcfg)
    R.Adam(list(grads), P).update(P, grads, LR)
    ref = {"rpn": outs[:2], "cls_ws": outs[2],
           "losses": {n: float(v) for n, v in rl.items()},
           "grads": grads, "params": P}
    return prog, ref, init


def _gaps(prog, ref, init) -> dict:
    """The widest gap of each compared quantity: the RPN outputs and weak
    logits over their largest value, each loss over its value, each leaf's
    gradient and update by norm over the reference's norm."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def norm(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    return {
        "rpn": max(rel(p, r) for p, r in zip(prog["rpn"], ref["rpn"])),
        "head": rel(prog["cls_ws"], ref["cls_ws"]),
        "loss": max(abs(prog["losses"][n] - v) / max(abs(v), 1e-30)
                    for n, v in ref["losses"].items()),
        "grad": max(norm(prog["grads"][n], g)
                    for n, g in ref["grads"].items()),
        "update": max(norm(prog["params"][n] - init[n],
                           ref["params"][n] - init[n])
                      for n in ref["grads"])}


@pytest.mark.parametrize("n_s,n_ws", [(1, 2), (2, 4)], ids=["1+2", "2+4"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_vgg16_step_follows_the_reference(seed, n_s, n_ws):
    prog, ref, init = _step(seed, n_s, n_ws)
    # the same leaves train on both sides: all but conv1-conv2
    assert set(prog["grads"]) == set(ref["grads"]) == {
        n for n, _ in RV.param_spec() if RV.trainable(n)}
    gaps = _gaps(prog, ref, init)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps
    # the frozen stem did not move, bit for bit
    for n in RV.param_spec():
        if not RV.trainable(n[0]):
            assert torch.equal(prog["params"][n[0]], init[n[0]]), n[0]
    # every loss takes part (nonzero), so each is compared
    assert all(v > 0 for v in ref["losses"].values()), ref["losses"]


def test_masks_the_program_draws_itself_fail_the_comparison():
    gaps = _gaps(*_step(3, 1, 2, fault="keep_altered"))
    assert gaps["head"] > 100 * TOL["head"], gaps
    assert not all(gaps[k] <= TOL[k] for k in TOL)
