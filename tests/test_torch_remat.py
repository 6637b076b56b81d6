"""Activation remat (``FasterRCNN.remat``: False / True / "trunk" /
"head"; ``models/detector.py``, ``models/layers.py:checkpoint``) on the
CPU: every choice leaves the combined step and the MIL step bit for bit
as without remat, at full ResNet-18 BN / GN and VGG16 width, a 192x256
canvas, 1 supervised + 2 weak images and reduced budgets (RPN 32 -> 16
proposals, 16 ROIs per supervised image), from seeded He weights with the
norms drawn away from their init (``tests/test_torch_resnet_model.py:
_perturbed``).  Bit for bit means: the losses, every parameter and
running statistic, and Adam's moments; the MIL step leaves the running
statistics as the combined step left them.  No tolerance: the recompute
runs the same CPU kernels on the same inputs, and the backward the same
graph.

The trouble spots each have a test of their own: BatchRenorm's in-place
update of its running statistics under a recompute (the recompute must
read the statistics the first run read, and update nothing); the MIL
step's ``running_stats_frozen`` context, which has exited when the
backward recomputes; and dropout drawn from the engine's explicit
``torch.Generator``, whose state a checkpoint does not restore.  One
ResNet-18 BN combined step under ``remat=True`` is held against the JAX
package's ``FasterRCNN(remat=True)`` step within
``tests/test_torch_resnet_engine.py``'s tolerances; the JAX package's own
``tests/test_resnet_engine.py`` holds its four choices equal."""

import copy
from unittest import mock

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from tests.test_torch_resnet_engine import (_build, _check_state,
                                            _combined_step)
from tests.test_torch_resnet_model import _perturbed
from tests.test_torch_train_step import _speckle
from wssdl_bus_tpu.models.detector import build_detector as jax_build
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import get_image_blob
from wssdl_bus_tpu_torch.models import resnet, vgg
from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.models.layers import (BatchRenorm, checkpoint,
                                               running_stats_frozen)
from wssdl_bus_tpu_torch.ops.proposal_target import num_candidates
from wssdl_bus_tpu_torch.train.engine import Engine, StepDraws

CANVAS = (192, 256)
STEP = 40000
LR = 5e-4
R, P = 16, 16
OVERRIDES = ["TEST.SCALES", "(192,)", "TEST.MAX_SIZE", "256",
             "TRAIN.RPN_PRE_NMS_TOP_N", "32", "TRAIN.RPN_POST_NMS_TOP_N",
             str(P), "TRAIN.BATCH_SIZE", str(R)]
CHOICES = [True, "head", "trunk"]
# (network, depth, norm, seed)
MODELS = {"resnet18_bn": ("Resnet_train", 18, "BN", 0),
          "resnet18_gn": ("Resnet_train", 18, "GN", 7),
          "vgg16": ("VGGnet_train", None, None, 6)}


def _model(key, remat):
    net, depth, norm, seed = MODELS[key]
    kw = dict(depth=depth, norm=norm) if depth else {}
    port = build_detector(net, device="cpu", remat=remat, **kw)
    if depth:
        he = _perturbed(he_tree(params_to_jax(port.state_dict()), seed),
                        seed)
    else:
        he = he_tree(params_to_jax(port.state_dict()), seed,
                     input_scale=64.0)
    # unsaturated RPN scores, as in tests/test_torch_resnet_engine.py
    for k in ("rpn_cls_score", "rpn_bbox_pred"):
        he["trunk"]["params"][k]["conv"]["kernel"] *= 0.03
    port.load_state_dict(params_from_jax(he))
    return port


def _batch(net, cfg, seed):
    rng = np.random.RandomState(seed)
    blobs, gts = [], np.zeros((3, 20, 5), np.float32)
    s = 192 / 150
    for i in range(3):
        im, (cx, cy) = _speckle(rng)
        blobs.append(get_image_blob(im, net, cfg, CANVAS)[0])
        if i == 0:
            gts[0, 0] = [(cx - 30) * s, (cy - 22) * s, (cx + 30) * s,
                         (cy + 22) * s, 2]
            gts[0, 1] = [0, 0, 255, 191, 0]   # whole-image background box
    return {"data": np.concatenate(blobs), "gt_boxes": gts,
            "num_gt_boxes": np.array([2, 0, 0], np.int32),
            "im_info": np.array([[192, 256, s, 2], [192, 256, s, 2],
                                 [192, 256, s, 1]], np.float32)}


def _draws(eng, seed):
    """Every draw of a combined and a MIL step, from a generator of its
    own: (combined StepDraws, MIL StepDraws)."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    n = num_candidates(P, eng.cfg.TRAIN.MAX_GT_PER_IMAGE, R)
    combined = StepDraws(anchor_u=rand(1, 2, len(eng.anchors)),
                         roi_u=rand(1, 2, n),
                         keep_sup=(rand(R, 512) < 0.5, rand(R, 512) < 0.5),
                         keep_ws=(rand(2 * P, 512) < 0.5,
                                  rand(2 * P, 512) < 0.5))
    return combined, StepDraws(keep_ws=(rand(2 * P, 512) < 0.5,
                                        rand(2 * P, 512) < 0.5))


def _state(eng):
    """Everything a step may change: the state dict (parameters and
    running statistics) and Adam's count and moments, as copies."""
    opt = eng.opt.state_dict()
    return {"model": {k: v.clone() for k, v in
                      eng.model.state_dict().items()},
            "count": opt["count"],
            "mu": {k: v.clone() for k, v in opt["mu"].items()},
            "nu": {k: v.clone() for k, v in opt["nu"].items()}}


def _run(key, remat, inject: bool):
    """One combined step, then one MIL step on the weak images, of a fresh
    model under ``remat``; -> (losses, state after the combined step,
    MIL loss, state after the MIL step).  Checks that the steps ran the
    checkpoints ``remat`` asks for, one a residual block or a VGG16 conv
    stage: ResNet-18's trunk 6 a step and its head 2; VGG16's trunk 5 a
    step (no stem kernel on the CPU) and its head one a ROI group (2 in
    the combined step, 1 in the MIL step)."""
    torch.set_num_threads(2)
    net = MODELS[key][0]
    cfg = Config().with_overrides(OVERRIDES)
    eng = Engine(_model(key, remat), cfg, CANVAS, device="cpu")
    assert eng.model.remat == remat
    batch = _batch(net.replace("_train", "_test"), cfg, MODELS[key][3])
    combined, mil = _draws(eng, 3) if inject else (None, None)
    parts = []
    trunk = list(eng.model.trunk.modules())

    def counted(fn, *args, **kwargs):
        owner = getattr(fn, "__self__", fn)
        parts.append("trunk" if any(owner is m for m in trunk) else "head")
        return checkpoint(fn, *args, **kwargs)

    with mock.patch.object(resnet, "checkpoint", counted), \
            mock.patch.object(vgg, "checkpoint", counted):
        losses = eng.train_step(batch, LR, STEP, combined)
        after = _state(eng)
        weak = {k: batch[k][1:] for k in ("data", "im_info")}
        mil_loss = eng.train_step_mil(weak, LR, STEP, mil)
    trunk_n, head_n = (10, 3) if key == "vgg16" else (12, 4)
    assert (parts.count("trunk"), parts.count("head")) == (
        trunk_n * (remat in (True, "trunk")),
        head_n * (remat in (True, "head")))
    return tuple(losses), after, mil_loss, _state(eng)


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def _assert_same_run(got, want):
    losses, after, mil, after_mil = got
    w_losses, w_after, w_mil, w_after_mil = want
    for i, (a, b) in enumerate(zip(losses, w_losses)):
        assert torch.equal(a, b), ("loss", i, float(a), float(b))
    assert torch.equal(mil, w_mil), (float(mil), float(w_mil))
    for (state, w_state, step) in ((after, w_after, "combined"),
                                   (after_mil, w_after_mil, "MIL")):
        assert state["count"] == w_state["count"]
        for part in ("model", "mu", "nu"):
            _assert_same(state[part], w_state[part], (step, part))
    # the MIL step moved the parameters and no running statistic
    stats = [k for k in after["model"] if k.endswith((".mean", ".var"))]
    for k in stats:
        assert torch.equal(after_mil["model"][k], after["model"][k]), k
    moved = [k for k in after["model"] if k not in stats
             and not torch.equal(after_mil["model"][k], after["model"][k])]
    assert moved


@pytest.fixture(scope="module")
def no_remat():
    """The runs without remat, by model and by draw injection."""
    return {}


@pytest.mark.parametrize("remat", CHOICES, ids=str)
@pytest.mark.parametrize("key", list(MODELS))
def test_steps_equal_without_remat(no_remat, key, remat):
    """A combined step and a MIL step under ``remat``, all draws injected,
    equal the steps without remat bit for bit; the combined step moved
    every running statistic of a BN model, the MIL step none."""
    if (key, True) not in no_remat:
        no_remat[key, True] = _run(key, False, inject=True)
    want = no_remat[key, True]
    _assert_same_run(_run(key, remat, inject=True), want)
    stats = [k for k in want[1]["model"] if k.endswith((".mean", ".var"))]
    assert len(stats) == (60 if key == "resnet18_bn" else 0)
    init = _model(key, False).state_dict()
    for k in stats:
        assert not torch.equal(want[1]["model"][k], init[k]), k


@pytest.mark.parametrize("remat", [True, "head"], ids=str)
def test_head_remat_draws_dropout_from_the_engine_generator(no_remat,
                                                            remat):
    """Trouble spot 3: VGG16's dropout drawn from the engine's
    ``torch.Generator`` (no injected masks), which a checkpoint's
    recompute cannot restore: the head's masks are drawn before its
    checkpoint, in the head's order, so the steps equal the steps without
    remat bit for bit (the MIL step's masks, drawn after the combined
    step's from the same generator, included)."""
    if ("vgg16", False) not in no_remat:
        no_remat["vgg16", False] = _run("vgg16", False, inject=False)
    _assert_same_run(_run("vgg16", remat, inject=False),
                     no_remat["vgg16", False])


def test_head_remat_without_predrawn_masks_would_differ():
    """The control for trouble spot 3: a VGG16 head checkpointed with the
    generator passed in draws other masks in its recompute, and its
    gradients differ from the masks' forward; the port's head remat
    (``remat=True``) draws them first and matches the head without a
    checkpoint."""
    torch.manual_seed(0)
    head = _model("vgg16", False).head.train()
    x = torch.randn(8, 7 * 7 * 512)

    def grads(fn):
        head.zero_grad()
        gen = torch.Generator().manual_seed(5)
        cls, bbox = fn(gen)
        (cls.square().sum() + bbox.square().sum()).backward()
        return [p.grad.clone() for p in head.parameters()]

    want = grads(lambda gen: head(x, None, gen))
    naive = grads(lambda gen: torch.utils.checkpoint.checkpoint(
        head, x, None, gen, use_reentrant=False))
    drawn = grads(lambda gen: head(x, None, gen, remat=True))
    assert any(not torch.equal(a, b) for a, b in zip(naive, want))
    assert all(torch.equal(a, b) for a, b in zip(drawn, want))


def _renorm_case():
    torch.manual_seed(1)
    m = BatchRenorm(6)
    with torch.no_grad():
        m.gamma.uniform_(0.5, 1.5)
        m.beta.normal_()
        m.mean.normal_()
        m.var.uniform_(0.5, 2.0)
    x = torch.randn(4, 6, 5, 5) * 2.0 + 0.3
    w = torch.randn(4, 6, 5, 5)
    return m, x, w


def _renorm_run(m, x, w, fn, frozen=False):
    """-> (x's and gamma's gradients, the running statistics after the
    backward), from a copy of ``m``."""
    m = copy.deepcopy(m).train()
    xx = x.clone().requires_grad_(True)
    ctx = running_stats_frozen(m) if frozen else torch.enable_grad()
    with ctx:
        y = fn(m, xx)
    # the backward runs after the context, as in Engine.train_step_mil
    (y * w).sum().backward()
    return (xx.grad, m.gamma.grad), (m.mean.clone(), m.var.clone())


def test_renorm_recompute_reads_the_statistics_the_forward_read():
    """Trouble spot 1: ``BatchRenorm`` updates its running statistics in
    its forward, and a recompute would update them again and compute r
    and d from the updated values.  Under ``models/layers.py:checkpoint``
    the gradients and the statistics (updated once) equal the run without
    a checkpoint bit for bit; under a bare ``torch.utils.checkpoint``
    (whose check compares shapes only) both differ."""
    m, x, w = _renorm_case()
    want_g, want_s = _renorm_run(m, x, w, lambda mm, xx: mm(xx))
    got_g, got_s = _renorm_run(m, x, w, lambda mm, xx: checkpoint(mm, xx))
    for a, b in zip(got_g + got_s, want_g + want_s):
        assert torch.equal(a, b)
    assert not torch.equal(want_s[0], m.mean)
    bare_g, bare_s = _renorm_run(
        m, x, w, lambda mm, xx: torch.utils.checkpoint.checkpoint(
            mm, xx, use_reentrant=False))
    assert not torch.equal(bare_s[0], want_s[0])
    assert not torch.equal(bare_g[0], want_g[0])


def test_renorm_frozen_stats_stay_frozen_in_the_recompute():
    """Trouble spot 2: the MIL step's ``running_stats_frozen`` has exited
    when its backward recomputes; the recompute still updates nothing, and
    the gradients equal the frozen run without a checkpoint."""
    m, x, w = _renorm_case()
    want_g, want_s = _renorm_run(m, x, w, lambda mm, xx: mm(xx), True)
    got_g, got_s = _renorm_run(m, x, w, lambda mm, xx: checkpoint(mm, xx),
                               True)
    for a, b in zip(got_g + got_s, want_g + want_s):
        assert torch.equal(a, b)
    assert torch.equal(got_s[0], m.mean) and torch.equal(got_s[1], m.var)


@pytest.mark.parametrize("frozen", [False, True], ids=["update", "frozen"])
def test_renorm_relu_recompute_reads_the_statistics_the_forward_read(frozen):
    """The fused norm + ReLU (``BatchRenorm(x, relu=True)``, the route of
    every preact and of every conv's norm but the last of a block) under
    ``models/layers.py:checkpoint``: the recompute runs the same forward
    with the statistics its first run read and updates nothing, so the
    gradients and the running statistics (updated once a step, or not at
    all under ``running_stats_frozen``) equal the run without a checkpoint
    bit for bit."""
    from wssdl_bus_tpu_torch.ops import batch_renorm_cuda

    m, x, w = _renorm_case()

    def fused(mm, xx):
        return mm(xx, relu=True)

    want_g, want_s = _renorm_run(m, x, w, fused, frozen)
    fwd = batch_renorm_cuda.batch_renorm_forward_plain
    with mock.patch.object(batch_renorm_cuda, "batch_renorm_forward_plain",
                           side_effect=fwd) as spy:
        got_g, got_s = _renorm_run(
            m, x, w, lambda mm, xx: checkpoint(fused, mm, xx), frozen)
    # the first run updates (unless frozen), the recompute never
    assert [c.args[5] for c in spy.call_args_list] == [not frozen, False]
    for a, b in zip(got_g + got_s, want_g + want_s):
        assert torch.equal(a, b)
    assert torch.equal(got_s[0], m.mean) == frozen
    plain_g, _ = _renorm_run(m, x, w, lambda mm, xx: mm(xx), frozen)
    assert not torch.equal(plain_g[0], got_g[0])     # the ReLU is in it


def test_remat_applies_in_training_with_gradients_only():
    """Eval mode, ``torch.no_grad`` and ``inference_mode`` run no
    checkpoint (and so record nothing): the serving and evaluation paths
    are untouched by ``remat``."""
    model = _model("resnet18_bn", True)
    assert model._remat("trunk") and model._remat("head")
    with torch.no_grad():
        assert not model._remat("trunk")
    with torch.inference_mode():
        assert not model._remat("head")
    model.eval()
    assert not model._remat("trunk") and not model._remat("head")
    head_only = _model("resnet18_bn", "head")
    assert head_only._remat("head") and not head_only._remat("trunk")
    with pytest.raises(ValueError):
        build_detector("Resnet_train", device="cpu", depth=18, norm="BN",
                       remat="both")


@pytest.mark.parametrize("name,depth", [
    ("VGGnet_train", 18), ("VGGnet_test", 18), ("Resnet_train", 18),
    ("Resnet_train", 34), ("Resnet_train", 50), ("Resnet_test", 101)])
def test_build_detector_defaults_match_jax(name, depth):
    """``remat=None`` picks the JAX package's default (off for VGG16, full
    remat for every ResNet), and an explicit choice passes through."""
    port = build_detector(name, device="cpu", depth=depth, norm="BN")
    assert port.remat == jax_build(name, depth, "BN").remat
    for choice in ((False, True, "head", "trunk") if depth == 18 else ()):
        assert build_detector(name, device="cpu", depth=depth, norm="BN",
                              remat=choice).remat == \
            jax_build(name, depth, "BN", remat=choice).remat == choice


def test_resnet18_bn_remat_step_matches_jax():
    """One ResNet-18 BN combined step of the port's ``remat=True`` model
    against the JAX package's ``FasterRCNN(remat=True)`` step, on the same
    inputs and injected draws, within ``tests/test_torch_resnet_engine.
    py``'s guards and tolerances."""
    s = _build("BN", 0, 0.03, remat=True)
    assert s["port"].remat is True and s["jeng"].model.remat is True
    jvars, _, before = _combined_step(s)
    assert _check_state(s["port"], jvars, before, True) == (149 - 60, 60)
