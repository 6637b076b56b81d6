"""The serving and training steps (counterpart of
``wssdl_bus_tpu/train/engine.py``).

``Engine.inference_step`` is the test-graph forward of
``Engine._inference_impl`` (``wssdl_bus_tpu/train/engine.py:638-661``): the
VGG16 trunk and RPN, ``rpn_softmax``, the proposal layer with TEST budgets
(greedy NMS in the CUDA kernel ``csrc/nms.cu``), ROI max-pool written as the
flat fc6 operand (``csrc/roi_pool.cu``), the fc head and a softmax.

``Engine.train_step`` is the combined step (``_train_step_impl``, the
reference's ``train_model``, train_bus.py:595-764): anchor targets for the
supervised images, proposals with TRAIN budgets, ROI sampling, the pool and
the head (with dropout) applied to the supervised ROIs and to the weak
images' proposals separately, the four supervised losses, weight decay and
the MIL bag loss, one backward and one optimizer update.  The pool's
backward is a CUDA kernel (``wssdl_roi_pool_bwd``, ``ops/roi_pool_cuda.py``).
``Engine.train_step_mil`` is the alternating regime's weak step
(``_train_step_mil_impl``): the MIL loss alone over weak images.

Every random draw of a step (anchor and ROI sampling uniforms, dropout
masks) can be passed in as :class:`StepDraws`, as the tests do with the JAX
package's draws; what is not passed comes from the engine's seeded
``torch.Generator`` on its device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.mil import get_bag_logits
from wssdl_bus_tpu_torch.models.detector import (FasterRCNN, rpn_softmax,
                                                 stem_is_frozen)
from wssdl_bus_tpu_torch.ops.anchor_target import anchor_target_layer_joint
from wssdl_bus_tpu_torch.ops.anchors import shifted_anchors
from wssdl_bus_tpu_torch.ops.nms import nms_mask
from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
from wssdl_bus_tpu_torch.ops.proposal import proposal_layer, proposals_to_rois
from wssdl_bus_tpu_torch.ops.proposal_target import proposal_target_layer
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_fc, roi_pool_fc_plain
from wssdl_bus_tpu_torch.train import losses as L
from wssdl_bus_tpu_torch.utils import resolve_device


class StepLosses(NamedTuple):
    total: torch.Tensor      # rpn_cls + rpn_box + rcnn_cls + rcnn_box
    rpn_cls: torch.Tensor
    rpn_box: torch.Tensor
    rcnn_cls: torch.Tensor
    rcnn_box: torch.Tensor
    mil_cls: torch.Tensor


class StepDraws(NamedTuple):
    """A step's random draws; None fields are drawn from the generator."""
    anchor_u: Optional[torch.Tensor] = None   # [n_s, 2, K] fg, bg uniforms
    roi_u: Optional[torch.Tensor] = None      # [n_s, 2, n] fg, bg uniforms
    keep_sup: Optional[tuple] = None          # (fc6, fc7) bool [n_s*R, 512]
    keep_ws: Optional[tuple] = None           # (fc6, fc7) bool [n_ws*P, 512]


class Optimizer:
    """optax's adam / amsgrad (eps 0.1) and Nesterov SGD, written out in the
    same f32 operations, with the learning rate given at every step (the
    JAX package's ``make_optimizer``, ``inject_hyperparams``).

    A parameter without a gradient in a step (None) counts as a zero
    gradient, as in optax, so its moments still decay and it still moves.
    amsgrad takes the running max of the BIAS-CORRECTED second moment, as
    optax does (``torch.optim.Adam(amsgrad=True)`` does not)."""

    def __init__(self, name: str, params, momentum: float = 0.9):
        if name not in ("adam", "amsgrad", "sgd"):
            raise NotImplementedError(name)
        self.name = name
        self.params = list(params)
        self.b1, self.b2, self.eps, self.momentum = 0.9, 0.999, 0.1, momentum
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        self.mu = zeros()
        self.nu = zeros() if name != "sgd" else None
        self.nu_max = zeros() if name == "amsgrad" else None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float):
        self.count += 1
        dev = self.params[0].device if self.params else "cpu"
        f32 = dict(dtype=torch.float32, device=dev)
        neg_lr = torch.tensor(-lr, **f32)
        if self.name != "sgd":
            bc1 = 1.0 - torch.pow(torch.tensor(self.b1, **f32), self.count)
            bc2 = 1.0 - torch.pow(torch.tensor(self.b2, **f32), self.count)
        for k, p in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.name == "sgd":
                tr = g + self.momentum * self.mu[k]
                self.mu[k] = tr
                u = g + self.momentum * tr
            else:
                self.mu[k] = (1.0 - self.b1) * g + self.b1 * self.mu[k]
                self.nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[k]
                mu_hat = self.mu[k] / bc1
                nu_hat = self.nu[k] / bc2
                if self.name == "amsgrad":
                    self.nu_max[k] = torch.maximum(self.nu_max[k], nu_hat)
                    nu_hat = self.nu_max[k]
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            p.copy_(p + u * neg_lr)


def make_optimizer(opt_name: str, cfg: Config, model: torch.nn.Module):
    """The optimizer over the model's trainable parameters (frozen ones,
    ``requires_grad`` False, are left out and never change)."""
    return Optimizer(opt_name,
                     [p for p in model.parameters() if p.requires_grad],
                     momentum=cfg.TRAIN.MOMENTUM)


def _batch_tensors(batch: dict, device) -> dict:
    """A minibatch dict (numpy or tensors) -> tensors on ``device``."""
    out = {}
    for k in ("data", "gt_boxes", "im_info"):
        if k in batch:
            out[k] = torch.as_tensor(batch[k], dtype=torch.float32,
                                     device=device)
    if "num_gt_boxes" in batch:
        out["num_gt_boxes"] = torch.as_tensor(batch["num_gt_boxes"],
                                              dtype=torch.int64,
                                              device=device)
    return out


class Engine:
    """One model + config + static canvas on one device.

    ``device``: CUDA unless named (raises without a card).  ``plain_ops``
    swaps the kernels for their plain PyTorch versions
    (``ops/nms.py:nms_mask``, ``ops/roi_pool_cuda.py:roi_pool_fc_plain``
    with its plain backward, and for the opt-in stem paths
    ``ops/conv1.py:vgg_stem_plain`` / ``ops/conv2_pool.py:
    vgg_conv2_pool_plain``) on whatever the device is: the yardstick
    ``chip_smoke.py`` holds the served and trained paths against.

    Training: ``num_supervised`` / ``num_ws`` default to the config's
    IMS_PER_BATCH / WS_IMS_PER_BATCH; the optimizer (``opt_name``) covers
    the parameters that require gradients (conv1/conv2 do not after
    ``build_detector("VGGnet_train")``); ``seed`` seeds the generator the
    unpassed draws come from (cfg.RNG_SEED by default)."""

    def __init__(self, model: FasterRCNN, cfg: Config, canvas_hw,
                 device=None, plain_ops: bool = False,
                 num_supervised: int = None, num_ws: int = None,
                 dataset: str = "SNUBH", opt_name: str = "adam",
                 selector_pair=("mal_max", "mal_max"), seed: int = None):
        if model.backbone != "VGGnet":
            raise NotImplementedError("only the VGG16 detector is ported")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.canvas_hw = tuple(canvas_hw)
        self.num_anchors = len(cfg.ANCHOR_RATIOS) * len(cfg.ANCHOR_SCALES)
        fh, fw = canvas_hw[0] // cfg.FEAT_STRIDE, canvas_hw[1] // cfg.FEAT_STRIDE
        self.anchors = torch.as_tensor(
            shifted_anchors(fh, fw, cfg.FEAT_STRIDE, cfg.ANCHOR_RATIOS,
                            cfg.ANCHOR_SCALES), device=self.device)
        self.plain_ops = plain_ops
        self._nms = nms_mask if plain_ops else nms_keep
        self._pool = roi_pool_fc_plain if plain_ops else roi_pool_fc

        t = cfg.TRAIN
        self.n_s = t.IMS_PER_BATCH if num_supervised is None \
            else num_supervised
        self.n_ws = t.WS_IMS_PER_BATCH if num_ws is None else num_ws
        self.selector_pair = tuple(selector_pair)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.RNG_SEED if seed is None else seed)
        self.opt_name = opt_name
        self._opt = None
        self._at_kwargs = dict(
            dataset=dataset, rpn_batchsize=t.RPN_BATCHSIZE,
            rpn_fg_fraction=t.RPN_FG_FRACTION,
            pos_overlap=t.RPN_POSITIVE_OVERLAP,
            neg_overlap=t.RPN_NEGATIVE_OVERLAP,
            clobber_positives=t.RPN_CLOBBER_POSITIVES,
            bbox_inside_weights=t.RPN_BBOX_INSIDE_WEIGHTS,
            positive_weight=t.RPN_POSITIVE_WEIGHT)
        self._pt_kwargs = dict(
            num_classes=model.num_classes, rois_per_image=t.BATCH_SIZE,
            fg_fraction=t.FG_FRACTION, fg_thresh=t.FG_THRESH,
            bg_thresh_hi=t.BG_THRESH_HI, bg_thresh_lo=t.BG_THRESH_LO,
            bbox_inside_weights=t.BBOX_INSIDE_WEIGHTS,
            normalize_targets=t.BBOX_NORMALIZE_TARGETS_PRECOMPUTED,
            normalize_means=t.BBOX_NORMALIZE_MEANS,
            normalize_stds=t.BBOX_NORMALIZE_STDS)

    @property
    def opt(self) -> Optimizer:
        """The optimizer, made at the first training step (a serving engine
        holds no moments)."""
        if self._opt is None:
            self._opt = make_optimizer(self.opt_name, self.cfg, self.model)
        return self._opt

    def _train_trunk(self, data):
        """The trunk in training mode: the stem kernels may run only while
        conv1/conv2 are frozen (``models/detector.py:stem_is_frozen``)."""
        return self.model.apply_trunk(
            data, stem_frozen=stem_is_frozen(self.model),
            plain_ops=self.plain_ops)

    def _pool_for_head(self, feat, boxes):
        """ROI-pool ``boxes`` [B, P, 4] against ``feat`` [B, h, w, C] into the
        flat fc6 operand [B*P, 7*7*C]."""
        flat = self._pool(feat, boxes, 7, 7, 1.0 / self.cfg.FEAT_STRIDE)
        return flat.reshape(-1, flat.shape[-1])

    def _proposals(self, rpn_score, rpn_bbox, im_info, budgets):
        """Proposals from detached RPN outputs at TEST or TRAIN budgets."""
        with torch.no_grad():
            return proposal_layer(
                rpn_softmax(rpn_score.detach(), self.num_anchors),
                rpn_bbox.detach(), im_info, self.anchors,
                num_anchors=self.num_anchors,
                pre_nms_top_n=budgets.RPN_PRE_NMS_TOP_N,
                post_nms_top_n=budgets.RPN_POST_NMS_TOP_N,
                nms_thresh=budgets.RPN_NMS_THRESH,
                min_size=float(budgets.RPN_MIN_SIZE), nms=self._nms)

    @torch.inference_mode()
    def inference_step(self, data, im_info):
        """data [B, H, W, 3] f32 canvas blob, im_info [B, 4] (h, w, scale, _)
        -> (rois5 [B*P, 5], valid [B*P], cls_score, cls_prob, bbox_pred), all
        on the engine's device."""
        self.model.eval()
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        im_info = torch.as_tensor(im_info, dtype=torch.float32,
                                  device=self.device)
        feat, rpn_score, rpn_bbox = self.model.apply_trunk(
            data, plain_ops=self.plain_ops)
        props = self._proposals(rpn_score, rpn_bbox, im_info, self.cfg.TEST)
        pooled = self._pool_for_head(feat, props.boxes)
        cls_score, bbox_pred = self.model.apply_head(pooled)
        cls_prob = torch.softmax(cls_score, dim=-1)
        return (proposals_to_rois(props), props.valid.reshape(-1), cls_score,
                cls_prob, bbox_pred)

    # ------------------------------------------------------------------ #
    def _mil(self, cls_ws, valid, im_info, step):
        """MIL bag loss over weak images' instance logits [n*P, C]."""
        cfg = self.cfg
        n = im_info.shape[0]
        bag_labels = im_info[:, 3].to(torch.int64)
        bag_logits = get_bag_logits(
            cls_ws.reshape(n, cfg.TRAIN.RPN_POST_NMS_TOP_N, -1), valid,
            bag_labels, self.selector_pair)
        scale = (L.mil_adaptive_scale(step)
                 if cfg.TRAIN.WS_LOSS_USE_ADAPTIVE_SCALE_FACTOR
                 else cfg.TRAIN.WS_LOSS_SCALE_FACTOR)
        return L.mil_class_loss(bag_logits, bag_labels, cfg.TRAIN.WS_MAL_PCT,
                                scale)

    def forward_train(self, batch: dict, step: int = 0,
                      draws: StepDraws = None):
        """The combined step's forward and losses, without the update.
        -> (loss to differentiate, StepLosses, details dict with the RPN
        class scores ``rpn_cls_score``, ``anchor_targets``, ``props`` and
        ``samples``)."""
        cfg = self.cfg
        n_s, n_ws = self.n_s, self.n_ws
        draws = draws or StepDraws()
        gen = self.generator
        b = _batch_tensors(batch, self.device)
        self.model.train()
        feat, rpn_score, rpn_bbox = self._train_trunk(b["data"])
        at = anchor_target_layer_joint(
            b["gt_boxes"], b["num_gt_boxes"], b["im_info"], self.anchors,
            n_s, uniforms=draws.anchor_u, generator=gen, **self._at_kwargs)
        props = self._proposals(rpn_score, rpn_bbox, b["im_info"], cfg.TRAIN)
        samples = proposal_target_layer(
            props.boxes[:n_s], props.valid[:n_s], b["gt_boxes"][:n_s],
            b["num_gt_boxes"][:n_s], uniforms=draws.roi_u, generator=gen,
            include_gt=True, **self._pt_kwargs)
        # the head runs on the two groups separately: it is norm-free, so
        # this equals one call on their concatenation without building the
        # [n_s*R + n_ws*P, 25088] operand
        cls_sup, bbox_sup = self.model.apply_head(
            self._pool_for_head(feat[:n_s], samples.rois), draws.keep_sup,
            gen)

        a = self.num_anchors
        r = cfg.TRAIN.BATCH_SIZE
        labels = samples.labels.reshape(-1)
        rpn_cls = L.rpn_class_loss(rpn_score, at.labels, a)
        rpn_box = L.rpn_box_loss(rpn_bbox, at.bbox_targets,
                                 at.inside_weights, at.outside_weights, n_s,
                                 a)
        rcnn_cls = L.rcnn_class_loss(cls_sup, labels)
        rcnn_box = L.rcnn_box_loss(
            bbox_sup, samples.bbox_targets.reshape(n_s * r, -1),
            samples.inside_weights.reshape(n_s * r, -1),
            samples.outside_weights.reshape(n_s * r, -1), labels)
        if n_ws:
            cls_ws, _ = self.model.apply_head(
                self._pool_for_head(feat[n_s:], props.boxes[n_s:]),
                draws.keep_ws, gen)
            mil = self._mil(cls_ws, props.valid[n_s:], b["im_info"][n_s:],
                            step)
        else:
            mil = torch.zeros((), device=self.device)
        total = rpn_cls + rpn_box + rcnn_cls + rcnn_box
        wd = L.weight_decay_loss(self.model, cfg.TRAIN.WEIGHT_DECAY)
        losses = StepLosses(total, rpn_cls, rpn_box, rcnn_cls, rcnn_box, mil)
        return total + wd + mil, losses, {
            "rpn_cls_score": rpn_score, "anchor_targets": at, "props": props,
            "samples": samples}

    def train_step(self, batch: dict, lr: float = None, step: int = 0,
                   draws: StepDraws = None) -> StepLosses:
        """One combined update (train_bus.py:595-764) on ``batch`` (the
        ``get_minibatch_joint`` layout, supervised images first).  The
        gradients of the supervised loss + weight decay and of the MIL loss
        add, as the reference's do, so one backward of their sum serves.
        -> the step's losses (detached, on the device)."""
        loss, losses, _ = self.forward_train(batch, step, draws)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step(self.cfg.TRAIN.LEARNING_RATE if lr is None else lr)
        return StepLosses(*(t.detach() for t in losses))

    def train_step_mil(self, batch: dict, lr: float = None, step: int = 0,
                       draws: StepDraws = None) -> torch.Tensor:
        """One weakly-supervised update of the alternating regime: only the
        MIL bag loss over ``batch``'s images, all weak
        (train_bus.py:298-301,368-394).  -> the MIL loss."""
        cfg = self.cfg
        draws = draws or StepDraws()
        b = _batch_tensors(batch, self.device)
        self.model.train()
        feat, rpn_score, rpn_bbox = self._train_trunk(b["data"])
        props = self._proposals(rpn_score, rpn_bbox, b["im_info"], cfg.TRAIN)
        cls_ws, _ = self.model.apply_head(
            self._pool_for_head(feat, props.boxes), draws.keep_ws,
            self.generator)
        mil = self._mil(cls_ws, props.valid, b["im_info"], step)
        self.opt.zero_grad()
        mil.backward()
        self.opt.step(cfg.TRAIN.LEARNING_RATE if lr is None else lr)
        return mil.detach()
