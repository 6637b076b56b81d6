"""The serving and training steps (counterpart of
``wssdl_bus_tpu/train/engine.py``).

``Engine.inference_step`` is the test-graph forward of
``Engine._inference_impl`` (``wssdl_bus_tpu/train/engine.py:638-661``): the
trunk and RPN, ``rpn_softmax``, the proposal layer with TEST budgets (greedy
NMS in the CUDA kernel ``csrc/nms.cu``), ROI max-pool (``csrc/roi_pool.cu``:
written as the flat fc6 operand for the VGG16 head, ``roi_pool_fc``; as
[N, 7, 7, C] for the ResNet head, ``roi_pool_grouped``), the head and a
softmax.

``Engine.train_step`` is the combined step (``_train_step_impl``, the
reference's ``train_model``, train_bus.py:595-764): anchor targets for the
supervised images, proposals with TRAIN budgets, ROI sampling, the pool and
the head (with dropout) applied to the supervised ROIs and to the weak
images' proposals separately (VGG16: its head is norm-free) or once on
their concatenation (ResNet: the head's BatchRenorm takes its batch
statistics over every ROI, ``wssdl_bus_tpu/train/engine.py:371-382``), the
four supervised losses, weight decay and the MIL bag loss, one backward and
one optimizer update; BatchRenorm's running statistics update in the
forward.  The pool's backward is a CUDA kernel (``wssdl_roi_pool_bwd``,
``ops/roi_pool_cuda.py``).  ``Engine.train_step_mil`` is the alternating
regime's weak step (``_train_step_mil_impl``): the MIL loss alone over weak
images, with batch-statistics normalisation and the running statistics left
as they are (``models/layers.py:running_stats_frozen``).  Both training
steps run under the model's activation remat (``FasterRCNN.remat``; the
JAX package's default for ResNet) with the same numbers as without it: the
recompute in the backward replays the running statistics the forward read
and updates none, so the MIL step's statistics stay frozen although its
context has exited by then, and the VGG16 head's dropout masks come from
the engine's generator before the head's checkpoint.
``Engine.inference_step_quant`` is the serving step with the int8 model of
``Engine.quantize_for_serving`` (``models/quantize.py``; the JAX
package's ``_inference_quant_impl``): the int8 trunk (the CUDA kernel
``csrc/int8_conv.cu``) and, for ResNet, the int8 group3 head; the RPN
convs and the dense layers are the model's own, and all detection
geometry stays f32.
``Engine.eval_step`` is the in-training evaluation forward (``eval_step``):
TEST proposal budgets, every image supervised, no GT appended to the ROI
candidates, the head in eval mode, and per-image losses.

A training batch carries either the host-prepared ``data`` blob or the
device-prep staging blobs ``raw`` (uint8) + ``prep``, which the step
finishes on the device (``ops/device_prep.py``), as the JAX package's
``Engine._batch_data`` does.

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
from wssdl_bus_tpu_torch.models.layers import running_stats_frozen
from wssdl_bus_tpu_torch.ops.anchor_target import anchor_target_layer_joint
from wssdl_bus_tpu_torch.ops.anchors import shifted_anchors
from wssdl_bus_tpu_torch.ops.device_prep import (net_divisor_for,
                                                 prep_device_batch)
from wssdl_bus_tpu_torch.ops.nms import nms_mask
from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
from wssdl_bus_tpu_torch.ops.proposal import proposal_layer, proposals_to_rois
from wssdl_bus_tpu_torch.ops.proposal_target import proposal_target_layer
from wssdl_bus_tpu_torch.ops.roi_pool import rois_with_batch_index
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                   roi_pool_fc_plain,
                                                   roi_pool_grouped,
                                                   roi_pool_grouped_plain)
from wssdl_bus_tpu_torch.train import losses as L
from wssdl_bus_tpu_torch.utils import resolve_device
from wssdl_bus_tpu_torch.utils.logging import span


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
    optax does (``torch.optim.Adam(amsgrad=True)`` does not).

    ``params``: (name, tensor) pairs; the state (:meth:`state_dict`) is
    keyed by these names, so a snapshot restores onto a fresh model."""

    def __init__(self, name: str, params, momentum: float = 0.9):
        if name not in ("adam", "amsgrad", "sgd"):
            raise NotImplementedError(name)
        self.name = name
        params = list(params)
        self.names = [n for n, _ in params]
        self.params = [p for _, p in params]
        self.b1, self.b2, self.eps, self.momentum = 0.9, 0.999, 0.1, momentum
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        self.mu = zeros()
        self.nu = zeros() if name != "sgd" else None
        self.nu_max = zeros() if name == "amsgrad" else None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """{"name", "count", "mu", "nu", "nu_max"}, each moment a dict
        parameter name -> tensor (None where the optimizer has none)."""
        def named(ts):
            return None if ts is None else dict(zip(self.names, ts))
        return {"name": self.name, "count": self.count,
                "mu": named(self.mu), "nu": named(self.nu),
                "nu_max": named(self.nu_max)}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` output (or ``models/convert.py:
        opt_state_from_jax``'s); every parameter of this optimizer must be
        named in it (names it does not hold are ignored)."""
        if state["name"] != self.name:
            raise ValueError(f"optimizer state is {state['name']!r}, this "
                             f"optimizer is {self.name!r}")
        self.count = int(state["count"])
        for field in ("mu", "nu", "nu_max"):
            mine = getattr(self, field)
            if mine is None:
                continue
            saved = state[field]
            missing = [n for n in self.names if n not in saved]
            if missing:
                raise KeyError(f"optimizer state lacks {field} of "
                               f"{missing[:3]}")
            for k, (n, p) in enumerate(zip(self.names, self.params)):
                mine[k] = torch.as_tensor(saved[n]).to(
                    device=p.device, dtype=p.dtype).clone()

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
                     [(n, p) for n, p in model.named_parameters()
                      if p.requires_grad],
                     momentum=cfg.TRAIN.MOMENTUM)


def _batch_tensors(batch: dict, device) -> dict:
    """A minibatch dict (numpy or tensors) -> tensors on ``device``; the
    device-prep ``raw`` blob travels as uint8."""
    out = {}
    if "raw" in batch:
        out["raw"] = torch.as_tensor(batch["raw"], dtype=torch.uint8,
                                     device=device)
        out["prep"] = torch.as_tensor(batch["prep"], dtype=torch.float32,
                                      device=device)
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
    (``ops/nms.py:nms_mask``, ``ops/roi_pool_cuda.py:roi_pool_fc_plain`` /
    ``roi_pool_grouped_plain`` with their plain backward, and for the
    opt-in stem paths
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
        if model.backbone == "VGGnet":
            self._pool = roi_pool_fc_plain if plain_ops else roi_pool_fc
        else:
            self._pool = (roi_pool_grouped_plain if plain_ops
                          else roi_pool_grouped)

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

    def full_state_dict(self) -> dict:
        """The model's whole state dict (a snapshot's ``variables``)."""
        return self.model.state_dict()

    def full_opt_state(self) -> dict:
        """The optimizer's whole state (a snapshot's ``opt_state``)."""
        return self.opt.state_dict()

    def load_full_state(self, variables: dict) -> None:
        """Load a whole state dict (a snapshot's ``variables``)."""
        self.model.load_state_dict(variables)

    def load_opt_state(self, state: dict) -> None:
        self.opt.load_state_dict(state)

    def _batch_data(self, b: dict) -> torch.Tensor:
        """The [B, H, W, 3] image blob: as shipped (``data``), or finished
        on the device from the uint8 staging blobs (``raw`` + ``prep``,
        ``ops/device_prep.py``)."""
        if "data" in b:
            return b["data"]
        return prep_device_batch(
            b["raw"], b["prep"], self.canvas_hw,
            self.cfg.PIXEL_MEAN / 255.0,
            net_divisor_for(self.model.backbone, self.cfg.PIXEL_STD))

    def _train_trunk(self, data):
        """The trunk in training mode: the stem kernels may run only while
        conv1/conv2 are frozen (``models/detector.py:stem_is_frozen``)."""
        return self.model.apply_trunk(
            data, stem_frozen=stem_is_frozen(self.model),
            plain_ops=self.plain_ops)

    def _pool_for_head(self, feat, boxes):
        """ROI-pool ``boxes`` [B, P, 4] against ``feat`` [B, h, w, C] into the
        head's operand: the flat fc6 operand [B*P, 7*7*C] (VGG16) or
        [B*P, 7, 7, C] (ResNet)."""
        out = self._pool(feat, boxes, 7, 7, 1.0 / self.cfg.FEAT_STRIDE)
        return out.reshape((-1,) + tuple(out.shape[2:]))

    def _apply_head(self, pooled, keep=None, generator=None):
        """The head over the pooled operand: the hook
        ``parallel/engine.py:ParallelEngine`` replaces with the
        tensor-parallel head (the JAX package's ``Engine._apply_head``)."""
        return self.model.apply_head(pooled, keep, generator)

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
        cls_score, bbox_pred = self._apply_head(pooled)
        cls_prob = torch.softmax(cls_score, dim=-1)
        return (proposals_to_rois(props), props.valid.reshape(-1), cls_score,
                cls_prob, bbox_pred)

    # ------------------------------------------------------------------ #
    # int8 serving (models/quantize.py)
    # ------------------------------------------------------------------ #
    def quantize_for_serving(self, calib_batches):
        """Post-training int8 quantization for serving -> the quantized
        tree :meth:`inference_step_quant` takes, on the engine's device.

        ``calib_batches`` iterates [B, H, W, 3] serving blobs for the
        activation ranges.  VGG16 quantizes the trunk (its fc head stays
        the model's); ResNet the trunk and the group3 head (norm None /
        "BN": GroupNorm is data-dependent at serving time and raises
        ``NotImplementedError``).  ResNet calibration pools with the
        engine's pool (kernel #3, or its plain version for ``plain_ops``)
        at the head's geometry."""
        from wssdl_bus_tpu_torch.models import quantize as Q

        if self.model.backbone == "VGGnet":
            scales = Q.calibrate_vgg_trunk(self.model, calib_batches)
            return Q.quantize_vgg_trunk(self.model, scales, self.device)
        scales = Q.calibrate_resnet(
            self.model, calib_batches,
            spatial_scale=1.0 / self.cfg.FEAT_STRIDE, pool=self._pool)
        return Q.quantize_resnet(self.model, scales, self.device)

    @torch.inference_mode()
    def inference_step_quant(self, qtrunk: dict, data, im_info):
        """:meth:`inference_step` with the int8 model ``qtrunk``: the same
        outputs (rois5, valid, cls_score, cls_prob, bbox_pred).  The int8
        convs run in the kernel (their plain version for ``plain_ops`` or on
        the CPU); the RPN convs and the dense layers are the model's own:
        the RPN convs and ResNet's dense layers in f32, VGG16's fc head in
        the model's compute dtype, as in the JAX package."""
        from wssdl_bus_tpu_torch.models import quantize as Q

        self.model.eval()
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        im_info = torch.as_tensor(im_info, dtype=torch.float32,
                                  device=self.device)
        m, plain = self.model, self.plain_ops
        trunk_apply = (Q.quant_trunk_apply if m.backbone == "VGGnet" else
                       Q.quant_resnet_trunk_apply)
        feat, rpn_score, rpn_bbox = trunk_apply(m, qtrunk, data, plain)
        props = self._proposals(rpn_score, rpn_bbox, im_info, self.cfg.TEST)
        pooled = self._pool_for_head(feat, props.boxes)
        if m.backbone == "VGGnet":
            cls_score, bbox_pred = m.apply_head(pooled)
        else:
            cls_score, bbox_pred = Q.quant_resnet_head_apply(
                m, qtrunk, pooled, plain)
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
        with span("upload"):
            b = _batch_tensors(batch, self.device)
        self.model.train()
        with span("prep"):
            data = self._batch_data(b)
        with span("trunk"):
            feat, rpn_score, rpn_bbox = self._train_trunk(data)
        with span("anchor_targets"):
            at = anchor_target_layer_joint(
                b["gt_boxes"], b["num_gt_boxes"], b["im_info"], self.anchors,
                n_s, uniforms=draws.anchor_u, generator=gen,
                **self._at_kwargs)
        with span("proposals"):
            props = self._proposals(rpn_score, rpn_bbox, b["im_info"],
                                    cfg.TRAIN)
        with span("roi_targets"):
            samples = proposal_target_layer(
                props.boxes[:n_s], props.valid[:n_s], b["gt_boxes"][:n_s],
                b["num_gt_boxes"][:n_s], uniforms=draws.roi_u,
                generator=gen, include_gt=True, **self._pt_kwargs)
        a = self.num_anchors
        r = cfg.TRAIN.BATCH_SIZE
        with span("pool"):
            sup_pooled = self._pool_for_head(feat[:n_s], samples.rois)
            ws_pooled = (self._pool_for_head(feat[n_s:], props.boxes[n_s:])
                         if n_ws else None)
        cls_ws = None
        with span("head"):
            if self.model.backbone == "VGGnet":
                # the head runs on the two groups separately: it is
                # norm-free, so this equals one call on their concatenation
                # without building the [n_s*R + n_ws*P, 25088] operand
                cls_sup, bbox_sup = self._apply_head(sup_pooled,
                                                     draws.keep_sup, gen)
                if n_ws:
                    cls_ws, _ = self._apply_head(ws_pooled, draws.keep_ws,
                                                 gen)
            else:
                # one call on the concatenation: BatchRenorm's batch
                # statistics cover every ROI of both groups, the weak
                # group's invalid proposal slots included (its props.boxes
                # hold them)
                cls_all, bbox_all = self._apply_head(
                    sup_pooled if ws_pooled is None
                    else torch.cat([sup_pooled, ws_pooled]))
                cls_sup, bbox_sup = cls_all[:n_s * r], bbox_all[:n_s * r]
                cls_ws = cls_all[n_s * r:]
        with span("losses"):
            labels = samples.labels.reshape(-1)
            rpn_cls = L.rpn_class_loss(rpn_score, at.labels, a)
            rpn_box = L.rpn_box_loss(rpn_bbox, at.bbox_targets,
                                     at.inside_weights, at.outside_weights,
                                     n_s, a)
            rcnn_cls = L.rcnn_class_loss(cls_sup, labels)
            rcnn_box = L.rcnn_box_loss(
                bbox_sup, samples.bbox_targets.reshape(n_s * r, -1),
                samples.inside_weights.reshape(n_s * r, -1),
                samples.outside_weights.reshape(n_s * r, -1), labels)
            if n_ws:
                mil = self._mil(cls_ws, props.valid[n_s:],
                                b["im_info"][n_s:], step)
            else:
                mil = torch.zeros((), device=self.device)
            total = rpn_cls + rpn_box + rcnn_cls + rcnn_box
            wd = L.weight_decay_loss(self.model, cfg.TRAIN.WEIGHT_DECAY)
            loss = total + wd + mil
        losses = StepLosses(total, rpn_cls, rpn_box, rcnn_cls, rcnn_box, mil)
        return loss, losses, {
            "rpn_cls_score": rpn_score, "anchor_targets": at, "props": props,
            "samples": samples}

    def train_step(self, batch: dict, lr: float = None, step: int = 0,
                   draws: StepDraws = None) -> StepLosses:
        """One combined update (train_bus.py:595-764) on ``batch`` (the
        ``get_minibatch_joint`` layout, supervised images first).  The
        gradients of the supervised loss + weight decay and of the MIL loss
        add, as the reference's do, so one backward of their sum serves.
        -> the step's losses (detached, on the device).  Each part of the
        step is a span (``utils/logging.py:span``) inside ``train_step``:
        ``forward_train``'s nine, ``backward`` (with each block's
        ``recompute`` under remat) and ``optimizer`` (the moments' reset
        and the update)."""
        with span("train_step"):
            loss, losses, _ = self.forward_train(batch, step, draws)
            with span("optimizer"):
                self.opt.zero_grad()
            with span("backward"):
                loss.backward()
            with span("optimizer"):
                self.opt.step(self.cfg.TRAIN.LEARNING_RATE if lr is None
                              else lr)
            return StepLosses(*(t.detach() for t in losses))

    def _mil_loss(self, batch: dict, step: int, draws: StepDraws):
        """The weak step's forward: the MIL bag loss over ``batch``'s images,
        all weak, with the running statistics frozen."""
        draws = draws or StepDraws()
        b = _batch_tensors(batch, self.device)
        self.model.train()
        with running_stats_frozen(self.model):
            feat, rpn_score, rpn_bbox = self._train_trunk(
                self._batch_data(b))
            props = self._proposals(rpn_score, rpn_bbox, b["im_info"],
                                    self.cfg.TRAIN)
            cls_ws, _ = self._apply_head(
                self._pool_for_head(feat, props.boxes), draws.keep_ws,
                self.generator)
        return self._mil(cls_ws, props.valid, b["im_info"], step)

    def train_step_mil(self, batch: dict, lr: float = None, step: int = 0,
                       draws: StepDraws = None) -> torch.Tensor:
        """One weakly-supervised update of the alternating regime: only the
        MIL bag loss over ``batch``'s images, all weak
        (train_bus.py:298-301,368-394).  BatchRenorm normalises with the
        batch's statistics and leaves its running statistics unchanged, as
        the JAX package discards them here.  -> the MIL loss."""
        mil = self._mil_loss(batch, step, draws)
        self.opt.zero_grad()
        mil.backward()
        self.opt.step(self.cfg.TRAIN.LEARNING_RATE if lr is None else lr)
        return mil.detach()

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def eval_step(self, batch: dict, step: int = 0, draws: StepDraws = None):
        """The in-training evaluation forward (the JAX package's
        ``eval_step``, the reference's train_bus.py:792-892): the training
        pipeline with is_training=False.  Every image is supervised; TEST
        proposal budgets; ROIs sampled from the proposals with no GT
        appended; the head in eval mode (no dropout).  Losses are PER IMAGE
        (each ``StepLosses`` field [B]), the MIL bag CE over each image's
        sampled ROIs with the adaptive scale at ``step`` included.
        -> (losses, rois5 [B*R, 5], cls_prob [B*R, C], bbox_pred
        [B*R, 4C], labels [B*R]; -1 marks an unfilled sampler slot)."""
        cfg = self.cfg
        draws = draws or StepDraws()
        gen = self.generator
        b = _batch_tensors(batch, self.device)
        n = b["im_info"].shape[0]
        self.model.eval()
        feat, rpn_score, rpn_bbox = self.model.apply_trunk(
            self._batch_data(b), plain_ops=self.plain_ops)
        at = anchor_target_layer_joint(
            b["gt_boxes"], b["num_gt_boxes"], b["im_info"], self.anchors, n,
            uniforms=draws.anchor_u, generator=gen, **self._at_kwargs)
        props = self._proposals(rpn_score, rpn_bbox, b["im_info"], cfg.TEST)
        samples = proposal_target_layer(
            props.boxes, props.valid, b["gt_boxes"], b["num_gt_boxes"],
            uniforms=draws.roi_u, generator=gen, include_gt=False,
            **self._pt_kwargs)
        cls_score, bbox_pred = self._apply_head(
            self._pool_for_head(feat, samples.rois))

        a, r = self.num_anchors, cfg.TRAIN.BATCH_SIZE
        mil_scale = (L.mil_adaptive_scale(step)
                     if cfg.TRAIN.WS_LOSS_USE_ADAPTIVE_SCALE_FACTOR
                     else cfg.TRAIN.WS_LOSS_SCALE_FACTOR)
        bag_labels = b["im_info"][:, 3].to(torch.int64)
        per = []
        for i in range(n):
            im = slice(i, i + 1)
            sl = slice(i * r, (i + 1) * r)
            rpn_cls = L.rpn_class_loss(rpn_score[im], at.labels[im], a)
            rpn_box = L.rpn_box_loss(
                rpn_bbox[im], at.bbox_targets[im], at.inside_weights[im],
                at.outside_weights[im], 1, a)
            labels_i = samples.labels[i].reshape(-1)
            rcnn_cls = L.rcnn_class_loss(cls_score[sl], labels_i)
            rcnn_box = L.rcnn_box_loss(
                bbox_pred[sl], samples.bbox_targets[i].reshape(r, -1),
                samples.inside_weights[i].reshape(r, -1),
                samples.outside_weights[i].reshape(r, -1), labels_i)
            bag = get_bag_logits(cls_score[sl].reshape(1, r, -1),
                                 (labels_i >= 0)[None], bag_labels[im],
                                 self.selector_pair)
            mil = L.mil_class_loss(bag, bag_labels[im], cfg.TRAIN.WS_MAL_PCT,
                                   mil_scale)
            per.append((rpn_cls + rpn_box + rcnn_cls + rcnn_box, rpn_cls,
                        rpn_box, rcnn_cls, rcnn_box, mil))
        losses = StepLosses(*(torch.stack([p[f] for p in per])
                              for f in range(len(StepLosses._fields))))
        return (losses, rois_with_batch_index(samples.rois),
                torch.softmax(cls_score, dim=-1), bbox_pred,
                samples.labels.reshape(-1))
