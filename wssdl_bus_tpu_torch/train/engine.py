"""The serving step (counterpart of ``wssdl_bus_tpu/train/engine.py``).

``Engine.inference_step`` is the test-graph forward of
``Engine._inference_impl`` (``wssdl_bus_tpu/train/engine.py:638-661``): the
VGG16 trunk and RPN, ``rpn_softmax``, the proposal layer with TEST budgets
(greedy NMS in the CUDA kernel ``csrc/nms.cu``), ROI max-pool written as the
flat fc6 operand (``csrc/roi_pool.cu``), the fc head and a softmax.  The
JAX engine's ``_rois5`` is ``ops/proposal.py:proposals_to_rois`` here.  The
training steps come with the training slice.
"""

from __future__ import annotations

import torch

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models.detector import FasterRCNN, rpn_softmax
from wssdl_bus_tpu_torch.ops.anchors import shifted_anchors
from wssdl_bus_tpu_torch.ops.nms import nms_mask
from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
from wssdl_bus_tpu_torch.ops.proposal import proposal_layer, proposals_to_rois
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_fc, roi_pool_fc_plain
from wssdl_bus_tpu_torch.utils import resolve_device


class Engine:
    """One model + config + static canvas on one device.

    ``device``: CUDA unless named (raises without a card).  ``plain_ops``
    swaps the two kernels for their plain PyTorch versions
    (``ops/nms.py:nms_mask``, ``ops/roi_pool.py:roi_pool``) on whatever the
    device is: the yardstick ``chip_smoke.py`` holds the served path
    against.  The model is moved to the device and put in eval mode."""

    def __init__(self, model: FasterRCNN, cfg: Config, canvas_hw,
                 device=None, plain_ops: bool = False):
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
        self._nms = nms_mask if plain_ops else nms_keep
        self._pool = roi_pool_fc_plain if plain_ops else roi_pool_fc

    def _pool_for_head(self, feat, boxes):
        """ROI-pool ``boxes`` [B, P, 4] against ``feat`` [B, h, w, C] into the
        flat fc6 operand [B*P, 7*7*C]."""
        flat = self._pool(feat, boxes, 7, 7, 1.0 / self.cfg.FEAT_STRIDE)
        return flat.reshape(-1, flat.shape[-1])

    @torch.inference_mode()
    def inference_step(self, data, im_info):
        """data [B, H, W, 3] f32 canvas blob, im_info [B, 4] (h, w, scale, _)
        -> (rois5 [B*P, 5], valid [B*P], cls_score, cls_prob, bbox_pred), all
        on the engine's device."""
        cfg = self.cfg
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        im_info = torch.as_tensor(im_info, dtype=torch.float32,
                                  device=self.device)
        feat, rpn_score, rpn_bbox = self.model.apply_trunk(data)
        rpn_prob = rpn_softmax(rpn_score, self.num_anchors)
        props = proposal_layer(
            rpn_prob, rpn_bbox, im_info, self.anchors,
            num_anchors=self.num_anchors,
            pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=cfg.TEST.RPN_POST_NMS_TOP_N,
            nms_thresh=cfg.TEST.RPN_NMS_THRESH,
            min_size=float(cfg.TEST.RPN_MIN_SIZE), nms=self._nms)
        pooled = self._pool_for_head(feat, props.boxes)
        cls_score, bbox_pred = self.model.apply_head(pooled)
        cls_prob = torch.softmax(cls_score, dim=-1)
        return (proposals_to_rois(props), props.valid.reshape(-1), cls_score,
                cls_prob, bbox_pred)
