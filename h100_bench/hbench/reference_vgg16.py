"""Plain PyTorch reference of the joint (supervised + weak) training step of
VGG16 Faster R-CNN, the detector's default network.

Written from the published descriptions (Simonyan & Zisserman,
arXiv:1409.1556, configuration D, for the trunk; Ren et al.,
arXiv:1506.01497, for the detector) and the original detector's graph
(``VGGnet_train_bus.py``): thirteen 3x3 convolutions with bias and ReLU in
five stages, a 2x2 max-pool after each of the first four, conv1-conv2
frozen; the RPN (a 3x3 conv of 512 with bias and ReLU, then 1x1 convs to
2A class logits and 4A box deltas); ROI max pooling to 7x7, flattened in
(row, column, channel) order into fc6's operand; fc6(512) -> dropout 0.5
-> fc7(512) -> dropout 0.5 -> cls_score(3) / bbox_pred(12).  In f32 with
no kernel, cache or fusion, TF32 off (:func:`train_step` turns it off for
its own work); it imports nothing of the program under test.  The
network-independent pieces (anchors, proposals and NMS, anchor targets,
ROI sampling, ROI pooling, the losses, MIL's schedule, Adam) are those of
the ResNet reference (``reference.py``).

Departures from ``VGGnet_train_bus.py``:

* the dropout masks are handed in (one bool [N, 512] per dropout and
  group), not drawn, so that the program under test and this reference
  drop the same units; a kept unit is scaled by 2 (1 / keep probability);
* the head runs on the supervised ROIs and on the weak images' proposals
  separately (it has no batch statistics, so this equals one call on
  their concatenation);
* the proposals and the MIL instance of each bag follow the program's RPN
  outputs and weak class logits (their order, NMS and argmax are discrete,
  and rounding would otherwise pick others), as in the ResNet reference;
* the weight decay sums every ``.weight``, the frozen stem's included (a
  constant, as the program's ``weight_decay_loss``), and biases none.

Parameters live in one flat dict keyed by the dotted names of
:func:`param_spec` (the detector's state-dict names).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import reference as R

# (name, out channels) of each stage, a 2x2 max-pool after all but the last
STAGES = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)
FROZEN = tuple(n for stage in STAGES[:2] for n, _ in stage)
FC = 512
POOLED = 7
KEEP_PROB = 0.5
_BB = "trunk.backbone"


def param_spec(num_classes: int = 3):
    """[(name, shape)] of every parameter."""
    spec, c = [], 3

    def conv(p, cin, cout, k):
        spec.extend([(f"{p}.conv.weight", (cout, cin, k, k)),
                     (f"{p}.conv.bias", (cout,))])

    def dense(p, cin, cout):
        spec.extend([(f"{p}.dense.weight", (cout, cin)),
                     (f"{p}.dense.bias", (cout,))])

    for stage in STAGES:
        for name, cout in stage:
            conv(f"{_BB}.{name}", c, cout, 3)
            c = cout
    conv("trunk.rpn_conv", c, 512, 3)
    conv("trunk.rpn_cls_score", 512, 2 * R.NUM_ANCHORS, 1)
    conv("trunk.rpn_bbox_pred", 512, 4 * R.NUM_ANCHORS, 1)
    dense("head.fc6", POOLED * POOLED * c, FC)
    dense("head.fc7", FC, FC)
    dense("head.cls_score", FC, num_classes)
    dense("head.bbox_pred", FC, 4 * num_classes)
    return spec


def trainable(name: str) -> bool:
    """Whether the optimizer updates ``name``: all but conv1-conv2."""
    return not name.startswith(tuple(f"{_BB}.{n}." for n in FROZEN))


# --------------------------------------------------------------------- #
# the network
# --------------------------------------------------------------------- #
def conv(P, p, x, relu=True):
    """A convolution with bias, stride 1, "SAME" padding (k // 2 on each
    side for the odd kernels here), then ReLU."""
    w = P[f"{p}.conv.weight"]
    y = F.conv2d(x, w, P[f"{p}.conv.bias"], padding=w.shape[-1] // 2)
    return F.relu(y) if relu else y


def trunk(P, images_nhwc):
    """[B, H, W, 3] -> (feat [B, H/16, W/16, 512], RPN class scores,
    RPN deltas), each NHWC; every pool floors."""
    x = images_nhwc.permute(0, 3, 1, 2).contiguous()
    for s, stage in enumerate(STAGES):
        for name, _ in stage:
            x = conv(P, f"{_BB}.{name}", x)
        if s < len(STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    rpn = conv(P, "trunk.rpn_conv", x)
    score = conv(P, "trunk.rpn_cls_score", rpn, relu=False)
    deltas = conv(P, "trunk.rpn_bbox_pred", rpn, relu=False)
    return tuple(t.permute(0, 2, 3, 1) for t in (x, score, deltas))


def _dense(P, p, x):
    return x @ P[f"{p}.dense.weight"].t() + P[f"{p}.dense.bias"]


def head(P, pooled_nhwc, keep):
    """[N, 7, 7, 512] pooled ROIs and the (fc6, fc7) keep masks [N, 512]
    -> (class logits [N, C], deltas [N, 4C])."""
    x = pooled_nhwc.reshape(pooled_nhwc.shape[0], -1)
    for name, k in zip(("head.fc6", "head.fc7"), keep):
        x = F.relu(_dense(P, name, x))
        x = torch.where(k, x / KEEP_PROB, torch.zeros_like(x))
    return _dense(P, "head.cls_score", x), _dense(P, "head.bbox_pred", x)


# --------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------- #
def train_step(P, batch, draws, keep, program_rpn, program_cls_ws, step,
               cfg):
    """One joint step's forward and gradients, with TF32 off.

    ``batch``: the reference's own minibatch (images [B, H, W, 3], gt
    [B, G, 5], num_gt [B], im_info [B, 4]), supervised images first.
    ``draws``: (anchor uniforms [n_s, 2, K], ROI uniforms [n_s, 2, n]).
    ``keep``: ((fc6, fc7) masks of the supervised ROIs, the same of the
    weak images' proposals).  ``program_rpn``: the program's RPN (scores,
    deltas) of this step, from which this reference's own proposal layer
    picks the proposals; ``program_cls_ws``: the program's weak class
    logits, from which the MIL instance of each bag is picked likewise.
    -> (losses dict, grads dict of the trainable leaves, proposals, the
    outputs: RPN scores and deltas, the weak ROIs' class logits)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _train_step(P, batch, draws, keep, program_rpn,
                           program_cls_ws, step, cfg)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


def _train_step(P, batch, draws, keep, program_rpn, program_cls_ws, step,
                cfg):
    n_s, n = cfg["n_s"], batch["im_info"].shape[0]
    train_names = [k for k in P if trainable(k)]
    leaves = {k: P[k].detach().requires_grad_(trainable(k)) for k in P}
    feat, score, deltas = trunk(leaves, batch["data"])
    fh, fw = feat.shape[1:3]
    anchors = torch.as_tensor(R.all_anchors(fh, fw), device=feat.device)
    at = [R.anchor_targets(batch["gt"][i], batch["num_gt"][i],
                           batch["im_info"][i], anchors, draws[0][i, 0],
                           draws[0][i, 1]) for i in range(n_s)]
    lab, tgt, iw, ow = (torch.stack(t) for t in zip(*at))
    with torch.no_grad():
        props, pvalid = R.proposals(program_rpn[0], program_rpn[1],
                                    batch["im_info"], anchors, cfg["pre_n"],
                                    cfg["post_n"], cfg["nms"],
                                    cfg["min_size"])
    rs = [R.sample_rois(props[i], pvalid[i], batch["gt"][i],
                        batch["num_gt"][i], draws[1][i, 0], draws[1][i, 1],
                        per_image=cfg["rois_per_image"]) for i in range(n_s)]
    rois, labels, btgt, biw, bow = (torch.stack(t) for t in zip(*rs))
    r = rois.shape[1]
    cls, box = head(leaves, R.roi_pool(feat[:n_s], rois), keep[0])
    cls_ws, _ = head(leaves, R.roi_pool(feat[n_s:], props[n_s:]), keep[1])
    rpn_cls, rpn_box = R.rpn_losses(score, deltas, torch.cat(
        [lab, lab.new_full((n - n_s, lab.shape[1]), -1)]), tgt, iw, ow, n_s)
    flat_labels = labels.reshape(-1)
    rcnn_cls = R._masked_mean(R._ce(cls, flat_labels), flat_labels >= 0)
    rcnn_box = R._masked_mean(
        (bow.reshape(n_s * r, -1) * biw.reshape(n_s * r, -1)
         * (box - btgt.reshape(n_s * r, -1)).abs()).sum(-1),
        flat_labels >= 0)
    post = cfg["post_n"]
    bags = batch["im_info"][n_s:, 3].long()
    prog = program_cls_ws.reshape(n - n_s, post, -1)[..., 2]
    pick = torch.where(pvalid[n_s:], prog, torch.full_like(prog, -1e30)
                       ).argmax(1)
    bag_logits = cls_ws.reshape(n - n_s, post, -1)[
        torch.arange(n - n_s, device=cls.device), pick]
    w = torch.tensor([0.0, cfg["ws_mal_pct"], 1 - cfg["ws_mal_pct"]],
                     device=cls.device)[bags]
    mil = (R.mil_scale(step).to(cls.device) * w
           * R._ce(bag_logits, bags)).mean()
    decay = sum(0.5 * (leaves[k] ** 2).sum() for k in P
                if k.endswith(".weight"))
    loss = rpn_cls + rpn_box + rcnn_cls + rcnn_box + cfg["weight_decay"] \
        * decay + mil
    grads = torch.autograd.grad(loss, [leaves[k] for k in train_names])
    losses = {"rpn_cls": rpn_cls, "rpn_box": rpn_box, "rcnn_cls": rcnn_cls,
              "rcnn_box": rcnn_box, "mil_cls": mil}
    return ({k: v.detach() for k, v in losses.items()},
            dict(zip(train_names, grads)), (props, pvalid),
            (score.detach(), deltas.detach(), cls_ws.detach()))
