"""Plain PyTorch reference of the joint (supervised + weak) training step of
a pre-activation ResNet Faster R-CNN with BatchRenorm.

Written from the published description and the original detector's
semantics (He et al., arXiv:1603.05027 for the blocks; the reference
code's ``Resnet_train_bus.py`` graph, ``anchor_target_layer``,
``proposal_layer``, ``proposal_target_layer``, ROI max pooling with the
CUDA kernel's bin edges, and the MIL bag loss), in f32 with no kernel,
cache or fusion.  It imports nothing of the program under test.

Parameters live in one flat dict keyed by the dotted names of
:func:`param_spec` (the detector's state-dict names), so the benchmark
can hand the same seeded tensors to both sides.  Every function is pure:
BatchRenorm returns its updated running statistics instead of writing
them, so a block may run under ``torch.utils.checkpoint`` (which the
reference uses to stay within the card's memory) without updating twice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FEATURES = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
NUM_ANCHORS = 9


def _group_prefix(g: int) -> str:
    return f"trunk.backbone.group{g}" if g < 3 else "head.group3"


def _block_plan(depth: int):
    """(group, block, c_in, features, stride, preact) of every bottleneck
    block: block 0 of group 0 has no pre-activation, block 0 of the other
    groups feeds its shortcut the normalised input ("both"), the rest the
    raw input ("default")."""
    plan, c = [], 64
    for g, count in enumerate(BLOCKS[depth]):
        for i in range(count):
            preact = ("none" if g == 0 else "both") if i == 0 else "default"
            plan.append((g, i, c, FEATURES[g], STRIDES[g] if i == 0 else 1,
                         preact))
            c = FEATURES[g] * 4
    return plan


def param_spec(depth: int, num_classes: int = 3):
    """[(name, shape)] of every parameter and running statistic."""
    spec = []

    def norm(p, c):
        spec.extend((f"{p}.{k}", (c,)) for k in ("gamma", "beta", "mean",
                                                "var"))

    def conv(p, cin, cout, k, bn=True):
        spec.append((f"{p}.conv.weight", (cout, cin, k, k)))
        if bn:
            norm(f"{p}.bn", cout)
        else:
            spec.append((f"{p}.conv.bias", (cout,)))

    conv("trunk.backbone.conv0", 3, 64, 7)
    for g, i, cin, f, _, preact in _block_plan(depth):
        p = f"{_group_prefix(g)}.block{i}"
        if preact != "none":
            norm(f"{p}.preact_prev", cin)
        conv(f"{p}.conv1", cin, f, 1)
        conv(f"{p}.conv2", f, f, 3)
        conv(f"{p}.conv3", f, 4 * f, 1)
        if cin != 4 * f:
            conv(f"{p}.convshortcut", cin, 4 * f, 1)
    norm("trunk.backbone.group2_norm", 1024)
    conv("trunk.rpn_conv", 1024, 1024, 3)
    conv("trunk.rpn_cls_score", 1024, 2 * NUM_ANCHORS, 1, bn=False)
    conv("trunk.rpn_bbox_pred", 1024, 4 * NUM_ANCHORS, 1, bn=False)
    norm("head.group3_norm", 2048)
    for name, out in (("cls_score", num_classes),
                      ("bbox_pred", 4 * num_classes)):
        spec.append((f"head.{name}.dense.weight", (out, 2048)))
        spec.append((f"head.{name}.dense.bias", (out,)))
    return spec


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def batch_renorm(P, p, x, stats):
    """Batch renormalisation in training mode (Ioffe 2017, r and d
    unclipped, as ``tf.layers.batch_normalization(renorm=True)``): the
    batch moments normalise, r = sigma_b / sigma_running and d = (mean -
    mean_running) / sigma_running carry no gradient; the running moments
    (the biased batch variance) move by 1 - momentum and go to ``stats``."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), correction=0)
    sigma_b = torch.sqrt(var + BN_EPS)
    ra_mean, ra_var = P[f"{p}.mean"], P[f"{p}.var"]
    sigma_m = torch.sqrt(ra_var + BN_EPS)
    r = (sigma_b / sigma_m).detach()
    d = ((mean - ra_mean) / sigma_m).detach()
    stats[p] = (BN_MOMENTUM * ra_mean + (1 - BN_MOMENTUM) * mean.detach(),
                BN_MOMENTUM * ra_var + (1 - BN_MOMENTUM) * var.detach())
    y = (x - mean[:, None, None]) / sigma_b[:, None, None] * r[:, None, None] \
        + d[:, None, None]
    return y * P[f"{p}.gamma"][:, None, None] + P[f"{p}.beta"][:, None, None]


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_bn(P, p, x, stride, relu, stats, bn=True):
    """A convolution with TensorFlow's "SAME" padding, then BatchRenorm
    and ReLU."""
    w = P[f"{p}.conv.weight"]
    k = w.shape[-1]
    (t, b), (l, r) = (_same_pads(s, k, stride) for s in x.shape[2:])
    y = F.conv2d(F.pad(x, (l, r, t, b)), w, P.get(f"{p}.conv.bias"), stride)
    if bn:
        y = batch_renorm(P, f"{p}.bn", y, stats)
    return F.relu(y) if relu else y


def block(P, p, x, stride, preact, stats):
    if preact == "none":
        shortcut_in = x
    else:
        pre = F.relu(batch_renorm(P, f"{p}.preact_prev", x, stats))
        shortcut_in = pre if preact == "both" else x
        x = pre
    y = conv_bn(P, f"{p}.conv1", x, 1, True, stats)
    y = conv_bn(P, f"{p}.conv2", y, stride, True, stats)
    y = conv_bn(P, f"{p}.conv3", y, 1, False, stats)
    if f"{p}.convshortcut.conv.weight" in P:
        shortcut_in = conv_bn(P, f"{p}.convshortcut", shortcut_in, stride,
                              False, stats)
    return y + shortcut_in


def _group(P, depth, g, x, stats):
    for gg, i, _, _, stride, preact in _block_plan(depth):
        if gg != g:
            continue
        p = f"{_group_prefix(g)}.block{i}"
        x = checkpoint(block, P, p, x, stride, preact, stats,
                       use_reentrant=False)
    return x


def trunk(P, depth, images_nhwc, stats):
    """[B, H, W, 3] -> (feat, rpn class scores, rpn deltas), each NHWC."""
    x = images_nhwc.permute(0, 3, 1, 2).contiguous()
    x = conv_bn(P, "trunk.backbone.conv0", x, 2, True, stats)
    x = F.max_pool2d(x, 3, 2)
    for g in range(3):
        x = _group(P, depth, g, x, stats)
    feat = F.relu(batch_renorm(P, "trunk.backbone.group2_norm", x, stats))
    rpn = conv_bn(P, "trunk.rpn_conv", feat, 1, True, stats)
    score = conv_bn(P, "trunk.rpn_cls_score", rpn, 1, False, stats, bn=False)
    deltas = conv_bn(P, "trunk.rpn_bbox_pred", rpn, 1, False, stats,
                     bn=False)
    return tuple(t.permute(0, 2, 3, 1) for t in (feat, score, deltas))


def head(P, depth, pooled_nhwc, stats):
    """[N, 7, 7, 1024] pooled ROIs -> (class logits [N, C], deltas
    [N, 4C]): group3 at stride 2, its norm and ReLU, the spatial mean and
    the two dense layers."""
    x = _group(P, depth, 3, pooled_nhwc.permute(0, 3, 1, 2).contiguous(),
               stats)
    x = F.relu(batch_renorm(P, "head.group3_norm", x, stats)).mean(dim=(2, 3))
    cls = x @ P["head.cls_score.dense.weight"].t() \
        + P["head.cls_score.dense.bias"]
    box = x @ P["head.bbox_pred.dense.weight"].t() \
        + P["head.bbox_pred.dense.bias"]
    return cls, box


# --------------------------------------------------------------------- #
# ROI max pooling
# --------------------------------------------------------------------- #
def _bins(start, size, pooled: int, limit: int):
    """Bin k of a ROI spans [floor(k * size / pooled), ceil((k + 1) * size
    / pooled)) from its start, clipped to the map: the CUDA kernel's
    edges.  -> (lo, hi) [R, pooled] int64."""
    k = torch.arange(pooled, device=start.device)[None]
    lo = (k * size[:, None]) // pooled + start[:, None]
    hi = ((k + 1) * size[:, None] + pooled - 1) // pooled + start[:, None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_pool(feat, boxes, pooled: int = 7, spatial_scale: float = 1 / 16,
             chunk: int = 32):
    """Max pooling of ``boxes`` [B, P, 4] (image coordinates) over ``feat``
    [B, H, W, C] -> [B * P, pooled, pooled, C]; corners round half away
    from zero on the feature grid, a ROI is at least 1 x 1, an empty bin
    gives 0.  The maximum is taken by index (first row of the first
    column attaining it) and gathered, so the gradient reaches that cell
    alone."""
    b, p = boxes.shape[:2]
    _, h, w, c = feat.shape
    flat_boxes = boxes.reshape(-1, 4).detach()
    q = torch.floor(flat_boxes * spatial_scale + 0.5).to(torch.int64)
    img = torch.arange(b, device=feat.device).repeat_interleave(p)
    rw = (q[:, 2] - q[:, 0] + 1).clamp_min(1)
    rh = (q[:, 3] - q[:, 1] + 1).clamp_min(1)
    hlo, hhi = _bins(q[:, 1], rh, pooled, h)
    wlo, whi = _bins(q[:, 0], rw, pooled, w)
    rows = torch.arange(h, device=feat.device)
    cols = torch.arange(w, device=feat.device)
    index = torch.zeros((b * p, pooled, pooled, c), dtype=torch.int64,
                        device=feat.device)
    neg = torch.tensor(float("-inf"), device=feat.device)
    fd = feat.detach()
    with torch.no_grad():
        for s in range(0, b * p, chunk):
            e = min(s + chunk, b * p)
            fb = fd[img[s:e]]                                # [R, H, W, C]
            for i in range(pooled):
                hm = (rows[None] >= hlo[s:e, i, None]) \
                    & (rows[None] < hhi[s:e, i, None])       # [R, H]
                colmax, colarg = torch.where(hm[:, :, None, None], fb,
                                             neg).max(dim=1)  # [R, W, C]
                for j in range(pooled):
                    wm = (cols[None] >= wlo[s:e, j, None]) \
                        & (cols[None] < whi[s:e, j, None])   # [R, W]
                    wbest = torch.where(wm[:, :, None], colmax,
                                        neg).argmax(dim=1)    # [R, C]
                    hbest = colarg.gather(1, wbest[:, None])[:, 0]
                    index[s:e, i, j] = (img[s:e, None] * h + hbest) * w \
                        + wbest
    nonempty = ((hhi > hlo)[:, :, None] & (whi > wlo)[:, None, :])
    out = feat.reshape(-1, c).gather(0, index.reshape(-1, c))
    out = out.reshape(b * p, pooled, pooled, c)
    return out * nonempty[..., None].to(out.dtype)


# --------------------------------------------------------------------- #
# box geometry (the +1 pixel-extent convention)
# --------------------------------------------------------------------- #
def generate_anchors(stride: int = 16, ratios=(0.5, 1.0, 2.0),
                     scales=(8, 16, 32)) -> np.ndarray:
    """The 9 base anchors of Faster R-CNN's ``generate_anchors``."""
    w = h = float(stride)
    cx = cy = 0.5 * (stride - 1)
    out = []
    for r in ratios:
        ws = round(math.sqrt(w * h / r))
        hs = round(ws * r)
        for s in scales:
            aw, ah = ws * s, hs * s
            out.append([cx - 0.5 * (aw - 1), cy - 0.5 * (ah - 1),
                        cx + 0.5 * (aw - 1), cy + 0.5 * (ah - 1)])
    return np.array(out)


def all_anchors(fh: int, fw: int, stride: int = 16) -> np.ndarray:
    """[fh * fw * 9, 4] f32, ordered (row, column, anchor)."""
    sy, sx = np.meshgrid(np.arange(fh) * stride, np.arange(fw) * stride,
                         indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return (generate_anchors(stride)[None] + shifts).reshape(-1, 4) \
        .astype(np.float32)


def iou(a, b):
    """[N, K] IoU in f32; 0 where two boxes do not overlap."""
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1.0).clamp_min(0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1.0).clamp_min(0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def covered_share(a, b):
    """[N, K] share of each box of ``a`` that box ``b`` covers."""
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1.0).clamp_min(0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1.0).clamp_min(0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    return torch.where(inter > 0, inter / area_a[:, None],
                       torch.zeros_like(inter))


def encode(ex, gt):
    ew, eh = ex[:, 2] - ex[:, 0] + 1.0, ex[:, 3] - ex[:, 1] + 1.0
    gw, gh = gt[:, 2] - gt[:, 0] + 1.0, gt[:, 3] - gt[:, 1] + 1.0
    ecx, ecy = ex[:, 0] + 0.5 * ew, ex[:, 1] + 0.5 * eh
    gcx, gcy = gt[:, 0] + 0.5 * gw, gt[:, 1] + 0.5 * gh
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], 1)


def decode(boxes, deltas):
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    pcx = deltas[:, 0] * w + cx
    pcy = deltas[:, 1] * h + cy
    pw = torch.exp(deltas[:, 2]) * w
    ph = torch.exp(deltas[:, 3]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                        pcy + 0.5 * ph], 1)


def _top_by_uniform(u, cand, limit):
    """The (at most ``limit``) candidates with the largest draws, ties to
    the lower index."""
    keys = torch.where(cand, u, torch.full_like(u, -math.inf))
    order = torch.sort(keys, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=u.device)
    return cand & (rank < limit), rank


# --------------------------------------------------------------------- #
# anchor targets, proposals, ROI sampling
# --------------------------------------------------------------------- #
def anchor_targets(gt, num_gt, im_hw, anchors, u_fg, u_bg, batch=256,
                   fg_fraction=0.5, pos=0.7):
    """One supervised image (the SNUBH labelling): an anchor inside the
    image is positive at IoU >= ``pos`` with a foreground box or as some
    foreground box's best anchor, negative where an annotated background
    box covers at least ``pos`` of it; then at most batch * fg_fraction
    positives and batch minus the kept positives negatives are kept by the
    largest draws.  -> (labels [K] in {-1, 0, 1}, targets, inside and
    outside weights [K, 4])."""
    k = anchors.shape[0]
    slot = torch.arange(gt.shape[0], device=gt.device) < num_gt
    fg_gt = slot & (gt[:, 4] != 0)
    bg_gt = slot & (gt[:, 4] == 0)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_hw[1]) & (anchors[:, 3] < im_hw[0]))
    ov = iou(anchors, gt[:, :4])
    ov = torch.where(fg_gt[None] & inside[:, None], ov, torch.full_like(ov,
                                                                        -1.))
    best, arg = ov.max(1).values, ov.argmax(1)
    cov = covered_share(anchors, gt[:, :4])
    cov = torch.where(bg_gt[None], cov, torch.full_like(cov, -1.))
    labels = torch.full((k,), -1, dtype=torch.int64, device=gt.device)
    labels[inside & (cov.max(1).values >= pos)] = 0
    col_best = ov.max(0).values
    labels[inside & ((ov == col_best[None]) & fg_gt[None]).any(1)] = 1
    labels[inside & (best >= pos)] = 1
    fg_keep, _ = _top_by_uniform(u_fg, labels == 1, int(fg_fraction * batch))
    labels[(labels == 1) & ~fg_keep] = -1
    bg_keep, _ = _top_by_uniform(u_bg, labels == 0,
                                 batch - int((labels == 1).sum()))
    labels[(labels == 0) & ~bg_keep] = -1
    targets = torch.where(inside[:, None], encode(anchors, gt[arg, :4]), 0.0)
    inside_w = (labels == 1)[:, None].float().expand(k, 4)
    n_ex = max(int((labels >= 0).sum()), 1)
    outside_w = ((labels >= 0)[:, None].float() / n_ex).expand(k, 4)
    return labels, targets, inside_w, outside_w


def nms_keep(boxes, valid, thresh: float, enough: int) -> np.ndarray:
    """Greedy NMS over score-sorted f32 boxes [N, 4] (a tensor): a valid
    box is kept unless a kept earlier box overlaps it at IoU >= thresh.
    The pairwise test is made on the boxes' device in f32, the walk on the
    host; it stops once ``enough`` are kept (later boxes then count as
    suppressed)."""
    b = boxes.float()
    n = len(b)
    area = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    over = torch.empty((n, n), dtype=torch.bool, device=b.device)
    for r0 in range(0, n, 2048):
        r = b[r0:r0 + 2048, None]
        iw = (torch.minimum(r[..., 2], b[:, 2])
              - torch.maximum(r[..., 0], b[:, 0]) + 1.0).clamp_min(0.0)
        ih = (torch.minimum(r[..., 3], b[:, 3])
              - torch.maximum(r[..., 1], b[:, 1]) + 1.0).clamp_min(0.0)
        inter = iw * ih
        over[r0:r0 + 2048] = inter / (area[r0:r0 + 2048, None] + area[None]
                                      - inter) >= thresh
    over = over.cpu().numpy()
    alive = np.asarray(valid, bool).copy()
    keep = np.zeros(n, bool)
    kept = 0
    for i in range(n):
        if not alive[i]:
            continue
        keep[i] = True
        kept += 1
        if kept >= enough:
            break
        alive[i + 1:] &= ~over[i, i + 1:]
    return keep


def proposals(score_nhwc, deltas_nhwc, im_info, anchors, pre_n, post_n,
              thresh, min_size):
    """The proposal layer on one batch of RPN outputs: fg probability by a
    two-way softmax per anchor, decode, clip, drop boxes under
    ``min_size * scale``, the ``pre_n`` best by score, greedy NMS, and
    per image the ``post_n`` first kept boxes in score order followed by
    the suppressed ones as invalid padding.  -> (boxes [B, post_n, 4],
    valid [B, post_n])."""
    a = NUM_ANCHORS
    bsz = score_nhwc.shape[0]
    out_b, out_v = [], []
    for i in range(bsz):
        s = score_nhwc[i].reshape(-1, 2 * a)
        bg, fg = s[:, :a], s[:, a:]
        m = torch.maximum(bg, fg)
        eb, ef = torch.exp(bg - m), torch.exp(fg - m)
        prob = (ef / (eb + ef)).reshape(-1)
        bx = decode(anchors, deltas_nhwc[i].reshape(-1, 4))
        h, w, scale = im_info[i, 0], im_info[i, 1], im_info[i, 2]
        bx = torch.stack([bx[:, 0].clamp(0, None).minimum(w - 1),
                          bx[:, 1].clamp(0, None).minimum(h - 1),
                          bx[:, 2].clamp(0, None).minimum(w - 1),
                          bx[:, 3].clamp(0, None).minimum(h - 1)], 1)
        ok = ((bx[:, 2] - bx[:, 0] + 1.0 >= min_size * scale)
              & (bx[:, 3] - bx[:, 1] + 1.0 >= min_size * scale))
        keyed = torch.where(ok, prob, torch.full_like(prob, -math.inf))
        order = torch.sort(-keyed, stable=True).indices[:pre_n]
        keep = nms_keep(bx[order], torch.isfinite(keyed[order]).cpu().numpy(),
                        thresh, post_n)
        pick = np.concatenate([np.flatnonzero(keep),
                               np.flatnonzero(~keep)])[:post_n]
        out_b.append(bx[order][torch.as_tensor(pick, device=bx.device)])
        out_v.append(torch.as_tensor(keep[pick], device=bx.device))
    return torch.stack(out_b), torch.stack(out_v)


def sample_rois(boxes, valid, gt, num_gt, u_fg, u_bg, num_classes=3,
                per_image=128, fg_fraction=0.25, fg_thresh=0.5):
    """ROI sampling for one supervised image: the foreground GT boxes join
    the proposals; at most fg_fraction of ``per_image`` slots go to
    candidates at IoU >= fg_thresh, the rest to candidates below it, each
    by the largest draws; slots are foreground, background, then the
    unchosen candidates in order as padding (label -1).  -> (rois [R, 4],
    labels [R], targets, inside and outside weights [R, 4C])."""
    dev = boxes.device
    slot = torch.arange(gt.shape[0], device=dev) < num_gt
    fg_gt = slot & (gt[:, 4] != 0)
    allb = torch.cat([boxes, gt[:, :4]])
    allv = torch.cat([valid, fg_gt])
    if len(allb) < per_image:
        pad = per_image - len(allb)
        allb = torch.cat([allb, allb.new_zeros((pad, 4))])
        allv = torch.cat([allv, allv.new_zeros((pad,))])
    ov = iou(allb, gt[:, :4])
    ov = torch.where(fg_gt[None], ov, torch.full_like(ov, -1.))
    best, arg = ov.max(1).values, ov.argmax(1)
    fg_sel, fg_rank = _top_by_uniform(u_fg, allv & (best >= fg_thresh),
                                      int(round(fg_fraction * per_image)))
    n_fg = int(fg_sel.sum())
    bg_sel, bg_rank = _top_by_uniform(u_bg, allv & (best < fg_thresh)
                                      & (best >= 0.0), per_image - n_fg)
    n_bg = int(bg_sel.sum())
    big = 1 << 20
    idx = torch.arange(len(allb), device=dev)
    key = torch.where(fg_sel, fg_rank,
                      torch.where(bg_sel, big + bg_rank, 2 * big + idx))
    order = torch.sort(key, stable=True).indices[:per_image]
    rois = allb[order]
    slots = torch.arange(per_image, device=dev)
    labels = torch.where(slots < n_fg, gt[arg[order], 4].long(),
                         torch.zeros_like(slots))
    labels = torch.where(slots < n_fg + n_bg, labels, labels.new_full((), -1))
    tgt = encode(rois, gt[arg[order], :4])
    targets = torch.zeros((per_image, 4 * num_classes), device=dev)
    inside_w = torch.zeros_like(targets)
    for c in range(1, num_classes):
        on = (labels == c)[:, None]
        targets[:, 4 * c:4 * c + 4] = torch.where(on, tgt, 0.0)
        inside_w[:, 4 * c:4 * c + 4] = on.float()
    return rois, labels, targets, inside_w, (inside_w > 0).float()


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #
def _ce(logits, labels):
    return -F.log_softmax(logits, -1).gather(
        -1, labels.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]


def _masked_mean(x, mask):
    m = mask.float()
    return (x * m).sum() / m.sum().clamp_min(1.0)


def rpn_losses(score_nhwc, deltas_nhwc, labels, targets, inside_w,
               outside_w, n_s, sigma=3.0):
    """Cross entropy over the sampled anchors, and the smooth-L1 box loss
    (sigma 3, times 10, summed and divided by the supervised images times
    4A) whose linear branch takes the raw difference, as the original."""
    a = NUM_ANCHORS
    b = score_nhwc.shape[0]
    pair = score_nhwc.reshape(b, -1, 2, a).transpose(2, 3).reshape(b, -1, 2)
    cls = _masked_mean(_ce(pair.reshape(-1, 2), labels.reshape(-1)),
                       labels.reshape(-1) >= 0)
    diff = deltas_nhwc.reshape(b, -1, 4)[:n_s] - targets
    small = (diff.abs() < 1.0).float()
    elem = outside_w * (0.5 * (inside_w * diff * sigma) ** 2 * small
                        + (diff.abs() - 0.5 / sigma ** 2) * (1 - small))
    return cls, 10.0 * elem.sum() / (n_s * 4 * a)


def mil_scale(step: int) -> torch.Tensor:
    e = torch.floor(torch.tensor(float(step)) / 2000)
    return 1.0 - 0.99 * torch.pow(torch.tensor(0.9), e)


# --------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------- #
class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 0.1 outside the square root) in
    f32: what the detector's solver runs."""

    def __init__(self, names, P):
        self.names = list(names)
        self.mu = {n: torch.zeros_like(P[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(P[n]) for n in self.names}
        self.count = 0

    @torch.no_grad()
    def update(self, P, grads, lr):
        self.count += 1
        bc1 = 1 - torch.pow(torch.tensor(0.9), self.count)
        bc2 = 1 - torch.pow(torch.tensor(0.999), self.count)
        for n in self.names:
            g = grads[n]
            self.mu[n] = 0.1 * g + 0.9 * self.mu[n]
            self.nu[n] = 0.001 * g * g + 0.999 * self.nu[n]
            u = (self.mu[n] / bc1.to(g.device)) / (
                torch.sqrt(self.nu[n] / bc2.to(g.device)) + 0.1)
            P[n] = P[n] - lr * u


def train_step(P, depth, batch, draws, program_rpn, program_cls_ws, step,
               cfg):
    """One joint step's forward and gradients.

    ``batch``: the reference's own minibatch (images [B, H, W, 3], gt
    [B, G, 5], num_gt [B], im_info [B, 4]), supervised images first.
    ``draws``: (anchor uniforms [n_s, 2, K], ROI uniforms [n_s, 2, n]).
    ``program_rpn``: the program's RPN (scores, deltas) of this step, from
    which this reference's own proposal layer picks the proposals (their
    order and NMS are discrete, and rounding would otherwise pick
    others); ``program_cls_ws``: the program's weak class logits, from
    which the MIL instance of each bag is picked likewise.
    -> (losses dict, grads dict, new running statistics, proposals, the
    outputs: RPN scores and deltas, the weak ROIs' class logits)."""
    n_s, n = cfg["n_s"], batch["im_info"].shape[0]
    stats = {}
    train_names = [k for k in P if not k.endswith((".mean", ".var"))]
    leaves = {k: P[k].detach().requires_grad_(k in train_names) for k in P}
    feat, score, deltas = trunk(leaves, depth, batch["data"], stats)
    fh, fw = feat.shape[1:3]
    anchors = torch.as_tensor(all_anchors(fh, fw), device=feat.device)
    at = [anchor_targets(batch["gt"][i], batch["num_gt"][i],
                         batch["im_info"][i], anchors, draws[0][i, 0],
                         draws[0][i, 1]) for i in range(n_s)]
    lab, tgt, iw, ow = (torch.stack(t) for t in zip(*at))
    with torch.no_grad():
        props, pvalid = proposals(program_rpn[0], program_rpn[1],
                                  batch["im_info"], anchors, cfg["pre_n"],
                                  cfg["post_n"], cfg["nms"], cfg["min_size"])
    rs = [sample_rois(props[i], pvalid[i], batch["gt"][i],
                      batch["num_gt"][i], draws[1][i, 0], draws[1][i, 1],
                      per_image=cfg["rois_per_image"]) for i in range(n_s)]
    rois, labels, btgt, biw, bow = (torch.stack(t) for t in zip(*rs))
    r = rois.shape[1]
    pooled = torch.cat([roi_pool(feat[:n_s], rois),
                        roi_pool(feat[n_s:], props[n_s:])])
    cls, box = head(leaves, depth, pooled, stats)
    rpn_cls, rpn_box = rpn_losses(score, deltas, torch.cat(
        [lab, lab.new_full((n - n_s, lab.shape[1]), -1)]), tgt, iw, ow, n_s)
    flat_labels = labels.reshape(-1)
    rcnn_cls = _masked_mean(_ce(cls[:n_s * r], flat_labels), flat_labels >= 0)
    rcnn_box = _masked_mean(
        (bow.reshape(n_s * r, -1) * biw.reshape(n_s * r, -1)
         * (box[:n_s * r] - btgt.reshape(n_s * r, -1)).abs()).sum(-1),
        flat_labels >= 0)
    post = cfg["post_n"]
    bags = batch["im_info"][n_s:, 3].long()
    weak_valid = pvalid[n_s:]
    prog = program_cls_ws.reshape(n - n_s, post, -1)[..., 2]
    pick = torch.where(weak_valid, prog, torch.full_like(prog, -1e30)
                       ).argmax(1)
    bag_logits = cls[n_s * r:].reshape(n - n_s, post, -1)[
        torch.arange(n - n_s, device=cls.device), pick]
    w = torch.tensor([0.0, cfg["ws_mal_pct"], 1 - cfg["ws_mal_pct"]],
                     device=cls.device)[bags]
    mil = (mil_scale(step).to(cls.device) * w * _ce(bag_logits, bags)).mean()
    decay = sum(0.5 * (leaves[k] ** 2).sum() for k in train_names
                if k.endswith(".weight"))
    loss = rpn_cls + rpn_box + rcnn_cls + rcnn_box + cfg["weight_decay"] \
        * decay + mil
    grads = torch.autograd.grad(loss, [leaves[k] for k in train_names])
    losses = {"rpn_cls": rpn_cls, "rpn_box": rpn_box, "rcnn_cls": rcnn_cls,
              "rcnn_box": rcnn_box, "mil_cls": mil}
    return ({k: v.detach() for k, v in losses.items()},
            dict(zip(train_names, grads)), stats, (props, pvalid),
            (score.detach(), deltas.detach(), cls[n_s * r:].detach()))
