#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; nothing is caught):
  1. device line: torch's name and count, nvidia-smi's name and power limit;
  2. build the CUDA kernels from ``wssdl_bus_tpu_torch/csrc`` with nvcc for
     sm_90a, one nvcc per source, all started together, printing ptxas's
     register / shared-memory report;
  3. the NMS and ROI-pool forward kernels against their plain PyTorch
     versions on the card, at the shapes the served path gives them (B = 8
     images at the full VGG16 width and the 6000/300 TEST budgets): NMS
     keep masks must be identical, ROI pool values (f32 and the bf16
     store, both flavors, and with NaNs planted in the map) must be equal;
     CUDA-event times of both, the pool's window cells and the bytes its
     direct path would read and its shared-memory path stages, the direct
     path and other slice widths timed beside it; then the direct path
     once, at a 125 x 125 x 512 map too large for the shared-memory path;
  4. the served path at full width: seeded He weights, synthetic grayscale
     ultrasound-like requests served through ``im_detect_batch`` +
     ``report_detections`` at batch 1 and batch 8, with the kernels' launch
     counters read around the run (the pool forward's by path: every
     launch of a main path on the shared-memory path); ms/image and peak
     device memory;
  5. the training path at full width with the default TRAIN settings (1
     supervised + 2 weak images, RPN 12000 -> 2000 at NMS 0.7, 128 ROIs per
     supervised image, Adam, conv1/conv2 frozen): synthetic speckle images
     written to a temporary directory and read back by
     ``get_minibatch_joint``; first the ROI-pool backward kernel against its
     plain version at the step's shapes (MIL-sparse, dense and tie
     cotangents: identical nonzero positions and values, CUDA-event
     times), then 3 combined ``train_step``s and 1 ``train_step_mil`` with
     the launch counters read around them: finite losses, ms/step, peak
     memory, conv1/conv2 bitwise unchanged and every other parameter moved;
  6. (run after phase 9, once TF32 is off for good) parity with TF32 off
     and deterministic cuDNN: the served requests and
     one combined training step, each through the kernels and through their
     plain versions from the same state and the same injected draws: keep
     sets, sampled ROIs and labels identical, losses and updated
     parameters within the tolerances printed;
  7. the stem kernels (the fused stem ``vgg_stem_fused`` and the stem tail
     ``vgg_conv2_pool``, conv1_2 on the tensor cores) against their plain
     versions at the served batch-8 and the training shapes with TF32 off:
     every element within 1e-5 of max |plain| (f32 reassociation), and bit
     for bit on a dyadic grid at the served shape; CUDA-event times beside
     the cuDNN bf16 composition of the same layers, TFLOP/s and the
     fraction of the bound;
  8. the bf16 output option of the ROI pool at the training shapes: its
     forward (and the f32 forward, timed on the same ROIs) and its backward
     kernel against their plain versions (values and dfeat identical; the
     MIL-sparse, dense and tie cotangents of phase 5 in bf16), then the
     op's own path, ``roi_pool_fc(out_dtype=bf16)`` under autograd, with
     the launch counters around it; and, for information, whether the
     backward routes like ``roi_pool_grad`` when windows hold a NaN;
  9. the opt-in stem paths, ``WSSDL_FUSED_STEM=1`` and then
     ``WSSDL_STEM_TAIL=1``: serving (3 batch-1 + 1 batch-8 requests) and
     training (3 combined + 1 MIL steps) with the counters around each
     (4 + 4 launches of the active stem kernel, 0 of the other; the default
     runs of phases 4 and 5 launch neither), ms/image, ms/step, peak
     memory; then parity: the model's own stem output within 1e-5 of the
     plain stem's max, and everything after the stem held as in phase 6
     (identical keep sets, proposals, labels and detections; losses and
     parameters within phase 6's tolerances) with both sides given the
     kernel's stem, and the stem path's distance from the default f32 stem
     printed for information;
 10. a ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

``--profile`` adds torch.profiler breakdowns (device time by kernel, busy
share) of the batch-8 serving step and of the combined training step, and
their Chrome traces in chiprun_out/.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bounds:
# HBM3 bandwidth, and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # dense bf16 on the tensor cores
NMS_OPS_PER_PAIR = 15       # min/max/sub/add x 2 axes, clamps, mul, union, div, compare
BATCH_1_REQUESTS = 3
BATCH = 8
TRAIN_STEPS = 3           # combined steps; then one MIL step
TRAIN_STEP = 40000        # global step: MIL scale 1 - 0.99 * 0.9^20
# the opt-in stem paths: kernel wrapper -> the variable that selects it
STEM_PATHS = {"vgg_stem_fused": "WSSDL_FUSED_STEM",
              "vgg_conv2_pool": "WSSDL_STEM_TAIL"}


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


def speckle_with_mass(rng: np.random.RandomState, h: int, w: int):
    """A grayscale ultrasound-like uint8 image: Rayleigh speckle over a
    depth-attenuated background with one dark elliptical mass; -> (image,
    the mass's box (x1, y1, x2, y2))."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tissue = 110.0 * np.exp(-yy / (1.5 * h))
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.08, 0.2) * w
    mass = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    tissue[mass] *= 0.25
    speckle = rng.rayleigh(1.0, (h, w)).astype(np.float32)
    box = np.array([cx - rx, cy - ry, cx + rx, cy + ry], np.float32)
    return np.clip(tissue * speckle, 0, 255).astype(np.uint8), box


def speckle_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    return speckle_with_mass(rng, h, w)[0]


def make_requests(seed: int, n: int):
    rng = np.random.RandomState(seed)
    sizes = [(450, 600), (480, 640)]
    return [speckle_image(rng, *sizes[i % 2]) for i in range(n)]


def build_model(device, seed: int):
    """VGG16 with He weights from ``seed``; the requests arrive in pixel
    units (std ~50), hence ``input_scale`` (models/convert.py:he_tree)."""
    from wssdl_bus_tpu_torch.models.convert import he_init_
    from wssdl_bus_tpu_torch.models.detector import build_detector

    return he_init_(build_detector("VGGnet_test", device=device), seed,
                    input_scale=64.0)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_bound(keep, valid):
    """(bound_ms, bound_by, pairs): bytes are the boxes, valid and keep
    read/written once; operations are the IoU tests this data needs, one
    per (valid box j, kept box i < j)."""
    keep = keep.to("cpu").numpy()
    valid = valid.to("cpu").numpy()
    kept_before = np.cumsum(keep, axis=1) - keep
    pairs = int((kept_before * valid).sum())
    b, n = keep.shape
    nbytes = b * n * (4 * 4 + 1 + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * NMS_OPS_PER_PAIR / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), pairs


def window_cells(rois, h: int, w: int, scale) -> int:
    """Window cells summed over the 7 x 7 "gpu" bins of every ROI."""
    from wssdl_bus_tpu_torch.ops.roi_pool import _bin_masks, quantize_rois

    rsw, rsh, roi_w, roi_h = quantize_rois(rois.reshape(-1, 4).cpu(), scale)
    hm, _ = _bin_masks(rsh, roi_h, 7, h, "gpu")
    wm, _ = _bin_masks(rsw, roi_w, 7, w, "gpu")
    return int((hm.sum(-1)[:, :, None] * wm.sum(-1)[:, None, :]).sum())


def roi_pool_bound(feat, rois, scale, out_bytes: int = 4):
    """(bound_ms, bound_by): bytes are feat and rois read once and the
    output (``out_bytes`` per element) written once; operations one max per
    window cell per channel."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    ops = window_cells(rois, h, w, scale) * c
    nbytes = feat.numel() * 4 + rois.numel() * 4 + b * p * 49 * c * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def roi_pool_traffic(feat, rois, scale) -> dict:
    """What the pool forward reads through L2 for these inputs: the window
    cells (summed over every ROI's bins), the bytes the direct path (the
    first design: each bin's window read on its own) reads for them, and
    the bytes the shared-memory path stages (one image's channel slice per
    block), on the wrapper's plan."""
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (forward_plan,
                                                       staged_tile_bytes)

    b, h, w, c = feat.shape
    p = rois.shape[1]
    cells = window_cells(rois, h, w, scale)
    cs, rblk = forward_plan(b, h, w, c, p)
    staged = (b * -(-p // rblk) * -(-c // cs) * staged_tile_bytes(h, w, cs)
              if cs else None)
    return {"window_cells": cells, "cells_per_roi": cells / (b * p),
            "direct_read_mb": cells * c * 4 / 1e6,
            "staged_mb": staged / 1e6 if staged else None,
            "output_mb": b * p * 49 * c * 4 / 1e6, "plan": [cs, rblk]}


def pool_forward_stats(feat, rois, scale, dtype, tag: str,
                       plans=()) -> dict:
    """CUDA-event times of the pool forward on (feat, rois) in ``dtype``:
    the wrapper's own path, the plain version and, for comparison in the
    same call, each (cs, rblk) of ``plans`` ((0, 0): the direct path)
    through the same launcher; the bound, its fraction and the traffic."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (_launch_forward,
                                                       roi_pool_fc,
                                                       roi_pool_fc_plain)

    def run():
        return roi_pool_fc(feat, rois, 7, 7, scale, out_dtype=dtype)

    ms = cuda_ms(run, 20)
    # the kernel alone: a small launch's CUDA-event time is the wrapper's
    device_ms, recorded = launch_device_ms(
        run, ("roi_pool_fwd_smem", "roi_pool_fwd_direct"))
    plain_ms = cuda_ms(lambda: roi_pool_fc_plain(feat, rois, 7, 7, scale,
                                                 out_dtype=dtype), 2,
                       warmup=1)
    bound_ms, by = roi_pool_bound(feat, rois, scale,
                                  out_bytes=torch.finfo(dtype).bits // 8)
    traffic = roi_pool_traffic(feat, rois, scale)
    plan_ms = {f"{cs}x{rblk}": cuda_ms(lambda: _launch_forward(
        feat, rois, 7, 7, scale, "gpu", dtype, (cs, rblk)), 20)
        for cs, rblk in plans}
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    others = "".join(f", plan {k} {v:.4f} ms" for k, v in plan_ms.items())
    staged = traffic["staged_mb"]
    dev = "not recorded" if device_ms is None else \
        f"{device_ms:.4f} ms a launch over the {recorded} of 5 it recorded " \
        f"({bound_ms / device_ms:.3f} of the bound)"
    print(f"[pool] {tag} {name} feat {tuple(feat.shape)} rois "
          f"{tuple(rois.shape)}: kernel {ms:.4f} ms on plan "
          f"{traffic['plan']} ({bound_ms / ms:.3f} of the bound {bound_ms:.4f}"
          f" ms by {by}), device time by the profiler {dev}, plain "
          f"{plain_ms:.3f} ms{others}; window cells "
          f"{traffic['window_cells']} ({traffic['cells_per_roi']:.1f} a "
          f"ROI): the direct path reads {traffic['direct_read_mb']:.1f} MB, "
          f"the shared-memory path stages "
          f"{'-' if staged is None else f'{staged:.1f}'} MB; output "
          f"{traffic['output_mb'] * (2 if name == 'bf16' else 4) / 4:.1f} "
          "MB", flush=True)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "bound_fraction": bound_ms / ms,
            "plan_ms": plan_ms, "shape": [list(feat.shape), list(rois.shape)],
            **traffic}


def check_pool_nan(feat, rois, scale, tag: str) -> int:
    """The NaN case: NaNs planted in a copy of ``feat`` (a diverged step);
    the forward kernel against its plain version in f32 and bf16: the same
    NaN positions, every other value equal.  -> NaN outputs (f32)."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                       roi_pool_fc_plain)

    f = feat.clone()
    gen = torch.Generator(device=f.device).manual_seed(3)
    at = tuple(torch.randint(0, n, (64,), generator=gen, device=f.device)
               for n in f.shape)
    f[at] = float("nan")
    n_nan = 0
    for dtype in (torch.float32, torch.bfloat16):
        got = roi_pool_fc(f, rois, 7, 7, scale, out_dtype=dtype)
        want = roi_pool_fc_plain(f, rois, 7, 7, scale, out_dtype=dtype)
        nan = want.isnan()
        _check(bool(nan.any()) and torch.equal(got.isnan(), nan)
               and torch.equal(got[~nan], want[~nan]),
               f"ROI pool NaN case ({tag}, {dtype}): kernel != plain")
        n_nan = n_nan or int(nan.sum())
    print(f"[pool] {tag}: 64 NaNs planted in the map: kernel == plain in f32"
          f" and bf16 ({n_nan} NaN outputs, the same positions; every other"
          " value equal)", flush=True)
    return n_nan


def phase_split(fn, phases, reps: int = 5) -> dict:
    """Device ms per call of ``fn`` spent in each kernel whose name holds
    ``<phase>_kernel``, from torch.profiler over ``reps`` calls; {} if it
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for phase in phases:
            if f"{phase}_kernel" in e.key:
                split[phase] = split.get(phase, 0.0) \
                    + getattr(e, "device_time_total", 0) / reps / 1e3
    return split


def launch_device_ms(fn, names, reps: int = 5):
    """(device ms per launch, launches recorded) of the kernels whose names
    hold one of ``names``, from torch.profiler over ``reps`` calls of
    ``fn``: their device time over the launches the profiler recorded
    (it may record fewer than were made); (None, 0) if none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if any(f"{n}_kernel" in e.key for n in names):
            total += getattr(e, "device_time_total", 0)
            count += e.count
    return (total / count / 1e3 if count else None), count


def split_text(split: dict) -> str:
    return " + ".join(f"{k} {v:.4f}" for k, v in split.items()) \
        or "not recorded"


def check_nms(boxes_t, valid, thresh, tag: str) -> dict:
    """The NMS kernel against its plain version on [B, 4, N] candidates:
    identical keep masks, image 0 equal to the host's numpy greedy NMS;
    CUDA-event times of the kernel and the plain version, the bound, and
    the mask / walk split of the kernel's time."""
    import torch

    from wssdl_bus_tpu_torch.evaluate.detect import nms_numpy
    from wssdl_bus_tpu_torch.ops.nms import nms_mask
    from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep

    keep_k = nms_keep(boxes_t, valid, thresh)
    keep_p = nms_mask(boxes_t, valid, thresh)
    torch.cuda.synchronize()
    nms_err = int((keep_k != keep_p).sum())
    _check(nms_err == 0, f"NMS ({tag}) keep masks differ in {nms_err} places")
    # a third, independent implementation: the host's numpy greedy NMS on
    # image 0 (strictly decreasing scores keep the sorted order)
    v0 = valid[0].cpu().numpy()
    b0 = boxes_t[0].cpu().numpy().T[v0]
    dets = np.hstack([b0, -np.arange(len(b0), dtype=np.float32)[:, None]])
    want0 = np.zeros(len(b0), bool)
    want0[nms_numpy(dets, thresh)] = True
    _check(np.array_equal(keep_k[0].cpu().numpy()[v0], want0),
           f"NMS ({tag}) kernel disagrees with the numpy greedy NMS on "
           "image 0")
    ms = cuda_ms(lambda: nms_keep(boxes_t, valid, thresh), 20)
    plain_ms = cuda_ms(lambda: nms_mask(boxes_t, valid, thresh), 3, warmup=1)
    bound_ms, bound_by, pairs = nms_bound(keep_k, valid)
    split = phase_split(lambda: nms_keep(boxes_t, valid, thresh),
                        ("nms_compact", "nms_mask", "nms_walk"))
    print(f"[nms] {tag} boxes_t {tuple(boxes_t.shape)}, {int(valid.sum())} "
          f"valid: nms_keep == nms_mask ({int(keep_k.sum())} kept), image 0 "
          f"== numpy greedy NMS; kernel {ms:.4f} ms ({split_text(split)} ms "
          f"by the profiler), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({pairs} IoU pairs)", flush=True)
    return {"max_abs_err": nms_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "split_ms": split,
            "shape": list(boxes_t.shape)}


def training_candidates(eng, batch) -> tuple:
    """The NMS inputs of a training step on ``batch``: the trunk's own RPN
    outputs through the TRAIN budgets' candidate selection (12000 per
    image) -> (boxes_t [B, 4, 12000], valid [B, 12000], thresh)."""
    import torch

    from wssdl_bus_tpu_torch.models.detector import rpn_softmax
    from wssdl_bus_tpu_torch.ops.proposal import top_candidates

    t = eng.cfg.TRAIN
    with torch.no_grad():
        data = torch.as_tensor(batch["data"], device=eng.device)
        im_info = torch.as_tensor(batch["im_info"], dtype=torch.float32,
                                  device=eng.device)
        _, score, bbox = eng.model.apply_trunk(data)
        cand = top_candidates(rpn_softmax(score, eng.num_anchors), bbox,
                              im_info, eng.anchors, eng.num_anchors,
                              t.RPN_PRE_NMS_TOP_N, float(t.RPN_MIN_SIZE))
    return cand.boxes_t, cand.valid, t.RPN_NMS_THRESH


def check_kernels(eng, images, net):
    """Phase 3: both kernels against their plain versions at the served
    path's shapes, fed by the trunk's own outputs for ``images``."""
    import torch

    from wssdl_bus_tpu_torch.evaluate.detect import pack_image_batch
    from wssdl_bus_tpu_torch.models.detector import rpn_softmax
    from wssdl_bus_tpu_torch.ops.proposal import (proposal_layer,
                                                  top_candidates)
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                       roi_pool_fc_plain,
                                                       roi_pool_grouped)

    cfg = eng.cfg
    blob, infos, _ = pack_image_batch(eng, images, net, eng.canvas_hw)
    with torch.inference_mode():
        data = torch.as_tensor(blob, device=eng.device)
        im_info = torch.as_tensor(infos, device=eng.device)
        feat, score, bbox = eng.model.apply_trunk(data)
        prob = rpn_softmax(score, eng.num_anchors)
        cand = top_candidates(prob, bbox, im_info, eng.anchors,
                              eng.num_anchors, cfg.TEST.RPN_PRE_NMS_TOP_N,
                              float(cfg.TEST.RPN_MIN_SIZE))
        thresh = cfg.TEST.RPN_NMS_THRESH
        boxes_t, valid = cand.boxes_t, cand.valid
        print(f"[kernels] NMS input boxes_t {tuple(boxes_t.shape)}, "
              f"{int(valid.sum())} valid; ROI pool feat {tuple(feat.shape)}",
              flush=True)

        nms_stats = check_nms(boxes_t, valid, thresh, "serve")

        props = proposal_layer(prob, bbox, im_info, eng.anchors,
                               eng.num_anchors, cfg.TEST.RPN_PRE_NMS_TOP_N,
                               cfg.TEST.RPN_POST_NMS_TOP_N, thresh,
                               float(cfg.TEST.RPN_MIN_SIZE))
        rois = props.boxes
        scale = 1.0 / cfg.FEAT_STRIDE
        roi_err = 0.0
        for flavor in ("gpu", "cpu"):
            got = roi_pool_fc(feat, rois, 7, 7, scale, flavor)
            want = roi_pool_fc_plain(feat, rois, 7, 7, scale, flavor)
            got4 = roi_pool_grouped(feat, rois, 7, 7, scale, flavor)
            _check(got.shape == (BATCH, cfg.TEST.RPN_POST_NMS_TOP_N,
                                 49 * feat.shape[-1]), f"shape {got.shape}")
            err = max(float((got - want).abs().max()),
                      float((got4.reshape(want.shape) - want).abs().max()))
            _check(err == 0.0, f"ROI pool ({flavor}) max |diff| {err}")
            roi_err = max(roi_err, err)
            got = roi_pool_fc(feat, rois, 7, 7, scale, flavor, torch.bfloat16)
            want = roi_pool_fc_plain(feat, rois, 7, 7, scale, flavor,
                                     torch.bfloat16)
            _check(torch.equal(got, want),
                   f"ROI pool bf16 ({flavor}): kernel != plain")
        print(f"[kernels] roi_pool_fc == plain roi_pool on {tuple(got.shape)}"
              f" (flat and 5-D views, both flavors; the bf16 store too): max "
              f"|diff| {roi_err}", flush=True)
        check_pool_nan(feat, rois, scale, "serve")
        # the first design (the direct path), twice the ROI blocks and a
        # narrower slice beside the wrapper's plan, in the same call
        plans = ((0, 0), (16, 150), (8, 300))
        f32 = pool_forward_stats(feat, rois, scale, torch.float32, "serve",
                                 plans)
        bf16 = pool_forward_stats(feat, rois, scale, torch.bfloat16, "serve",
                                  plans[:1])
    print("[kernels] ROI pool library: none (PyTorch has no NMS or ROI-pool "
          "op; torchvision is not used)", flush=True)
    return {
        "nms_keep": dict(nms_stats, per_shape={"serve": nms_stats}),
        "roi_pool_fc": dict(f32, max_abs_err=roi_err, per_shape={
            "serve": f32}),
        "roi_pool_fc_bf16_serve": bf16,
    }


def check_direct_path(seed: int = 5) -> dict:
    """The forward's direct path once, at a map too large for the shared-
    memory path: the 125 x 125 x 512 map of a 2000 x 2000-pixel image
    (random, post-ReLU) and 300 random ROIs: parity in f32 and bf16, both
    flavors, the NaN case, its own counter, times."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (forward_plan,
                                                       roi_pool_fc,
                                                       roi_pool_fc_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    feat = torch.relu(torch.randn((1, 125, 125, 512), generator=gen,
                                  device="cuda"))
    xy = torch.rand((1, 300, 2), generator=gen, device="cuda") * 1900
    wh = 16 + torch.rand((1, 300, 2), generator=gen, device="cuda") * 700
    rois = torch.cat([xy, (xy + wh).clamp(max=1999)], -1).contiguous()
    scale = 1.0 / 16
    _check(forward_plan(1, 125, 125, 512, 300) == (0, 0),
           "the 125 x 125 map should take the direct path")
    before = dict(roi_pool_fc.paths)
    with torch.no_grad():
        got = roi_pool_fc(feat, rois, 7, 7, scale)
        torch.cuda.synchronize()
        _check(roi_pool_fc.paths == {"smem": before["smem"],
                                     "direct": before["direct"] + 1},
               f"direct path: counters {before} -> {roi_pool_fc.paths}")
        _check(torch.equal(got, roi_pool_fc_plain(feat, rois, 7, 7, scale)),
               "direct path: kernel != plain")
        for flavor in ("gpu", "cpu"):
            for dtype in (torch.float32, torch.bfloat16):
                _check(torch.equal(
                    roi_pool_fc(feat, rois, 7, 7, scale, flavor, dtype),
                    roi_pool_fc_plain(feat, rois, 7, 7, scale, flavor,
                                      dtype)),
                    f"direct path ({flavor}, {dtype}): kernel != plain")
        print("[pool] direct path: feat (1, 125, 125, 512), rois (1, 300, 4)"
              ": kernel == plain (both flavors, f32 and bf16), counted on "
              "roi_pool_fc.paths['direct']", flush=True)
        check_pool_nan(feat, rois, scale, "direct")
        return pool_forward_stats(feat, rois, scale, torch.float32, "direct")


def serve(eng, requests, net, batch):
    """Serve ``requests`` in batches of ``batch`` through the public entry
    points; -> list of (scores, boxes, report entries) per request."""
    from wssdl_bus_tpu_torch.evaluate.detect import im_detect_batch
    from wssdl_bus_tpu_torch.serve import report_detections

    out = []
    for s in range(0, len(requests), batch):
        for scores, boxes in im_detect_batch(eng, requests[s:s + batch], net,
                                             eng.canvas_hw):
            entries, _ = report_detections(scores, boxes, eng.cfg)
            out.append((scores, boxes, entries))
    return out


def time_serving(eng, requests, net, batch, reps: int = 5) -> dict:
    """Per-image host-clock times at ``batch``: the whole serving call
    (``e2e``) and its three stages (host prep + packing, the device step up
    to its synchronize, decode + per-class NMS report), and peak device
    memory."""
    import torch

    from wssdl_bus_tpu_torch.evaluate.detect import (_decode_packed,
                                                     pack_image_batch)
    from wssdl_bus_tpu_torch.serve import report_detections

    reqs = requests[:batch]
    serve(eng, reqs, net, batch)                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        serve(eng, reqs, net, batch)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    prep = step = post = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        blob, infos, scales = pack_image_batch(eng, reqs, net, eng.canvas_hw)
        t1 = time.perf_counter()
        outs = eng.inference_step(blob, infos)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for scores, boxes in _decode_packed(eng, reqs, scales, outs):
            report_detections(scores, boxes, eng.cfg)
        t3 = time.perf_counter()
        prep, step, post = prep + t1 - t0, step + t2 - t1, post + t3 - t2
    per = 1e3 / (reps * batch)
    return {"ms_per_image": e2e * per, "prep_ms_per_image": prep * per,
            "device_step_ms_per_image": step * per,
            "decode_report_ms_per_image": post * per,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def profile_step(eng, requests, net, out_dir: str):
    """``--profile``: torch.profiler over three batch-8 device steps; prints
    device time by kernel and the device's busy share of the window, and
    writes a Chrome trace to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    data, info = (torch.as_tensor(a, device=eng.device)
                  for a in _packed(eng, requests, net))
    eng.inference_step(data, info)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.inference_step(data, info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in events) / 1e6
    print(f"[profile] 3 steps of batch {len(requests)}: wall {wall * 1e3:.3f}"
          f" ms, device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)",
          flush=True)
    for e in events[:15]:
        print(f"[profile] {e.device_time_total / 3e3:9.4f} ms/step "
              f"x{e.count // 3:<4d} {e.key[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "serve_b8_trace.json"))


def _packed(eng, requests, net):
    from wssdl_bus_tpu_torch.evaluate.detect import pack_image_batch

    blob, infos, _ = pack_image_batch(eng, requests, net, eng.canvas_hw)
    return blob, infos


# --------------------------------------------------------------------- #
# the training path
# --------------------------------------------------------------------- #
def write_roidb(tmpdir: str, seed: int, n_sup: int, n_ws: int):
    """Speckle images written as PNG files, read back by the minibatch code
    as on the real path.  Supervised entries carry the mass box (benign or
    malignant) and a whole-image ``__background__`` box (the SNUBH
    negatives need one); weak entries only a BIRADS label."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    sizes = [(450, 600), (480, 640)]
    sup, ws = [], []
    for i in range(n_sup + n_ws):
        h, w = sizes[i % 2]
        im, box = speckle_with_mass(rng, h, w)
        path = os.path.join(tmpdir, f"bus_{i}.png")
        Image.fromarray(im).save(path)
        cls = 1 + i % 2
        entry = {"image": path, "flipped": False, "birads_diag": cls,
                 "boxes": np.stack([box, [0, 0, w - 1, h - 1]]),
                 "gt_classes": np.array([cls, 0])}
        (sup if i < n_sup else ws).append(entry)
    return sup, ws, sizes


def train_batches(cfg, canvas, sup, ws, n_steps: int):
    """``n_steps`` joint minibatches (1 + 2 images each) and one weak-only
    minibatch, drawn from one RandomState(cfg.RNG_SEED) in that order."""
    from wssdl_bus_tpu_torch.data.minibatch import (get_minibatch,
                                                    get_minibatch_joint)

    rng = np.random.RandomState(cfg.RNG_SEED)
    n_s, n_w = cfg.TRAIN.IMS_PER_BATCH, cfg.TRAIN.WS_IMS_PER_BATCH
    joint = [get_minibatch_joint(sup[k * n_s:(k + 1) * n_s],
                                 ws[k * n_w:(k + 1) * n_w], "VGGnet_train",
                                 cfg, canvas, rng)
             for k in range(n_steps)]
    weak = get_minibatch(ws[:n_w], "VGGnet_train", cfg, canvas, True, True,
                         rng)
    return joint, weak


def roi_pool_bwd_bound(feat, rois, g, scale):
    """(bound_ms, bound_by) of one backward launch: bytes are the cotangent
    (in its own dtype), feat and rois read once and dfeat written once;
    operations one zero test per cotangent element and, for the ROIs with a
    nonzero cotangent row, one compare per window cell per channel."""
    from wssdl_bus_tpu_torch.ops.roi_pool import (_bin_masks, active_rows,
                                                  quantize_rois)

    b, h, w, c = feat.shape
    act = active_rows(g).reshape(-1).cpu()
    r = rois.reshape(-1, 4).cpu()[act]
    rsw, rsh, roi_w, roi_h = quantize_rois(r, scale)
    hm, _ = _bin_masks(rsh, roi_h, 7, h, "gpu")
    wm, _ = _bin_masks(rsw, roi_w, 7, w, "gpu")
    cells = int((hm.sum(-1)[:, :, None] * wm.sum(-1)[:, None, :]).sum())
    ops = g.numel() + cells * c
    nbytes = g.numel() * g.element_size() + (2 * feat.numel()
                                              + rois.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def training_groups(eng, batch):
    """The combined step's two pool launches' inputs, from the trunk's own
    features and the step's own ROIs: {"sup": (feat [1, 38, 56, 512],
    sampled ROIs [1, 128, 4]), "weak": (feat [2, ...], proposals
    [2, 2000, 4])}."""
    import torch

    n_s = eng.n_s
    with torch.no_grad():
        data = torch.as_tensor(batch["data"], device=eng.device)
        feat = eng.model.apply_trunk(data)[0]
        _, _, det = eng.forward_train(batch, TRAIN_STEP)
    return {"sup": (feat[:n_s], det["samples"].rois),
            "weak": (feat[n_s:], det["props"].boxes[n_s:].contiguous())}


# the backward's launches (csrc/roi_pool.cu), as phase_split names them
BACKWARD_PHASES = ("roi_rows_active", "roi_rows_compact", "roi_argmax",
                   "roi_gather")


def check_backward_kernel(eng, groups, dtype):
    """Phase 5a (f32 cotangent, kernel #4) and phase 8 (bf16 cotangent, the
    bf16 output's backward): the backward kernel against its plain version
    at the combined step's two launches (the supervised group [1, 128] and
    the weak group [2, 2000] of ROIs on a [38, 56, 512] map) with three
    cotangent patterns."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool import (active_rows, roi_pool_grad,
                                                  roi_pool_grad_bf16)
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (
        roi_pool_fc_backward, roi_pool_fc_backward_bf16)

    bf16 = dtype == torch.bfloat16
    kernel = roi_pool_fc_backward_bf16 if bf16 else roi_pool_fc_backward
    plain = roi_pool_grad_bf16 if bf16 else roi_pool_grad
    tag = "[backward-bf16]" if bf16 else "[backward]"
    scale = 1.0 / eng.cfg.FEAT_STRIDE
    gen = torch.Generator(device=eng.device).manual_seed(1)

    def cotangent(f, rois, pattern):
        shape = (rois.shape[0], rois.shape[1], 49 * f.shape[-1])
        g = torch.randn(shape, generator=gen, device=eng.device)
        if pattern == "mil":     # one row per bag, as MIL leaves it
            mask = torch.zeros(shape[:2], dtype=torch.bool,
                               device=eng.device)
            mask[:, 0] = True
            g = g * mask[..., None]
        return g.to(dtype)

    cases = {
        "mil": {"sup": cotangent(*groups["sup"], "dense"),
                "weak": cotangent(*groups["weak"], "mil")},
        "dense": {k: cotangent(*groups[k], "dense") for k in groups},
    }
    err = 0.0
    for pattern, gs in cases.items():
        for k, g in gs.items():
            f, rois = groups[k]
            got = kernel(f, rois, g, 7, 7, scale)
            want = plain(f, rois, g, 7, 7, scale)
            torch.cuda.synchronize()
            _check(torch.equal(got != 0, want != 0),
                   f"{tag} {pattern} {k}: nonzero positions differ")
            e = float((got - want).abs().max())
            _check(e == 0.0, f"{tag} {pattern} {k}: max |diff| {e}")
            err = max(err, e)
            print(f"{tag} {pattern:5s} {k:4s} g {tuple(g.shape)} {dtype}, "
                  f"{int(active_rows(g).sum())} active rows: identical "
                  f"nonzero positions ({int((got != 0).sum())}), max |diff|"
                  f" {e}", flush=True)
    # a tie: a constant map; every bin's whole cotangent lands on one cell
    f, rois = groups["sup"]
    f1 = torch.ones_like(f)
    g1 = torch.ones((1, rois.shape[1], 49 * f.shape[-1]), device=eng.device,
                    dtype=dtype)
    got = kernel(f1, rois, g1, 7, 7, scale)
    want = plain(f1, rois, g1, 7, 7, scale)
    nonempty = int((want != 0).sum())
    _check(torch.equal(got, want), f"{tag} tie: kernel != plain")
    _check(bool((got == got.round()).all()),
           f"{tag} tie: a bin's cotangent was split between cells")
    print(f"{tag} tie   sup  constant map: kernel == plain, every bin's "
          f"cotangent on one cell ({nonempty} cells hit, sum "
          f"{float(got.sum()):.0f})", flush=True)

    # times of one step's two launches (the MIL pattern: the real one)
    gs = cases["mil"]
    ms = plain_ms = bound_ms = 0.0
    per = {}
    for k, g in gs.items():
        f, rois = groups[k]
        t = cuda_ms(lambda: kernel(f, rois, g, 7, 7, scale), 20)
        tp = cuda_ms(lambda: plain(f, rois, g, 7, 7, scale), 2, warmup=1)
        bnd, by = roi_pool_bwd_bound(f, rois, g, scale)
        split = phase_split(lambda: kernel(f, rois, g, 7, 7, scale),
                            BACKWARD_PHASES)
        per[k] = {"ms": t, "plain_ms": tp, "bound_ms": bnd, "bound_by": by,
                  "g_shape": list(g.shape), "split_ms": split}
        ms, plain_ms, bound_ms = ms + t, plain_ms + tp, bound_ms + bnd
        print(f"{tag} {k:4s} launch: kernel {t:.4f} ms ({split_text(split)}"
              f" ms by the profiler), plain {tp:.3f} ms, bound {bnd:.4f} ms "
              f"by {by}", flush=True)
    def dense():
        return kernel(*groups["weak"], cases["dense"]["weak"], 7, 7, scale)

    tdense = cuda_ms(dense, 5)
    split = phase_split(dense, BACKWARD_PHASES, reps=2)
    print(f"{tag} weak launch with a dense cotangent (all 4000 rows): "
          f"kernel {tdense:.4f} ms ({split_text(split)} ms by the "
          "profiler)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if all(
                v["bound_by"] == "bytes" for v in per.values())
            else "operations", "per_launch": per,
            "dense_weak_ms": tdense, "dense_weak_split_ms": split}


def backward_nan_routing(eng, groups) -> dict:
    """For information (the backward is not changed): the backward kernel
    against ``roi_pool_grad`` when windows hold a NaN, on the supervised
    group with 64 NaNs planted in its map and a dense cotangent.  The plain
    version's argmax takes a NaN as the maximum; the kernel's ">" compares
    never select one.  -> whether they agree, and on how many elements of
    dfeat they differ."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool_grad
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_fc_backward

    scale = 1.0 / eng.cfg.FEAT_STRIDE
    f, rois = groups["sup"]
    f = f.clone()
    gen = torch.Generator(device=f.device).manual_seed(4)
    f[tuple(torch.randint(0, n, (64,), generator=gen, device=f.device)
            for n in f.shape)] = float("nan")
    g = torch.randn((1, rois.shape[1], 49 * f.shape[-1]), generator=gen,
                    device=f.device)
    got = roi_pool_fc_backward(f, rois, g, 7, 7, scale)
    want = roi_pool_grad(f, rois, g, 7, 7, scale)
    torch.cuda.synchronize()
    same = (got == want) | (got.isnan() & want.isnan())
    differ = int((~same).sum())
    print(f"[backward] NaN in windows (information): kernel vs plain "
          f"roi_pool_grad on the supervised group: "
          f"{'agree' if differ == 0 else f'differ in {differ} of'} "
          f"{got.numel()} dfeat elements ({int(want.isnan().sum())} NaN in "
          f"the plain dfeat, {int(got.isnan().sum())} in the kernel's)",
          flush=True)
    return {"agree": differ == 0, "differing": differ,
            "nan_plain": int(want.isnan().sum()),
            "nan_kernel": int(got.isnan().sum())}


def check_train_forward(eng, groups) -> dict:
    """Phase 8a: the pool forward at the combined step's two launches (the
    supervised group [1, 128] and the weak group [2, 2000] of ROIs on a
    [38, 56, 512] map): the bf16 store against its plain version and the
    rounded f32 forward, the f32 forward against its plain version, and the
    NaN case on the weak group; times of both dtypes on the same ROIs.
    -> {dtype name: stats summed over the two launches, per group}."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                       roi_pool_fc_plain)

    scale = 1.0 / eng.cfg.FEAT_STRIDE
    bf16 = torch.bfloat16
    res = {}
    with torch.no_grad():
        for k, (f, rois) in groups.items():
            got = roi_pool_fc(f, rois, 7, 7, scale, out_dtype=bf16)
            want = roi_pool_fc_plain(f, rois, 7, 7, scale, out_dtype=bf16)
            f32 = roi_pool_fc(f, rois, 7, 7, scale)
            f32_plain = roi_pool_fc_plain(f, rois, 7, 7, scale)
            torch.cuda.synchronize()
            _check(got.dtype == bf16 and torch.equal(got, want),
                   f"bf16 forward ({k}): kernel != plain")
            _check(torch.equal(got, f32.to(bf16)),
                   f"bf16 forward ({k}): != the rounded f32 forward")
            _check(torch.equal(f32, f32_plain),
                   f"f32 forward ({k}): kernel != plain")
            print(f"[pool-bf16] forward {k:4s} {tuple(got.shape)}: kernel =="
                  f" plain == bf16(f32 forward); f32 kernel == plain",
                  flush=True)
            # beside the wrapper's plan: the direct path, and two and four
            # times the ROI blocks
            p = rois.shape[1]
            plans = ((0, 0), (16, -(-p // 8)), (16, -(-p // 16))) \
                if k == "sup" else ((0, 0), (16, 500), (16, 285))
            for dtype in (torch.float32, bf16):
                name = "bf16" if dtype == bf16 else "f32"
                res.setdefault(name, {})[k] = pool_forward_stats(
                    f, rois, scale, dtype, f"train {k}",
                    plans if dtype == torch.float32 else plans[:1])
        check_pool_nan(*groups["weak"], scale, "train weak")
    out = {}
    for name, per in res.items():
        out[name] = {key: sum(v[key] for v in per.values())
                     for key in ("ms", "plain_ms", "bound_ms")}
        dev = [v["device_ms"] for v in per.values()]
        out[name]["device_ms"] = None if None in dev else sum(dev)
        out[name].update(max_abs_err=0.0, per_group=per, bound_by="bytes" if
                         all(v["bound_by"] == "bytes" for v in per.values())
                         else "operations")
    return out


def run_bf16_pool_path(eng, groups):
    """Phase 8c: the bf16 option's own path, ``roi_pool_fc(...,
    out_dtype=bfloat16)`` under autograd, on the step's two groups with the
    MIL-pattern cotangent, counters set to 0 just before; dfeat against the
    plain version's autograd.  -> the launch counts."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                       roi_pool_fc_plain)

    scale = 1.0 / eng.cfg.FEAT_STRIDE
    gen = torch.Generator(device=eng.device).manual_seed(2)
    cots = {}
    for k, (f, rois) in groups.items():
        g = torch.randn((rois.shape[0], rois.shape[1], 49 * f.shape[-1]),
                        generator=gen, device=eng.device)
        if k == "weak":
            g[:, 1:] = 0.0
        cots[k] = g.to(torch.bfloat16)
    reset_counts()
    grads = {}
    for k, (f, rois) in groups.items():
        fk = f.detach().requires_grad_(True)
        roi_pool_fc(fk, rois, 7, 7, scale, out_dtype=torch.bfloat16) \
            .backward(cots[k])
        grads[k] = fk.grad
    torch.cuda.synchronize()
    counts = read_counts()
    for k, (f, rois) in groups.items():
        fp = f.detach().requires_grad_(True)
        roi_pool_fc_plain(fp, rois, 7, 7, scale, out_dtype=torch.bfloat16) \
            .backward(cots[k])
        _check(grads[k].dtype == torch.float32
               and torch.equal(grads[k], fp.grad),
               f"bf16 pool path ({k}): dfeat != the plain autograd's")
    check_counts(counts, {"roi_pool_fc_bf16": 2,
                          "roi_pool_fc_backward_bf16": 2}, "bf16 pool path")
    check_pool_paths(counts, "bf16_pool")
    print(f"[pool-bf16] roi_pool_fc(out_dtype=bf16) under autograd on the "
          f"two groups: launches {counts}; f32 dfeat == the plain "
          f"version's autograd", flush=True)
    return counts


def run_training(eng, joint, weak):
    """Phase 5b: TRAIN_STEPS combined steps and one MIL step; -> per-step
    losses and times.  The launch counters are read by the caller."""
    import torch

    rows, times = [], []
    for k, batch in enumerate(joint):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls = eng.train_step(batch, step=TRAIN_STEP + k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = [float(x) for x in ls]
        _check(all(np.isfinite(vals)), f"step {k}: losses {vals}")
        rows.append(dict(zip(ls._fields, vals)))
        print(f"[train] step {k}: {times[-1]:.2f} ms; losses " + ", ".join(
            f"{n} {v:.6f}" for n, v in rows[-1].items()), flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mil = float(eng.train_step_mil(weak, step=TRAIN_STEP + len(joint)))
    torch.cuda.synchronize()
    mil_ms = (time.perf_counter() - t0) * 1e3
    _check(np.isfinite(mil), f"MIL step loss {mil}")
    print(f"[train] MIL step: {mil_ms:.2f} ms; mil_cls {mil:.6f}", flush=True)
    return rows, times, mil, mil_ms


def time_train_step(eng, batch, reps: int = 3) -> float:
    """Mean ms of a combined step by CUDA events (after the run above)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(reps):
        eng.train_step(batch, step=TRAIN_STEP)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_train(eng, batch, out_dir: str):
    """``--profile``: torch.profiler over two combined training steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.train_step(batch, step=TRAIN_STEP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            eng.train_step(batch, step=TRAIN_STEP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in events) / 1e6
    print(f"[profile-train] 2 combined steps: wall {wall * 1e3:.3f} ms, "
          f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)",
          flush=True)
    for e in events[:20]:
        print(f"[profile-train] {e.device_time_total / 2e3:9.4f} ms/step "
              f"x{e.count // 2:<5d} {e.key[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_step_trace.json"))


def check_train_parity(model, cfg, canvas, batch, device="cuda"):
    """Phase 6b: one combined step through the kernels and one through the
    plain versions, from copies of the same model, fresh optimizers and the
    same injected draws, TF32 off and cuDNN deterministic."""
    import copy

    import torch

    from wssdl_bus_tpu_torch.ops.proposal_target import num_candidates
    from wssdl_bus_tpu_torch.train.engine import Engine, StepDraws

    engs = [Engine(copy.deepcopy(model), cfg, canvas, device=device,
                   plain_ops=plain) for plain in (False, True)]
    t = cfg.TRAIN
    gen = torch.Generator(device=device).manual_seed(7)
    k = len(engs[0].anchors)
    n = num_candidates(t.RPN_POST_NMS_TOP_N, t.MAX_GT_PER_IMAGE,
                       t.BATCH_SIZE)
    rand = lambda *shape: torch.rand(shape, generator=gen,  # noqa: E731
                                     device=device)
    n_sup = t.IMS_PER_BATCH * t.BATCH_SIZE
    n_ws = t.WS_IMS_PER_BATCH * t.RPN_POST_NMS_TOP_N
    draws = StepDraws(anchor_u=rand(t.IMS_PER_BATCH, 2, k),
                      roi_u=rand(t.IMS_PER_BATCH, 2, n),
                      keep_sup=(rand(n_sup, 512) < 0.5,
                                rand(n_sup, 512) < 0.5),
                      keep_ws=(rand(n_ws, 512) < 0.5, rand(n_ws, 512) < 0.5))
    dets = []
    with torch.no_grad():
        for e in engs:
            dets.append(e.forward_train(batch, TRAIN_STEP, draws)[2])
    (dk, dp) = dets
    for name, a, b in (("keep sets", dk["props"].valid, dp["props"].valid),
                       ("proposals", dk["props"].boxes, dp["props"].boxes),
                       ("sampled ROIs", dk["samples"].rois,
                        dp["samples"].rois),
                       ("ROI labels", dk["samples"].labels,
                        dp["samples"].labels),
                       ("anchor labels", dk["anchor_targets"].labels,
                        dp["anchor_targets"].labels)):
        _check(torch.equal(a, b), f"training parity: {name} differ")
    lr = t.LEARNING_RATE
    losses = [e.train_step(batch, lr, TRAIN_STEP, draws) for e in engs]
    loss_err = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
                   for a, b in zip(*losses))
    sds = [e.model.state_dict() for e in engs]
    param_err = max(float((sds[0][n_] - sds[1][n_]).abs().max())
                    for n_ in sds[0])
    # identical pooled features and dfeat feed deterministic cuDNN / cuBLAS
    # kernels of the same shapes: the runs should agree exactly; the
    # tolerances allow reassociation only
    _check(loss_err <= 1e-6, f"training parity: losses differ by "
           f"{loss_err} (relative) > 1e-6")
    _check(param_err <= 1e-3 * lr, f"training parity: updated parameters "
           f"differ by {param_err} > {1e-3 * lr}")
    print(f"[parity] training step (TF32 off, deterministic cuDNN): kernels "
          f"vs plain versions: keep sets ({int(dk['props'].valid.sum())} "
          f"kept), proposals, sampled ROIs and labels identical; max "
          f"relative |d loss| {loss_err}, max |d param| {param_err} "
          f"(tolerances 1e-6 and {1e-3 * lr})", flush=True)
    return {"loss_rel_err": loss_err, "param_abs_err": param_err}


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
    from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool
    from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (
        roi_pool_fc, roi_pool_fc_backward, roi_pool_fc_backward_bf16,
        roi_pool_fc_bf16)

    return {f.__name__: f for f in (
        nms_keep, roi_pool_fc, roi_pool_fc_backward, roi_pool_fc_bf16,
        roi_pool_fc_backward_bf16, vgg_stem_fused, vgg_conv2_pool)}


def reset_counts():
    for f in kernel_wrappers().values():
        f.launches = 0
        if hasattr(f, "paths"):
            f.paths = dict.fromkeys(f.paths, 0)


def read_counts() -> dict:
    return {n: f.launches for n, f in kernel_wrappers().items()}


POOL_PATHS = {}     # main path -> the pool forwards' launches by path


def check_pool_paths(counts: dict, what: str) -> dict:
    """Every pool-forward launch of the run (``counts``, read just before)
    took the shared-memory path; recorded in POOL_PATHS[what]."""
    paths = {n: dict(f.paths) for n, f in kernel_wrappers().items()
             if hasattr(f, "paths")}
    for name, by in paths.items():
        _check(by == {"smem": counts[name], "direct": 0},
               f"{what}: {name} launches by path {by}, expected all "
               f"{counts[name]} on the shared-memory path")
    POOL_PATHS[what] = paths
    return paths


def check_counts(counts: dict, want: dict, what: str):
    """Every wrapper launched exactly ``want[name]`` times (0 if absent)."""
    for name, n in counts.items():
        _check(n == want.get(name, 0), f"{what}: {name} launched {n} times,"
               f" expected {want.get(name, 0)}")


def stem_bounds(b: int, h: int, w: int) -> dict:
    """name -> (bound_ms, bound_by, flops) at an [b, h, w] image batch:
    the fused stem's 27 + 576 and the tail's 576 multiply-adds per output
    pixel and channel at the dense bf16 tensor-core rate, against x (f32)
    or a1 (bf16) read once, the weights read once and the pooled f32 output
    written once."""
    out = b * (h // 2) * (w // 2) * 64 * 4
    work = {"vgg_stem_fused": (2 * b * h * w * 64 * (27 + 576),
                               b * h * w * 3 * 4 + out + (27 + 576 + 2) * 256),
            "vgg_conv2_pool": (2 * b * h * w * 64 * 576,
                               b * h * w * 64 * 2 + out + (576 + 1) * 256)}
    res = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        res[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops)
    return res


STEM_REL_TOL = 1e-5    # of max |plain|: f32 reassociation of exact products


def dyadic_stem_inputs(shape, device, seed: int = 11):
    """Phase 7's dyadic grid at ``shape`` [B, H, W, 3]: integer x in
    [-4, 4], w1/b1/w2/b2 multiples of 1/8 (w2 in [-1/2, 1/2]), and a bf16
    a1 of multiples of 1/8 in [0, 4]; every partial sum of either kernel
    is exact, so any order of sums gives the same bits."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def grid(*s, lo=-8, hi=9):
        return torch.randint(lo, hi, s, generator=gen, device=device,
                             dtype=torch.int32).float() / 8.0

    x = torch.randint(-4, 5, shape, generator=gen, device=device,
                      dtype=torch.int32).float()
    w = (grid(3, 3, 3, 64), grid(64), grid(3, 3, 64, 64, lo=-4, hi=5),
         grid(64))
    a1 = grid(*shape[:3], 64, lo=0, hi=33).to(torch.bfloat16)
    return x, w, a1


def check_stem_kernels(model, x, tag: str, dyadic: bool) -> dict:
    """Phase 7: both stem kernels against their plain versions on the image
    batch ``x`` [B, H, W, 3] with TF32 off: every element within
    STEM_REL_TOL of max |plain| (the kernels sum on the tensor cores), and,
    with ``dyadic``, bit for bit on the dyadic grid at the same shape;
    CUDA-event times of the kernel, of the plain version and of the cuDNN
    composition of the same layers in bf16 channels_last (its rounding
    differs: bf16 outputs; a yardstick, not a port), TFLOP/s and the
    fraction of the bound."""
    import torch
    import torch.nn.functional as F

    from wssdl_bus_tpu_torch.models.detector import _hwio
    from wssdl_bus_tpu_torch.ops.conv1 import vgg_stem_plain
    from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
    from wssdl_bus_tpu_torch.ops.conv2_pool import (vgg_conv1_1,
                                                    vgg_conv2_pool_plain)
    from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    bb = model.trunk.backbone
    w1, b1 = _hwio(bb.conv1_1)
    w2, b2 = _hwio(bb.conv1_2)
    bf16, cl = torch.bfloat16, torch.channels_last
    lib_w = [t.to(bf16).contiguous(memory_format=cl) if t.ndim == 4
             else t.to(bf16) for t in (bb.conv1_1.conv.weight,
                                       bb.conv1_1.conv.bias,
                                       bb.conv1_2.conv.weight,
                                       bb.conv1_2.conv.bias)]
    stats = {}
    with torch.no_grad():
        a1 = vgg_conv1_1(x, w1, b1, out_dtype=bf16)
        xb = x.permute(0, 3, 1, 2).to(bf16)
        a1n = a1.permute(0, 3, 1, 2)
        runs = {
            "vgg_stem_fused": (
                lambda: vgg_stem_fused(x, w1, b1, w2, b2),
                lambda: vgg_stem_plain(x, w1, b1, w2, b2),
                lambda: F.max_pool2d(F.relu(F.conv2d(F.relu(F.conv2d(
                    xb, lib_w[0], lib_w[1], padding=1)), lib_w[2], lib_w[3],
                    padding=1)), 2, 2)),
            "vgg_conv2_pool": (
                lambda: vgg_conv2_pool(a1, w2, b2),
                lambda: vgg_conv2_pool_plain(a1, w2, b2),
                lambda: F.max_pool2d(F.relu(F.conv2d(
                    a1n, lib_w[2], lib_w[3], padding=1)), 2, 2)),
        }
        if dyadic:
            dx, dw, da1 = dyadic_stem_inputs(tuple(x.shape), x.device)
            exact = {"vgg_stem_fused": (lambda: vgg_stem_fused(dx, *dw),
                                        lambda: vgg_stem_plain(dx, *dw)),
                     "vgg_conv2_pool": (
                         lambda: vgg_conv2_pool(da1, *dw[2:]),
                         lambda: vgg_conv2_pool_plain(da1, *dw[2:]))}
        bounds = stem_bounds(*x.shape[:3])
        for name, (kernel, plain, library) in runs.items():
            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            _check(got.shape == want.shape and err <= STEM_REL_TOL * scale,
                   f"{name} ({tag}): max |diff| {err} against the plain "
                   f"version > {STEM_REL_TOL} x max |plain| {scale}")
            del got, want
            line = ""
            if dyadic:
                got, want = (f() for f in exact[name])
                _check(torch.equal(got, want), f"{name} ({tag}): not bit "
                       "for bit the plain version on the dyadic grid")
                line = (f"; dyadic grid: bit for bit ({int((want > 0).sum())}"
                        f" of {want.numel()} outputs > 0)")
                del got, want
            ms = cuda_ms(kernel, 5, warmup=1)
            plain_ms = cuda_ms(plain, 1, warmup=0)
            library_ms = cuda_ms(library, 10)
            bnd, by, flops = bounds[name]
            stats[name] = {"max_abs_err": err, "max_rel_err": err / scale,
                           "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bnd, "bound_by": by,
                           "library_ms": library_ms,
                           "tflops": flops / ms / 1e9,
                           "bound_fraction": bnd / ms,
                           "input_shape": list(x.shape)}
            print(f"[stem] {name} {tag} x {tuple(x.shape)}: max |diff| vs "
                  f"plain {err} = {err / scale:.3e} of max |plain| "
                  f"(tolerance {STEM_REL_TOL}){line}; kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {bnd / ms:.3f} of the "
                  f"bound), plain {plain_ms:.3f} ms, cuDNN bf16 composition "
                  f"{library_ms:.4f} ms, bound {bnd:.4f} ms by {by}",
                  flush=True)
    torch.backends.cudnn.allow_tf32 = tf32
    return stats


def run_stem_path(name, eng, requests, net, teng, joint, weak, smi) -> dict:
    """Phase 9: serve and train with ``name``'s variable set: counters read
    around the served run (3 batch-1 + 1 batch-8 requests) and around the
    training run (3 combined + 1 MIL steps); ms/image, ms/step, peak
    memory.  The variable is restored afterwards."""
    import torch

    var = STEM_PATHS[name]
    os.environ[var] = "1"
    try:
        reset_counts()
        served = serve(eng, requests[:BATCH_1_REQUESTS], net, 1) \
            + serve(eng, requests, net, BATCH)
        torch.cuda.synchronize()
        serve_counts = read_counts()
        n = BATCH_1_REQUESTS + 1
        check_counts(serve_counts, {"nms_keep": n, "roi_pool_fc": n,
                                    name: n}, f"{var}=1 serving")
        check_pool_paths(serve_counts, f"serve_{var}")
        for scores, boxes, _ in served:
            _check(np.isfinite(scores).all() and np.isfinite(boxes).all()
                   and boxes.shape == (scores.shape[0], 12),
                   f"{var}=1: non-finite or misshapen detections")
        perf = {b: time_serving(eng, requests, net, b) for b in (1, BATCH)}
        for b, t in perf.items():
            print(f"[{var}] batch {b}: {t['ms_per_image']:.3f} ms/image end"
                  f" to end, device step {t['device_step_ms_per_image']:.3f}"
                  f"; peak {t['peak_bytes'] / 2**20:.1f} MiB; {smi}",
                  flush=True)

        model = teng.model
        before = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rows, step_ms, mil, mil_ms = run_training(teng, joint, weak)
        torch.cuda.synchronize()
        train_counts = read_counts()
        check_counts(train_counts, {
            "nms_keep": TRAIN_STEPS + 1, "roi_pool_fc": 2 * TRAIN_STEPS + 1,
            "roi_pool_fc_backward": 2 * TRAIN_STEPS + 1,
            name: TRAIN_STEPS + 1}, f"{var}=1 training")
        check_pool_paths(train_counts, f"train_{var}")
        peak = torch.cuda.max_memory_allocated()
        after = model.state_dict()
        frozen = [k for k in after if ".conv1_" in k or ".conv2_" in k]
        _check(all(torch.equal(before[k], after[k]) for k in frozen),
               f"{var}=1: conv1/conv2 parameters changed")
        step_time = time_train_step(teng, joint[-1])
    finally:
        del os.environ[var]
    print(f"[{var}] launches: serving {serve_counts}, training "
          f"{train_counts}; training: losses finite, conv1/conv2 bitwise "
          f"unchanged, combined step {step_time:.3f} ms by CUDA events, "
          f"MIL step {mil_ms:.2f} ms host clock, peak "
          f"{peak / 2**20:.1f} MiB; {smi}", flush=True)
    return {"serve_launches": serve_counts, "train_launches": train_counts,
            "serving": {str(b): v for b, v in perf.items()},
            "training": {"losses": rows, "mil_step_loss": mil,
                         "step_ms_cuda_events": step_time,
                         "step_ms_host": step_ms, "mil_step_ms_host": mil_ms,
                         "peak_bytes": peak}}


def check_serve_parity(eng, eng_plain, requests, net, what: str):
    """Phase 6a/9: the served requests through the kernels and through the
    plain versions: keep sets and proposal boxes identical, class
    probabilities to 1e-6, reported detections identical.  -> the
    kernels' detections."""
    import torch

    outs_k = eng.inference_step(*_packed(eng, requests, net))
    outs_p = eng_plain.inference_step(*_packed(eng, requests, net))
    _check(torch.equal(outs_k[1], outs_p[1]), f"{what}: valid masks differ")
    _check(torch.equal(outs_k[0], outs_p[0]),
           f"{what}: proposal boxes differ")
    prob_err = float((outs_k[3] - outs_p[3]).abs().max())
    # identical pooled features feed identical head kernels: the tolerance
    # allows only f32 reassociation in the head's matmuls
    _check(prob_err <= 1e-6, f"{what}: cls_prob differs by {prob_err} > "
           "1e-6")
    det_k = serve(eng, requests, net, BATCH)
    det_p = serve(eng_plain, requests, net, BATCH)
    for (_, _, ek), (_, _, ep) in zip(det_k, det_p):
        _check(ek == ep, f"{what}: served detections differ from the "
               "plain run")
    print(f"[parity] {what} (TF32 off): kernels vs plain versions on the "
          f"card: keep sets and proposal boxes identical, max |d cls_prob| "
          f"{prob_err}, reported detections identical", flush=True)
    return det_k


def check_stem_output(model, data, what: str) -> float:
    """Phase 9a: the model's own stem output (``FasterRCNN._stem``, the
    dispatch ``apply_trunk`` makes, the stem variable set) against the plain
    stem's on the same batch: within STEM_REL_TOL of its max.  -> the
    relative max |diff|."""
    import torch

    data = torch.as_tensor(data, device="cuda")
    with torch.no_grad():
        got = model._stem(data, plain_ops=False)
        want = model._stem(data, plain_ops=True)
    torch.cuda.synchronize()
    _check(got is not None and got.shape == want.shape,
           f"{what}: the stem did not dispatch")
    rel = float((got - want).abs().max() / want.abs().max())
    _check(rel <= STEM_REL_TOL, f"{what}: the kernel's stem output differs "
           f"from the plain stem's by {rel} of its max > {STEM_REL_TOL}")
    print(f"[parity] {what}: the model's stem output {tuple(got.shape)} "
          f"within {rel:.3e} of the plain stem's max (tolerance "
          f"{STEM_REL_TOL})", flush=True)
    return rel


@contextlib.contextmanager
def kernel_stem_in_plain_runs():
    """Phase 9b: the plain-versions runs take the stem kernels' output as
    their stem, so that everything after the stem can be held exactly."""
    from wssdl_bus_tpu_torch.models import detector

    saved = detector.vgg_stem_plain, detector.vgg_conv2_pool_plain
    detector.vgg_stem_plain = detector.vgg_stem_fused
    detector.vgg_conv2_pool_plain = detector.vgg_conv2_pool
    try:
        yield
    finally:
        detector.vgg_stem_plain, detector.vgg_conv2_pool_plain = saved


def stem_distance(eng, requests, net, det_default, name) -> dict:
    """For information only: how far ``name``'s stem path (bf16 rounding,
    the JAX package's accepted numerics) moves the features and the served
    detections from the default f32 stem, both with TF32 off."""
    import torch

    data, _ = _packed(eng, requests, net)
    data = torch.as_tensor(data, device=eng.device)
    with torch.no_grad():
        base = eng.model.apply_trunk(data)[0]
        os.environ[STEM_PATHS[name]] = "1"
        try:
            feat = eng.model.apply_trunk(data)[0]
            det = serve(eng, requests, net, BATCH)
        finally:
            del os.environ[STEM_PATHS[name]]
    rel = float((feat - base).abs().max() / base.abs().max())
    same = sum(int(a[2] == b[2]) for a, b in zip(det, det_default))
    n_dets = sum(len(e) for _, _, e in det)
    print(f"[info] {STEM_PATHS[name]}=1 vs the default f32 stem (TF32 off):"
          f" conv5_3 features max |diff| {rel:.3e} of their max; reported "
          f"detections identical for {same} of {len(det)} requests "
          f"({n_dets} detections)", flush=True)
    return {"feat_rel_max_diff": rel, "requests_identical": same}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke needs a card")
    sys.path.insert(0, REPO)
    from wssdl_bus_tpu_torch.config import Config
    from wssdl_bus_tpu_torch.data.augment import max_canvas
    from wssdl_bus_tpu_torch.models.convert import he_init_
    from wssdl_bus_tpu_torch.models.detector import build_detector
    from wssdl_bus_tpu_torch.ops import _build
    from wssdl_bus_tpu_torch.train.engine import Engine

    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    out_dir = os.path.join(REPO, "chiprun_out")
    for var in STEM_PATHS.values():     # the default paths run without them
        os.environ.pop(var, None)
    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] torch: {kind} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"[build] {len(_build.SOURCES)} sources built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    net = "VGGnet_test"
    cfg = Config()
    requests = make_requests(seed=0, n=BATCH)
    canvas = max_canvas([r.shape for r in requests], cfg.TEST.SCALES[0],
                        cfg.TEST.MAX_SIZE)
    model = build_model("cuda", seed=0)
    eng = Engine(model, cfg, canvas)
    print(f"[serve] VGG16 full width, canvas {canvas}, TEST budgets "
          f"{cfg.TEST.RPN_PRE_NMS_TOP_N}/{cfg.TEST.RPN_POST_NMS_TOP_N}, "
          f"{len(requests)} requests of sizes "
          f"{sorted({r.shape for r in requests})}", flush=True)

    # phase 3: kernels against their plain versions, and the pool
    # forward's direct path at a map too large for its shared-memory path
    stats = check_kernels(eng, requests, net)
    stats["roi_pool_fc"]["per_shape"]["direct"] = check_direct_path()

    # phase 4a: the served path through the kernels, counters around it
    reset_counts()
    served_1 = serve(eng, requests[:BATCH_1_REQUESTS], net, 1)
    served_8 = serve(eng, requests, net, BATCH)
    torch.cuda.synchronize()
    serve_launches = read_counts()
    want = BATCH_1_REQUESTS + 1
    print(f"[serve] launches during the served run: {serve_launches} "
          f"(expected {want} for the two forward kernels: one per served "
          f"batch; none for the opt-in stem kernels)", flush=True)
    check_counts(serve_launches, {"nms_keep": want, "roi_pool_fc": want},
                 "serving")
    print(f"[serve] pool forward launches by path: "
          f"{check_pool_paths(serve_launches, 'serve')}", flush=True)
    for scores, boxes, _ in served_1 + served_8:
        _check(scores.ndim == 2 and scores.shape[1] == 3
               and boxes.shape == (scores.shape[0], 12),
               f"output shapes {scores.shape} {boxes.shape}")
        _check(np.isfinite(scores).all() and np.isfinite(boxes).all(),
               "non-finite detections")
    for (s1, b1, e1), (s8, b8, e8) in zip(served_1, served_8):
        _check(s1.shape == s8.shape, "batch 1 and batch 8 proposal counts "
               "differ for the same request")
    n_dets = [len(e) for _, _, e in served_8]
    print(f"[serve] batch 8: {[len(s) for s, _, _ in served_8]} valid "
          f"proposals, {n_dets} reported detections (score >= 0.5)",
          flush=True)

    # phase 4b: timing and peak memory (PyTorch defaults: TF32 convs)
    perf = {}
    for b in (1, BATCH):
        perf[b] = t = time_serving(eng, requests, net, b)
        print(f"[perf] batch {b}: {t['ms_per_image']:.3f} ms/image end to "
              f"end = prep {t['prep_ms_per_image']:.3f} + device step "
              f"{t['device_step_ms_per_image']:.3f} + decode/report "
              f"{t['decode_report_ms_per_image']:.3f}; peak "
              f"{t['peak_bytes'] / 2**20:.1f} MiB allocated; {smi}",
              flush=True)
    if profile:
        profile_step(eng, requests, net, out_dir)

    # phase 5: the training path, default TRAIN settings
    tcfg = Config()
    t = tcfg.TRAIN
    tmp = tempfile.TemporaryDirectory()
    sup, ws, sizes = write_roidb(tmp.name, seed=1,
                                 n_sup=TRAIN_STEPS * t.IMS_PER_BATCH,
                                 n_ws=TRAIN_STEPS * t.WS_IMS_PER_BATCH)
    crop = t.CROPPING_MAX_MARGIN if t.USE_CROPPING else 0.0
    tcanvas = max_canvas(sizes, t.SCALES[0], t.MAX_SIZE, crop_margin=crop)
    joint, weak = train_batches(tcfg, tcanvas, sup, ws, TRAIN_STEPS)
    tmodel = he_init_(build_detector("VGGnet_train", device="cuda"), 0,
                      input_scale=64.0)
    teng = Engine(tmodel, tcfg, tcanvas)
    print(f"[train] VGG16 full width, canvas {tcanvas}, {t.IMS_PER_BATCH} "
          f"supervised + {t.WS_IMS_PER_BATCH} weak images, RPN "
          f"{t.RPN_PRE_NMS_TOP_N} -> {t.RPN_POST_NMS_TOP_N} at NMS "
          f"{t.RPN_NMS_THRESH}, {t.BATCH_SIZE} ROIs per supervised image, "
          f"adam lr {t.LEARNING_RATE}, MIL {teng.selector_pair}", flush=True)

    # phase 5a: NMS at the combined and the MIL step's candidates, and the
    # backward kernel at the step's shapes
    for tag, batch in (("train", joint[0]), ("mil", weak)):
        stats["nms_keep"]["per_shape"][tag] = check_nms(
            *training_candidates(teng, batch), tag)
    groups = training_groups(teng, joint[0])
    stats["roi_pool_fc_backward"] = check_backward_kernel(teng, groups,
                                                          torch.float32)

    # phase 5b: 3 combined steps + 1 MIL step, counters around them
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rows, step_ms, mil, mil_ms = run_training(teng, joint, weak)
    torch.cuda.synchronize()
    train_launches = read_counts()
    expect = {"nms_keep": TRAIN_STEPS + 1,
              "roi_pool_fc": 2 * TRAIN_STEPS + 1,
              "roi_pool_fc_backward": 2 * TRAIN_STEPS + 1}
    print(f"[train] launches during the training run: {train_launches} "
          f"(expected {expect}: NMS once per step, the pool forward and "
          f"backward twice per combined step and once per MIL step; none "
          f"for the stem kernels)", flush=True)
    check_counts(train_launches, expect, "training")
    print(f"[train] pool forward launches by path: "
          f"{check_pool_paths(train_launches, 'train')}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    after = tmodel.state_dict()
    frozen = [k for k in after if ".conv1_" in k or ".conv2_" in k]
    _check(len(frozen) == 8 and all(torch.equal(before[k], after[k])
                                    for k in frozen),
           "conv1/conv2 parameters changed")
    unmoved = [k for k in after if k not in frozen
               and torch.equal(before[k], after[k])]
    _check(not unmoved, f"parameters that did not move: {unmoved}")
    step_time = time_train_step(teng, joint[-1])
    print(f"[train] {TRAIN_STEPS} combined steps + 1 MIL step: all losses "
          f"finite; conv1/conv2 ({len(frozen)} tensors) bitwise unchanged, "
          f"the other {len(after) - len(frozen)} moved; combined step "
          f"{step_time:.3f} ms by CUDA events (3 more steps), host clock "
          f"{', '.join(f'{x:.2f}' for x in step_ms)} ms, MIL step "
          f"{mil_ms:.2f} ms; peak {peak / 2**20:.1f} MiB allocated; {smi}",
          flush=True)
    if profile:
        profile_train(teng, joint[-1], out_dir)

    # phase 7: the stem kernels at the served and the training shapes
    serve_x = torch.as_tensor(_packed(eng, requests, net)[0], device="cuda")
    train_x = torch.as_tensor(joint[0]["data"], device="cuda")
    stem_stats = {"serve": check_stem_kernels(model, serve_x, "serve B=8",
                                              dyadic=True),
                  "train": check_stem_kernels(tmodel, train_x, "train B=3",
                                              dyadic=False)}
    del serve_x, train_x

    # phase 8: the bf16 output option of the ROI pool at the training
    # shapes, and the f32 forward on the same ROIs
    train_fwd = check_train_forward(teng, groups)
    stats["roi_pool_fc_bf16"] = train_fwd["bf16"]
    stats["roi_pool_fc"]["per_shape"]["train"] = train_fwd["f32"]
    stats["roi_pool_fc_bf16"]["per_shape"] = {
        "serve": stats.pop("roi_pool_fc_bf16_serve"),
        "train": train_fwd["bf16"]["per_group"]}
    stats["roi_pool_fc_backward_nan"] = backward_nan_routing(teng, groups)
    stats["roi_pool_fc_backward_bf16"] = check_backward_kernel(
        teng, groups, torch.bfloat16)
    bf16_launches = run_bf16_pool_path(teng, groups)
    del groups

    # phase 9: the opt-in stem paths, serving and training
    stem_runs = {name: run_stem_path(name, eng, requests, net, teng, joint,
                                     weak, smi) for name in STEM_PATHS}

    # phase 6 (and 9): parity with the plain versions, TF32 off on both
    # sides so the trunks are bit-identical
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    eng_plain = Engine(model, cfg, canvas, plain_ops=True)
    det_default = check_serve_parity(eng, eng_plain, requests, net,
                                     "f32 default stem")
    parity = {"train": check_train_parity(tmodel, tcfg, tcanvas, joint[0])}
    stem_data = {"serve": (eng.model, _packed(eng, requests, net)[0]),
                 "train": (tmodel, joint[0]["data"])}
    for name, var in STEM_PATHS.items():
        os.environ[var] = "1"
        try:
            stem_err = {k: check_stem_output(m, d, f"{var}=1 {k}")
                        for k, (m, d) in stem_data.items()}
            with kernel_stem_in_plain_runs():
                check_serve_parity(eng, eng_plain, requests, net,
                                   f"{var}=1, both sides given the kernel's "
                                   "stem")
                parity[name] = check_train_parity(tmodel, tcfg, tcanvas,
                                                  joint[0])
        finally:
            del os.environ[var]
        parity[name]["stem_rel_err"] = stem_err
        parity[name]["vs_default_stem"] = stem_distance(
            eng, requests, net, det_default, name)
    tmp.cleanup()

    paths = {"serve": serve_launches, "train": train_launches,
             "bf16_pool": bf16_launches}
    for name, run in stem_runs.items():
        paths[f"serve_{STEM_PATHS[name]}"] = run["serve_launches"]
        paths[f"train_{STEM_PATHS[name]}"] = run["train_launches"]

    def launches(name):
        by_path = {p: c[name] for p, c in paths.items()}
        _check(sum(by_path.values()) > 0, f"{name} never launched on its "
               "path")
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    def kernel_stats(st):
        return {k: st[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}

    def stem_entry(name, source, replaces):
        sv, tr = stem_stats["serve"][name], stem_stats["train"][name]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    **launches(name), **kernel_stats(sv),
                    library_ms=sv["library_ms"],
                    max_abs_err_train=tr["max_abs_err"],
                    per_shape={"serve": sv, "train": tr})

    kernels = [
        dict(name="nms_keep", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/nms.cu",
             replaces="wssdl_bus_tpu/ops/nms_pallas.py:42",
             library_ms=None, **launches("nms_keep"), **stats["nms_keep"]),
        dict(name="roi_pool_fc", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:373",
             library_ms=None, **launches("roi_pool_fc"),
             **kernel_stats(stats["roi_pool_fc"]),
             launches_by_forward_path={
                 p: c["roi_pool_fc"] for p, c in POOL_PATHS.items()},
             per_shape=stats["roi_pool_fc"]["per_shape"]),
        dict(name="roi_pool_fc_backward", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:140",
             library_ms=None, **launches("roi_pool_fc_backward"),
             **kernel_stats(stats["roi_pool_fc_backward"])),
        dict(name="roi_pool_fc_bf16", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:373",
             library_ms=None, **launches("roi_pool_fc_bf16"),
             **kernel_stats(stats["roi_pool_fc_bf16"]),
             launches_by_forward_path={
                 p: c["roi_pool_fc_bf16"] for p, c in POOL_PATHS.items()},
             per_shape=stats["roi_pool_fc_bf16"]["per_shape"]),
        dict(name="roi_pool_fc_backward_bf16", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:426",
             library_ms=None, **launches("roi_pool_fc_backward_bf16"),
             **kernel_stats(stats["roi_pool_fc_backward_bf16"])),
        stem_entry("vgg_stem_fused", "wssdl_bus_tpu_torch/csrc/conv1.cu",
                   "wssdl_bus_tpu/ops/conv1_pallas.py:141"),
        stem_entry("vgg_conv2_pool", "wssdl_bus_tpu_torch/csrc/conv2_pool.cu",
                   "wssdl_bus_tpu/ops/conv2_pool_pallas.py:196"),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"serving": {str(b): v for b, v in perf.items()},
                      "training": {"losses": rows, "mil_step_loss": mil,
                                   "step_ms_cuda_events": step_time,
                                   "step_ms_host": step_ms,
                                   "mil_step_ms_host": mil_ms,
                                   "peak_bytes": peak},
                      "parity": parity,
                      "backward_per_launch": {
                          k: stats[k]["per_launch"] for k in (
                              "roi_pool_fc_backward",
                              "roi_pool_fc_backward_bf16")},
                      "backward_nan_routing":
                          stats["roi_pool_fc_backward_nan"],
                      "backward_dense_weak_ms": {
                          k: stats[k]["dense_weak_ms"] for k in (
                              "roi_pool_fc_backward",
                              "roi_pool_fc_backward_bf16")},
                      "stem_paths": {STEM_PATHS[n]: {
                          k: v for k, v in r.items() if k in (
                              "serving", "training")}
                          for n, r in stem_runs.items()},
                      "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
