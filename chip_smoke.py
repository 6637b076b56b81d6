#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU:
VGG16 (phases 3-12), the ResNet detectors (phase 13), bf16 compute and int8
serving (phase 14), and the serving surface: artifacts, the HTTP server and
the export / predict CLIs (phase 15).

    python3 chip_smoke.py [--profile]

Phases (any failure, a failed check or an exception, prints
``chip_smoke: FAIL: phase <n> (<name>): ...`` on stdout and exits 1; in a
directory without the port beside it, phase 0 fails so):
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
     the launch counters around it; then both backward kernels (#4, #5)
     under NaNs in the map (in bins, in a window below a bin, outside the
     ROIs' columns) and in the cotangent (some ROIs, all of it), on the
     supervised and the weak group: the same NaN positions as the plain
     versions (which follow the Pallas kernels) and equal values elsewhere;
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
 10. the evaluation entry point, ``python -m wssdl_bus_tpu_torch.main.test``
     (its ``main``), over a synthetic SNUBH-layout imdb of 16 images (8 at
     450 x 600, 8 at 480 x 640) from a port snapshot of seeded He weights,
     TEST defaults, at batch 1 and batch 8 and once with
     ``TEST.DEBUG_TIMELINE``: the native host library loads; one NMS and
     one pool forward per device step (16 and 2), all on the shared-memory
     path; ``detections.pkl``, ``eval.txt`` (AP / CorLoc / Mean AP) and the
     FROC points written, and the trace; ms/image split into host read +
     prep, device step (CUDA events), copy-back + decode and NMS; then
     (after phase 6 turns TF32 off) ``test_net`` at batch 8 through the
     kernels and with ``plain_ops=True``: all_boxes equal;
 11. (TF32 off, deterministic cuDNN) the training entry points over the
     evaluation imdb (training, weak and test imdb alike, as the CLI
     defaults are), from the seeded He weights written as a
     ``--pretrained_model`` ``.npy`` (every array loaded), default TRAIN
     budgets and ``DEVICE_PREP``: ``main.train.main`` for 6 iterations
     with prefetch, evaluations (batch 8) and snapshots at 3 and 6 (files,
     finite losses, launches: per iteration 1 NMS + 2 pool forward + 2
     backward, per evaluation pass 2 + 2 + 0, every forward on the
     shared-memory path); its ``--resume`` from the iteration-3 snapshot,
     both under ``torch.use_deterministic_algorithms`` (warnings name any
     op without a deterministic implementation): parameters and moments
     of the iteration-6 snapshots equal bit for bit, test losses equal
     (else held to the spread of two uninterrupted runs);
     ``main.train_alter.main`` for 4 iterations (supervised 0-2, weak 1-3:
     1 + 1 + 1 launches a step, two optimizer states stepped 3 times,
     ws_step 3); both regimes with and without prefetch at PyTorch's
     defaults (cuDNN TF32 convs) and the host-prep feed for the numbers
     (ms per iteration by host clock and CUDA events, the feed's host ms,
     upload bytes, evaluation ms/image, peak memory); the
     device-prepped blob against the host blob for one supervised and one
     weak batch; ``periodic_eval`` from the iteration-6 snapshot through
     the kernels and with ``plain_ops=True``: all_boxes and test losses
     equal; the pool forward at the eval step's [8, 128] ROIs against its
     plain version, timed;
 13. the ResNet detectors at full width from seeded He weights (the RPN's
     1x1 kernels x 0.03), at the served canvas and the default TEST and
     TRAIN budgets.  13a (run after phase 8, before the evaluation phase's
     profiler trace): kernel #3 (``roi_pool_grouped``) against its plain
     version at the served batch of 8 and at the combined step's two groups
     of ResNet-18 BN (C = 256) and ResNet-50 GN (C = 1024) (both flavors
     and 64 NaNs planted in the map; ``forward_plan``'s path and grid;
     CUDA-event and profiler times beside the bound), #4 at the two groups
     (MIL, dense and tie cotangents, then the five NaN cases, f32).  The
     rest after phase 11 (TF32 off and deterministic cuDNN except where
     timed).  ResNet-18 BN (the CLI default): serving through
     ``im_detect_batch`` + ``report_detections`` (3 requests at batch 1, 8
     at batch 8: one NMS and one #3 launch per device step, every #3
     launch on the shared-memory path) with ms/image by stage and peak
     memory at PyTorch's defaults; 3 combined steps and 1 MIL step (1 + 2
     + 2 launches of #1 / #3 / #4 a combined step, 1 + 1 + 1 a MIL step;
     every parameter moved, every running statistic moved by the combined
     steps and bit for bit unchanged by the MIL step; ms/step by CUDA
     events and peak memory); the served batch and one combined step
     through the kernels and with ``plain_ops=True`` (as phase 6, running
     statistics among the compared tensors).  ResNet-50 GN (bottleneck
     blocks, GroupNorm, C = 1024): batch-8 serving and one combined step.
     Then ``main.train --network Resnet_train`` (18,
     BN) from the He weights as a ResNet ``.npy`` for 3 iterations over the
     evaluation imdb (evaluation at 3, snapshots at 2 and 3; #3 at the
     evaluation's [8, 128] ROIs against its plain version, timed beside
     its bound) and its ``--resume`` from 2 (parameters, running
     statistics, moments and test losses equal bit for bit), and
     ``main.test --network Resnet_test`` on the snapshot at batch 8; logs in ``chiprun_out/resnet_*.log``;
 14. (after phase 13) bf16 and int8, VGG16 and ResNet-18 BN (int8 also
     ResNet-50 BN) at the served
     canvas: the int8 conv kernel (``csrc/int8_conv.cu``) against its
     plain version, bit for bit, in both variants (f32 out, and int8 out
     through its requantizing epilogue) at every layer shape of each
     model's batch-8 int8 step (the inputs recorded from that step; 12 /
     8 / 32 convs of the VGG16 / ResNet-18 BN / ResNet-50 BN step write
     int8), each timed beside its bound (int8 operations at 1,979 TOP/s,
     or bytes at the output's element size), cuDNN's bf16 conv
     of the same layer and, for a 1x1 layer, ``torch._int_mm`` on its
     operand (library yardsticks the port never calls); int8 serving
     through ``Engine.quantize_for_serving`` (calibrated on the requests'
     batch-8 blob) and ``QuantServingEngine`` (3 requests at batch 1, 8 at
     batch 8: per device step one NMS, one pool forward and one int8 conv
     per quantized layer), ms/image by stage and peak memory, all five
     outputs through the kernels equal to ``plain_ops=True``, the keep sets
     against the f32 step's (a diagnostic); ``--bf16`` serving and one
     bf16 combined step (outputs f32, no bf16 pool launch, f32
     parameters) timed beside f32; ``main.test --int8`` and ``--bf16`` at
     batch 8 over the evaluation imdb and ``main.train --bf16`` for 3
     iterations (logs ``chiprun_out/precision_*.log``);
 15. (after phase 14; TF32 off but where timed) the serving surface at full
     width from the seeded He weights: ``serve.export_serving`` of VGG16
     f32 and int8 (calibrated on the requests' batch-8 blob) at batch sizes
     (1, 8) and of ResNet-18 BN at (8,), ``load_serving`` on the card (the
     int8 artifact's replaced parameters NaN, its file < 0.7x the f32
     one); each driven through ``ServingModel.detect`` (3 single requests,
     the batch of 8, the first 3 padded to 8) with the counters around it
     (per device step one NMS, one pool forward, #2 or #3, and 13 #8 for
     int8), its batch-8 detections equal to the live engine's
     (``im_detect_batch``; for int8 the live ``QuantServingEngine``) bit
     for bit, padded requests against the unpadded live run (the same
     kept proposals and classes, scores and boxes within ``PAD_ATOL``:
     another batch size may take another cuDNN algorithm), the int8
     artifact's step equal to ``plain_ops=True``, ms/image at batch 1 and
     8 at PyTorch's defaults; the HTTP server (``serve.server.serve`` on a
     loopback port in a thread) over the VGG16 artifact: 64 PNG requests
     (450 x 600 / 480 x 640) from 8 client threads, every response 200
     and the library path's report (classes equal, values within the
     padding tolerances), one NMS and one pool forward per device step;
     the same load at PyTorch's defaults for ``/metrics``' latency
     percentiles and images per second, then 16 sequential single
     requests; ``main.export`` (with and without ``--int8``) from phase
     10's snapshot and ``main.predict`` on 3 PNGs from the artifact, the
     snapshot and the int8 artifact (logs ``chiprun_out/serve_*.log``);
 12. a ``{"kernels": [...]}`` line (#3 as ``roi_pool_grouped``, its
     launches from the ResNet paths; the int8 conv as ``int8_conv``, its
     numbers those of the VGG16 batch-8 int8 step), then the last line
     ``{"ok": true, "device": {...}}``.

``--profile`` adds torch.profiler breakdowns (device time by kernel, busy
share) of the batch-8 serving step and of the combined training step, for
VGG16 and for ResNet-18 BN, of the int8 batch-8 serving steps, and their
Chrome traces in chiprun_out/.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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


PHASE = "0 (start)"     # the phase running; every failure names it


def phase(label: str) -> None:
    global PHASE
    PHASE = label


def _fail(msg: str):
    """Name the phase and the failure on stdout (and stderr) and exit 1."""
    line = f"chip_smoke: FAIL: phase {PHASE}: {msg}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
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


def build_model(device, seed: int, name: str = "VGGnet_test", dtype=None):
    """VGG16 (``name``) with He weights from ``seed`` and the compute dtype
    ``dtype``; the requests arrive in pixel units (std ~50), hence
    ``input_scale`` (models/convert.py:he_tree)."""
    from wssdl_bus_tpu_torch.models.convert import he_init_
    from wssdl_bus_tpu_torch.models.detector import build_detector

    return he_init_(build_detector(name, device=device, compute_dtype=dtype),
                    seed, input_scale=64.0)


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


def profile_step(eng, requests, net, out_dir: str, tag: str = ""):
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
    print(f"[profile{tag}] 3 steps of batch {len(requests)}: wall "
          f"{wall * 1e3:.3f}"
          f" ms, device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)",
          flush=True)
    for e in events[:15]:
        print(f"[profile{tag}] {e.device_time_total / 3e3:9.4f} ms/step "
              f"x{e.count // 3:<4d} {e.key[:110]}", flush=True)
    # the int8 path's PyTorch quantize steps (x / s, round, clamp) and
    # whatever else divides, rounds or clamps
    quant = [e for e in events if any(w in e.key.lower()
                                      for w in ("div", "round", "clamp"))]
    print(f"[profile{tag}] div / round / clamp kernels: "
          f"{sum(e.count for e in quant) // 3} a step, "
          f"{sum(e.device_time_total for e in quant) / 3e3:.4f} ms/step",
          flush=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"serve_b8{tag}_trace.json"))


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


def train_batches(cfg, canvas, sup, ws, n_steps: int,
                  net: str = "VGGnet_train"):
    """``n_steps`` joint minibatches (1 + 2 images each) and one weak-only
    minibatch for ``net``'s pixel scale, drawn from one
    RandomState(cfg.RNG_SEED) in that order."""
    from wssdl_bus_tpu_torch.data.minibatch import (get_minibatch,
                                                    get_minibatch_joint)

    rng = np.random.RandomState(cfg.RNG_SEED)
    n_s, n_w = cfg.TRAIN.IMS_PER_BATCH, cfg.TRAIN.WS_IMS_PER_BATCH
    joint = [get_minibatch_joint(sup[k * n_s:(k + 1) * n_s],
                                 ws[k * n_w:(k + 1) * n_w], net, cfg,
                                 canvas, rng)
             for k in range(n_steps)]
    weak = get_minibatch(ws[:n_w], net, cfg, canvas, True, True, rng)
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
BACKWARD_PHASES = ("roi_rows_scan", "roi_rows_compact", "roi_argmax",
                   "roi_gather")


def check_backward_kernel(eng, groups, dtype, label: str = "",
                          pattern: str = "mil"):
    """Phase 5a (f32 cotangent, kernel #4), phase 8 (bf16 cotangent, the
    bf16 output's backward) and phase 13a (f32, ``label`` the ResNet): the
    backward kernel against its plain version at the combined step's two
    launches (the supervised group [1, 128] and the weak group [2, 2000] of
    ROIs on a [38, 56, C] map) with three cotangent patterns; the step's
    two launches timed with ``pattern``'s cotangents, the one the step
    gives the kernel ("mil": the weak group's one row per bag; "dense":
    every row, as a BatchRenorm head gives it)."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool import (active_rows, roi_pool_grad,
                                                  roi_pool_grad_bf16)
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (
        roi_pool_fc_backward, roi_pool_fc_backward_bf16)

    bf16 = dtype == torch.bfloat16
    kernel = roi_pool_fc_backward_bf16 if bf16 else roi_pool_fc_backward
    plain = roi_pool_grad_bf16 if bf16 else roi_pool_grad
    tag = ("[backward-bf16]" if bf16 else "[backward]") + label
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
    for case, gs in cases.items():
        for k, g in gs.items():
            f, rois = groups[k]
            got = kernel(f, rois, g, 7, 7, scale)
            want = plain(f, rois, g, 7, 7, scale)
            torch.cuda.synchronize()
            _check(torch.equal(got != 0, want != 0),
                   f"{tag} {case} {k}: nonzero positions differ")
            e = float((got - want).abs().max())
            _check(e == 0.0, f"{tag} {case} {k}: max |diff| {e}")
            err = max(err, e)
            print(f"{tag} {case:5s} {k:4s} g {tuple(g.shape)} {dtype}, "
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

    # times of one step's two launches, in the step's own pattern
    gs = cases[pattern]
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
    dbound, dby = roi_pool_bwd_bound(*groups["weak"], cases["dense"]["weak"],
                                     scale)
    print(f"{tag} weak launch with a dense cotangent (all 4000 rows): "
          f"kernel {tdense:.4f} ms ({split_text(split)} ms by the "
          f"profiler), bound {dbound:.4f} ms by {dby}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if all(
                v["bound_by"] == "bytes" for v in per.values())
            else "operations", "per_launch": per, "pattern": pattern,
            "dense_weak_ms": tdense, "dense_weak_split_ms": split,
            "dense_weak_bound_ms": dbound}


NAN_CASES = ("in_bins", "below_bins", "outside_columns", "g_some_rois",
             "g_all")


def plant_nans(case, f, rois, g, scale, seed):
    """(f, g) copies with the NaNs of one backward NaN case, planted by the
    windows of ROIs 0..7 of each image (in the MIL pattern ROI 0 is the
    active one): a cell inside a bin; the row just below bin row 0, inside
    its window; a cell of bin row 0's rows outside every ROI's columns (or,
    where the ROIs cover every column, outside the ROI's own); NaN
    cotangents in some ROIs (one in a single channel block); a fully NaN
    cotangent, the diverged step."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool import bin_edges, quantize_rois

    f, g = f.clone(), g.clone()
    b, h, w, c = f.shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if case == "g_all":
        g[:] = float("nan")
        return f, g
    if case == "g_some_rois":
        g4 = g.view(b, rois.shape[1], 49, c)
        for bi in range(b):
            for r in range(min(4, rois.shape[1])):
                ch = int(torch.randint(0, c, (1,), generator=gen))
                g4[bi, r, int(torch.randint(0, 49, (1,), generator=gen)),
                   ch] = float("nan")
        return f, g
    rsw, rsh, roi_w, roi_h = quantize_rois(rois.reshape(-1, 4).cpu(), scale)
    hlo, hhi = bin_edges(rsh, roi_h, 7, h, "gpu")
    wlo, whi = bin_edges(rsw, roi_w, 7, w, "gpu")
    p = rois.shape[1]
    for bi in range(b):
        covered = torch.zeros(w, dtype=torch.bool)
        for q in range(bi * p, (bi + 1) * p):
            covered[int(wlo[q, 0]):int(whi[q, -1])] = True
        for r in range(min(8, p)):
            q = bi * p + r
            ch = int(torch.randint(0, c, (1,), generator=gen))
            y0, y1 = int(hlo[q, 0]), int(hhi[q, -1])
            x0, x1 = int(wlo[q, 0]), int(whi[q, -1])
            if y1 <= y0 or x1 <= x0:
                continue
            if case == "in_bins":
                y, x = (y0 + y1) // 2, (x0 + x1) // 2
            elif case == "below_bins":
                y, x = min(int(hhi[q, 0]), h - 1), x0
            else:
                free = (~covered).nonzero().flatten()
                y = y0
                x = int(free[r % len(free)]) if len(free) else (
                    x1 if x1 < w else x0 - 1)
                if x < 0:
                    continue
            f[bi, y, x, ch] = float("nan")
    return f, g


def check_backward_nan_routing(eng, groups, dtypes=None,
                               label: str = "") -> dict:
    """Phase 8b: both backward kernels (#4 f32, #5 bf16) against their
    plain versions, which follow the Pallas kernels, under NaNs: in the map
    (inside bins, in a window below a bin, outside the ROIs' columns inside
    a window's rows) and in the cotangent (some ROIs, all of it), on the
    supervised (dense cotangent) and the weak (MIL cotangent) group.  The
    same NaN positions and equal values elsewhere, or the run fails.
    ``dtypes``: the cotangent dtypes (both by default); ``label`` names the
    model in the output."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool import (roi_pool_grad,
                                                  roi_pool_grad_bf16)
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (
        roi_pool_fc_backward, roi_pool_fc_backward_bf16)

    scale = 1.0 / eng.cfg.FEAT_STRIDE
    gen = torch.Generator(device=eng.device).manual_seed(4)
    out = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        kernel = roi_pool_fc_backward_bf16 if bf16 else roi_pool_fc_backward
        plain = roi_pool_grad_bf16 if bf16 else roi_pool_grad
        tag = ("[backward-bf16]" if bf16 else "[backward]") + label
        for k, (f, rois) in groups.items():
            shape = (rois.shape[0], rois.shape[1], 49 * f.shape[-1])
            g = torch.randn(shape, generator=gen, device=eng.device)
            if k == "weak":      # one row per bag, as MIL leaves it
                g[:, 1:] = 0.0
            for n, case in enumerate(NAN_CASES):
                fn, gn = plant_nans(case, f, rois, g, scale, seed=n)
                gn = gn.to(dtype)
                got = kernel(fn, rois, gn, 7, 7, scale)
                want = plain(fn, rois, gn, 7, 7, scale)
                torch.cuda.synchronize()
                nan = want.isnan()
                same = bool(torch.equal(got.isnan(), nan)) and bool(
                    torch.equal(got.masked_fill(nan, 0),
                                want.masked_fill(nan, 0)))
                routed = int((fn.isnan().any(-1)).sum())
                print(f"{tag} NaN {case:15s} {k:4s}: {routed} map cells "
                      f"and {int(gn.isnan().sum())} cotangent entries NaN; "
                      f"kernel {'==' if same else '!='} plain "
                      f"({int(nan.sum())} NaN, {int((want != 0).sum())} "
                      "nonzero in dfeat)", flush=True)
                _check(same, f"{tag} NaN case {case} on the {k} group: "
                       "kernel != plain")
                out[f"{dtype}:{k}:{case}"] = {
                    "nan_dfeat": int(nan.sum()),
                    "nonzero_dfeat": int((want != 0).sum())}
    return out


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


def profile_train(eng, batch, out_dir: str, tag: str = ""):
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
    print(f"[profile-train{tag}] 2 combined steps: wall {wall * 1e3:.3f} ms, "
          f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)",
          flush=True)
    for e in events[:20]:
        print(f"[profile-train{tag}] {e.device_time_total / 2e3:9.4f} ms/step "
              f"x{e.count // 2:<5d} {e.key[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"train_step{tag}_trace.json"))


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
    from wssdl_bus_tpu_torch.ops.int8_conv_cuda import int8_conv
    from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (
        roi_pool_fc, roi_pool_fc_backward, roi_pool_fc_backward_bf16,
        roi_pool_fc_bf16, roi_pool_grouped)

    return {f.__name__: f for f in (
        nms_keep, roi_pool_fc, roi_pool_grouped, roi_pool_fc_backward,
        roi_pool_fc_bf16, roi_pool_fc_backward_bf16, vgg_stem_fused,
        vgg_conv2_pool, int8_conv)}


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


EVAL_IMAGES = 16          # the evaluation phase's synthetic imdb


def write_eval_imdb(root: str, seed: int = 7) -> None:
    """A synthetic SNUBH-layout imdb: ``TIFFImages/*.tif`` (grayscale
    uint8 speckle with a mass, 8 at 450 x 600 and 8 at 480 x 640),
    ``Annotations/*.xml`` (a benign or malignant box on the mass, a
    ``__background__`` box, ``<BIRADS><diag>``) and
    ``ImageSets/Main/test.txt``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for d in ("TIFFImages", "Annotations", os.path.join("ImageSets",
                                                        "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = []
    for k in range(EVAL_IMAGES):
        h, w = (450, 600) if k % 2 == 0 else (480, 640)
        im, box = speckle_with_mass(rng, h, w)
        name = f"eval_{k:03d}"
        Image.fromarray(im).save(os.path.join(root, "TIFFImages",
                                              name + ".tif"))
        x1, y1 = max(int(box[0]), 0), max(int(box[1]), 0)
        x2, y2 = min(int(box[2]), w - 1), min(int(box[3]), h - 1)
        objs = [("benign" if k % 4 < 2 else "malignant", x1, y1, x2, y2),
                ("__background__", 0, h // 2, w - 1, h - 1)]
        xml = "".join(
            f"<object><name>{n}</name><difficult>0</difficult><bndbox>"
            f"<xmin>{a + 1}</xmin><ymin>{b + 1}</ymin><xmax>{c + 1}</xmax>"
            f"<ymax>{d + 1}</ymax></bndbox></object>"
            for n, a, b, c, d in objs)
        with open(os.path.join(root, "Annotations", name + ".xml"),
                  "w") as f:
            f.write(f"<annotation>{xml}<BIRADS><diag>{k % 2}</diag>"
                    "</BIRADS></annotation>")
        names.append(name)
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def run_evaluation(tmpdir: str, out_dir: str, smi: str) -> dict:
    """Phase 10: the evaluation entry point, ``wssdl_bus_tpu_torch.main.
    test.main``, on the card over a synthetic imdb from a port snapshot of
    seeded He weights, with TEST defaults, at batch 1 and batch 8, then
    batch 8 with ``TEST.DEBUG_TIMELINE``.  Each run: the counters around
    it (one NMS and one pool forward per device step, all on the
    shared-memory path), its files, and its ms/image by stage."""
    import contextlib as ctx

    import torch

    from wssdl_bus_tpu_torch import native
    from wssdl_bus_tpu_torch.main import test as main_test
    from wssdl_bus_tpu_torch.train.checkpoint import save_checkpoint

    _check(native.available(), "the native host library did not build or "
           "load")
    data = os.path.join(tmpdir, "eval_data")
    write_eval_imdb(data)
    snap = save_checkpoint(os.path.join(tmpdir, "snapshots"), "vgg16", "", 0,
                           build_model("cuda", seed=0).state_dict())
    os.makedirs(out_dir, exist_ok=True)
    runs = {}
    for tag, bs, extra in (("batch1", 1, []), ("batch8", BATCH, []),
                           ("trace", BATCH, ["--set_cfgs",
                                             "TEST.DEBUG_TIMELINE", "True"])):
        out = os.path.join(tmpdir, f"eval_{tag}")
        timings = {}
        reset_counts()
        log = os.path.join(out_dir, f"eval_{tag}.log")
        with open(log, "w") as f, ctx.redirect_stdout(f):
            all_boxes, result = main_test.main(
                ["--model", snap, "--imdb_test", "bus_test", "--data_dir",
                 data, "--network", "VGGnet_test", "--output_dir", out,
                 "--batch_size", str(bs), *extra], timings=timings)
        torch.cuda.synchronize()
        counts = read_counts()
        steps = -(-EVAL_IMAGES // bs)
        _check(timings["steps"] == steps, f"evaluation {tag}: "
               f"{timings['steps']} device steps, expected {steps}")
        check_counts(counts, {"nms_keep": steps, "roi_pool_fc": steps},
                     f"evaluation {tag}")
        by_path = check_pool_paths(counts, f"eval_{tag}")
        names = set(os.listdir(out))
        for want in ("detections.pkl", "eval.txt", "froc_curve_pts.npy",
                     "all_arr_ok.npy"):
            _check(want in names, f"evaluation {tag}: no {want} written")
        with open(os.path.join(out, "eval.txt")) as f:
            text = f.read()
        for line in ("AP for benign", "CorLoc for benign", "AP for malignant",
                     "CorLoc for malignant", "Mean AP", "CorLoc ="):
            _check(line in text, f"evaluation {tag}: eval.txt lacks "
                   f"'{line}'")
        if tag == "trace":
            tdir = os.path.join(out, "torch_trace")
            _check(os.path.isdir(tdir) and os.listdir(tdir),
                   "evaluation: DEBUG_TIMELINE wrote no trace")
        n = EVAL_IMAGES
        ms = {"ms_per_image": timings["wall_s"] * 1e3 / n,
              "read_prep_ms_per_image": timings["read_prep_s"] * 1e3 / n,
              "device_step_ms_per_image": timings["device_ms"] / n,
              "decode_ms_per_image": timings["decode_s"] * 1e3 / n,
              "nms_ms_per_image": timings["nms_s"] * 1e3 / n}
        n_dets = sum(len(all_boxes[j][i]) for j in (1, 2) for i in range(n))
        runs[tag] = dict(ms, launches=counts, pool_paths=by_path,
                         result=[float(x) for x in result],
                         detections=n_dets, steps=steps)
        print(f"[eval] {tag}: {n} images, batch {bs}, {steps} device steps;"
              f" launches {counts['nms_keep']} NMS + {counts['roi_pool_fc']}"
              f" pool forward ({by_path}); {n_dets} detections; CorLoc "
              f"{runs[tag]['result']}; {ms['ms_per_image']:.3f} ms/image = "
              f"host read + prep {ms['read_prep_ms_per_image']:.3f} (on the "
              f"prefetch thread) | device step "
              f"{ms['device_step_ms_per_image']:.3f} (CUDA events) | "
              f"copy-back + decode {ms['decode_ms_per_image']:.3f} | NMS + "
              f"cap {ms['nms_ms_per_image']:.3f}; {smi}", flush=True)
    return {"snapshot": snap, "data": data, "runs": runs}


def check_eval_parity(ev: dict, tmpdir: str):
    """Phase 10b (TF32 off): ``test_net`` at batch 8 through the kernels and
    on an Engine with ``plain_ops=True``, from the same snapshot: all_boxes
    equal."""
    from wssdl_bus_tpu_torch.config import Config
    from wssdl_bus_tpu_torch.data.augment import max_canvas
    from wssdl_bus_tpu_torch.data.dataset import get_imdb, prepare_roidb
    from wssdl_bus_tpu_torch.evaluate.detect import test_net as run_test_net
    from wssdl_bus_tpu_torch.models.detector import build_detector
    from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint
    from wssdl_bus_tpu_torch.train.engine import Engine

    cfg = Config()
    imdb = get_imdb("bus_test", ev["data"])
    sizes = [(e["height"], e["width"]) for e in prepare_roidb(imdb)]
    canvas = max_canvas(sizes, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
    model = build_detector("VGGnet_test", device="cuda")
    model.load_state_dict(load_checkpoint(ev["snapshot"], "cuda")[0])
    out = {}
    for plain in (False, True):
        eng = Engine(model, cfg, canvas, plain_ops=plain)
        out[plain], _ = run_test_net(
            eng, imdb, os.path.join(tmpdir, f"eval_parity_{plain}"),
            "VGGnet_test", canvas, verbose=False, batch_size=BATCH)
    same, err = True, 0.0
    for j in (1, 2):
        for i in range(imdb.num_images):
            a, b = np.asarray(out[False][j][i]), np.asarray(out[True][j][i])
            if a.shape != b.shape:
                same = False
                continue
            if a.size:
                err = max(err, float(np.abs(a - b).max()))
            same &= bool(np.array_equal(a, b))
    print(f"[parity] evaluation (TF32 off): test_net at batch {BATCH} "
          f"through the kernels vs plain_ops=True: all_boxes "
          f"{'equal' if same else f'differ (max |diff| {err})'}",
          flush=True)
    _check(same, "evaluation: all_boxes through the kernels differ from "
           "the plain run")


# --------------------------------------------------------------------- #
# phase 11: the training entry points
# --------------------------------------------------------------------- #
CLI_ITERS = 6             # the combined run; snapshots and evaluations at 3, 6
CLI_SNAPSHOT = "VGGnet_fast_rcnn_iter_{}"


# flax leaf -> the reference checkpoint's variable name
NPY_VARS = {"kernel": "weights", "bias": "biases", "gamma": "gamma",
            "beta": "beta", "mean": "moving_mean", "var": "moving_variance"}


def write_npy(path: str, tree: dict) -> int:
    """A flax-layout tree (``params_to_jax``) as a reference-layout ``.npy``
    dict ``{scope: {var: value}}``: flat VGG scopes, slash-nested ResNet
    ones (``group0/block0/conv1``, ``group2/norm``), norm variables under
    ``batch_normalization/``; -> the arrays written."""
    data = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            segs = []
            for p in path:
                if p in ("backbone", "conv", "dense", "bn", "gn"):
                    continue
                segs += [p[:-5], "norm"] if p.endswith("_norm") else [p]
            var = NPY_VARS[k]
            if "bn" in path:
                var = "batch_normalization/" + var
            data.setdefault("/".join(segs), {})[var] = v

    for part in ("trunk", "head"):
        for coll in tree[part].values():
            walk(coll, ())
    np.save(path, data, allow_pickle=True)
    return sum(len(v) for v in data.values())


def write_he_npy(path: str) -> int:
    """The seeded He weights (``models/convert.py:he_tree``, seed 0,
    ``input_scale`` 64) as a reference-layout ``.npy`` dict ``{scope:
    {"weights", "biases"}}`` (flat VGG scopes); -> the arrays written."""
    from wssdl_bus_tpu_torch.models.convert import he_tree, params_to_jax
    from wssdl_bus_tpu_torch.models.detector import build_detector

    return write_npy(path, he_tree(params_to_jax(
        build_detector("VGGnet_train", device="cpu").state_dict()), 0,
        input_scale=64.0))


def train_cli(fn, argv, log: str):
    """One run of a training entry point's ``main`` with its stdout in
    ``log`` and the kernels' counters around it; -> (solver, launches)."""
    import torch

    reset_counts()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        solver = fn(argv)
    torch.cuda.synchronize()
    return solver, read_counts()


def cli_rates(solver) -> dict:
    """ms per solver iteration (host clock, CUDA events), the feed's host
    ms and the upload bytes per step: medians over the iterations after the
    first; evaluation ms/image over the in-loop passes."""
    st = solver.stats["train"]

    def med(xs):
        return float(np.median(xs[1:] if len(xs) > 1 else xs))

    ev = solver.stats.get("eval", [])
    return {"iter_ms_host": med(st["iter_ms_host"]),
            "iter_ms_cuda_events": med(st["iter_ms_cuda"]),
            "feed_ms_host": med(st["feed_ms_host"]),
            "upload_bytes": int(max(st["upload_bytes"])),
            "eval_ms_per_image": (sum(e["seconds"] for e in ev) * 1e3
                                  / sum(e["images"] for e in ev)
                                  if ev else None),
            "iters": st["count"]["iter_ms_host"]}


def same_snapshot(a: str, b: str) -> dict:
    """Max |diff| of parameters and optimizer moments between two port
    snapshots, and whether their last test losses are equal."""
    import torch

    from wssdl_bus_tpu_torch.train.checkpoint import (load_checkpoint,
                                                      load_host_state)

    va, _, oa, wa = load_checkpoint(a, opt_state=True, opt_state_ws=True)
    vb, _, ob, wb = load_checkpoint(b, opt_state=True, opt_state_ws=True)
    p_err = max(float((va[k] - vb[k]).abs().max()) for k in va)
    m_err = 0.0
    for x, y in ((oa, ob), (wa, wb)):
        if x is None:
            continue
        _check(x["count"] == y["count"], "optimizer counts differ")
        for m in ("mu", "nu"):
            m_err = max(m_err, max(float((x[m][k] - y[m][k]).abs().max())
                                   for k in x[m]))
    la = load_host_state(a)["test_loss_logs"]
    lb = load_host_state(b)["test_loss_logs"]
    equal = p_err == 0.0 and m_err == 0.0 and la == lb
    return {"params_max_abs_diff": p_err, "moments_max_abs_diff": m_err,
            "test_losses": [la[-1], lb[-1]], "equal": bool(equal)}


@contextlib.contextmanager
def pytorch_defaults():
    """PyTorch's own numerics settings (cuDNN TF32 convs, f32 matmuls,
    non-deterministic cuDNN) for a timed run; the caller's are restored."""
    import torch

    keys = ("allow_tf32", "deterministic", "benchmark")
    saved = {k: getattr(torch.backends.cudnn, k) for k in keys}
    saved_mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)
        torch.backends.cuda.matmul.allow_tf32 = saved_mm


@contextlib.contextmanager
def deterministic_ops():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
    ops with a deterministic alternative take it; the others warn, naming
    themselves) around a run; yields the warnings' texts."""
    import torch

    names = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield names
    finally:
        torch.use_deterministic_algorithms(False)
    names.extend(sorted({str(w.message).splitlines()[0] for w in caught
                         if "deterministic" in str(w.message)}))


def check_device_prep(solver, smi: str) -> dict:
    """Phase 11d: the device-prepped ``data`` of one supervised and one
    weak batch against the host ``prep_image`` blob for the same draws:
    unrotated images within 2e-5 x 255, rotated weak images within the
    uint8 re-quantisation bound (0.5 / 255 of the range x the largest
    contrast factor x 255, ``ops/device_prep.py``) + 2e-5 x 255."""
    import torch

    from wssdl_bus_tpu_torch.data.loader import _raw_canvas
    from wssdl_bus_tpu_torch.data.minibatch import get_minibatch
    from wssdl_bus_tpu_torch.ops.device_prep import (net_divisor_for,
                                                     prep_device_batch)

    cfg, canvas = solver.cfg, solver.eng.canvas_hw
    db = solver.roidb_train_s
    raw_hw = _raw_canvas(db)
    out = {}
    for tag, is_ws, n in (("supervised", False, cfg.TRAIN.IMS_PER_BATCH),
                          ("weak", True, cfg.TRAIN.WS_IMS_PER_BATCH)):
        entries = db[2:2 + n]
        host = get_minibatch(entries, "VGGnet_train", cfg, canvas, True,
                             is_ws, np.random.RandomState(11))
        dev = get_minibatch(entries, "VGGnet_train", cfg, canvas, True,
                            is_ws, np.random.RandomState(11), raw_hw=raw_hw)
        _check(np.array_equal(host["im_info"], dev["im_info"]),
               f"device prep {tag}: the draws differ")
        got = prep_device_batch(
            torch.as_tensor(dev["raw"], device="cuda"),
            torch.as_tensor(dev["prep"], device="cuda"), canvas,
            cfg.PIXEL_MEAN / 255.0,
            net_divisor_for("VGGnet", cfg.PIXEL_STD)).cpu().numpy()
        err = float(np.abs(got - host["data"]).max())
        bound = 2e-5 * 255 + (0.5 * cfg.TRAIN.CONTRAST_ADJUSTMENT_UPPER_FACTOR
                              if is_ws else 0.0)
        _check(err <= bound, f"device prep {tag}: max |diff| {err} > "
               f"{bound}")
        out[tag] = {"max_abs_err": err, "bound": bound}
    print(f"[train-cli] device prep vs host prep_image (same draws): "
          f"supervised max |diff| {out['supervised']['max_abs_err']:.3e} "
          f"(bound {out['supervised']['bound']:.3e}), rotated weak "
          f"{out['weak']['max_abs_err']:.3e} (bound "
          f"{out['weak']['bound']:.3e}), x255 units; {smi}", flush=True)
    return out


def eval_step_pool_inputs(solver):
    """The pool's inputs at the eval step's shape, as ``Solver.
    periodic_eval`` gives them: a batch of BATCH test images of the
    solver's network through its kernel engine's trunk (eval mode), TEST
    proposals, TRAIN.BATCH_SIZE ROIs sampled per image with no GT
    appended.  -> (feat, rois, scale)."""
    import torch

    from wssdl_bus_tpu_torch.data.minibatch import get_minibatch
    from wssdl_bus_tpu_torch.ops.proposal_target import proposal_target_layer
    from wssdl_bus_tpu_torch.train.engine import _batch_tensors

    eng, cfg = solver.eng, solver.cfg
    blobs = get_minibatch(solver.roidb_test[:BATCH], solver.net_name, cfg,
                          eng.canvas_hw, False, False,
                          np.random.RandomState(0))
    b = _batch_tensors(blobs, eng.device)
    with torch.no_grad():
        eng.model.eval()
        feat, score, deltas = eng.model.apply_trunk(b["data"])
        props = eng._proposals(score, deltas, b["im_info"], cfg.TEST)
        rois = proposal_target_layer(
            props.boxes, props.valid, b["gt_boxes"], b["num_gt_boxes"],
            generator=eng.generator, include_gt=False,
            **eng._pt_kwargs).rois
    return feat, rois, 1.0 / cfg.FEAT_STRIDE


def eval_pool_stats(solver) -> dict:
    """Phase 11e: #2 at the eval step's shape (:func:`eval_step_pool_inputs`
    of a VGG16 solver): kernel == plain, and its times and bound."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                       roi_pool_fc_plain)

    feat, rois, scale = eval_step_pool_inputs(solver)
    with torch.no_grad():
        got = roi_pool_fc(feat, rois, 7, 7, scale)
        want = roi_pool_fc_plain(feat, rois, 7, 7, scale)
        _check(torch.equal(got, want), "ROI pool at the eval step's shape: "
               "kernel != plain")
        st = pool_forward_stats(feat, rois, scale, torch.float32, "eval")
    return dict(st, max_abs_err=float((got - want).abs().max()))


def run_training_entry_points(tmpdir: str, data: str, out_dir: str,
                              smi: str) -> dict:
    """Phase 11 (TF32 off, deterministic cuDNN): ``main.train`` and
    ``main.train_alter`` over the evaluation imdb (as training, weak and
    test imdb, as the CLI defaults do), from the seeded He weights as a
    ``--pretrained_model`` ``.npy``, with the default TRAIN budgets and
    ``DEVICE_PREP``, checks and numbers; see the module docstring."""
    import torch

    from wssdl_bus_tpu_torch.data.loader import RoIDataLayerJoint
    from wssdl_bus_tpu_torch.main import train as main_train
    from wssdl_bus_tpu_torch.main import train_alter as main_alter
    from wssdl_bus_tpu_torch.models.detector import build_detector
    from wssdl_bus_tpu_torch.models.pretrained import load_pretrained_model
    from wssdl_bus_tpu_torch.train.checkpoint import (load_checkpoint,
                                                      load_host_state)
    from wssdl_bus_tpu_torch.train.solver import _build_solver

    t0 = time.perf_counter()
    npy = os.path.join(tmpdir, "vgg16_he.npy")
    n_arrays = write_he_npy(npy)
    check = build_detector("VGGnet_train", device="cuda")
    load_pretrained_model(npy, check, min_loaded=n_arrays)
    ref = build_model("cuda", seed=0).state_dict()
    _check(all(torch.equal(v, ref[k]) for k, v in check.state_dict().items()),
           "the pretrained .npy did not load every array it holds")
    del check, ref

    def argv(out, iters, *extra, snap=3, test=3):
        return ["--data_dir", data, "--output_dir", out, "--max_iters",
                str(iters), "--pretrained_model", npy, "--eval_batch",
                str(BATCH), *extra, "--set_cfgs", "TRAIN.DISPLAY", "1",
                "TRAIN.SNAPSHOT_ITERS", str(snap), "TRAIN.TEST_ITERS",
                str(test)]

    def logfile(tag):
        os.makedirs(out_dir, exist_ok=True)
        return os.path.join(out_dir, f"train_{tag}.log")

    per_iter = {"nms_keep": 1, "roi_pool_fc": 2, "roi_pool_fc_backward": 2}
    per_eval = {"nms_keep": 2, "roi_pool_fc": 2}

    def want(iters, evals, step=per_iter):
        return {k: iters * step.get(k, 0) + evals * per_eval.get(k, 0)
                for k in per_iter}

    # 11a: the combined regime, prefetch on, deterministic ops
    out_a = os.path.join(tmpdir, "train_a")
    torch.cuda.reset_peak_memory_stats()
    with deterministic_ops() as nondet_a:
        sol_a, counts_a = train_cli(main_train.main,
                                    argv(out_a, CLI_ITERS, "--prefetch"),
                                    logfile("combined"))
    peak = torch.cuda.max_memory_allocated()
    with open(logfile("combined")) as f:
        log = f.read()
    _check(f"loaded {n_arrays} pretrained arrays" in log,
           f"main.train did not load the {n_arrays} pretrained arrays")
    names = set(os.listdir(out_a))
    for want_f in (CLI_SNAPSHOT.format(3), CLI_SNAPSHOT.format(CLI_ITERS),
                   "log.txt", "test"):
        _check(want_f in names, f"main.train wrote no {want_f}")
    _check({"detections.pkl", "eval.txt"} <= set(os.listdir(
        os.path.join(out_a, "test"))), "main.train: no in-loop eval files")
    losses = np.asarray(sol_a.stats["train"]["losses"])
    _check(losses.shape == (CLI_ITERS, 6) and np.isfinite(losses).all(),
           f"main.train losses {losses}")
    for e in sol_a.stats["eval"]:
        _check(np.isfinite(e["test_loss"]).all(), "non-finite test loss")
    check_counts(counts_a, want(CLI_ITERS, 2), "main.train")
    paths_a = check_pool_paths(counts_a, "train_cli")
    rates = {"combined_prefetch": cli_rates(sol_a)}
    print(f"[train-cli] main.train: {CLI_ITERS} iterations (1 + 2 images, "
          f"default TRAIN budgets, DEVICE_PREP, prefetch), evaluations and "
          f"snapshots at 3 and 6; launches {counts_a} (per iteration 1 NMS +"
          f" 2 pool forward + 2 backward, per evaluation pass of "
          f"{EVAL_IMAGES} images at batch {BATCH} 2 + 2 + 0), pool forward "
          f"by path {paths_a}; losses finite, last {losses[-1].round(4)}; "
          f"test losses {[round(e['test_loss'][0], 4) for e in sol_a.stats['eval']]};"
          f" peak {peak / 2**20:.1f} MiB allocated; {smi}", flush=True)

    # 11b: exact resume from the iteration-3 snapshot
    out_b = os.path.join(tmpdir, "train_b")
    os.makedirs(out_b)
    shutil.copytree(os.path.join(out_a, CLI_SNAPSHOT.format(3)),
                    os.path.join(out_b, CLI_SNAPSHOT.format(3)))
    with deterministic_ops() as nondet_b:
        sol_b, counts_b = train_cli(
            main_train.main, argv(out_b, CLI_ITERS, "--prefetch", "--resume"),
            logfile("combined_resume"))
    _check(sol_b.start_iter == 3, f"resume started at {sol_b.start_iter}")
    check_counts(counts_b, want(CLI_ITERS - 3, 1), "main.train --resume")
    paths_b = check_pool_paths(counts_b, "train_cli_resume")
    snap = CLI_SNAPSHOT.format(CLI_ITERS)
    resume = same_snapshot(os.path.join(out_a, snap),
                           os.path.join(out_b, snap))
    resume["nondeterministic_ops"] = sorted(set(nondet_a) | set(nondet_b))
    if not resume["equal"]:
        # name the op and hold the resume to two uninterrupted runs' spread
        out_a2 = os.path.join(tmpdir, "train_a2")
        with deterministic_ops():
            train_cli(main_train.main, argv(out_a2, CLI_ITERS, "--prefetch"),
                      logfile("combined_again"))
        spread = same_snapshot(os.path.join(out_a, snap),
                               os.path.join(out_a2, snap))
        shutil.rmtree(out_a2)
        resume["spread_of_two_runs"] = spread
        print(f"[train-cli] resume differs: {resume}; nondeterministic ops: "
              f"{resume['nondeterministic_ops']}", flush=True)
        _check(not spread["equal"], "two uninterrupted runs agree exactly "
               "but the resumed run differs: the resume is at fault")
        for k in ("params_max_abs_diff", "moments_max_abs_diff"):
            _check(resume[k] <= spread[k], f"resume {k} {resume[k]} > the "
                   f"spread of two runs {spread[k]}")
    shutil.rmtree(out_b)
    print(f"[train-cli] exact resume (TF32 off, deterministic cuDNN and "
          f"torch.use_deterministic_algorithms): iteration-{CLI_ITERS} "
          f"snapshot of the run resumed at 3 vs the uninterrupted run: "
          f"parameters max |diff| {resume['params_max_abs_diff']}, moments "
          f"{resume['moments_max_abs_diff']}, test losses "
          f"{resume['test_losses']}; {'equal bit for bit' if resume['equal'] else 'within the spread'};"
          f" ops without a deterministic implementation: "
          f"{resume['nondeterministic_ops'] or 'none'}; launches {counts_b}",
          flush=True)

    # 11c: the alternating regime: 0 supervised, 1-2 both, 3 weak
    out_c = os.path.join(tmpdir, "train_alter")
    sol_c, counts_c = train_cli(
        main_alter.main, argv(out_c, 4, "--prefetch", "--s_end_iter", "2",
                              "--ws_start_iter", "1", snap=4, test=4),
        logfile("alternating"))
    check_counts(counts_c, want(6, 1, {"nms_keep": 1, "roi_pool_fc": 1,
                                       "roi_pool_fc_backward": 1}),
                 "main.train_alter")
    paths_c = check_pool_paths(counts_c, "train_alter_cli")
    snap_c = os.path.join(out_c, CLI_SNAPSHOT.format(4))
    _, _, opt, opt_ws = load_checkpoint(snap_c, opt_state=True,
                                        opt_state_ws=True)
    ws_step = load_host_state(snap_c)["ws_step"]
    _check(opt["count"] == 3 and opt_ws["count"] == 3 and ws_step == 3
           and sol_c.ws_step == 3, f"main.train_alter: optimizer counts "
           f"{opt['count']} / {opt_ws['count']}, ws_step {ws_step}")
    losses_c = np.asarray(sol_c.stats["train"]["losses"])
    _check(np.isfinite(losses_c).all(), "main.train_alter losses")
    rates["alternating_prefetch"] = cli_rates(sol_c)
    shutil.rmtree(out_c)
    print(f"[train-cli] main.train_alter: 4 iterations (supervised 0-2, weak "
          f"1-3); launches {counts_c} (1 + 1 + 1 per supervised and per weak"
          f" step, 2 + 2 + 0 per evaluation pass), pool forward by path "
          f"{paths_c}; two optimizer states, counts {opt['count']} and "
          f"{opt_ws['count']}, ws_step {ws_step}", flush=True)

    # 11d: both regimes with and without the prefetch thread at PyTorch's
    # defaults (cuDNN TF32 convs, non-deterministic cuDNN), as a user
    # trains; then the feed with DEVICE_PREP off
    rates = {f"{k}_tf32_off": v for k, v in rates.items()}
    with pytorch_defaults():
        for tag, fn, extra in (
                ("combined", main_train.main, ()),
                ("alternating", main_alter.main,
                 ("--s_end_iter", "2", "--ws_start_iter", "1"))):
            for pf in ("--prefetch", "--no_prefetch"):
                name = f"{tag}_{pf[2:]}"
                out = os.path.join(tmpdir, name)
                sol, _ = train_cli(fn, argv(out, 4, pf, *extra, snap=100,
                                            test=100), logfile(name))
                rates[name] = cli_rates(sol)
                shutil.rmtree(out)      # a snapshot is ~330 MB
    layer = RoIDataLayerJoint(sol_a.roidb_train_s, sol_a.roidb_train_ws,
                              "VGGnet_train", sol_a.cfg, sol_a.eng.canvas_hw,
                              rng=np.random.RandomState(0),
                              device_prep=False)
    feed_ms, nbytes = [], []
    for _ in range(4):
        t1 = time.perf_counter()
        blobs = layer.forward()
        feed_ms.append((time.perf_counter() - t1) * 1e3)
        nbytes.append(sum(v.nbytes for v in blobs.values()))
    rates["combined_host_prep_feed"] = {
        "feed_ms_host": float(np.median(feed_ms[1:])),
        "upload_bytes": int(max(nbytes))}
    for tag, r in rates.items():
        print(f"[train-cli] {tag}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()) + f"; {smi}", flush=True)
    prep = check_device_prep(sol_a, smi)

    # 11e: kernels vs plain on this path: periodic_eval from the
    # iteration-6 snapshot through the kernels and with plain_ops
    evals = {}
    for plain in (False, True):
        out = os.path.join(tmpdir, f"eval_from_snapshot_{plain}")
        os.makedirs(out)
        shutil.copytree(os.path.join(out_a, snap), os.path.join(out, snap))
        with open(logfile(f"periodic_eval_plain_{plain}"), "w") as f, \
                contextlib.redirect_stdout(f):
            solver = _build_solver(
                "VGGnet_train", build_detector("VGGnet_train", device="cuda"),
                sol_a.roidb_train_s, sol_a.roidb_train_ws,
                sol_a.imdb_test, sol_a.roidb_test, out, None, "adam",
                sol_a.cfg.TRAIN.LEARNING_RATE, "const", False, CLI_ITERS,
                sol_a.cfg, "SNUBH", sol_a.eng.canvas_hw, None,
                ("mal_max", "mal_max"), False, True, eval_batch=BATCH,
                device="cuda", plain_ops=plain)
            reset_counts()
            test_loss = solver.periodic_eval(CLI_ITERS - 1, 1e-3,
                                             np.zeros(6), [])
            solver.logger.close()
            torch.cuda.synchronize()
        counts = read_counts()
        if not plain:
            check_counts(counts, per_eval, "periodic_eval (kernels)")
            pool_st = eval_pool_stats(solver)
        with open(os.path.join(out, "test", "detections.pkl"), "rb") as f:
            evals[plain] = (test_loss, pickle.load(f))
        shutil.rmtree(out)
    shutil.rmtree(out_a)
    same = np.array_equal(evals[False][0], evals[True][0])
    for j in (1, 2):
        for i in range(EVAL_IMAGES):
            same &= np.array_equal(np.asarray(evals[False][1][j][i]),
                                   np.asarray(evals[True][1][j][i]))
    print(f"[parity] periodic_eval from the iteration-{CLI_ITERS} snapshot "
          f"(TF32 off): all_boxes and test losses through the kernels vs "
          f"plain_ops=True: {'equal' if same else 'differ'} (test losses "
          f"{evals[False][0].round(5).tolist()})", flush=True)
    _check(same, "periodic_eval through the kernels differs from the plain "
           "run")
    print(f"[train-cli] phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": {"train_cli": counts_a, "train_cli_resume": counts_b,
                         "train_alter_cli": counts_c},
            "rates": rates, "resume": resume, "device_prep": prep,
            "peak_bytes": peak, "eval_pool": pool_st,
            "losses": losses.tolist(),
            "test_losses": [e["test_loss"] for e in sol_a.stats["eval"]]}

# --------------------------------------------------------------------- #
# phase 13: the ResNet detectors
# --------------------------------------------------------------------- #
RESNET_NET = {"test": "Resnet_test", "train": "Resnet_train"}
RESNET_CLI_ITERS = 3      # snapshots at 2 and 3, one evaluation at 3


def resnet_model(name: str, depth: int, norm, seed: int = 0, dtype=None):
    """A ResNet detector on the card with seeded He weights (``input_scale``
    1: the ResNet blob is already unit scale) and the RPN's 1x1 kernels x
    0.03, so that the decoded proposals stay near their anchors and the
    ranked RPN probabilities are not f32 ties at 1.0 (He weights through
    the residual stack leave the RPN features at std ~10)."""
    from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                    params_to_jax)
    from wssdl_bus_tpu_torch.models.detector import build_detector

    model = build_detector(name, device="cuda", depth=depth, norm=norm,
                           compute_dtype=dtype)
    tree = he_tree(params_to_jax(model.state_dict()), seed)
    for k in ("rpn_cls_score", "rpn_bbox_pred"):
        tree["trunk"]["params"][k]["conv"]["kernel"] *= 0.03
    model.load_state_dict(params_from_jax(tree))
    return model


def grouped_forward_stats(feat, rois, scale, tag: str) -> dict:
    """Kernel #3 through its wrapper ``roi_pool_grouped`` against
    ``roi_pool_grouped_plain`` on (feat, rois): equal values in both
    flavors and with 64 NaNs planted in the map (the same NaN positions);
    the path ``forward_plan`` picks and its grid; CUDA-event times of the
    kernel and the plain version, device time by the profiler, the bound
    (bytes: feat and rois read once, the [B, P, 7, 7, C] output written
    once)."""
    import torch

    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (
        forward_plan, roi_pool_grouped, roi_pool_grouped_plain)

    b, h, w, c = feat.shape
    p = rois.shape[1]
    with torch.no_grad():
        for flavor in ("gpu", "cpu"):
            got = roi_pool_grouped(feat, rois, 7, 7, scale, flavor)
            want = roi_pool_grouped_plain(feat, rois, 7, 7, scale, flavor)
            _check(got.shape == (b, p, 7, 7, c) and torch.equal(got, want),
                   f"#3 {tag} ({flavor}): kernel != plain")
        f = feat.clone()
        gen = torch.Generator(device=f.device).manual_seed(3)
        at = tuple(torch.randint(0, n, (64,), generator=gen,
                                 device=f.device) for n in f.shape)
        f[at] = float("nan")
        got = roi_pool_grouped(f, rois, 7, 7, scale)
        want = roi_pool_grouped_plain(f, rois, 7, 7, scale)
        nan = want.isnan()
        _check(bool(nan.any()) and torch.equal(got.isnan(), nan)
               and torch.equal(got[~nan], want[~nan]),
               f"#3 {tag}: NaN case kernel != plain")

        def run():
            return roi_pool_grouped(feat, rois, 7, 7, scale)

        ms = cuda_ms(run, 20)
        device_ms, recorded = launch_device_ms(
            run, ("roi_pool_fwd_smem", "roi_pool_fwd_direct"))
        plain_ms = cuda_ms(lambda: roi_pool_grouped_plain(
            feat, rois, 7, 7, scale), 2, warmup=1)
    bound_ms, by = roi_pool_bound(feat, rois, scale)
    cs, rblk = forward_plan(b, h, w, c, p)
    grid = [-(-c // cs), -(-p // rblk), b] if cs else None
    out_mb = b * p * 49 * c * 4 / 1e6
    print(f"[resnet-pool] #3 {tag} feat {tuple(feat.shape)} rois "
          f"{tuple(rois.shape)}: roi_pool_grouped == plain (both flavors, "
          f"and {int(nan.sum())} NaN outputs at the same positions with 64 "
          f"NaNs in the map); forward_plan "
          f"{'shared-memory' if cs else 'direct'}"
          f" path, {cs}-channel slices x {rblk} ROIs a block, grid {grid} "
          f"({grid[0] * grid[2] if grid else '-'} slice blocks of the image "
          f"axis); kernel {ms:.4f} ms, device "
          f"{'not recorded' if device_ms is None else f'{device_ms:.4f}'} ms "
          f"({recorded} launches recorded), plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms by {by} (output {out_mb:.1f} MB), "
          f"{bound_ms / ms:.3f} of it", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "bound_fraction": bound_ms / ms, "plan": [cs, rblk],
            "grid": grid, "output_mb": out_mb,
            "shape": [list(feat.shape), list(rois.shape)]}


def served_features(eng, requests, net):
    """The served batch's map and TEST proposals, from the engine's own
    trunk: (feat [B, h, w, C], rois [B, 300, 4])."""
    import torch

    from wssdl_bus_tpu_torch.models.detector import rpn_softmax
    from wssdl_bus_tpu_torch.ops.proposal import proposal_layer

    cfg = eng.cfg
    data, info = (torch.as_tensor(a, device=eng.device)
                  for a in _packed(eng, requests, net))
    with torch.no_grad():
        eng.model.eval()
        feat, score, bbox = eng.model.apply_trunk(data)
        props = proposal_layer(rpn_softmax(score, eng.num_anchors), bbox,
                               info, eng.anchors, eng.num_anchors,
                               cfg.TEST.RPN_PRE_NMS_TOP_N,
                               cfg.TEST.RPN_POST_NMS_TOP_N,
                               cfg.TEST.RPN_NMS_THRESH,
                               float(cfg.TEST.RPN_MIN_SIZE))
    return feat, props.boxes.contiguous()


def resnet_serve(tag, eng, requests, smi, batches=(1, BATCH)):
    """The served path at full width through ``im_detect_batch`` +
    ``report_detections``: BATCH_1_REQUESTS requests at batch 1 and one
    batch of 8, the counters around the run (one NMS and one #3 launch per
    device step, every #3 launch on the shared-memory path, nothing else);
    then ms/image by stage and peak memory at PyTorch's defaults."""
    import torch

    net = RESNET_NET["test"]
    reset_counts()
    out = []
    steps = 0
    for b in batches:
        reqs = requests[:BATCH_1_REQUESTS] if b == 1 else requests[:b]
        out += serve(eng, reqs, net, b)
        steps += -(-len(reqs) // b)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {"nms_keep": steps, "roi_pool_grouped": steps},
                 f"{tag} serving")
    paths = check_pool_paths(counts, f"serve_{tag}")
    for scores, boxes, _ in out:
        _check(scores.ndim == 2 and scores.shape[1] == 3
               and boxes.shape == (scores.shape[0], 12)
               and np.isfinite(scores).all() and np.isfinite(boxes).all(),
               f"{tag} serving: outputs {scores.shape} {boxes.shape}")
    perf = {}
    with pytorch_defaults():
        for b in batches:
            perf[b] = t = time_serving(eng, requests, net, b)
            print(f"[resnet-perf] {tag} batch {b}: {t['ms_per_image']:.3f} "
                  f"ms/image end to end = host prep "
                  f"{t['prep_ms_per_image']:.3f} + device step "
                  f"{t['device_step_ms_per_image']:.3f} + decode/report "
                  f"{t['decode_report_ms_per_image']:.3f}; peak "
                  f"{t['peak_bytes'] / 2**20:.1f} MiB allocated; {smi}",
                  flush=True)
    print(f"[resnet-serve] {tag}: {len(out)} requests served; launches "
          f"{counts} (one NMS + one roi_pool_grouped per device step, "
          f"{steps} steps); #3 by path {paths['roi_pool_grouped']}; valid "
          f"proposals {[len(s) for s, _, _ in out]}", flush=True)
    return {"launches": counts, "perf": perf,
            "proposals": [len(s) for s, _, _ in out]}


def resnet_train(tag, teng, joint, weak, smi, mil: bool = True):
    """Combined steps on ``joint`` (and, with ``mil``, one MIL step on
    ``weak``) at full width and the default TRAIN budgets, the counters
    around them; finite losses, every parameter moved, the running
    statistics moved by the combined steps and left bit for bit by the MIL
    step; then ms/step by CUDA events and peak memory at PyTorch's
    defaults."""
    import torch

    before = {k: v.clone() for k, v in teng.model.state_dict().items()}
    stats_keys = [k for k in before if k.endswith((".mean", ".var"))]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for k, batch in enumerate(joint):
        ls = teng.train_step(batch, step=TRAIN_STEP + k)
        losses.append([float(x) for x in ls])
        _check(np.isfinite(losses[-1]).all(), f"{tag} step {k}: losses "
               f"{losses[-1]}")
    after_combined = {k: v.clone() for k, v in teng.model.state_dict().items()
                      if k in stats_keys}
    mil_loss = None
    if mil:
        mil_loss = float(teng.train_step_mil(weak, step=TRAIN_STEP))
        _check(np.isfinite(mil_loss), f"{tag} MIL step loss {mil_loss}")
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(joint) + int(mil)
    want = {"nms_keep": n, "roi_pool_grouped": 2 * len(joint) + int(mil),
            "roi_pool_fc_backward": 2 * len(joint) + int(mil)}
    check_counts(counts, want, f"{tag} training")
    paths = check_pool_paths(counts, f"train_{tag}")
    after = teng.model.state_dict()
    unmoved = [k for k in after if k not in stats_keys
               and torch.equal(before[k], after[k])]
    _check(not unmoved, f"{tag}: parameters that did not move: {unmoved[:5]}")
    still = [k for k in stats_keys if torch.equal(before[k],
                                                  after_combined[k])]
    _check(not still, f"{tag}: running statistics the combined steps did "
           f"not move: {still[:5]}")
    if mil:
        changed = [k for k in stats_keys
                   if not torch.equal(after_combined[k], after[k])]
        _check(not changed, f"{tag}: the MIL step changed running "
               f"statistics {changed[:5]}")
    with pytorch_defaults():
        step_ms = time_train_step(teng, joint[-1])
    print(f"[resnet-train] {tag}: {len(joint)} combined steps"
          f"{' + 1 MIL step' if mil else ''}; launches {counts} (expected "
          f"{want}); #3 by path {paths['roi_pool_grouped']}; losses finite "
          f"(last {np.round(losses[-1], 4).tolist()}, MIL {mil_loss}); all "
          f"{len(after) - len(stats_keys)} parameters moved; "
          f"{len(stats_keys)} running statistics moved by the combined "
          f"steps{' and bit for bit unchanged by the MIL step' if mil else ''}"
          f"; combined step {step_ms:.3f} ms by CUDA events (3 more steps, "
          f"PyTorch's defaults); peak {peak / 2**20:.1f} MiB allocated "
          f"(16 GiB limit: {'within' if peak <= 16 * 2**30 else 'EXCEEDED'}"
          f"); {smi}", flush=True)
    return {"launches": counts, "losses": losses, "mil_loss": mil_loss,
            "step_ms_cuda_events": step_ms, "peak_bytes": peak,
            "running_stats": len(stats_keys)}


def resnet_kernels(tag, eng, teng, requests, batch) -> dict:
    """#3 and #4 against their plain versions at this model's served and
    training shapes: #3 at the served batch of 8 and at the combined step's
    two groups; #4 at the two groups with MIL-sparse, dense and tie
    cotangents (times and bounds), then under NaNs in the map and in the
    cotangent (f32, the ResNet path's dtype)."""
    import torch

    scale = 1.0 / eng.cfg.FEAT_STRIDE
    feat, rois = served_features(eng, requests, RESNET_NET["test"])
    fwd = {"serve": grouped_forward_stats(feat, rois, scale,
                                          f"{tag} serve")}
    del feat, rois
    groups = training_groups(teng, batch)
    for k, (f, r) in groups.items():
        fwd[f"train_{k}"] = grouped_forward_stats(f, r, scale,
                                                  f"{tag} train {k}")
    label = f" {tag}"
    # BatchRenorm's statistics over every ROI of the step make the weak
    # group's cotangent dense; GroupNorm (per ROI) leaves MIL's one row a
    # bag
    pattern = "dense" if teng.model.norm == "BN" else "mil"
    bwd = check_backward_kernel(teng, groups, torch.float32, label, pattern)
    bwd["nan_routing"] = check_backward_nan_routing(
        teng, groups, (torch.float32,), label)
    del groups
    return {"forward": fwd, "backward": bwd}


def resnet_cli(tmpdir, data, out_dir, smi) -> dict:
    """``main.train`` with ``--network Resnet_train`` (ResNet-18 BN, from
    its seeded He weights as a reference-layout ``.npy``, every array
    loaded) for RESNET_CLI_ITERS iterations, an evaluation (batch 8) and a
    snapshot at the end, one at 2; ``--resume`` from 2: parameters, running
    statistics, moments and test losses of the final snapshot equal bit
    for bit (TF32 off, deterministic algorithms); ``main.test`` with
    ``Resnet_test`` on that snapshot at batch 8."""
    import torch

    from wssdl_bus_tpu_torch.main import test as main_test
    from wssdl_bus_tpu_torch.main import train as main_train
    from wssdl_bus_tpu_torch.models.convert import params_to_jax
    from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    npy = os.path.join(tmpdir, "resnet18_bn_he.npy")
    ref = resnet_model("Resnet_train", 18, "BN").state_dict()
    n_arrays = write_npy(npy, params_to_jax(ref))
    res = ["--network", "Resnet_train", "--net_depth", "18",
           "--norm_type", "BN"]

    def argv(out, *extra):
        return ["--data_dir", data, "--output_dir", out, "--max_iters",
                str(RESNET_CLI_ITERS), "--pretrained_model", npy,
                "--eval_batch", str(BATCH), *res, "--no_prefetch", *extra,
                "--set_cfgs", "TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_ITERS",
                "2", "TRAIN.TEST_ITERS", str(RESNET_CLI_ITERS)]

    def log(t):
        return os.path.join(out_dir, f"resnet_{t}.log")

    out_a = os.path.join(tmpdir, "resnet_a")
    with deterministic_ops() as nondet:
        sol_a, counts_a = train_cli(main_train.main, argv(out_a), log("train"))
    with open(log("train")) as f:
        _check(f"loaded {n_arrays} pretrained arrays" in f.read(),
               f"main.train (ResNet) did not load the {n_arrays} arrays")
    n_it = RESNET_CLI_ITERS
    want_a = {"nms_keep": n_it + 2, "roi_pool_grouped": 2 * n_it + 2,
              "roi_pool_fc_backward": 2 * n_it}
    check_counts(counts_a, want_a, "main.train (ResNet)")
    check_pool_paths(counts_a, "resnet_train_cli")
    # #3 at the shape of the evaluation's launches, against its plain version
    eval_pool = grouped_forward_stats(*eval_step_pool_inputs(sol_a),
                                      "resnet18_bn eval")
    snap = CLI_SNAPSHOT.format(n_it)
    v0, _ = load_checkpoint(os.path.join(out_a, CLI_SNAPSHOT.format(2)))
    unmoved = [k for k in ref if k.endswith((".mean", ".var"))
               and torch.equal(v0[k], ref[k].cpu())]
    _check(not unmoved, f"main.train (ResNet): running statistics unmoved "
           f"at iteration 2: {unmoved[:3]}")
    out_b = os.path.join(tmpdir, "resnet_b")
    os.makedirs(out_b)
    shutil.copytree(os.path.join(out_a, CLI_SNAPSHOT.format(2)),
                    os.path.join(out_b, CLI_SNAPSHOT.format(2)))
    with deterministic_ops() as nondet_b:
        sol_b, counts_b = train_cli(main_train.main,
                                    argv(out_b, "--resume"), log("resume"))
    _check(sol_b.start_iter == 2, f"resume started at {sol_b.start_iter}")
    check_counts(counts_b, {"nms_keep": 3, "roi_pool_grouped": 4,
                            "roi_pool_fc_backward": 2},
                 "main.train --resume (ResNet)")
    resume = same_snapshot(os.path.join(out_a, snap),
                           os.path.join(out_b, snap))
    resume["nondeterministic_ops"] = sorted(set(nondet) | set(nondet_b))
    va, _ = load_checkpoint(os.path.join(out_a, snap))
    vb, _ = load_checkpoint(os.path.join(out_b, snap))
    n_stats = sum(k.endswith((".mean", ".var")) for k in va)
    _check(resume["equal"] and n_stats == 60
           and all(torch.equal(va[k], vb[k]) for k in va),
           f"ResNet --resume is not exact: {resume}")
    print(f"[resnet-cli] main.train --network Resnet_train (18, BN): "
          f"{n_it} iterations from the He .npy ({n_arrays} arrays loaded), "
          f"launches {counts_a}; --resume from 2: launches {counts_b}; the "
          f"iteration-{n_it} snapshots' parameters, {n_stats} running "
          f"statistics, moments and test losses {resume['test_losses']} "
          f"equal bit for bit; ops without a deterministic implementation: "
          f"{resume['nondeterministic_ops'] or 'none'}; {smi}", flush=True)
    shutil.rmtree(out_b)

    out_t = os.path.join(tmpdir, "resnet_test")
    timings = {}
    reset_counts()
    with open(log("test"), "w") as f, contextlib.redirect_stdout(f):
        all_boxes, result = main_test.main(
            ["--model", os.path.join(out_a, snap), "--imdb_test", "bus_test",
             "--data_dir", data, "--network", "Resnet_test", "--net_depth",
             "18", "--norm_type", "BN", "--output_dir", out_t,
             "--batch_size", str(BATCH)], timings=timings)
    torch.cuda.synchronize()
    counts_t = read_counts()
    steps = -(-EVAL_IMAGES // BATCH)
    check_counts(counts_t, {"nms_keep": steps, "roi_pool_grouped": steps},
                 "main.test (ResNet)")
    check_pool_paths(counts_t, "resnet_test_cli")
    _check({"detections.pkl", "eval.txt"} <= set(os.listdir(out_t)),
           "main.test (ResNet) wrote no detections / eval.txt")
    n_dets = sum(len(all_boxes[j][i]) for j in (1, 2)
                 for i in range(EVAL_IMAGES))
    ms = timings["wall_s"] * 1e3 / EVAL_IMAGES
    dev = timings["device_ms"]
    print(f"[resnet-cli] main.test --network Resnet_test on the "
          f"iteration-{n_it} snapshot, batch {BATCH}: launches {counts_t}; "
          f"{n_dets} detections; CorLoc {[float(x) for x in result]}; "
          f"{ms:.3f} ms/image (device step "
          f"{'not measured' if dev is None else dev / EVAL_IMAGES}); {smi}",
          flush=True)
    shutil.rmtree(out_a)
    return {"launches": {"resnet_train_cli": counts_a,
                         "resnet_train_cli_resume": counts_b,
                         "resnet_test_cli": counts_t},
            "eval_pool": eval_pool, "resume": resume,
            "train_rates": cli_rates(sol_a),
            "test_ms_per_image": ms, "detections": n_dets}


def resnet_setup(tmp, requests) -> dict:
    """The ResNet phases' config, canvases and training batches (speckle
    images written to ``tmp``, the ResNet pixel scale)."""
    from wssdl_bus_tpu_torch.config import Config
    from wssdl_bus_tpu_torch.data.augment import max_canvas

    cfg = Config()
    t = cfg.TRAIN
    canvas = max_canvas([r.shape for r in requests], cfg.TEST.SCALES[0],
                        cfg.TEST.MAX_SIZE)
    sup, ws, sizes = write_roidb(tmp, seed=11,
                                 n_sup=TRAIN_STEPS * t.IMS_PER_BATCH,
                                 n_ws=TRAIN_STEPS * t.WS_IMS_PER_BATCH)
    crop = t.CROPPING_MAX_MARGIN if t.USE_CROPPING else 0.0
    tcanvas = max_canvas(sizes, t.SCALES[0], t.MAX_SIZE, crop_margin=crop)
    joint, weak = train_batches(cfg, tcanvas, sup, ws, TRAIN_STEPS,
                                RESNET_NET["train"])
    return {"cfg": cfg, "canvas": canvas, "tcanvas": tcanvas,
            "joint": joint, "weak": weak}


RESNET_CELLS = (("resnet18_bn", 18, "BN"), ("resnet50_gn", 50, "GN"))


def resnet_engines(st, depth, norm):
    """(serving engine, training engine) of one ResNet at full width."""
    from wssdl_bus_tpu_torch.train.engine import Engine

    return (Engine(resnet_model(RESNET_NET["test"], depth, norm), st["cfg"],
                   st["canvas"]),
            Engine(resnet_model(RESNET_NET["train"], depth, norm),
                   st["cfg"], st["tcanvas"]))


def run_resnet_kernels(st, requests) -> dict:
    """Phase 13a (before the evaluation phase, whose profiler trace leaves
    torch.profiler recording none of the pool forward's later launches):
    #3 and #4 at the ResNet-18 (C = 256) and ResNet-50 (C = 1024) served
    and training shapes, from each model's own seeded trunk."""
    import torch

    out = {}
    for tag, depth, norm in RESNET_CELLS:
        eng, teng = resnet_engines(st, depth, norm)
        out[tag] = resnet_kernels(tag, eng, teng, requests, st["joint"][0])
        del eng, teng
        torch.cuda.empty_cache()
    return out


def run_resnet(st, kern, eval_data, requests, out_dir, smi,
               profile: bool = False) -> dict:
    """Phase 13 (see the module docstring), with phase 13a's kernel checks
    ``kern``; with ``profile`` the torch.profiler breakdowns of ResNet-18
    BN's batch-8 serving step and combined training step (PyTorch's
    defaults)."""
    import torch

    from wssdl_bus_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    cfg, canvas, tcanvas = st["cfg"], st["canvas"], st["tcanvas"]
    joint, weak = st["joint"], st["weak"]
    out = {"launches": {}}

    # 13b: ResNet-18 BN, the CLI default, on every path
    tag = "resnet18_bn"
    eng, teng = resnet_engines(st, 18, "BN")
    print(f"[resnet] ResNet-18 BN full width (seeded He weights), serving "
          f"canvas {canvas}, training canvas {tcanvas}, default TEST / "
          f"TRAIN budgets", flush=True)
    serve18 = resnet_serve(tag, eng, requests, smi)
    train18 = resnet_train(tag, teng, joint, weak, smi)
    if profile:
        with pytorch_defaults():
            profile_step(eng, requests, RESNET_NET["test"], out_dir,
                         "_" + tag)
            profile_train(teng, joint[-1], out_dir, "_" + tag)
    out["launches"].update({f"serve_{tag}": serve18["launches"],
                            f"train_{tag}": train18["launches"]})

    # 13c: parity with the plain versions, TF32 off (as since phase 6)
    eng_plain = Engine(eng.model, cfg, canvas, plain_ops=True)
    check_serve_parity(eng, eng_plain, requests, RESNET_NET["test"],
                       "ResNet-18 BN served batch")
    parity = check_train_parity(teng.model, cfg, tcanvas, joint[0])
    del eng, eng_plain, teng
    torch.cuda.empty_cache()

    # 13d: ResNet-50 GN: the bottleneck blocks, GroupNorm, C = 1024
    tag50 = "resnet50_gn"
    eng, teng = resnet_engines(st, 50, "GN")
    serve50 = resnet_serve(tag50, eng, requests, smi, batches=(BATCH,))
    train50 = resnet_train(tag50, teng, joint[:1], weak, smi, mil=False)
    out["launches"].update({f"serve_{tag50}": serve50["launches"],
                            f"train_{tag50}": train50["launches"]})
    del eng, teng
    torch.cuda.empty_cache()

    # 13e: the entry points
    cli = resnet_cli(st["tmp"], eval_data, out_dir, smi)
    out["launches"].update(cli.pop("launches"))
    kern["resnet18_bn"]["forward"]["eval_step"] = cli.pop("eval_pool")
    print(f"[resnet] phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    out.update(kernels=kern, parity=parity, cli=cli,
               serve={tag: serve18["perf"], tag50: serve50["perf"]},
               train={tag: {k: v for k, v in train18.items()
                            if k != "launches"},
                      tag50: {k: v for k, v in train50.items()
                              if k != "launches"}})
    return out


# --------------------------------------------------------------------- #
# phase 14: bf16 compute and int8 serving
# --------------------------------------------------------------------- #
INT8_OPS_PER_S = 1979e12    # dense int8 on the tensor cores (data sheet)
# the convs of a step whose epilogue writes the next layer's int8 input
# (models/quantize.py's docstring): VGG16 conv1_1 ... conv5_2; ResNet-18
# each basic block's conv1; ResNet-50 each bottleneck's conv1 and conv2
INT8_OUT_LAYERS = {"vgg16": 12, "resnet18_bn": 8, "resnet50_bn": 32}


@contextlib.contextmanager
def recorded_int8_convs():
    """Within the block the int8 walks (``models/quantize.py``) call the
    kernel's wrapper through a recorder: -> {(B, H, W, Cin, Cout, k,
    stride): {"args": the first call's arguments but ``out_scale``,
    "out_scale": the first int8-out call's or None, "calls": {"f32": n,
    "int8": n}}}."""
    from wssdl_bus_tpu_torch.models import quantize as Q
    from wssdl_bus_tpu_torch.ops.int8_conv_cuda import int8_conv

    seen = {}

    def rec(xq, packed, kh, kw, scale, bias, stride=1, relu=False,
            out_scale=None):
        args = (xq, packed, kh, kw, scale, bias, stride, relu)
        key = (*xq.shape, int(packed.shape[0]), kh, stride)
        e = seen.setdefault(key, {"args": args, "out_scale": None,
                                  "calls": {"f32": 0, "int8": 0}})
        e["calls"]["f32" if out_scale is None else "int8"] += 1
        if e["out_scale"] is None:
            e["out_scale"] = out_scale
        return int8_conv(*args, out_scale)

    real = Q._int8_conv_fn
    Q._int8_conv_fn = lambda plain: rec
    try:
        yield seen
    finally:
        Q._int8_conv_fn = real


def int8_conv_stats(args, out_scale=None) -> dict:
    """The int8 conv kernel against its plain version at one layer's real
    inputs, bit for bit, in both variants: f32 out, and int8 out (the
    requantizing epilogue) at ``out_scale`` (the path's next-layer scale,
    or, for a layer the path runs with f32 out, the f32 output's absmax /
    127); CUDA-event times and bounds of both (the output's real element
    size), the tile plan, and two library yardsticks the port never calls:
    cuDNN's bf16 conv of the same layer, and for a 1x1 layer
    ``torch._int_mm`` on its (strided) operand, whose int32 product is
    checked equal to the plain accumulator."""
    import torch
    import torch.nn.functional as F

    from wssdl_bus_tpu_torch.ops.int8_conv import (conv_pads,
                                                   int8_conv_acc_plain,
                                                   int8_conv_plain,
                                                   unpack_weight)
    from wssdl_bus_tpu_torch.ops.int8_conv_cuda import int8_conv, tile_plan

    xq, packed, kh, kw, scale, bias, stride, relu = args
    b, h, w, cin = xq.shape
    cout = int(packed.shape[0])
    (pt, pb), (pl, pr), (ho, wo) = conv_pads(h, w, kh, kw, stride)
    macs = b * ho * wo * cout * kh * kw * cin
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    shape = f"{tuple(xq.shape)} {kh}x{kw}/{stride} -> {(b, ho, wo, cout)}"
    out = {"shape": shape, "macs": macs, "ops_ms": t_ops,
           "plan": tile_plan(b, h, w, cin, cout, kh, stride)._asdict()}
    for variant in ("f32", "int8"):
        if variant == "int8" and out_scale is None:
            out_scale = (int8_conv_plain(*args).abs().max() / 127).clamp_min(
                1e-12)
        va = args + ((out_scale,) if variant == "int8" else ())
        got = int8_conv(*va)
        want = int8_conv_plain(*va)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        _check(got.dtype == want.dtype and torch.equal(got, want),
               f"int8_conv {shape} {variant} out: differs from its plain "
               f"version (max |diff| {err})")
        ms = cuda_ms(lambda: int8_conv(*va), iters=10)
        plain_ms = cuda_ms(lambda: int8_conv_plain(*va), iters=1, warmup=1)
        nbytes = xq.numel() + packed.numel() + 8 * cout \
            + got.numel() * got.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[variant] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes", "bytes_ms": t_bytes}
        del got, want
    wt = unpack_weight(packed, kh, kw, cin)
    xb = F.pad(xq.permute(0, 3, 1, 2).to(torch.bfloat16),
               (pl, pr, pt, pb)).contiguous(memory_format=torch.channels_last)
    wb = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, None, stride), iters=10)
    del xb, wb
    int_mm_ms = None
    if kh == 1 and b * ho * wo > 16 and cin % 8 == 0 and cout % 8 == 0:
        a = xq[:, ::stride, ::stride].reshape(-1, cin).contiguous()
        m = wt.reshape(cin, cout).t().contiguous().t()    # column-major
        acc = torch._int_mm(a, m)
        _check(torch.equal(acc.reshape(b, ho, wo, cout),
                           int8_conv_acc_plain(xq, packed, kh, kw, stride)),
               f"torch._int_mm {shape}: not the plain accumulator")
        int_mm_ms = cuda_ms(lambda: torch._int_mm(a, m), iters=10)
        del a, m, acc
    out.update(library_ms=cudnn_ms, library="cudnn bf16 conv",
               int_mm_ms=int_mm_ms)
    return out


def keep_set_agreement(out_q, out_f, batch: int) -> dict:
    """Diagnostic, no threshold: per image, whether the int8 step's kept
    proposals (boxes to 1/16 px) are the f32 step's, and the share of int8
    kept proposals found in the f32 keep set."""
    def kept(outs):
        rois = outs[0].reshape(batch, -1, 5)[..., 1:].cpu().numpy()
        valid = outs[1].reshape(batch, -1).cpu().numpy()
        return [{tuple(np.round(r * 16).astype(int)) for r in rois[i][
            valid[i]]} for i in range(batch)]

    q, f = kept(out_q), kept(out_f)
    same = sum(a == b for a, b in zip(q, f))
    shared = sum(len(a & b) for a, b in zip(q, f))
    total = sum(len(a) for a in q)
    return {"images_same_keep_set": same, "images": batch,
            "kept_in_f32_keep_set": shared / max(total, 1)}


def int8_serve(tag, model, cfg, canvas, net, requests, smi, out_dir,
               profile: bool = False) -> dict:
    """Int8 serving at full width: ``Engine.quantize_for_serving``
    calibrated on the requests' batch-8 blob, then ``QuantServingEngine``
    through ``im_detect_batch`` + ``report_detections`` (BATCH_1_REQUESTS
    at batch 1 and one batch of 8) with the counters around it (one NMS,
    one pool forward and one int8 conv per quantized layer a device step);
    every layer shape of the batch-8 step held against the plain int8 conv;
    ms/image and peak memory; the served batch through the kernels equal
    to ``plain_ops=True`` (TF32 off since phase 6); the keep sets against
    the f32 step's."""
    import torch

    from wssdl_bus_tpu_torch.models.quantize import QuantServingEngine
    from wssdl_bus_tpu_torch.train.engine import Engine

    eng = Engine(model, cfg, canvas)
    blob, infos = _packed(eng, requests, net)
    t0 = time.perf_counter()
    q = eng.quantize_for_serving([blob])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    n_convs = (len(q["layers"]) if model.backbone == "VGGnet"
               else len(q["trunk"]["layers"]) + len(q["head"]["layers"]))
    pool = "roi_pool_fc" if model.backbone == "VGGnet" else "roi_pool_grouped"
    qeng = QuantServingEngine(eng, q)
    with recorded_int8_convs() as seen:
        qeng.inference_step(blob, infos)
    torch.cuda.synchronize()
    reset_counts()
    out = serve(qeng, requests[:BATCH_1_REQUESTS], net, 1) \
        + serve(qeng, requests, net, BATCH)
    torch.cuda.synchronize()
    counts = read_counts()
    steps = BATCH_1_REQUESTS + 1
    check_counts(counts, {"nms_keep": steps, pool: steps,
                          "int8_conv": steps * n_convs},
                 f"{tag} int8 serving")
    paths = check_pool_paths(counts, f"serve_{tag}_int8")
    for scores, boxes, _ in out:
        _check(scores.ndim == 2 and scores.shape[1] == 3
               and boxes.shape == (scores.shape[0], 12)
               and np.isfinite(scores).all() and np.isfinite(boxes).all(),
               f"{tag} int8 serving: outputs {scores.shape} {boxes.shape}")
    shapes = {}
    for key, entry in seen.items():
        st = int8_conv_stats(entry["args"], entry["out_scale"])
        st["calls_per_step"] = entry["calls"]
        shapes["x".join(map(str, key))] = st
        p = st["plan"]
        print(f"[int8] {tag} {st['shape']} x{entry['calls']} ({p['path']} "
              f"path, tile {p['bn']}x{p['bh']}x{p['bw']} of {p['rows']} "
              f"rows): "
              + "; ".join(
                  f"{v} out {st[v]['ms']:.4f} ms (bound "
                  f"{st[v]['bound_ms']:.4f} by {st[v]['bound_by']}, "
                  f"{st[v]['bound_ms'] / st[v]['ms']:.2f} of it), plain "
                  f"{st[v]['plain_ms']:.3f}" for v in ("f32", "int8"))
              + f"; cuDNN bf16 conv {st['library_ms']:.4f}"
              + ("" if st["int_mm_ms"] is None
                 else f", torch._int_mm {st['int_mm_ms']:.4f}")
              + "; both equal bit for bit", flush=True)
    calls = sum(sum(e["calls"].values()) for e in seen.values())
    _check(calls == n_convs, f"{tag}: the recorded step made {calls} int8 "
           f"convs, not {n_convs}")
    n_int8 = sum(e["calls"]["int8"] for e in seen.values())
    _check(n_int8 == INT8_OUT_LAYERS[tag], f"{tag}: {n_int8} convs of the "
           f"step wrote int8, want {INT8_OUT_LAYERS[tag]}")

    def per_step(k):
        """A step's sum over its layers, each in the variant it ran."""
        return sum(st[v][k] * st["calls_per_step"][v]
                   for st in shapes.values() for v in ("f32", "int8"))

    step = {k: per_step(k) for k in ("ms", "plain_ms", "bound_ms")}
    step.update({k: sum(st[k] * sum(st["calls_per_step"].values())
                        for st in shapes.values())
                 for k in ("library_ms", "macs")})
    step["max_abs_err"] = max(st[v]["max_abs_err"] for st in shapes.values()
                              for v in ("f32", "int8"))
    step["int8_out_convs"] = n_int8
    by_ops = sum(st[v]["bound_ms"] * st["calls_per_step"][v]
                 for st in shapes.values() for v in ("f32", "int8")
                 if st[v]["bound_by"] == "operations")
    step["bound_by"] = ("operations" if 2 * by_ops >= step["bound_ms"]
                        else "bytes")
    with pytorch_defaults():
        perf = {b: time_serving(qeng, requests, net, b) for b in (1, BATCH)}
        if profile:
            profile_step(qeng, requests, net, out_dir, f"_{tag}_int8")
    eng_plain = Engine(model, cfg, canvas, plain_ops=True)
    outs_k = eng.inference_step_quant(q, blob, infos)
    outs_p = eng_plain.inference_step_quant(q, blob, infos)
    for name, a, b in zip(("rois", "valid", "cls_score", "cls_prob",
                           "bbox_pred"), outs_k, outs_p):
        _check(torch.equal(a, b), f"{tag} int8 parity: {name} through the "
               "kernels differs from plain_ops=True")
    agree = keep_set_agreement(outs_k, eng.inference_step(blob, infos),
                               BATCH)
    for b in (1, BATCH):
        t = perf[b]
        print(f"[int8-perf] {tag} batch {b}: {t['ms_per_image']:.3f} "
              f"ms/image end to end = host prep {t['prep_ms_per_image']:.3f}"
              f" + device step {t['device_step_ms_per_image']:.3f} + decode"
              f"/report {t['decode_report_ms_per_image']:.3f}; peak "
              f"{t['peak_bytes'] / 2**20:.1f} MiB allocated; {smi}",
              flush=True)
    print(f"[int8] {tag}: calibrated and quantized in {calib_s:.2f} s; "
          f"{len(out)} requests served, launches {counts} ({n_convs} int8 "
          f"convs a step); {pool} by path {paths[pool]}; the batch-8 step's "
          f"{n_convs} convs ({n_int8} with int8 out): kernel "
          f"{step['ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
          f"({step['bound_ms'] / step['ms']:.2f} of it; "
          f"{step['macs'] / 1e12:.3f} TMAC), "
          f"plain {step['plain_ms']:.1f} ms, cuDNN bf16 convs "
          f"{step['library_ms']:.3f} ms; through the kernels == plain_ops="
          f"True (all five outputs, TF32 off); keep sets vs f32: {agree}",
          flush=True)
    return {"launches": counts, "perf": perf, "per_shape": shapes,
            "step": step, "keep_sets_vs_f32": agree, "calib_s": calib_s}


def bf16_paths(tag, make, cfg, canvas, tcanvas, joint, requests, net,
               smi) -> dict:
    """``--bf16`` serving (one batch of 8) and one combined training step
    against the f32 ones: boundary outputs f32, launches as f32 with no
    launch of the bf16 pool store (#2's bf16 instance, #5), finite losses,
    f32 parameters; step times at PyTorch's defaults."""
    import torch

    from wssdl_bus_tpu_torch.train.engine import Engine

    pool = "roi_pool_fc" if net.startswith("VGG") else "roi_pool_grouped"
    e32 = Engine(make(None, False), cfg, canvas)
    e16 = Engine(make(torch.bfloat16, False), cfg, canvas)
    blob, infos = _packed(e16, requests, net)
    reset_counts()
    outs = e16.inference_step(blob, infos)
    served = serve(e16, requests, net, BATCH)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {"nms_keep": 2, pool: 2}, f"{tag} bf16 serving")
    _check(all(o.dtype == torch.float32 for i, o in enumerate(outs)
               if i != 1), f"{tag} bf16 serving: outputs "
           f"{[o.dtype for o in outs]}, want f32 at the boundary")
    _check(all(np.isfinite(sc).all() for sc, _, _ in served),
           f"{tag} bf16 serving: non-finite scores")
    agree = keep_set_agreement(outs, e32.inference_step(blob, infos), BATCH)
    with pytorch_defaults():
        perf = {dt: time_serving(e, requests, net, BATCH)
                for dt, e in (("bf16", e16), ("f32", e32))}
    del e32, e16
    t32 = Engine(make(None, True), cfg, tcanvas)
    t16 = Engine(make(torch.bfloat16, True), cfg, tcanvas)
    reset_counts()
    ls = t16.train_step(joint[0], step=TRAIN_STEP)
    torch.cuda.synchronize()
    counts_t = read_counts()
    check_counts(counts_t, {"nms_keep": 1, pool: 2,
                            "roi_pool_fc_backward": 2}, f"{tag} bf16 step")
    losses = [float(x) for x in ls]
    _check(np.isfinite(losses).all(), f"{tag} bf16 step: losses {losses}")
    _check(all(v.dtype == torch.float32
               for v in t16.model.state_dict().values()),
           f"{tag} bf16 step: a parameter left f32")
    with pytorch_defaults():
        step_ms = {"bf16": time_train_step(t16, joint[-1]),
                   "f32": time_train_step(t32, joint[-1])}
    print(f"[bf16] {tag}: serving batch {BATCH} launches {counts} (no bf16 "
          f"pool store), outputs f32, keep sets vs f32 {agree}; device step "
          f"{perf['bf16']['device_step_ms_per_image']:.3f} ms/image (f32 "
          f"{perf['f32']['device_step_ms_per_image']:.3f}), end to end "
          f"{perf['bf16']['ms_per_image']:.3f} (f32 "
          f"{perf['f32']['ms_per_image']:.3f}), peak "
          f"{perf['bf16']['peak_bytes'] / 2**20:.1f} MiB (f32 "
          f"{perf['f32']['peak_bytes'] / 2**20:.1f}); one combined step: "
          f"launches {counts_t}, losses {np.round(losses, 4).tolist()}, "
          f"parameters f32; {step_ms['bf16']:.3f} ms by CUDA events (f32 "
          f"{step_ms['f32']:.3f}, PyTorch's defaults); {smi}", flush=True)
    return {"launches": {"serve": counts, "train": counts_t},
            "perf": perf, "step_ms": step_ms, "losses": losses,
            "keep_sets_vs_f32": agree}


def precision_cli(tmpdir, ev, out_dir, smi) -> dict:
    """``main.test --int8`` and ``main.test --bf16`` over the evaluation
    imdb at batch 8 from phase 10's snapshot (per device step one NMS and
    one pool forward, f32, and for int8 its 13 convs), and ``main.train
    --bf16`` for 3 iterations from the He ``.npy`` (1 + 2 + 2 launches an
    iteration, no evaluation)."""
    import torch

    from wssdl_bus_tpu_torch.main import test as main_test
    from wssdl_bus_tpu_torch.main import train as main_train

    out = {"launches": {}}
    steps = -(-EVAL_IMAGES // BATCH)
    for tag in ("int8", "bf16"):
        dst = os.path.join(tmpdir, f"precision_{tag}")
        timings = {}
        reset_counts()
        with open(os.path.join(out_dir, f"precision_test_{tag}.log"),
                  "w") as f, contextlib.redirect_stdout(f):
            all_boxes, result = main_test.main(
                ["--model", ev["snapshot"], "--imdb_test", "bus_test",
                 "--data_dir", ev["data"], "--network", "VGGnet_test",
                 "--output_dir", dst, "--batch_size", str(BATCH),
                 f"--{tag}"], timings=timings)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, {"nms_keep": steps, "roi_pool_fc": steps,
                              "int8_conv": 13 * steps if tag == "int8"
                              else 0}, f"main.test --{tag}")
        check_pool_paths(counts, f"precision_test_{tag}")
        _check({"detections.pkl", "eval.txt"} <= set(os.listdir(dst)),
               f"main.test --{tag} wrote no detections / eval.txt")
        n_dets = sum(len(all_boxes[j][i]) for j in (1, 2)
                     for i in range(EVAL_IMAGES))
        ms = timings["wall_s"] * 1e3 / EVAL_IMAGES
        out["launches"][f"test_{tag}"] = counts
        out[f"test_{tag}"] = {"ms_per_image": ms, "detections": n_dets,
                              "result": [float(x) for x in result],
                              "device_step_ms_per_image":
                                  timings["device_ms"] / EVAL_IMAGES}
        print(f"[precision-cli] main.test --{tag} batch {BATCH}: launches "
              f"{counts}; {n_dets} detections; CorLoc "
              f"{out[f'test_{tag}']['result']}; {ms:.3f} ms/image (device "
              f"step {timings['device_ms'] / EVAL_IMAGES:.3f}); {smi}",
              flush=True)
    npy = os.path.join(tmpdir, "vgg16_he.npy")
    if not os.path.exists(npy):
        write_he_npy(npy)
    dst = os.path.join(tmpdir, "precision_train")
    solver, counts = train_cli(main_train.main, [
        "--data_dir", ev["data"], "--output_dir", dst, "--max_iters", "3",
        "--pretrained_model", npy, "--bf16", "--no_prefetch", "--set_cfgs",
        "TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_ITERS", "3",
        "TRAIN.TEST_ITERS", "100"],
        os.path.join(out_dir, "precision_train_bf16.log"))
    check_counts(counts, {"nms_keep": 3, "roi_pool_fc": 6,
                          "roi_pool_fc_backward": 6}, "main.train --bf16")
    _check(solver.eng.model.compute_dtype == torch.bfloat16,
           "main.train --bf16 built an f32 model")
    losses = np.asarray(solver.stats["train"]["losses"])
    _check(losses.shape == (3, 6) and np.isfinite(losses).all(),
           f"main.train --bf16 losses {losses}")
    _check(CLI_SNAPSHOT.format(3) in os.listdir(dst),
           "main.train --bf16 wrote no snapshot")
    out["launches"]["train_bf16"] = counts
    out["train_bf16"] = cli_rates(solver)
    print(f"[precision-cli] main.train --bf16: 3 iterations, launches "
          f"{counts}, losses finite, snapshot at 3; "
          f"{out['train_bf16']}; {smi}", flush=True)
    shutil.rmtree(dst)
    return out


def run_precision(st, ev, tmpdir, requests, tcanvas, joint, out_dir,
                  smi, profile: bool = False) -> dict:
    """Phase 14 (after phase 13; TF32 off but where timed); with
    ``profile`` the torch.profiler breakdowns of the int8 batch-8 serving
    steps."""
    import torch

    from wssdl_bus_tpu_torch.config import Config

    t0 = time.perf_counter()
    cfg = Config()
    canvas = st["canvas"]
    out = {"launches": {}}
    int8 = {}
    int8["vgg16"] = int8_serve("vgg16", build_model("cuda", 0), cfg, canvas,
                               "VGGnet_test", requests, smi, out_dir,
                               profile)
    torch.cuda.empty_cache()
    for tag, depth in (("resnet18_bn", 18), ("resnet50_bn", 50)):
        int8[tag] = int8_serve(tag, resnet_model(RESNET_NET["test"], depth,
                                                 "BN"), cfg, canvas,
                               RESNET_NET["test"], requests, smi, out_dir,
                               profile)
        torch.cuda.empty_cache()
    for tag, r in int8.items():
        out["launches"][f"serve_{tag}_int8"] = r.pop("launches")
    bf16 = {
        "vgg16": bf16_paths(
            "vgg16", lambda dt, train: build_model(
                "cuda", 0, "VGGnet_train" if train else "VGGnet_test", dt),
            cfg, canvas, tcanvas, joint, requests, "VGGnet_test", smi),
        "resnet18_bn": bf16_paths(
            "resnet18_bn", lambda dt, train: resnet_model(
                RESNET_NET["train" if train else "test"], 18, "BN",
                dtype=dt),
            cfg, canvas, st["tcanvas"], st["joint"], requests,
            RESNET_NET["test"], smi)}
    for tag, r in bf16.items():
        for k, c in r.pop("launches").items():
            out["launches"][f"{k}_{tag}_bf16"] = c
    torch.cuda.empty_cache()
    cli = precision_cli(tmpdir, ev, out_dir, smi)
    out["launches"].update(cli.pop("launches"))
    print(f"[precision] phase 14: {time.perf_counter() - t0:.1f} s",
          flush=True)
    out.update(int8=int8, bf16=bf16, cli=cli)
    return out


# --------------------------------------------------------------------- #
# phase 15: the serving surface
# --------------------------------------------------------------------- #
HTTP_REQUESTS = 64        # concurrent PNG requests to the HTTP server
HTTP_CLIENTS = 8
HTTP_SEQUENTIAL = 16      # single requests one after another (batch 1)
# a padded batch against the same images served unpadded: another batch
# size may take another cuDNN algorithm (f32 reassociation, TF32 off), so
# values are held to f32 drift: class probabilities as the CPU parity
# tests hold them, 1e-5 for VGG16 (tests/test_torch_engine.py) and 1e-4
# for ResNet (tests/test_torch_resnet_engine.py); boxes 2e-2 px for VGG16
# (measured 2.2e-3 on the H100) and 0.5 px for ResNet-18 BN, measured
# there at 0.104-0.213 px: its He-weighted head regresses large box
# deltas, which the decode passes through exp, so a delta's drift grows
# in pixels (the scores moved 7.5e-6-1.4e-5)
PAD_ATOL = {"VGGnet": (1e-5, 2e-2), "Resnet": (1e-4, 0.5)}  # score, px


def _report_err(got, want, what: str) -> dict:
    """Two reports (``report_detections`` entries) of one image: per class
    the same number of entries, each paired with the other report's
    nearest box of its class, one to one (a report is ordered by score,
    and scores saturated at 1.0 tie, so two runs may order them apart);
    -> the largest score and box differences of the pairs."""
    err = {"score": 0.0, "box": 0.0}
    for cls in sorted({d["class"] for d in got + want}):
        g = [d for d in got if d["class"] == cls]
        w = [d for d in want if d["class"] == cls]
        _check(len(g) == len(w), f"{what}: {len(g)} {cls} detections, "
               f"the other report {len(w)}")
        dist = np.abs(np.array([d["box"] for d in g])[:, None]
                      - np.array([d["box"] for d in w])[None]).max(-1)
        pair = dist.argmin(1)
        _check(len(set(pair.tolist())) == len(g),
               f"{what}: the {cls} boxes do not pair one to one")
        err["box"] = max(err["box"], float(dist[np.arange(len(g)),
                                                pair].max()))
        err["score"] = max(err["score"], float(np.abs(np.subtract(
            [d["score"] for d in g], [w[j]["score"] for j in pair])).max()))
    return err


def _within(errs, backbone: str, what: str) -> dict:
    """The largest of per-image differences ``errs``, held to
    PAD_ATOL[backbone]."""
    err = {k: max([e[k] for e in errs], default=0.0)
           for k in ("score", "box")}
    limits = PAD_ATOL[backbone]
    _check(err["score"] <= limits[0] and err["box"] <= limits[1],
           f"{what}: scores {err['score']:.3g} / boxes {err['box']:.3g} px "
           f"apart (limits {limits[0]} / {limits[1]})")
    return err


def _same_detections(got, want, cfg, what: str,
                     backbone: str = "VGGnet") -> dict:
    """Per image: the same kept proposals (rows) and report classes, scores
    and boxes within PAD_ATOL[backbone]; -> the largest differences."""
    from wssdl_bus_tpu_torch.serve import report_detections

    _check(len(got) == len(want), f"{what}: {len(got)} results for "
           f"{len(want)} images")
    errs = []
    for k, ((gs, gb), (ws, wb)) in enumerate(zip(got, want)):
        _check(gs.shape == ws.shape and gb.shape == wb.shape,
               f"{what}: image {k} keeps {gs.shape[0]} proposals, "
               f"unpadded {ws.shape[0]}")
        if len(gs):
            errs.append({"score": float(np.abs(gs - ws).max()),
                         "box": float(np.abs(gb - wb).max())})
        _report_err(report_detections(gs, gb, cfg)[0],
                    report_detections(ws, wb, cfg)[0], f"{what}: image {k}")
    return _within(errs, backbone, what)


def _equal_detections(got, want, what: str):
    _check(len(got) == len(want) and all(
        np.array_equal(gs, ws) and np.array_equal(gb, wb)
        for (gs, gb), (ws, wb) in zip(got, want)),
        f"{what}: detections differ")


def check_artifact(tag, served, live, requests, net, pool, n_int8,
                   smi) -> dict:
    """One loaded artifact on its main path, the counters around it:
    BATCH_1_REQUESTS single requests, the 8 requests, and the first 3
    padded to the exported batch (per device step one NMS, one pool
    forward ``pool``, ``n_int8`` int8 convs); then (TF32 off) its
    detections against the live engine ``live`` on the same weights: equal
    where the batch is the same, within the padding tolerances where the
    artifact pads; ms/image at PyTorch's defaults."""
    import torch

    from wssdl_bus_tpu_torch.evaluate.detect import im_detect_batch

    canvas = served.canvas_hw
    reset_counts()
    singles = [served.detect([r])[0] for r in requests[:BATCH_1_REQUESTS]]
    batch = served.detect(requests)
    three = served.detect(requests[:3])
    torch.cuda.synchronize()
    counts = read_counts()
    steps = BATCH_1_REQUESTS + 2
    want = {"nms_keep": steps, pool: steps}
    if n_int8:
        want["int8_conv"] = n_int8 * steps
    check_counts(counts, want, f"artifact {tag}")
    paths = check_pool_paths(counts, f"artifact_{tag}")
    for scores, boxes in singles + batch:
        _check(scores.ndim == 2 and scores.shape[1] == 3
               and boxes.shape == (scores.shape[0], 12)
               and np.isfinite(scores).all() and np.isfinite(boxes).all(),
               f"artifact {tag}: outputs {scores.shape} {boxes.shape}")
    _equal_detections(batch, im_detect_batch(live, requests, net, canvas),
                      f"artifact {tag} batch 8 vs the live engine")
    live_singles = [im_detect_batch(live, [r], net, canvas)[0]
                    for r in requests[:BATCH_1_REQUESTS]]
    pad = {}
    backbone = served.meta["backbone"]
    if 1 in served.batch_sizes:
        _equal_detections(singles, live_singles,
                          f"artifact {tag} batch 1 vs the live engine")
    else:
        pad["singles"] = _same_detections(
            singles, live_singles, live.cfg, f"artifact {tag}: 1 request "
            f"padded to {min(served.batch_sizes)} vs the live batch 1",
            backbone)
    pad["three"] = _same_detections(
        three, im_detect_batch(live, requests[:3], net, canvas), live.cfg,
        f"artifact {tag}: 3 requests padded to 8 vs the live batch 3",
        backbone)
    with pytorch_defaults():   # at an exported size detect() is this path
        perf = {b: time_serving(served, requests, net, b)
                for b in served.batch_sizes}
    print(f"[artifact] {tag}: batches {served.batch_sizes}, "
          f"{steps} device steps, launches {counts} ({pool} by path "
          f"{paths[pool]}); batch 8 == the live engine bit for bit"
          + (", batch 1 too" if 1 in served.batch_sizes else "")
          + f"; padded vs unpadded (keep sets and classes equal): "
          + ", ".join(f"{k} scores {v['score']:.3g} boxes {v['box']:.3g} px"
                      for k, v in pad.items())
          + "; " + ", ".join(
              f"batch {b} {t['ms_per_image']:.3f} ms/image end to end = "
              f"prep {t['prep_ms_per_image']:.3f} + device step "
              f"{t['device_step_ms_per_image']:.3f} + decode/report "
              f"{t['decode_report_ms_per_image']:.3f}"
              for b, t in perf.items()) + f"; {smi}", flush=True)
    return {"launches": counts, "perf": perf, "padded_vs_unpadded": pad}


def _png(im) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="PNG")
    return buf.getvalue()


def _post(port: int, body: bytes):
    """-> (status, JSON, seconds) of one POST /detect on localhost."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/detect", body=body)
        r = conn.getresponse()
        out = r.status, json.loads(r.read().decode())
    finally:
        conn.close()
    return out + (time.perf_counter() - t0,)


def _get(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        _check(r.status == 200, f"GET {path}: {r.status}")
        return json.loads(r.read().decode())
    finally:
        conn.close()


def _hammer(port: int, bodies) -> tuple:
    """POST every body from HTTP_CLIENTS threads, each taking every
    HTTP_CLIENTS-th; -> (responses in order, wall seconds)."""
    import threading

    out = [None] * len(bodies)

    def client(c):
        for i in range(c, len(bodies), HTTP_CLIENTS):
            out[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    _check(not any(t.is_alive() for t in threads), "an HTTP client hung")
    return out, wall


def http_serving(art, live, net, smi) -> dict:
    """``serve(art, port=0)`` on the card in a thread: HTTP_REQUESTS PNG
    requests from HTTP_CLIENTS threads (TF32 off), every response 200 and
    the library path's report for its image (classes equal, scores and
    boxes within the padding tolerances: the batcher coalesces requests
    into batch 1 and padded batch-8 steps); one NMS and one pool forward
    per device step; the same load again at PyTorch's defaults for
    ``/metrics``' latency percentiles and images per second; then
    HTTP_SEQUENTIAL single requests one after another."""
    import threading

    import torch

    from wssdl_bus_tpu_torch.evaluate.detect import im_detect_batch
    from wssdl_bus_tpu_torch.serve import report_detections
    from wssdl_bus_tpu_torch.serve.server import ServerMetrics, serve

    images = make_requests(seed=15, n=HTTP_REQUESTS)
    bodies = [_png(im) for im in images]
    httpd = serve(art, port=0)
    port = httpd.server_port
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    service = httpd.service
    out = {"launches": {}}
    try:
        health = _get(port, "/healthz")
        _check(health["device"].startswith("cuda") and health["batch_sizes"]
               == [1, BATCH], f"/healthz: {health}")
        reset_counts()
        responses, _ = _hammer(port, bodies)
        torch.cuda.synchronize()
        counts = read_counts()
        steps = service.batcher.total_steps
        check_counts(counts, {"nms_keep": steps, "roi_pool_fc": steps},
                     "http")
        check_pool_paths(counts, "http")
        out["launches"]["http"] = counts
        hist = dict(service.metrics.snapshot(service.batcher)[
            "images_per_step_histogram"])
        errs, n_dets = [], 0
        for k, (im, (code, obj, _)) in enumerate(zip(images, responses)):
            _check(code == 200, f"http request {k}: {code} {obj}")
            _check(obj["image_hw"] == list(im.shape),
                   f"http request {k}: image_hw {obj['image_hw']}")
            (scores, boxes), = im_detect_batch(live, [im], net,
                                               live.canvas_hw)
            want, _ = report_detections(scores, boxes, live.cfg)
            errs.append(_report_err(obj["detections"], want,
                                    f"http request {k} vs the library "
                                    "path"))
            n_dets += len(want)
        err = _within(errs, "VGGnet", "http vs the library path")
        print(f"[http] checked run (TF32 off): {len(responses)} requests "
              f"from {HTTP_CLIENTS} clients, all 200, each the library "
              f"path's report ({n_dets} detections; scores within "
              f"{err['score']:.3g}, boxes {err['box']:.3g} px); {steps} "
              f"device steps {hist}; launches {counts}", flush=True)

        with pytorch_defaults():
            service.metrics = ServerMetrics()
            b = service.batcher
            b.step_sizes.clear()
            b.total_steps = b.failed_steps = 0
            reset_counts()
            responses, wall = _hammer(port, bodies)
            torch.cuda.synchronize()
            counts = read_counts()
            _check(all(r[0] == 200 for r in responses),
                   "http timed run: a request failed")
            metrics = _get(port, "/metrics")
            steps = metrics["device_steps"]
            check_counts(counts, {"nms_keep": steps, "roi_pool_fc": steps},
                         "http timed run")
            check_pool_paths(counts, "http_defaults")
            out["launches"]["http_defaults"] = counts
            seq = [_post(port, bodies[i])[2]
                   for i in range(HTTP_SEQUENTIAL)]
        lat = metrics["latency_s"]
        out.update(
            metrics=metrics, images_per_s=len(bodies) / wall,
            wall_s=wall, checked_err=err, checked_histogram=hist,
            sequential_ms={"mean": 1e3 * float(np.mean(seq)),
                           "p50": 1e3 * float(np.median(seq)),
                           "max": 1e3 * max(seq)})
        sq = out["sequential_ms"]
        print(f"[http] {len(bodies)} requests from {HTTP_CLIENTS} clients "
              f"(PyTorch defaults): latency p50 {lat['p50'] * 1e3:.1f} / "
              f"p90 {lat['p90'] * 1e3:.1f} / p99 {lat['p99'] * 1e3:.1f} / "
              f"max {lat['max'] * 1e3:.1f} ms (n {lat['n']}), "
              f"{out['images_per_s']:.1f} images/s, images per step "
              f"{metrics['images_per_step_histogram']}, "
              f"{metrics['device_steps']} device steps; {HTTP_SEQUENTIAL} "
              f"sequential single requests: mean {sq['mean']:.1f} / p50 "
              f"{sq['p50']:.1f} / max {sq['max']:.1f} ms; {smi}",
              flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.batcher.close()
        thread.join(timeout=60)
    _check(not thread.is_alive(), "the HTTP server thread did not stop")
    return out


def serving_cli(tmpdir, ev, requests, out_dir, smi) -> dict:
    """``main.export`` from phase 10's snapshot of the He weights (batch
    sizes 1 and 8, canvas from the evaluation imdb), with and without
    ``--int8`` (calibrated on its 8 first images): no kernel launches;
    ``main.predict`` on 3 PNG requests from the f32 artifact (padded to 8)
    and from the snapshot (``--batch 3``): the same classes, scores and
    boxes within the padding tolerances; and from the int8 artifact
    (13 int8 convs a step); each predict one NMS and one pool forward."""
    import torch

    from wssdl_bus_tpu_torch.main import export as main_export
    from wssdl_bus_tpu_torch.main import predict as main_predict

    out = {"launches": {}}
    arts = {}
    for tag, extra in (("f32", []), ("int8", ["--int8", "--calib_images",
                                             str(BATCH)])):
        arts[tag] = os.path.join(tmpdir, f"cli_artifact_{tag}")
        reset_counts()
        with open(os.path.join(out_dir, f"serve_export_{tag}.log"),
                  "w") as f, contextlib.redirect_stdout(f):
            meta = main_export.main(
                ["--model", ev["snapshot"], "--out", arts[tag],
                 "--batch_sizes", f"1,{BATCH}", "--imdb_test", "bus_test",
                 "--data_dir", ev["data"], "--network", "VGGnet_test"]
                + extra)
        torch.cuda.synchronize()
        check_counts(read_counts(), {}, f"main.export {tag}")
        _check(meta["batch_sizes"] == [1, BATCH]
               and meta["quantized"] == (tag == "int8")
               and meta["platform"] == "cuda",
               f"main.export {tag}: meta {meta}")
        out[f"export_{tag}_bytes"] = os.path.getsize(
            os.path.join(arts[tag], "variables.pt"))
    _check(out["export_int8_bytes"] < 0.7 * out["export_f32_bytes"],
           f"int8 artifact {out['export_int8_bytes']} bytes, f32 "
           f"{out['export_f32_bytes']}")
    pngs = []
    for k, im in enumerate(requests[:3]):
        pngs.append(os.path.join(tmpdir, f"request_{k}.png"))
        with open(pngs[-1], "wb") as f:
            f.write(_png(im))
    reports = {}
    for tag, args, n_int8 in (
            ("artifact", ["--artifact", arts["f32"]], 0),
            ("model", ["--model", ev["snapshot"], "--network", "VGGnet_test",
                       "--batch", "3"], 0),
            ("artifact_int8", ["--artifact", arts["int8"]], 13)):
        dst = os.path.join(tmpdir, f"predict_{tag}")
        reset_counts()
        with open(os.path.join(out_dir, f"serve_predict_{tag}.log"),
                  "w") as f, contextlib.redirect_stdout(f):
            reports[tag] = main_predict.main(pngs + ["--out", dst, "--vis",
                                                     *args])
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, {"nms_keep": 1, "roi_pool_fc": 1,
                              "int8_conv": n_int8}, f"main.predict {tag}")
        check_pool_paths(counts, f"cli_predict_{tag}")
        out["launches"][f"cli_predict_{tag}"] = counts
        with open(os.path.join(dst, "predictions.json")) as f:
            _check(json.load(f) == reports[tag],
                   f"main.predict {tag}: predictions.json differs")
        _check(sorted(os.listdir(dst)) == sorted(
            ["predictions.json"] + [f"request_{k}_pred.png"
                                    for k in range(3)]),
               f"main.predict {tag}: files {os.listdir(dst)}")
    err = _within([_report_err(a["detections"], m["detections"],
                               f"main.predict {a['image']}: --artifact vs "
                               "--model")
                   for a, m in zip(reports["artifact"], reports["model"])],
                  "VGGnet", "main.predict --artifact vs --model")
    out["artifact_vs_model"] = err
    n = {t: sum(len(e["detections"]) for e in r) for t, r in reports.items()}
    print(f"[serve-cli] main.export f32 {out['export_f32_bytes']} bytes, "
          f"--int8 {out['export_int8_bytes']} bytes (no launches); "
          f"main.predict on 3 PNGs: --artifact (padded to 8) and --model "
          f"(batch 3) report the same classes (scores {err['score']:.3g}, "
          f"boxes {err['box']:.3g} px apart), detections {n}; launches "
          f"{out['launches']}; {smi}", flush=True)
    return out


def run_serving_surface(st, ev, tmpdir, requests, out_dir, smi) -> dict:
    """Phase 15 (after phase 14; TF32 off but where timed): artifacts of
    VGG16 f32 and int8 at batches (1, 8) and of ResNet-18 BN at (8,) from
    the seeded He weights, exported and loaded back on the card and driven
    on their main paths; the int8 artifact through #8 equal to
    ``plain_ops=True``; the HTTP server over the VGG16 artifact; the
    export and predict CLIs."""
    import torch

    from wssdl_bus_tpu_torch.models.quantize import (QuantServingEngine,
                                                    replaced_state_keys)
    from wssdl_bus_tpu_torch.serve import export_serving, load_serving
    from wssdl_bus_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    cfg, canvas = st["cfg"], st["canvas"]
    net = "VGGnet_test"
    out = {"launches": {}, "artifacts": {}}
    eng = Engine(build_model("cuda", 0), cfg, canvas)
    blob, infos = _packed(eng, requests, net)
    arts = {t: os.path.join(tmpdir, f"artifact_{t}")
            for t in ("vgg16", "int8", "resnet18_bn")}
    export_serving(eng, arts["vgg16"], net, batch_sizes=(1, BATCH))
    export_serving(eng, arts["int8"], net, batch_sizes=(1, BATCH),
                   calib_batches=[blob])
    reng = Engine(resnet_model(RESNET_NET["test"], 18, "BN"), cfg, canvas)
    export_serving(reng, arts["resnet18_bn"], RESNET_NET["test"],
                   batch_sizes=(BATCH,))
    served = {t: load_serving(a) for t, a in arts.items()}
    sizes = {t: os.path.getsize(os.path.join(a, "variables.pt"))
             for t, a in arts.items()}
    _check(sizes["int8"] < 0.7 * sizes["vgg16"], f"artifact sizes {sizes}")
    qserved = served["int8"].engine
    qmodel = qserved._eng.model
    nan = replaced_state_keys(qmodel)
    _check(nan and all(torch.isnan(v).all() for k, v in
                       qmodel.state_dict().items() if k in nan),
           "int8 artifact: the replaced parameters are not NaN")
    live_q = QuantServingEngine(eng, eng.quantize_for_serving([blob]))
    for tag, live, pool, n_int8, name in (
            ("vgg16", eng, "roi_pool_fc", 0, net),
            ("int8", live_q, "roi_pool_fc", 13, net),
            ("resnet18_bn", reng, "roi_pool_grouped", 0,
             RESNET_NET["test"])):
        r = check_artifact(tag, served[tag], live, requests, name, pool,
                           n_int8, smi)
        out["launches"][f"artifact_{tag}"] = r.pop("launches")
        out["artifacts"][tag] = dict(r, variables_bytes=sizes[tag])
    eng_plain = Engine(qmodel, cfg, canvas, plain_ops=True)
    outs_k = served["int8"].inference_step(blob, infos)
    outs_p = eng_plain.inference_step_quant(qserved._qtrunk, blob, infos)
    for name, a, b in zip(("rois", "valid", "cls_score", "cls_prob",
                           "bbox_pred"), outs_k, outs_p):
        _check(torch.equal(a, b), f"int8 artifact: {name} through the "
               "kernels differs from plain_ops=True")
    print(f"[artifact] int8: {len(nan)} replaced tensors NaN after "
          f"loading; the batch-8 step through #8 == plain_ops=True (all "
          f"five outputs, TF32 off); variables.pt {sizes}", flush=True)
    del served, live_q, eng_plain, reng
    torch.cuda.empty_cache()
    out["http"] = http_serving(arts["vgg16"], eng, net, smi)
    out["launches"].update(out["http"].pop("launches"))
    out["cli"] = serving_cli(tmpdir, ev, requests, out_dir, smi)
    out["launches"].update(out["cli"].pop("launches"))
    print(f"[serve] phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke needs a card")
    # exact resume under torch.use_deterministic_algorithms (phase 11)
    # needs cuBLAS's fixed workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    phase("0 (import the port)")
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, "wssdl_bus_tpu_torch")):
        _fail(f"the port package wssdl_bus_tpu_torch is not beside this "
              f"script in {REPO}: run it from a checkout of the repository")
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
    phase("1 (device)")
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
    phase("2 (build)")
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
    phase("3 (kernels vs plain)")
    # forward's direct path at a map too large for its shared-memory path
    stats = check_kernels(eng, requests, net)
    stats["roi_pool_fc"]["per_shape"]["direct"] = check_direct_path()

    # phase 4a: the served path through the kernels, counters around it
    phase("4a (served path)")
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
    phase("4b (serving times)")
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
    phase("5 (training path)")
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
    phase("5a (training kernels)")
    # backward kernel at the step's shapes
    for tag, batch in (("train", joint[0]), ("mil", weak)):
        stats["nms_keep"]["per_shape"][tag] = check_nms(
            *training_candidates(teng, batch), tag)
    groups = training_groups(teng, joint[0])
    stats["roi_pool_fc_backward"] = check_backward_kernel(teng, groups,
                                                          torch.float32)

    # phase 5b: 3 combined steps + 1 MIL step, counters around them
    phase("5b (training steps)")
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
    phase("7 (stem kernels)")
    serve_x = torch.as_tensor(_packed(eng, requests, net)[0], device="cuda")
    train_x = torch.as_tensor(joint[0]["data"], device="cuda")
    stem_stats = {"serve": check_stem_kernels(model, serve_x, "serve B=8",
                                              dyadic=True),
                  "train": check_stem_kernels(tmodel, train_x, "train B=3",
                                              dyadic=False)}
    del serve_x, train_x

    # phase 8: the bf16 output option of the ROI pool at the training
    phase("8 (bf16 pool)")
    # shapes, and the f32 forward on the same ROIs
    train_fwd = check_train_forward(teng, groups)
    stats["roi_pool_fc_bf16"] = train_fwd["bf16"]
    stats["roi_pool_fc"]["per_shape"]["train"] = train_fwd["f32"]
    stats["roi_pool_fc_bf16"]["per_shape"] = {
        "serve": stats.pop("roi_pool_fc_bf16_serve"),
        "train": train_fwd["bf16"]["per_group"]}
    stats["roi_pool_fc_backward_nan"] = check_backward_nan_routing(
        teng, groups)
    stats["roi_pool_fc_backward_bf16"] = check_backward_kernel(
        teng, groups, torch.bfloat16)
    bf16_launches = run_bf16_pool_path(teng, groups)
    del groups

    # phase 13a: the ResNet widths of #3 and #4 against their plain versions
    phase("13a (ResNet kernels)")
    rst = dict(resnet_setup(tmp.name, requests), tmp=tmp.name)
    resnet_kern = run_resnet_kernels(rst, requests)

    # phase 9: the opt-in stem paths, serving and training
    phase("9 (stem paths)")
    stem_runs = {name: run_stem_path(name, eng, requests, net, teng, joint,
                                     weak, smi) for name in STEM_PATHS}

    # phase 10: the evaluation entry point over a synthetic imdb
    phase("10 (evaluation entry point)")
    evaluation = run_evaluation(tmp.name, out_dir, smi)

    # phase 6 (and 9): parity with the plain versions, TF32 off on both
    phase("6 (parity, TF32 off)")
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
    check_eval_parity(evaluation, tmp.name)

    # phase 11: the training entry points (TF32 off from here on)
    phase("11 (training entry points)")
    training_cli = run_training_entry_points(tmp.name, evaluation["data"],
                                             out_dir, smi)
    stats["roi_pool_fc"]["per_shape"]["eval_step"] = training_cli.pop(
        "eval_pool")

    # phase 13: the ResNet detectors (TF32 off but where timed)
    phase("13 (ResNet)")
    resnet = run_resnet(rst, resnet_kern, evaluation["data"], requests,
                        out_dir, smi, profile)

    # phase 14: bf16 compute and int8 serving (TF32 off but where timed)
    phase("14 (bf16 and int8)")
    precision = run_precision(rst, evaluation, tmp.name, requests, tcanvas,
                              joint, out_dir, smi, profile)

    # phase 15: the serving surface (TF32 off but where timed)
    phase("15 (serving surface)")
    surface = run_serving_surface(rst, evaluation, tmp.name, requests,
                                  out_dir, smi)
    tmp.cleanup()

    paths = {"serve": serve_launches, "train": train_launches,
             "bf16_pool": bf16_launches}
    for tag, run in evaluation["runs"].items():
        paths[f"eval_{tag}"] = run["launches"]
    for name, run in stem_runs.items():
        paths[f"serve_{STEM_PATHS[name]}"] = run["serve_launches"]
        paths[f"train_{STEM_PATHS[name]}"] = run["train_launches"]
    paths.update(training_cli.pop("launches"))
    paths.update(resnet.pop("launches"))
    paths.update(precision.pop("launches"))
    paths.update(surface.pop("launches"))

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

    def int8_entry(int8):
        """The int8 conv (no TPU kernel: XLA's s8 x s8 -> s32 conv in the
        JAX package): its numbers are those of the VGG16 batch-8 int8 step,
        summed over its 13 layers; every layer shape in per_shape."""
        vgg = int8["vgg16"]["step"]
        return dict(name="int8_conv", route="cuda",
                    source="wssdl_bus_tpu_torch/csrc/int8_conv.cu",
                    replaces="wssdl_bus_tpu/models/quantize.py:127",
                    **launches("int8_conv"),
                    max_abs_err=max(r["step"]["max_abs_err"]
                                    for r in int8.values()),
                    ms=vgg["ms"], plain_ms=vgg["plain_ms"],
                    bound_ms=vgg["bound_ms"], bound_by=vgg["bound_by"],
                    library_ms=vgg["library_ms"],
                    library="cudnn bf16 convs of the same layers",
                    per_shape={t: {"step": r["step"],
                                   "layers": r["per_shape"]}
                               for t, r in int8.items()})

    r_fwd = {m: k["forward"] for m, k in resnet["kernels"].items()}
    r_bwd = {m: k["backward"] for m, k in resnet["kernels"].items()}
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
        dict(name="roi_pool_grouped", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:84",
             library_ms=None, **launches("roi_pool_grouped"),
             **kernel_stats(r_fwd["resnet18_bn"]["serve"]),
             launches_by_forward_path={
                 p: c["roi_pool_grouped"] for p, c in POOL_PATHS.items()},
             per_shape=r_fwd),
        dict(name="roi_pool_fc_backward", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:140",
             library_ms=None, **launches("roi_pool_fc_backward"),
             **kernel_stats(stats["roi_pool_fc_backward"]),
             per_shape={"vgg16_train": kernel_stats(
                 stats["roi_pool_fc_backward"]), **{
                     m: dict(kernel_stats(v), per_launch=v["per_launch"],
                             pattern=v["pattern"],
                             dense_weak_ms=v["dense_weak_ms"],
                             dense_weak_bound_ms=v["dense_weak_bound_ms"])
                     for m, v in r_bwd.items()}}),
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
        int8_entry(precision["int8"]),
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
                      "evaluation": {k: {m: v for m, v in r.items()
                                         if m != "launches"}
                                     for k, r in evaluation["runs"].items()},
                      "training_entry_points": training_cli,
                      "resnet": {k: resnet[k] for k in (
                          "serve", "train", "parity", "cli")},
                      "precision": {
                          "int8": {t: {k: v for k, v in r.items()
                                       if k != "per_shape"}
                                   for t, r in precision["int8"].items()},
                          "bf16": precision["bf16"],
                          "cli": precision["cli"]},
                      "serving_surface": surface,
                      "stem_paths": {STEM_PATHS[n]: {
                          k: v for k, v in r.items() if k in (
                              "serving", "training")}
                          for n, r in stem_runs.items()},
                      "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def run() -> int:
    """``main()``, with any exception reported on stdout with the phase it
    stopped in (an exception's traceback goes to stderr only)."""
    import traceback

    try:
        return main()
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 - reported, then exit 1
        traceback.print_exc()
        _fail(f"{type(e).__name__}: {e}")


if __name__ == "__main__":
    sys.exit(run())
