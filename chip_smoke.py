#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device line: torch's name and count, nvidia-smi's name and power limit;
  2. build both CUDA kernels from ``wssdl_bus_tpu_torch/csrc`` with nvcc for
     sm_90a, printing ptxas's register / shared-memory report;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the served path gives it (B = 8 images at the full VGG16 width
     and the 6000/300 TEST budgets): NMS keep masks must be identical, ROI
     pool values must differ by exactly 0; CUDA-event times of both;
  4. the served path at full width: seeded He weights, synthetic grayscale
     ultrasound-like requests served through ``im_detect_batch`` +
     ``report_detections`` at batch 1 and batch 8, with the kernels' launch
     counters read around the run; then the same requests with the kernels
     swapped for their plain versions (TF32 off on both sides): keep sets and
     detections must match; ms/image and peak device memory;
  5. a ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler breakdown of the batch-8 device step
(device time by kernel, busy share) and a Chrome trace in chiprun_out/.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bounds:
# HBM3 bandwidth, and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NMS_OPS_PER_PAIR = 15       # min/max/sub/add x 2 axes, clamps, mul, union, div, compare
BATCH_1_REQUESTS = 3
BATCH = 8


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


def speckle_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A grayscale ultrasound-like uint8 image: Rayleigh speckle over a
    depth-attenuated background with one dark elliptical mass."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tissue = 110.0 * np.exp(-yy / (1.5 * h))
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.08, 0.2) * w
    mass = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    tissue[mass] *= 0.25
    speckle = rng.rayleigh(1.0, (h, w)).astype(np.float32)
    return np.clip(tissue * speckle, 0, 255).astype(np.uint8)


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


def roi_pool_bound(feat, rois, scale):
    """(bound_ms, bound_by): bytes are feat and rois read once and the
    output written once; operations one max per window cell per channel."""
    from wssdl_bus_tpu_torch.ops.roi_pool import _bin_masks, quantize_rois

    b, h, w, c = feat.shape
    p = rois.shape[1]
    rsw, rsh, roi_w, roi_h = quantize_rois(rois.reshape(-1, 4).cpu(), scale)
    hm, _ = _bin_masks(rsh, roi_h, 7, h, "gpu")
    wm, _ = _bin_masks(rsw, roi_w, 7, w, "gpu")
    cells = int((hm.sum(-1)[:, :, None] * wm.sum(-1)[:, None, :]).sum())
    ops = cells * c
    nbytes = feat.numel() * 4 + rois.numel() * 4 + b * p * 49 * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels(eng, images, net):
    """Phase 3: both kernels against their plain versions at the served
    path's shapes, fed by the trunk's own outputs for ``images``."""
    import torch

    from wssdl_bus_tpu_torch.evaluate.detect import (nms_numpy,
                                                     pack_image_batch)
    from wssdl_bus_tpu_torch.models.detector import rpn_softmax
    from wssdl_bus_tpu_torch.ops.nms import nms_mask
    from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
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

        keep_k = nms_keep(boxes_t, valid, thresh)
        keep_p = nms_mask(boxes_t, valid, thresh)
        torch.cuda.synchronize()
        nms_err = int((keep_k != keep_p).sum())
        _check(nms_err == 0, f"NMS keep masks differ in {nms_err} places")
        # a third, independent implementation: the host's numpy greedy NMS
        # on image 0 (strictly decreasing scores keep the sorted order)
        v0 = valid[0].cpu().numpy()
        b0 = boxes_t[0].cpu().numpy().T[v0]
        dets = np.hstack([b0, -np.arange(len(b0), dtype=np.float32)[:, None]])
        want0 = np.zeros(len(b0), bool)
        want0[nms_numpy(dets, thresh)] = True
        _check(np.array_equal(keep_k[0].cpu().numpy()[v0], want0),
               "NMS kernel disagrees with the numpy greedy NMS on image 0")
        print(f"[kernels] nms_keep == nms_mask on {tuple(keep_k.shape)}: "
              f"{int(keep_k.sum())} kept; image 0 == numpy greedy NMS",
              flush=True)
        nms_ms = cuda_ms(lambda: nms_keep(boxes_t, valid, thresh), 20)
        nms_plain_ms = cuda_ms(lambda: nms_mask(boxes_t, valid, thresh), 3,
                               warmup=1)
        nms_bound_ms, nms_bound_by, pairs = nms_bound(keep_k, valid)

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
        print(f"[kernels] roi_pool_fc == plain roi_pool on {tuple(got.shape)}"
              f" (flat and 5-D views, both flavors): max |diff| {roi_err}",
              flush=True)
        roi_ms = cuda_ms(lambda: roi_pool_fc(feat, rois, 7, 7, scale), 20)
        roi_plain_ms = cuda_ms(
            lambda: roi_pool_fc_plain(feat, rois, 7, 7, scale), 3, warmup=1)
        roi_bound_ms, roi_bound_by = roi_pool_bound(feat, rois, scale)
    print(f"[kernels] nms_keep {nms_ms:.4f} ms (plain {nms_plain_ms:.3f} ms,"
          f" bound {nms_bound_ms:.4f} ms by {nms_bound_by}, {pairs} IoU "
          f"pairs); roi_pool_fc {roi_ms:.4f} ms (plain {roi_plain_ms:.3f} ms,"
          f" bound {roi_bound_ms:.4f} ms by {roi_bound_by}); library: none "
          "(PyTorch has no NMS or ROI-pool op; torchvision is not used)",
          flush=True)
    return {
        "nms_keep": {"max_abs_err": nms_err, "ms": nms_ms,
                     "plain_ms": nms_plain_ms, "bound_ms": nms_bound_ms,
                     "bound_by": nms_bound_by},
        "roi_pool_fc": {"max_abs_err": roi_err, "ms": roi_ms,
                        "plain_ms": roi_plain_ms, "bound_ms": roi_bound_ms,
                        "bound_by": roi_bound_by},
    }


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke needs a card")
    sys.path.insert(0, REPO)
    from wssdl_bus_tpu_torch.config import Config
    from wssdl_bus_tpu_torch.data.augment import max_canvas
    from wssdl_bus_tpu_torch.ops import _build
    from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_fc
    from wssdl_bus_tpu_torch.train.engine import Engine

    t_start = time.perf_counter()
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
    print(f"[build] both kernels built for sm_90a in "
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

    # phase 3: kernels against their plain versions
    stats = check_kernels(eng, requests, net)

    # phase 4a: the served path through the kernels, counters around it
    nms_keep.launches = 0
    roi_pool_fc.launches = 0
    served_1 = serve(eng, requests[:BATCH_1_REQUESTS], net, 1)
    served_8 = serve(eng, requests, net, BATCH)
    torch.cuda.synchronize()
    launches = {"nms_keep": nms_keep.launches,
                "roi_pool_fc": roi_pool_fc.launches}
    want = BATCH_1_REQUESTS + 1
    print(f"[serve] launches during the served run: {launches} "
          f"(expected {want} each: one per served batch)", flush=True)
    for name, n in launches.items():
        _check(n == want, f"{name} launched {n} times, expected {want}")
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
    if "--profile" in sys.argv[1:]:
        profile_step(eng, requests, net, os.path.join(REPO, "chiprun_out"))

    # phase 4c: the same requests with the kernels swapped for the plain
    # versions, TF32 off on both sides so the trunks are bit-identical
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    eng_plain = Engine(model, cfg, canvas, plain_ops=True)
    outs_k = eng.inference_step(*_packed(eng, requests, net))
    outs_p = eng_plain.inference_step(*_packed(eng, requests, net))
    _check(torch.equal(outs_k[1], outs_p[1]), "valid masks differ")
    _check(torch.equal(outs_k[0], outs_p[0]), "proposal boxes differ")
    prob_err = float((outs_k[3] - outs_p[3]).abs().max())
    # identical pooled features feed identical head kernels: the tolerance
    # allows only f32 reassociation in the head's matmuls
    _check(prob_err <= 1e-6, f"cls_prob differs by {prob_err} > 1e-6")
    det_k = serve(eng, requests, net, BATCH)
    det_p = serve(eng_plain, requests, net, BATCH)
    for (_, _, ek), (_, _, ep) in zip(det_k, det_p):
        _check(ek == ep, "served detections differ from the plain run")
    print(f"[parity] f32 (TF32 off): kernels vs plain versions on the card: "
          f"keep sets and proposal boxes identical, max |d cls_prob| "
          f"{prob_err}, reported detections identical", flush=True)

    kernels = [
        dict(name="nms_keep", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/nms.cu",
             replaces="wssdl_bus_tpu/ops/nms_pallas.py:42",
             launches=launches["nms_keep"], library_ms=None,
             **stats["nms_keep"]),
        dict(name="roi_pool_fc", route="cuda",
             source="wssdl_bus_tpu_torch/csrc/roi_pool.cu",
             replaces="wssdl_bus_tpu/ops/roi_pool_pallas.py:373",
             launches=launches["roi_pool_fc"], library_ms=None,
             **stats["roi_pool_fc"]),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"serving": {str(b): t for b, t in perf.items()},
                      "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
