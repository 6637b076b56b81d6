"""Traffic kind ``train_combined``: the joint training loop of the
detector's solver (``Solver.train_combined`` without display, periodic
evaluation or snapshots): ``RoIDataLayerJoint`` through ``Prefetcher``,
then ``Engine.train_step``, one update per step.

A run: write the seeded image database under ``TMPDIR``, build the
detector with seeded weights, run the first ``check_steps`` steps through
the window's own feed and call (recording what the reference needs to
follow them), then measure the window, then free the program and hold
those first steps against the plain reference (``reference.py``,
``feed.py``).  Every random draw of a step (anchor and ROI sampling) is
made here from the seed and handed to the step, so the reference gets the
same draws.
"""

from __future__ import annotations

import gc
import os
import statistics
import time

import numpy as np
import torch

from . import feed as FD
from . import reference as R
from . import work as W
from .trace import span, traced
from .weights import make_weights

_IMAGES_NET = "Resnet_train"


def seeds(seed: int) -> dict:
    """Independent streams of one ``--seed`` (any size): the database,
    the weights, the data layer and the step draws."""
    states = np.random.SeedSequence(int(seed)).spawn(4)
    return {k: int(s.generate_state(1)[0]) for k, s in
            zip(("imdb", "weights", "feed", "draws"), states)}


def build_kernels(names) -> list:
    """Build the port's CUDA kernels ``names`` and its native host library
    where a checkout lacks them (its first run) -> the names built."""
    from wssdl_bus_tpu_torch import native
    from wssdl_bus_tpu_torch.ops import _build

    built = [n for n, report in _build.build_all(names).items() if report]
    if not os.path.exists(native.lib_path()):
        native.build()
        built.append("native")
    return built


class Run:
    """One run of one cell: the program under test and what its checks
    need.  ``control``: None, or "bf16" (the program's own bf16 compute
    path, the comparison's control); ``fault``: None, "unchanged" (the
    update leaves the parameters as they are), "half_batch" (the
    supervised ROI class loss takes its mean over the first half of the
    ROI slots only), "feed_altered" (the device-prepped image batch has
    its first image mirrored left to right) or "proposal_altered" (the
    proposal layer's first box of the first image is moved 4 px right)."""

    def __init__(self, config: dict, mix: dict, seed: int, workdir: str,
                 device="cuda", control=None, fault=None):
        from wssdl_bus_tpu_torch.config import Config
        from wssdl_bus_tpu_torch.data.augment import max_canvas
        from wssdl_bus_tpu_torch.data.dataset import (get_imdb,
                                                      get_training_roidb)
        from wssdl_bus_tpu_torch.data.loader import (Prefetcher,
                                                     RoIDataLayerJoint)
        from wssdl_bus_tpu_torch.models.detector import build_detector
        from wssdl_bus_tpu_torch.train.engine import Engine

        self.marks = [("imports", time.perf_counter())]
        self.built = (build_kernels(("nms", "roi_pool"))
                      if torch.device(device).type == "cuda" else [])
        self.marks.append(("kernel builds", time.perf_counter()))
        self.config, self.mix, self.workdir = config, mix, workdir
        self.device = torch.device(device)
        self.seeds = seeds(seed)
        self.settings = mix["settings"]
        FD.write_imdb(workdir, self.seeds["imdb"], mix)
        self.marks.append(("database", time.perf_counter()))
        self.cfg = Config().with_overrides(
            [x for kv in self.settings.items() for x in kv])
        t = self.cfg.TRAIN
        s_db = get_training_roidb(get_imdb("bus_s_train", workdir),
                                  use_flipped=t.USE_FLIPPED)
        ws_db = get_training_roidb(get_imdb("bus_ws_train", workdir),
                                   use_flipped=t.USE_FLIPPED)
        sizes = [(e["height"], e["width"]) for e in s_db + ws_db]
        self.canvas = max_canvas(sizes, t.SCALES[0], t.MAX_SIZE,
                                 crop_margin=t.CROPPING_MAX_MARGIN)
        if list(self.canvas) != list(mix["canvas"]):
            raise ValueError(f"canvas {self.canvas} is not the mix's "
                             f"{mix['canvas']}")
        self.marks.append(("roidb", time.perf_counter()))
        self.depth = config["depth"]
        if tuple(config["blocks"]) != R.BLOCKS[self.depth]:
            raise ValueError(f"blocks {config['blocks']} are not ResNet-"
                             f"{self.depth}'s {R.BLOCKS[self.depth]}")
        self.spec = R.param_spec(self.depth, config["num_classes"])
        model = build_detector(
            _IMAGES_NET, num_classes=config["num_classes"], device=device,
            depth=self.depth, norm=config["norm"], remat=config["remat"],
            compute_dtype=torch.bfloat16 if control == "bf16" else None)
        self.init = make_weights(self.spec, self.seeds["weights"],
                                 self.device)
        model.load_state_dict(self.init, strict=True)
        self.eng = Engine(model, self.cfg, self.canvas, device=device,
                          dataset="SNUBH", opt_name="adam",
                          seed=self.seeds["draws"])
        self.n_s, self.n_ws = t.IMS_PER_BATCH, t.WS_IMS_PER_BATCH
        self.fh, self.fw = W.feature_hw(self.canvas)
        self.rois_per_step = (self.n_s * t.BATCH_SIZE
                              + self.n_ws * t.RPN_POST_NMS_TOP_N)
        self.n_cand = max(t.RPN_POST_NMS_TOP_N + t.MAX_GT_PER_IMAGE,
                          t.BATCH_SIZE)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seeds["draws"])
        layer = RoIDataLayerJoint(
            s_db, ws_db, _IMAGES_NET, self.cfg, self.canvas,
            rng=np.random.RandomState(self.seeds["feed"]),
            device_prep=t.DEVICE_PREP)
        self.feed = Prefetcher(layer)
        self.marks.append(("model and weights", time.perf_counter()))
        self.lr = t.LEARNING_RATE
        self.it = 0
        self.fault, self._undo = fault, []
        if fault == "half_batch":
            self._half_batch()
        elif fault == "feed_altered":
            self._alter("_batch_data",
                        lambda x: torch.cat([x[:1].flip(2), x[1:]]))
        elif fault == "proposal_altered":
            self._alter("_proposals", self._moved_box)
        elif fault not in (None, "unchanged"):
            raise ValueError(f"unknown fault {fault!r}")

    # ------------------------------------------------------------------ #
    def _draws(self):
        from wssdl_bus_tpu_torch.train.engine import StepDraws

        k = self.fh * self.fw * R.NUM_ANCHORS
        return StepDraws(
            anchor_u=torch.rand((self.n_s, 2, k), generator=self.gen,
                                device=self.device),
            roi_u=torch.rand((self.n_s, 2, self.n_cand), generator=self.gen,
                             device=self.device))

    def step(self):
        """One step of the loop: the feed, the draws, the update."""
        with span("feed_wait"):
            t0 = time.perf_counter()
            blobs = self.feed.forward()
            wait = time.perf_counter() - t0
        draws = self._draws()
        with span("train_step"):
            losses = self.eng.train_step(blobs, self.lr, self.it, draws)
        self.it += 1
        return blobs, draws, losses, wait

    def _half_batch(self):
        from wssdl_bus_tpu_torch.train import losses

        whole = losses.rcnn_class_loss

        def half(cls_score, labels):
            n = len(labels) // 2
            return whole(cls_score[:n], labels[:n])

        losses.rcnn_class_loss = half
        self._undo.append(lambda: setattr(losses, "rcnn_class_loss", whole))

    def _alter(self, name, change):
        """The engine's ``name`` with ``change`` applied to what it returns
        (an instance attribute, which ``checked_steps`` takes as the
        original and removes when it ends)."""
        whole = getattr(self.eng, name)
        setattr(self.eng, name, lambda *a: change(whole(*a)))

    @staticmethod
    def _moved_box(props):
        boxes = props.boxes.clone()
        boxes[0, 0, 0::2] += 4.0
        return props._replace(boxes=boxes)

    # ------------------------------------------------------------------ #
    def checked_steps(self) -> dict:
        """The first ``check_steps`` steps, through the feed and the call
        the window uses, recording for the reference: the draws, the
        program's RPN outputs and proposals (the reference's proposal
        layer follows the former and is held against the latter), its
        weak class logits (the MIL instance), the minibatch its feed
        assembled (the image blob, boxes and image info), its losses,
        the gradient the optimizer got in step 1 (its first moment / (1 -
        b1)) and the parameters' change after the last step."""
        eng, rec = self.eng, {k: [] for k in (
            "draws", "rpn", "props", "cls_ws", "blob", "feed", "losses")}
        hooks = ("_proposals", "_mil", "_batch_data")
        orig = {k: getattr(eng, k) for k in hooks}

        def proposals(score, deltas, im_info, budgets):
            out = orig["_proposals"](score, deltas, im_info, budgets)
            rec["rpn"].append((score.detach().clone(),
                               deltas.detach().clone()))
            rec["props"].append((out.boxes.clone(), out.valid.clone()))
            return out

        def mil(cls_ws, *args):
            rec["cls_ws"].append(cls_ws.detach().float().clone())
            return orig["_mil"](cls_ws, *args)

        def batch_data(b):
            out = orig["_batch_data"](b)
            rec["blob"].append(out.detach().cpu())
            return out

        eng._proposals, eng._mil, eng._batch_data = proposals, mil, batch_data
        if self.fault == "unchanged":
            eng.opt.step = lambda lr: None
        try:
            for s in range(self.mix["check_steps"]):
                blobs, draws, losses, _ = self.step()
                rec["feed"].append({k: np.array(blobs[k]) for k in (
                    "gt_boxes", "num_gt_boxes", "im_info")})
                rec["draws"].append((draws.anchor_u.clone(),
                                     draws.roi_u.clone()))
                rec["losses"].append({k: float(getattr(losses, k)) for k in
                                      ("rpn_cls", "rpn_box", "rcnn_cls",
                                       "rcnn_box", "mil_cls")})
                if s == 0:
                    opt = eng.opt
                    rec["grad_norms"] = {
                        n: float((m / (1 - opt.b1)).norm())
                        for n, m in zip(opt.names, opt.mu)}
        finally:
            for k in hooks:
                delattr(eng, k)
            eng.opt.__dict__.pop("step", None)
        self.marks.append(("checked steps", time.perf_counter()))
        params = dict(eng.model.named_parameters())
        rec["change_norms"] = {n: float((params[n].detach() - self.init[n])
                                        .norm()) for n in eng.opt.names}
        self.init = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return rec

    # ------------------------------------------------------------------ #
    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        """With ``trace_steps``, that many steps under the profiler first
        (the traced window); then the measured window: steps until the
        first step boundary after ``seconds``, the card synchronised at
        both ends.  -> the window's readings."""
        dev = self.device
        traces = []
        if trace_steps:
            with traced(traces):
                for _ in range(trace_steps):
                    self.step()
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        waits, events = [], []
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        while True:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, _, losses, wait = self.step()
            e1.record()
            bad += (~torch.isfinite(losses.total)).to(torch.int64)
            waits.append(wait)
            events.append((e0, e1))
            if time.perf_counter() - t0 >= seconds:
                break
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        steps = len(events)
        return {
            "start": t0, "attempted": steps, "setup_peak_bytes": setup_peak,
            "steps": steps, "images": steps * (self.n_s + self.n_ws),
            "seconds": t1 - t0, "failed": int(bad),
            "feed_wait_s": waits,
            "step_device_s": [a.elapsed_time(b) * 1e-3 for a, b in events],
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "trace": traces[0] if traces else None,
            "trace_steps": trace_steps}

    def work(self) -> dict:
        """What one step needs, by the benchmark's own counts."""
        c = 1024
        feat = (self.fh, self.fw)
        t = self.cfg.TRAIN
        return {
            "step_flops": W.step_flops(self.depth, self.canvas,
                                       self.n_s + self.n_ws,
                                       self.rois_per_step, train=True),
            "roi_pool_fwd_bytes": (
                W.roi_pool_bytes(self.n_s, feat, c, self.n_s * t.BATCH_SIZE,
                                 False)
                + W.roi_pool_bytes(self.n_ws, feat, c,
                                   self.n_ws * t.RPN_POST_NMS_TOP_N, False)),
            "roi_pool_bwd_bytes": (
                W.roi_pool_bytes(self.n_s, feat, c, self.n_s * t.BATCH_SIZE,
                                 True)
                + W.roi_pool_bytes(self.n_ws, feat, c,
                                   self.n_ws * t.RPN_POST_NMS_TOP_N, True))}

    def close(self):
        """Stop the feed's thread and free the program's state."""
        if self.feed is not None:
            self.feed.close()
        while self._undo:
            self._undo.pop()()
        self.feed = self.eng = self.init = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the comparison
# --------------------------------------------------------------------- #
def _ref_settings(s: dict) -> dict:
    return {"n_s": s["TRAIN.IMS_PER_BATCH"],
            "pre_n": s["TRAIN.RPN_PRE_NMS_TOP_N"],
            "post_n": s["TRAIN.RPN_POST_NMS_TOP_N"],
            "rois_per_image": s["TRAIN.BATCH_SIZE"],
            "nms": s["TRAIN.RPN_NMS_THRESH"],
            "min_size": float(s["TRAIN.RPN_MIN_SIZE"]),
            "ws_mal_pct": s["TRAIN.WS_MAL_PCT"],
            "weight_decay": s["TRAIN.WEIGHT_DECAY"]}


def _leaf_gap(prog: dict, ref: dict, names) -> tuple:
    """The worst leaf's |norm(program) - norm(reference)| over the larger
    of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _feed_gap(blob, feed: dict, ref: dict) -> float:
    """The widest gap of the program's minibatch from the reference's:
    the image blob over the reference's largest pixel, the boxes over its
    largest coordinate, each image-info entry over max(1, its value); 1
    where the number of boxes of an image differs."""
    data = ref["data"]
    gaps = [float((blob.to(data.device) - data).abs().max()
                  / data.abs().max()),
            float(np.abs(feed["gt_boxes"] - ref["gt"].cpu().numpy()).max()
                  / max(float(ref["gt"].abs().max()), 1.0)),
            float((np.abs(feed["im_info"] - ref["im_info"].cpu().numpy())
                   / np.maximum(np.abs(ref["im_info"].cpu().numpy()), 1.0))
                  .max())]
    if (feed["num_gt_boxes"] != ref["num_gt"].cpu().numpy()).any():
        gaps.append(1.0)
    return max(gaps)


def reference_check(run: Run, rec: dict) -> dict:
    """Run the reference over the recorded steps on the run's device ->
    {number: value} for each number compared, and ``info``."""
    dev = run.device
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        settings = run.settings
        P = make_weights(run.spec, run.seeds["weights"], dev)
        init = {k: v.clone() for k, v in P.items()}
        train_names = [k for k in P if not k.endswith((".mean", ".var"))]
        adam = R.Adam(train_names, P)
        replica = FD.FeedReplica(
            FD.read_split(run.workdir, "s_train",
                          settings["TRAIN.USE_FLIPPED"]),
            FD.read_split(run.workdir, "ws_train",
                          settings["TRAIN.USE_FLIPPED"]),
            run.seeds["feed"], FD.feed_settings(settings), run.canvas)
        cfg = _ref_settings(settings)
        loss_gap, feed_gap, prop_diff = 0.0, 0.0, 0
        where = ""
        for s in range(len(rec["losses"])):
            b = {k: torch.as_tensor(v, device=dev) for k, v in
                 replica.next().items()}
            feed_gap = max(feed_gap, _feed_gap(rec["blob"][s],
                                               rec["feed"][s], b))
            losses, grads, stats, (props, pvalid), outs = R.train_step(
                P, run.depth, b, rec["draws"][s], rec["rpn"][s],
                rec["cls_ws"][s], s, cfg)
            pb, pv = rec["props"][s]
            prop_diff += int(((pb - props).abs().amax(-1) > 1e-3)
                             .logical_or(pv != pvalid).sum())
            for k, r in losses.items():
                gap = abs(rec["losses"][s][k] - float(r)) / max(
                    abs(float(r)), 1e-30)
                if gap > loss_gap:
                    loss_gap, where = gap, f"step {s + 1} {k}"
            if s == 0:
                ref_grad = {n: float(g.norm()) for n, g in grads.items()}
                prog = (*rec["rpn"][0], rec["cls_ws"][0])
                gaps = [float((p - r).abs().max() / r.abs().max())
                        for p, r in zip(prog, outs)]
                out_gaps = {"rpn_gap": max(gaps[:2]), "head_gap": gaps[2]}
            adam.update(P, grads, settings["TRAIN.LEARNING_RATE"])
            for p, (m, v) in stats.items():
                P[f"{p}.mean"], P[f"{p}.var"] = m, v
            del grads
        ref_change = {n: float((P[n] - init[n]).norm()) for n in train_names}
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    med_g = statistics.median(ref_grad.values())
    moved = [n for n in train_names if ref_grad[n] >= 1e-3 * med_g]
    out = dict(out_gaps, loss_gap=loss_gap, feed_gap=feed_gap,
               proposal_slots_differing=prop_diff)
    info = {"loss_gap_at": where}
    for key, prog, ref, names in (
            ("grad", rec["grad_norms"], ref_grad, train_names),
            ("change", rec["change_norms"], ref_change, moved)):
        out[f"{key}_gap"], info[f"{key}_gap_leaf"] = _leaf_gap(prog, ref,
                                                               names)
    info.update(leaves_compared=len(moved),
                leaves_left_out=len(train_names) - len(moved))
    return dict(out, info=info)


def context(run: Run, w: dict, setup_s: float) -> dict:
    """What the metric readers read (``metrics/<name>.py``): the window's
    readings, the work a step needs and the card's peaks."""
    return dict(w, setup_s=setup_s, **run.work(),
                images_per_step=run.n_s + run.n_ws,
                roi_pool_launches_per_step=2,
                peak_flops=W.PEAK_TF32_FLOPS,
                peak_bytes_per_s=W.PEAK_HBM_BYTES)
