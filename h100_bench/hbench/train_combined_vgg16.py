"""Traffic kind ``train_combined_vgg16``: the joint training loop of
``train_combined.py`` on VGG16, the detector's default network
(``build_detector("VGGnet_train")``: conv1-conv2 frozen, remat off),
through the same ``RoIDataLayerJoint``, ``Prefetcher`` and
``Engine.train_step``.

Beside the draws ``train_combined.py`` makes, every step draws the head's
two dropout masks for each group from the seed and hands them to the step
(``StepDraws.keep_sup`` / ``keep_ws``) and to the plain reference
(``reference_vgg16.py``).  The traced window's one profiler run gives
both the benchmark's trace (``trace.py``, for the readers it serves) and
the program's spans (``program_trace.py``, for ``stem``); the measured
window also reads the ROI-pool backward's row counters.  The comparison
takes ``train_combined.py``'s seven numbers and ``frozen_moved``, the
largest change of a frozen stem parameter over the checked steps.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from . import feed as FD
from . import program_trace as PT
from . import reference as R
from . import reference_vgg16 as RV
from . import train_combined as TC
from . import work as W
from . import work_vgg16 as WV
from .trace import SPAN_PREFIX, Trace
from .weights import make_weights

_IMAGES_NET = "VGGnet_train"


class Run(TC.Run):
    """One run of one cell: ``train_combined.Run`` on VGG16.  ``control``
    and ``fault`` as there, and two more faults: "keep_altered" (the
    program draws its own dropout masks) and "stem_trained" (conv1-conv2
    are not frozen)."""

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
        self.built = (TC.build_kernels(("nms", "roi_pool"))
                      if torch.device(device).type == "cuda" else [])
        self.marks.append(("kernel builds", time.perf_counter()))
        self.config, self.mix, self.workdir = config, mix, workdir
        self.device = torch.device(device)
        self.seeds = TC.seeds(seed)
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
        widths = [[n, c] for stage in RV.STAGES for n, c in stage]
        if config["convs"] != widths or list(config["frozen"]) != \
                list(RV.FROZEN):
            raise ValueError("the configuration's convolutions or frozen "
                             "stem are not VGG16's")
        self.spec = RV.param_spec(config["num_classes"])
        model = build_detector(
            _IMAGES_NET, num_classes=config["num_classes"], device=device,
            freeze_stem=fault != "stem_trained", remat=config["remat"],
            compute_dtype=torch.bfloat16 if control == "bf16" else None)
        self.init = make_weights(self.spec, self.seeds["weights"],
                                 self.device)
        model.load_state_dict(self.init, strict=True)
        self.eng = Engine(model, self.cfg, self.canvas, device=device,
                          dataset="SNUBH", opt_name="adam",
                          seed=self.seeds["draws"])
        self.n_s, self.n_ws = t.IMS_PER_BATCH, t.WS_IMS_PER_BATCH
        self.fh, self.fw = WV.feature_hw(self.canvas)
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
        self.keep = None
        self.fault, self._undo = fault, []
        if fault == "half_batch":
            self._half_batch()
        elif fault == "feed_altered":
            self._alter("_batch_data",
                        lambda x: torch.cat([x[:1].flip(2), x[1:]]))
        elif fault == "proposal_altered":
            self._alter("_proposals", self._moved_box)
        elif fault not in (None, "unchanged", "keep_altered",
                           "stem_trained"):
            raise ValueError(f"unknown fault {fault!r}")

    # ------------------------------------------------------------------ #
    def _draws(self):
        """``train_combined.Run``'s draws, then the (fc6, fc7) keep masks
        of the supervised ROIs and of the weak images' proposals, kept in
        ``self.keep`` for the reference."""
        draws = super()._draws()
        t = self.cfg.TRAIN
        self.keep = tuple(
            tuple(torch.rand((rows, RV.FC), generator=self.gen,
                             device=self.device) < RV.KEEP_PROB
                  for _ in range(2))
            for rows in (self.n_s * t.BATCH_SIZE,
                         self.n_ws * t.RPN_POST_NMS_TOP_N))
        if self.fault == "keep_altered":
            return draws
        return draws._replace(keep_sup=self.keep[0], keep_ws=self.keep[1])

    def _stem(self):
        params = dict(self.eng.model.named_parameters())
        return {n: params[n] for n, _ in self.spec if not RV.trainable(n)}

    def checked_steps(self) -> dict:
        """``train_combined.Run.checked_steps``, also recording each step's
        keep masks and ``frozen_moved``."""
        before = {n: p.detach().clone() for n, p in self._stem().items()}
        keeps, step = [], self.step

        def recorded():
            out = step()
            keeps.append(self.keep)
            return out

        self.step = recorded
        try:
            rec = super().checked_steps()
        finally:
            del self.step
        rec["keep"] = keeps
        rec["frozen_moved"] = max(float((p.detach() - before[n]).abs().max())
                                  for n, p in self._stem().items())
        return rec

    # ------------------------------------------------------------------ #
    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        """``train_combined.Run.window``, its traced steps under one
        profiler run read both ways (``trace`` and ``program_trace``),
        and ``pool_bwd_rows``: the ROI-pool backward's (rows, rows
        active) over the measured window, None where the program has no
        such counters."""
        traces = []
        if trace_steps:
            with _traced(traces):
                for _ in range(trace_steps):
                    self.step()
        before = _pool_rows()
        w = super().window(seconds, 0)
        after = _pool_rows()
        w.update(trace=traces[0][0] if traces else None,
                 program_trace=traces[0][1] if traces else None,
                 trace_steps=trace_steps,
                 pool_bwd_rows=None if before is None else
                 (after[0] - before[0], after[1] - before[1]))
        return w

    def work(self) -> dict:
        """What one step needs, by the benchmark's own counts."""
        c, feat, t = WV.CHANNELS, (self.fh, self.fw), self.cfg.TRAIN
        groups = ((self.n_s, self.n_s * t.BATCH_SIZE),
                  (self.n_ws, self.n_ws * t.RPN_POST_NMS_TOP_N))
        return {
            "step_flops": WV.step_flops(self.canvas, self.n_s + self.n_ws,
                                        self.rois_per_step, train=True),
            "roi_pool_fwd_bytes": sum(W.roi_pool_bytes(n, feat, c, r, False)
                                      for n, r in groups),
            "roi_pool_bwd_bytes": sum(W.roi_pool_bytes(n, feat, c, r, True)
                                      for n, r in groups)}


def _pool_rows():
    """(rows, rows active) the port's ROI-pool backward has counted, or
    None where it counts no rows."""
    from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_fc_backward

    rows = getattr(roi_pool_fc_backward, "rows", None)
    active = getattr(roi_pool_fc_backward, "rows_active", None)
    return None if rows is None or active is None else (rows, int(active))


@contextlib.contextmanager
def _traced(record):
    """Trace the card and the host while the block runs; ``record`` (a
    list) receives (:class:`trace.Trace`, :class:`program_trace.
    ProgramTrace`) of the same events afterwards.  The block should end
    with the device synchronised."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0, start = time.perf_counter(), time.time_ns()
        yield
        torch.cuda.synchronize()
        window, end = time.perf_counter() - t0, time.time_ns()
    events = prof.profiler.kineto_results.events()
    ops, spans = [], []
    for e in events:        # as trace.traced reads them
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.name().startswith(SPAN_PREFIX):
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((e.name(), s, s + d))
        elif e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            ops.append((e.name(), s, d))
    record.append((Trace(ops, spans, window),
                   PT.collect(events, (start, end))))


# --------------------------------------------------------------------- #
# the comparison
# --------------------------------------------------------------------- #
class _Feed(FD.FeedReplica):
    """The reference's minibatches as VGG16's prep scales them: 255 where
    ResNet's takes 255 / PIXEL_STD, so the blob times PIXEL_STD."""

    def next(self) -> dict:
        b = super().next()
        b["data"] = b["data"] * np.float32(self.cfg["pixel_std"])
        return b


def reference_check(run: Run, rec: dict) -> dict:
    """Run the reference over the recorded steps on the run's device ->
    {number: value} for each number compared, and ``info``."""
    dev = run.device
    settings = run.settings
    P = make_weights(run.spec, run.seeds["weights"], dev)
    init = {k: v.clone() for k, v in P.items()}
    train_names = [k for k in P if RV.trainable(k)]
    adam = R.Adam(train_names, P)
    replica = _Feed(
        FD.read_split(run.workdir, "s_train", settings["TRAIN.USE_FLIPPED"]),
        FD.read_split(run.workdir, "ws_train",
                      settings["TRAIN.USE_FLIPPED"]),
        run.seeds["feed"], FD.feed_settings(settings), run.canvas)
    cfg = TC._ref_settings(settings)
    loss_gap, feed_gap, prop_diff = 0.0, 0.0, 0
    where = ""
    for s in range(len(rec["losses"])):
        b = {k: torch.as_tensor(v, device=dev) for k, v in
             replica.next().items()}
        feed_gap = max(feed_gap, TC._feed_gap(rec["blob"][s], rec["feed"][s],
                                              b))
        losses, grads, (props, pvalid), outs = RV.train_step(
            P, b, rec["draws"][s], rec["keep"][s], rec["rpn"][s],
            rec["cls_ws"][s], s, cfg)
        pb, pv = rec["props"][s]
        prop_diff += int(((pb - props).abs().amax(-1) > 1e-3)
                         .logical_or(pv != pvalid).sum())
        for k, r in losses.items():
            gap = abs(rec["losses"][s][k] - float(r)) / max(abs(float(r)),
                                                          1e-30)
            if gap > loss_gap:
                loss_gap, where = gap, f"step {s + 1} {k}"
        if s == 0:
            ref_grad = {n: float(g.norm()) for n, g in grads.items()}
            prog = (*rec["rpn"][0], rec["cls_ws"][0])
            gaps = [float((p - r).abs().max() / r.abs().max())
                    for p, r in zip(prog, outs)]
            out_gaps = {"rpn_gap": max(gaps[:2]), "head_gap": gaps[2]}
        adam.update(P, grads, settings["TRAIN.LEARNING_RATE"])
        del grads
    ref_change = {n: float((P[n] - init[n]).norm()) for n in train_names}
    med_g = statistics.median(ref_grad.values())
    moved = [n for n in train_names if ref_grad[n] >= 1e-3 * med_g]
    out = dict(out_gaps, loss_gap=loss_gap, feed_gap=feed_gap,
               proposal_slots_differing=prop_diff,
               frozen_moved=rec["frozen_moved"])
    info = {"loss_gap_at": where}
    for key, prog, ref, names in (
            ("grad", rec["grad_norms"], ref_grad, train_names),
            ("change", rec["change_norms"], ref_change, moved)):
        out[f"{key}_gap"], info[f"{key}_gap_leaf"] = TC._leaf_gap(prog, ref,
                                                                  names)
    info.update(leaves_compared=len(moved),
                leaves_left_out=len(train_names) - len(moved))
    return dict(out, info=info)


context = TC.context
