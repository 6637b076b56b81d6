"""Detect lesions in raw image files, the direct serving CLI (counterpart
of ``wssdl_bus_tpu/main/predict.py``).  Works from EITHER a serving
artifact (``main/export.py``) or a port snapshot::

    python -m wssdl_bus_tpu_torch.main.predict --artifact /tmp/artifact \\
        a.png b.png
    python -m wssdl_bus_tpu_torch.main.predict --model <snapshot> \\
        --out preds/ --vis --device cpu *.png

Writes ``predictions.json`` (per image: class / score / [x1,y1,x2,y2] in
original pixel coordinates, the reference detection post-processing:
per-class score floor 0.05 + NMS ``cfg.TEST.NMS``; the JAX CLI's schema
and key order) and, with ``--vis``, overlay PNGs.  Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

from wssdl_bus_tpu_torch.main.common import (add_common_args, build_config,
                                             check_ported)

# the model options an artifact's meta.json decides
_ARTIFACT_DECIDES = ("network", "net_depth", "norm_type", "bf16")


def main(argv=None) -> list:
    """-> the report written to ``predictions.json``."""
    parser = argparse.ArgumentParser(
        description="Run detection on raw image files")
    parser.add_argument("images", nargs="+", help="image file paths")
    parser.add_argument("--artifact", default=None, type=str,
                        help="serving artifact directory (main/export.py)")
    parser.add_argument("--model", default=None, type=str,
                        help="snapshot directory written by the port")
    parser.add_argument("--out", default="./predictions", type=str)
    parser.add_argument("--thresh", default=0.5, type=float,
                        help="minimum score for a reported detection")
    parser.add_argument("--vis", action="store_true",
                        help="save overlay PNGs next to predictions.json")
    parser.add_argument("--batch", default=1, type=int,
                        help="images per device step (snapshot mode; "
                             "artifact mode uses the exported batch sizes)")
    add_common_args(parser)
    # None tells an option given from one left at its default
    defaults = {k: parser.get_default(k) for k in _ARTIFACT_DECIDES}
    parser.set_defaults(**dict.fromkeys(_ARTIFACT_DECIDES))
    args = parser.parse_args(argv)
    check_ported(args)
    if (args.artifact is None) == (args.model is None):
        parser.error("exactly one of --artifact / --model is required")
    if args.artifact and args.cfg:
        parser.error("--cfg applies to --model mode; an artifact carries "
                     "its own config (host-side keys can still be "
                     "adjusted with --set_cfgs)")
    given = [k for k in _ARTIFACT_DECIDES if getattr(args, k) is not None]
    if args.artifact and given:
        parser.error(f"--{', --'.join(given)} apply to --model mode; an "
                     f"artifact carries its own model")
    for k in _ARTIFACT_DECIDES:
        if getattr(args, k) is None:
            setattr(args, k, defaults[k])

    from wssdl_bus_tpu_torch.serve import load_gray
    images = [load_gray(p) for p in args.images]
    os.makedirs(args.out, exist_ok=True)

    if args.artifact:
        from wssdl_bus_tpu_torch.serve import load_serving
        served = load_serving(args.artifact, device=args.device)
        # device-side keys (proposal budgets, canvas) are the artifact's;
        # overrides adjust the host-side post-processing (e.g. TEST.NMS,
        # TEST.CLS_AGNOSTIC_NMS)
        cfg = served.cfg.with_overrides(args.set_cfgs) if args.set_cfgs \
            else served.cfg
        step = max(served.batch_sizes)
        results = []
        for i in range(0, len(images), step):
            results.extend(served.detect(images[i:i + step]))
    else:
        from wssdl_bus_tpu_torch.data.augment import max_canvas
        from wssdl_bus_tpu_torch.evaluate.detect import im_detect_batch
        from wssdl_bus_tpu_torch.main.common import build_model
        from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint
        from wssdl_bus_tpu_torch.train.engine import Engine

        cfg = build_config(args)
        sizes = [im.shape[:2] for im in images]
        canvas = max_canvas(sizes, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
        print(f"static canvas: {canvas}")
        model = build_model(args, cfg)
        variables, step = load_checkpoint(args.model, device=args.device)
        model.load_state_dict(variables)
        print(f"restored snapshot at iter {step} from {args.model}")
        eng = Engine(model, cfg, canvas, device=args.device,
                     dataset=args.dataset)
        results = []
        for i in range(0, len(images), args.batch):
            results.extend(im_detect_batch(eng, images[i:i + args.batch],
                                           args.network, canvas))

    from wssdl_bus_tpu_torch.serve import CLASS_NAMES, report_detections
    report = []
    for path, im, (scores, boxes) in zip(args.images, images, results):
        detections, kept = report_detections(scores, boxes, cfg,
                                             thresh=args.thresh)
        entry = {"image": path, "detections": detections}
        report.append(entry)
        if args.vis:
            from wssdl_bus_tpu_torch.evaluate.visualize import \
                draw_detections
            # draw exactly the reported set (already thresholded above)
            img = draw_detections(im, kept, class_names=CLASS_NAMES,
                                  thresh=-1.0,
                                  max_dets=max(1, len(entry["detections"])))
            stem = os.path.splitext(os.path.basename(path))[0]
            img.save(os.path.join(args.out, f"{stem}_pred.png"))

    out_json = os.path.join(args.out, "predictions.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)
    n_det = sum(len(e["detections"]) for e in report)
    print(f"{len(report)} images, {n_det} detections >= {args.thresh} "
          f"-> {out_json}")
    return report


if __name__ == "__main__":
    main()
