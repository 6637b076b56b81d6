"""Export a port snapshot to a serving artifact (counterpart of
``wssdl_bus_tpu/main/export.py``)::

    python -m wssdl_bus_tpu_torch.main.export --model <snapshot> \\
        --out artifact/ --batch_sizes 1,8 [--int8] [--device cpu]

Restores the snapshot (``train/checkpoint.py``) into the detector
``--network`` names, sizes the static canvas over ``--imdb_test``'s images
(or takes ``--canvas``), and writes the artifact of ``serve.export_serving``
(``meta.json`` + ``variables.pt``).  ``--int8`` calibrates the activation
ranges on ``--calib_images`` images of ``--imdb_test`` and ships the int8
tree (VGG16 trunk; ResNet trunk and group3 head, norm BN).  ``--bf16``
records bf16 compute in the artifact.  Runs on CUDA unless ``--device
cpu``; the options ``main/common.py:check_ported`` names raise.
"""

from __future__ import annotations

import argparse
import pprint

import numpy as np

from wssdl_bus_tpu_torch.main.common import (add_common_args, build_config,
                                             check_ported, seed_all)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a snapshot to a serving artifact")
    parser.add_argument("--model", required=True, type=str,
                        help="snapshot directory written by the port")
    parser.add_argument("--out", required=True, type=str,
                        help="artifact output directory")
    parser.add_argument("--batch_sizes", default="1", type=str,
                        help="comma-separated device batch sizes to export")
    parser.add_argument("--canvas", default=None, type=int, nargs=2,
                        metavar=("H", "W"),
                        help="static canvas; default derives from "
                             "--imdb_test like main/test.py")
    parser.add_argument("--imdb_test", default="bus_test", type=str)
    parser.add_argument("--int8", action="store_true",
                        help="int8-quantize (VGG trunk; ResNet trunk + "
                             "group3 head, norm BN): calibrate activation "
                             "ranges on --imdb_test images and ship int8 "
                             "weights (models/quantize.py)")
    parser.add_argument("--calib_images", default=16, type=int,
                        help="number of --imdb_test images used for int8 "
                             "activation-range calibration")
    add_common_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """-> the artifact's metadata."""
    args = parse_args(argv)
    print("Called with args:")
    print(args)
    if args.int8 and args.network.startswith("Resnet"):
        from wssdl_bus_tpu_torch.models.quantize import check_int8_norm
        check_int8_norm(args.norm_type)
    check_ported(args)

    cfg = build_config(args)
    print("Using config:")
    pprint.pprint(cfg)
    seed_all(args, cfg)

    roidb = None
    if args.canvas is None or args.int8:
        from wssdl_bus_tpu_torch.data.dataset import get_imdb, prepare_roidb
        roidb = prepare_roidb(get_imdb(args.imdb_test, args.data_dir))
    if args.canvas is not None:
        canvas = tuple(args.canvas)
    else:
        from wssdl_bus_tpu_torch.data.augment import max_canvas
        sizes = [(e["height"], e["width"]) for e in roidb]
        canvas = max_canvas(sizes, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
    print(f"static canvas: {canvas}")

    from wssdl_bus_tpu_torch.main.common import build_model
    from wssdl_bus_tpu_torch.serve import export_serving
    from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint
    from wssdl_bus_tpu_torch.train.engine import Engine

    model = build_model(args, cfg)
    variables, step = load_checkpoint(args.model, device=args.device)
    model.load_state_dict(variables)
    print(f"restored snapshot at iter {step} from {args.model}")
    eng = Engine(model, cfg, canvas, device=args.device,
                 dataset=args.dataset)

    calib = None
    if args.int8:
        from PIL import Image

        from wssdl_bus_tpu_torch.evaluate.detect import pack_image_batch
        images = [np.asarray(Image.open(e["image"]))
                  for e in roidb[:args.calib_images]]
        blob, _, _ = pack_image_batch(eng, images, args.network, canvas)
        calib = [blob]
        print(f"int8 calibration on {len(images)} {args.imdb_test} images")

    batch_sizes = sorted({int(b) for b in args.batch_sizes.split(",")})
    meta = export_serving(eng, args.out, args.network,
                          batch_sizes=batch_sizes, calib_batches=calib)
    print(f"exported {meta['net_name']} (canvas {meta['canvas_hw']}, "
          f"batches {meta['batch_sizes']}, platform {meta['platform']}, "
          f"quantized {meta['quantized']}, compute "
          f"{meta['compute_dtype']}) to {args.out}")
    return meta


if __name__ == "__main__":
    main()
