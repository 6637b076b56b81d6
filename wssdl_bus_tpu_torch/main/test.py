"""Inference / evaluation CLI (counterpart of ``wssdl_bus_tpu/main/test.py``,
the reference's ``code/main/test.py``):

    python -m wssdl_bus_tpu_torch.main.test --model <snapshot> \\
        --imdb_test bus_test --data_dir <SNUBH_BUS> [--batch_size 8] \\
        [--device cpu]

Reads the imdb, sizes the static canvas over its images, builds the
detector ``--network`` names (``VGGnet_test``, or ``Resnet_test`` with
``--net_depth`` / ``--norm_type``), restores the port's snapshot
(``train/checkpoint.py``), runs ``test_net`` and writes ``detections.pkl``,
``eval.txt`` (AP / CorLoc) and the FROC points to ``--output_dir``.  Runs
on CUDA unless ``--device cpu``.  ``--bf16`` evaluates in bf16 compute;
``--int8`` calibrates the activation ranges on ``--calib_images`` images of
``--calib_imdb`` (default: the evaluated split), quantizes the model
(``Engine.quantize_for_serving``) and evaluates it through
``models/quantize.py:QuantServingEngine`` (int8 VGG16 trunk; ResNet trunk
and group3 head, norm BN; GroupNorm raises).  The options
``main/common.py:check_ported`` names raise.
"""

from __future__ import annotations

import argparse
import pprint

import numpy as np

from wssdl_bus_tpu_torch.main.common import (add_common_args, build_config,
                                             check_ported, seed_all)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Test a Faster R-CNN network")
    parser.add_argument("--model", required=True, type=str,
                        help="snapshot directory written by the port")
    parser.add_argument("--imdb_test", default="bus_test", type=str)
    parser.add_argument("--comp_mode", action="store_true",
                        help="competition mode (kept for CLI parity)")
    parser.add_argument("--qual_res", action="store_true",
                        help="save qualitative detection overlays")
    parser.add_argument("--batch_size", default=1, type=int,
                        help="images per device step (batched serving path)")
    parser.add_argument("--int8", action="store_true",
                        help="evaluate the int8-quantized model instead "
                             "(VGG trunk; ResNet trunk + group3 head, norm "
                             "BN; models/quantize.py): quantized-vs-f32 "
                             "mAP/CorLoc directly")
    parser.add_argument("--calib_imdb", default=None, type=str,
                        help="imdb whose images calibrate int8 activation "
                             "ranges (default: the evaluated --imdb_test)")
    parser.add_argument("--calib_images", default=16, type=int)
    add_common_args(parser)
    return parser.parse_args(argv)


def main(argv=None, timings: dict = None):
    """-> (all_boxes, evaluation result).  ``timings`` is passed to
    ``test_net``."""
    args = parse_args(argv)
    print("Called with args:")
    print(args)
    if args.int8:
        if args.mesh_data * args.mesh_model > 1:
            raise NotImplementedError("--int8 is single-device serving")
        if args.network.startswith("Resnet"):
            from wssdl_bus_tpu_torch.models.quantize import check_int8_norm
            check_int8_norm(args.norm_type)
    check_ported(args)

    cfg = build_config(args)
    print("Using config:")
    pprint.pprint(cfg)
    seed_all(args, cfg)

    from wssdl_bus_tpu_torch.data.augment import max_canvas
    from wssdl_bus_tpu_torch.data.dataset import get_imdb, prepare_roidb
    from wssdl_bus_tpu_torch.evaluate.detect import test_net as run_test_net
    from wssdl_bus_tpu_torch.main.common import build_model
    from wssdl_bus_tpu_torch.train.checkpoint import load_checkpoint
    from wssdl_bus_tpu_torch.train.engine import Engine

    imdb = get_imdb(args.imdb_test, args.data_dir)
    imdb.competition_mode(args.comp_mode)
    roidb = prepare_roidb(imdb)
    sizes = [(e["height"], e["width"]) for e in roidb]
    canvas = max_canvas(sizes, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
    print(f"static canvas: {canvas}")

    model = build_model(args, cfg)
    variables, step = load_checkpoint(args.model, device=args.device)
    model.load_state_dict(variables)
    print(f"restored snapshot at iter {step} from {args.model}")
    eng = Engine(model, cfg, canvas, device=args.device,
                 dataset=args.dataset)
    if args.int8:
        eng = int8_engine(eng, args, roidb, canvas)
    all_boxes, result = run_test_net(
        eng, imdb, args.output_dir, args.network, canvas, vis=args.qual_res,
        batch_size=args.batch_size, timings=timings)
    print("evaluation result:", np.asarray(result))
    return all_boxes, result


def int8_engine(eng, args, roidb, canvas):
    """Calibrate on ``--calib_images`` images packed as one serving blob,
    quantize, and -> the int8 engine ``test_net`` evaluates."""
    from PIL import Image

    from wssdl_bus_tpu_torch.data.dataset import get_imdb, prepare_roidb
    from wssdl_bus_tpu_torch.evaluate.detect import pack_image_batch
    from wssdl_bus_tpu_torch.models.quantize import QuantServingEngine

    calib_roidb = roidb
    if args.calib_imdb:
        calib_roidb = prepare_roidb(get_imdb(args.calib_imdb, args.data_dir))
    else:
        print("int8 NOTE: calibrating on the evaluated split itself: the "
              "reported delta excludes calibration-set shift; pass "
              "--calib_imdb <train split> for deployment-honest numbers")
    images = [np.asarray(Image.open(e["image"]))
              for e in calib_roidb[:args.calib_images]]
    blob, _, _ = pack_image_batch(eng, images, args.network, canvas)
    qtrunk = eng.quantize_for_serving([blob])
    print(f"int8: calibrated on {len(images)} images from "
          f"{args.calib_imdb or args.imdb_test}")
    return QuantServingEngine(eng, qtrunk)


if __name__ == "__main__":
    main()
