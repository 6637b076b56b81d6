"""The port stands alone: importing it, serving a request (also through
the serving artifact and the HTTP server) and taking training steps (VGG16
and ResNet-18) load nothing of JAX or of the JAX package; no file of it (or
``chip_smoke.py``) imports them; and its entry points never drop to the CPU
unasked."""

import ast
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (the test process itself has both frameworks)
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "wssdl_bus_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wssdl_bus_tpu")


def _forbidden(name: str) -> bool:
    # mind the prefix: wssdl_bus_tpu_torch starts with wssdl_bus_tpu
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


_SERVE_ON_CPU = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import im_detect_batch
from wssdl_bus_tpu_torch.models.convert import he_init_
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.serve import report_detections
from wssdl_bus_tpu_torch.train.engine import Engine
cfg = Config().with_overrides(["TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
                               "TEST.RPN_PRE_NMS_TOP_N", "50",
                               "TEST.RPN_POST_NMS_TOP_N", "10"])
model = he_init_(build_detector("VGGnet_test", device="cpu"), 0, 64.0)
eng = Engine(model, cfg, (64, 96), device="cpu")
im = np.random.RandomState(0).randint(0, 255, (40, 60)).astype(np.uint8)
(scores, boxes), = im_detect_batch(eng, [im], "VGGnet_test", (64, 96))
report_detections(scores, boxes, cfg)
print(json.dumps({"modules": sorted(sys.modules), "n": len(scores)}))
"""


def test_serving_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SERVE_ON_CPU], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] > 0
    assert "wssdl_bus_tpu_torch.train.engine" in res["modules"]
    assert [m for m in res["modules"] if _forbidden(m)] == []


_INT8_ON_CPU = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import (im_detect_batch,
                                                 pack_image_batch)
from wssdl_bus_tpu_torch.models.convert import he_init_
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.models.quantize import QuantServingEngine
from wssdl_bus_tpu_torch.train.engine import Engine
cfg = Config().with_overrides(["TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
                               "TEST.RPN_PRE_NMS_TOP_N", "50",
                               "TEST.RPN_POST_NMS_TOP_N", "10"])
n = 0
for name, kw, scale in (("VGGnet_test", {}, 64.0),
                        ("Resnet_test", {"depth": 18, "norm": "BN"}, 1.0)):
    model = he_init_(build_detector(name, device="cpu", **kw), 0, scale)
    eng = Engine(model, cfg, (64, 96), device="cpu")
    im = np.random.RandomState(0).randint(0, 255, (40, 60)).astype(np.uint8)
    blob, _, _ = pack_image_batch(eng, [im], name, (64, 96))
    qeng = QuantServingEngine(eng, eng.quantize_for_serving([blob]))
    (scores, boxes), = im_detect_batch(qeng, [im], name, (64, 96))
    n += len(scores)
print(json.dumps({"modules": sorted(sys.modules), "n": n}))
"""


def test_int8_serving_loads_no_jax_module():
    """Int8 calibration, quantization and a served request, VGG16 and
    ResNet-18 BN, on the CPU in a fresh process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _INT8_ON_CPU], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] > 0
    for m in ("wssdl_bus_tpu_torch.models.quantize",
              "wssdl_bus_tpu_torch.ops.int8_conv",
              "wssdl_bus_tpu_torch.ops.int8_conv_cuda"):
        assert m in res["modules"]
    assert [m for m in res["modules"] if _forbidden(m)] == []


_TRAIN_ON_CPU = """
import json, sys, tempfile, os
import numpy as np
import torch
from PIL import Image
torch.set_num_threads(2)
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.minibatch import get_minibatch_joint
from wssdl_bus_tpu_torch.models.convert import he_init_
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.engine import Engine
cfg = Config().with_overrides(["TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE",
                               "96", "ANCHOR_SCALES", "(2, 4, 8)",
                               "TRAIN.RPN_PRE_NMS_TOP_N", "50",
                               "TRAIN.RPN_POST_NMS_TOP_N", "10",
                               "TRAIN.BATCH_SIZE", "8"])
d = tempfile.mkdtemp()
rng = np.random.RandomState(0)
roidb = []
for i in range(3):
    path = os.path.join(d, f"{i}.png")
    Image.fromarray(rng.randint(0, 255, (40, 60)).astype(np.uint8)).save(path)
    roidb.append({"image": path, "boxes": np.array([[10, 8, 30, 25],
                  [0, 0, 59, 39]], np.float32),
                  "gt_classes": np.array([2, 0]), "birads_diag": 1 + i % 2})
batch = get_minibatch_joint(roidb[:1], roidb[1:], "VGGnet_train", cfg,
                            (80, 112), np.random.RandomState(0))
model = he_init_(build_detector("VGGnet_train", device="cpu"), 0, 64.0)
eng = Engine(model, cfg, (80, 112), device="cpu")
ls = eng.train_step(batch, step=0)
mil = eng.train_step_mil({k: batch[k][1:] for k in ("data", "im_info")})
print(json.dumps({"modules": sorted(sys.modules),
                  "losses": [float(x) for x in ls] + [float(mil)]}))
"""


def test_training_loads_no_jax_module():
    """The training slice end to end on the CPU (minibatch from image
    files, one combined and one MIL step) in a fresh process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _TRAIN_ON_CPU], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert np.isfinite(res["losses"]).all()
    for m in ("wssdl_bus_tpu_torch.ops.anchor_target",
              "wssdl_bus_tpu_torch.ops.proposal_target",
              "wssdl_bus_tpu_torch.mil", "wssdl_bus_tpu_torch.train.losses",
              "wssdl_bus_tpu_torch.data.minibatch"):
        assert m in res["modules"]
    assert [m for m in res["modules"] if _forbidden(m)] == []


_HELP = """
import json, runpy, sys
sys.argv = ["wssdl_bus_tpu_torch.main.test", "--help"]
try:
    runpy.run_module("wssdl_bus_tpu_torch.main.test", run_name="__main__")
except SystemExit:
    pass
print(json.dumps({"modules": sorted(sys.modules)}))
"""

_TEST_NET_ON_CPU = """
import json, os, sys, tempfile
import numpy as np
import torch
from PIL import Image
torch.set_num_threads(2)
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data.dataset import get_imdb
from wssdl_bus_tpu_torch.evaluate.detect import test_net as run
from wssdl_bus_tpu_torch.models.convert import he_init_
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.engine import Engine
d = tempfile.mkdtemp()
for sub in ("TIFFImages", "Annotations", "ImageSets/Main"):
    os.makedirs(os.path.join(d, sub))
rng = np.random.RandomState(0)
for k in range(2):
    Image.fromarray(rng.randint(0, 255, (40, 60)).astype(np.uint8)).save(
        os.path.join(d, "TIFFImages", f"t{k}.tif"))
    with open(os.path.join(d, "Annotations", f"t{k}.xml"), "w") as f:
        f.write("<annotation><object><name>benign</name><difficult>0"
                "</difficult><bndbox><xmin>5</xmin><ymin>5</ymin><xmax>30"
                "</xmax><ymax>25</ymax></bndbox></object><BIRADS><diag>0"
                "</diag></BIRADS></annotation>")
with open(os.path.join(d, "ImageSets", "Main", "test.txt"), "w") as f:
    f.write("t0\\nt1\\n")
cfg = Config().with_overrides(["TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
                               "TEST.RPN_PRE_NMS_TOP_N", "50",
                               "TEST.RPN_POST_NMS_TOP_N", "10"])
model = he_init_(build_detector("VGGnet_test", device="cpu"), 0, 64.0)
eng = Engine(model, cfg, (64, 96), device="cpu")
boxes, res = run(eng, get_imdb("bus_test", d), os.path.join(d, "out"),
                 "VGGnet_test", (64, 96), verbose=False, batch_size=2)
print(json.dumps({"modules": sorted(sys.modules), "result": list(res)}))
"""


@pytest.mark.parametrize("script", ["help", "test_net"])
def test_evaluation_loads_no_jax_module(script):
    """``python -m wssdl_bus_tpu_torch.main.test --help``, and ``test_net``
    over a two-image imdb on the CPU, in fresh processes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _HELP if script == "help" else _TEST_NET_ON_CPU
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if script == "help":
        assert "wssdl_bus_tpu_torch.main.common" in res["modules"]
    else:
        assert len(res["result"]) == 3
        for m in ("wssdl_bus_tpu_torch.evaluate.voc_eval",
                  "wssdl_bus_tpu_torch.data.loader",
                  "wssdl_bus_tpu_torch.native"):
            assert m in res["modules"]
    assert [m for m in res["modules"] if _forbidden(m)] == []


_TRAIN_CLI_ON_CPU = """
import json, os, shutil, sys, tempfile
import numpy as np
import torch
from PIL import Image
torch.set_num_threads(2)
from wssdl_bus_tpu_torch.main import train
d = tempfile.mkdtemp()   # removed at the end: snapshots are ~330 MB each
for sub in ("TIFFImages", "Annotations", "ImageSets/Main"):
    os.makedirs(os.path.join(d, sub))
rng = np.random.RandomState(0)
for k in range(2):
    Image.fromarray(rng.randint(0, 255, (60, 80)).astype(np.uint8)).save(
        os.path.join(d, "TIFFImages", f"t{k}.tif"))
    with open(os.path.join(d, "Annotations", f"t{k}.xml"), "w") as f:
        f.write("<annotation><object><name>benign</name><difficult>0"
                "</difficult><bndbox><xmin>5</xmin><ymin>5</ymin><xmax>40"
                "</xmax><ymax>35</ymax></bndbox></object><object><name>"
                "__background__</name><difficult>0</difficult><bndbox><xmin>"
                "1</xmin><ymin>30</ymin><xmax>80</xmax><ymax>60</ymax>"
                "</bndbox></object><BIRADS><diag>1</diag></BIRADS>"
                "</annotation>")
with open(os.path.join(d, "ImageSets", "Main", "test.txt"), "w") as f:
    f.write("t0\\nt1\\n")
npy = os.path.join(d, "vgg.npy")
np.save(npy, {"conv5_3": {"biases": np.zeros(512, np.float32)}},
        allow_pickle=True)
out = os.path.join(d, "run")
solver = train.main([
    "--max_iters", "2", "--output_dir", out, "--data_dir", d, "--device",
    "cpu", "--pretrained_model", npy, "--prefetch", "--set_cfgs",
    "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96", "TEST.SCALES", "(64,)",
    "TEST.MAX_SIZE", "96", "ANCHOR_SCALES", "(2, 4, 8)",
    "TRAIN.RPN_PRE_NMS_TOP_N", "50", "TRAIN.RPN_POST_NMS_TOP_N", "8",
    "TRAIN.BATCH_SIZE", "8", "TEST.RPN_PRE_NMS_TOP_N", "50",
    "TEST.RPN_POST_NMS_TOP_N", "8", "TRAIN.SNAPSHOT_ITERS", "1",
    "TRAIN.TEST_ITERS", "2", "TRAIN.DISPLAY", "1"])
files = sorted(os.listdir(out))
shutil.rmtree(d)
print(json.dumps({"modules": sorted(sys.modules), "files": files,
                  "eval": solver.stats["eval"][0]["test_loss"]}))
"""


def test_training_cli_loads_no_jax_module():
    """``python -m wssdl_bus_tpu_torch.main.train`` (its ``main``) on the
    CPU for two iterations, with a pretrained ``.npy``, device prep and the
    prefetch thread, in a fresh process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _TRAIN_CLI_ON_CPU], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert np.isfinite(res["eval"]).all()
    assert {"VGGnet_fast_rcnn_iter_1", "VGGnet_fast_rcnn_iter_2",
            "log.txt", "test"} <= set(res["files"])
    for m in ("wssdl_bus_tpu_torch.train.solver",
              "wssdl_bus_tpu_torch.train.schedules",
              "wssdl_bus_tpu_torch.models.pretrained",
              "wssdl_bus_tpu_torch.ops.device_prep",
              "wssdl_bus_tpu_torch.data.loader"):
        assert m in res["modules"], m
    assert [m for m in res["modules"] if _forbidden(m)] == []


def _resnet(script: str) -> str:
    """A VGG16 script above, on ResNet-18 BN with its pixel scale."""
    return script.replace(
        'build_detector("VGGnet_test", device="cpu"), 0, 64.0)',
        'build_detector("Resnet_test", device="cpu", depth=18, norm="BN"), '
        '0)').replace(
        'build_detector("VGGnet_train", device="cpu"), 0, 64.0)',
        'build_detector("Resnet_train", device="cpu", depth=18, norm="BN"), '
        '0)').replace('"VGGnet_test"', '"Resnet_test"').replace(
        '"VGGnet_train"', '"Resnet_train"')


@pytest.mark.parametrize("script", ["serve", "train"])
def test_resnet_steps_load_no_jax_module(script):
    """A ResNet-18 BN serving step (``im_detect_batch`` +
    ``report_detections``) and a combined + MIL training step on the CPU,
    in fresh processes, with the models/resnet.py modules loaded."""
    code = _resnet(_SERVE_ON_CPU if script == "serve" else _TRAIN_ON_CPU)
    assert "Resnet_" in code and "VGGnet" not in code
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if script == "serve":
        assert res["n"] > 0
    else:
        assert np.isfinite(res["losses"]).all()
    assert "wssdl_bus_tpu_torch.models.resnet" in res["modules"]
    assert [m for m in res["modules"] if _forbidden(m)] == []


_SERVING_SURFACE_ON_CPU = """
import json, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import pack_image_batch
from wssdl_bus_tpu_torch.models.convert import he_init_
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.serve import (export_serving, load_serving,
                                       report_detections)
from wssdl_bus_tpu_torch.serve.server import serve
from wssdl_bus_tpu_torch.train.engine import Engine
cfg = Config().with_overrides(["TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
                               "TEST.RPN_PRE_NMS_TOP_N", "50",
                               "TEST.RPN_POST_NMS_TOP_N", "10"])
model = he_init_(build_detector("VGGnet_test", device="cpu"), 0, 64.0)
eng = Engine(model, cfg, (64, 96), device="cpu")
im = np.random.RandomState(0).randint(0, 255, (40, 60)).astype(np.uint8)
d = tempfile.mkdtemp()
blob, _, _ = pack_image_batch(eng, [im], "VGGnet_test", (64, 96))
n = 0
for name, calib in (("f32", None), ("int8", [blob])):
    export_serving(eng, os.path.join(d, name), "VGGnet_test", (1, 2), calib)
    served = load_serving(os.path.join(d, name), device="cpu")
    for scores, boxes in served.detect([im, im[::-1].copy()]):
        report_detections(scores, boxes, served.cfg)
        n += len(scores)
httpd = serve(os.path.join(d, "f32"), port=0, device="cpu")
httpd.server_close()
httpd.service.batcher.close()
print(json.dumps({"modules": sorted(sys.modules), "n": n}))
"""


def test_serving_surface_loads_no_jax_module():
    """``export_serving`` (f32 and int8), ``load_serving``,
    ``ServingModel.detect`` and the HTTP server's ``serve`` on the CPU, in a
    fresh process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SERVING_SURFACE_ON_CPU],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] > 0
    for m in ("wssdl_bus_tpu_torch.serve", "wssdl_bus_tpu_torch.serve.server",
              "wssdl_bus_tpu_torch.models.quantize"):
        assert m in res["modules"]
    assert [m for m in res["modules"] if _forbidden(m)] == []


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_port_imports_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = {os.path.relpath(f, REPO): m for f in files
           for m in _imports(f) if _forbidden(m)}
    assert bad == {}
    assert not _forbidden("wssdl_bus_tpu_torch.ops")
    assert _forbidden("wssdl_bus_tpu.ops") and _forbidden("jax.numpy")


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without ``device=`` the entry points want CUDA; with no card they
    raise instead of running on the CPU."""
    from wssdl_bus_tpu_torch.config import Config
    from wssdl_bus_tpu_torch.models.detector import FasterRCNN, build_detector
    from wssdl_bus_tpu_torch.train.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(FasterRCNN(), Config(), (64, 64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector("VGGnet_test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector("Resnet_test", depth=18, norm="BN")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(FasterRCNN(backbone="Resnet", depth=18, norm="BN"), Config(),
               (64, 64))
