"""The port stands alone: importing it, serving a request and taking
training steps load nothing of JAX or of the JAX package; no file of it (or
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
    with pytest.raises(NotImplementedError, match="ResNet"):
        build_detector("Resnet_test", device="cpu")
