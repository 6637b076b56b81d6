"""CPU tests of the H100 benchmark's harness (run from the repository's
root: ``python -m pytest h100_bench -q``; the test marked ``gpu`` runs one
short cell on the card and skips without one).

They cover finding configurations, traffic mixes, limits and metric
readers by name (and adding each with new files alone), the work and rate
arithmetic, the plain reference against the port at a tiny size, the
control and the faults that the comparison must catch, and that a run
loads nothing of JAX or of the JAX package."""

import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import run as harness  # noqa: E402
from hbench import work as W  # noqa: E402

BENCH = harness.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]

# a tiny version of the train_combined mix and of ResNet-50 BN's cell that
# a CPU holds: 1 + 2 images of 192 px, 300 -> 24 proposals, 16 ROIs
TINY_MIX = {"canvas": [208, 288],
            "imdb": {"supervised": 4, "weak": 6,
                     "sizes": [[192, 256], [144, 192]], "mass_px": [30, 90],
                     "background_px": [40, 80]},
            "settings": {"TRAIN.IMS_PER_BATCH": 1,
                         "TRAIN.WS_IMS_PER_BATCH": 2,
                         "TRAIN.SCALES": [192], "TRAIN.MAX_SIZE": 320,
                         "TRAIN.RPN_PRE_NMS_TOP_N": 300,
                         "TRAIN.RPN_POST_NMS_TOP_N": 24,
                         "TRAIN.BATCH_SIZE": 16}}

REHEARSAL = r"""
import json, sys, tempfile
sys.path[:0] = [{here!r}, {root!r}]
import torch
torch.set_num_threads(4)
import run as harness
from hbench import train_combined as TC
found = harness.find_cell(harness.load_json({root!r}, "BENCHMARK.json"),
                          "resnet50_bn.train_combined")
mix, tiny = found["mix"], json.loads({tiny!r})
for key in ("imdb", "settings"):
    mix[key].update(tiny.pop(key))
mix.update(tiny)
out = []
for control, fault in json.loads({variants!r}):
    with tempfile.TemporaryDirectory() as d:
        run = TC.Run(found["config"], mix, 2 ** 31 + 77, d, device="cpu",
                     control=control, fault=fault)
        rec = run.checked_steps()
        run.close()
        numbers = TC.reference_check(run, rec)
    correct, checks = harness.judge(numbers, found["limits"])
    out.append({{"control": control, "fault": fault, "correct": correct,
                "numbers": {{k: v for k, v in numbers.items()
                            if k != "info"}}}})
print(json.dumps({{"runs": out, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def rehearse(variants):
    code = REHEARSAL.format(here=HERE, root=ROOT, tiny=json.dumps(TINY_MIX),
                            variants=json.dumps(variants))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sound():
    return rehearse([[None, None]])


# --------------------------------------------------------------------- #
def test_every_cell_finds_its_files():
    for name in CELLS:
        found = harness.find_cell(BENCH, name)
        assert found["mix"]["kind"] == "train_combined"
        assert set(found["limits"]) == {"rpn_gap", "head_gap", "loss_gap",
                                        "grad_gap", "change_gap", "feed_gap",
                                        "proposal_slots_differing"}
        names = {m["name"] for m in found["end_to_end"]}
        assert {"setup_s", "train_images_per_s", "train_peak_gib"} <= names
        for m in found["end_to_end"] + found["per_layer"]:
            assert callable(harness.reader(m["name"]))


def test_a_cell_config_mix_and_metric_are_added_with_files_alone(tmp_path):
    """A new configuration, traffic mix, limits file and per-layer metric
    come in as new files and new BENCHMARK.json entries; no file of the
    benchmark changes."""
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "h100_bench").rglob("*")
              if p.is_file()}
    bench = copy.deepcopy(BENCH)
    conf = harness.load_json(HERE, "configs", "resnet50_bn.json")
    (tmp_path / "h100_bench/configs/resnet50_bn_b.json").write_text(
        json.dumps(dict(conf, name="resnet50_bn_b")))
    mix = harness.load_json(HERE, "traffic", "train_combined.json")
    mix["settings"]["TRAIN.BATCH_SIZE"] = 256
    (tmp_path / "h100_bench/traffic/train_wide.json").write_text(
        json.dumps(mix))
    (tmp_path / "h100_bench/checks/resnet50_bn_b.train_wide.json"
     ).write_text(json.dumps({"limits": {"loss_gap": 1.0}}))
    (tmp_path / "h100_bench/metrics/steps.train.py").write_text(
        "def read(ctx):\n    return ctx['steps']\n")
    bench["configs"].append({"name": "resnet50_bn_b", "source": "x",
                             "file": "h100_bench/configs/resnet50_bn_b.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "resnet50_bn_b.train_wide",
                               "config": "resnet50_bn_b",
                               "traffic": "train_wide", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("resnet50_bn_b.train_wide")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine step",
                               "moves": "train_images_per_s",
                               "workloads": ["resnet50_bn_b.train_wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = importlib.util.spec_from_file_location(
        "run_copy", tmp_path / "h100_bench" / "run.py")
    copy_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy_run)
    found = copy_run.find_cell(copy_run.load_json(str(tmp_path),
                                                  "BENCHMARK.json"),
                               "resnet50_bn_b.train_wide")
    assert found["config"]["name"] == "resnet50_bn_b"
    assert found["mix"]["settings"]["TRAIN.BATCH_SIZE"] == 256
    assert "steps.train" in {m["name"] for m in found["per_layer"]}
    ctx = {"steps": 7, "images": 21, "seconds": 3.0, "setup_s": 1.0,
           "peak_bytes": 2 ** 31}
    got = copy_run.read_metrics(
        [m for m in found["per_layer"] + found["end_to_end"]
         if m["name"] in ("steps.train", "train_images_per_s", "setup_s",
                          "train_peak_gib")], ctx)
    assert got["steps.train"]["value"] == 7
    assert got["train_images_per_s"]["value"] == 7.0
    assert got["train_peak_gib"]["value"] == 2.0
    # the older cell still finds its own files, and nothing was edited
    assert copy_run.find_cell(copy_run.load_json(str(tmp_path),
                                                 "BENCHMARK.json"),
                              "resnet50_bn.train_combined")
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_per_layer_metric_must_list_its_cells():
    bench = copy.deepcopy(BENCH)
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(SystemExit, match="lists no workloads"):
        harness.find_cell(bench, CELLS[0])


def test_work_counts_by_hand():
    assert W.feature_hw((608, 896)) == (38, 56)
    # group3 on one 7x7 ROI: block 0 (1x1 1024->512 at 7x7, 3x3/2 512->512
    # to 4x4, 1x1 512->2048, shortcut 1x1/2 1024->2048), blocks 1-2 at 4x4,
    # and the two dense layers 2048 -> 3 + 12
    block0 = 49 * 1024 * 512 + 16 * 9 * 512 * 512 + 16 * 512 * 2048 \
        + 16 * 1024 * 2048
    later = 16 * 2048 * 512 + 16 * 9 * 512 * 512 + 16 * 512 * 2048
    hand = block0 + 2 * later + 2048 * 15
    assert hand == 256_407_552
    assert W.head_macs_per_roi(101) == W.head_macs_per_roi(50) == hand
    # conv0 at 608x896: 304x448 outputs of a 7x7x3 window, 64 channels
    assert W.trunk_macs(50, (608, 896))["conv0"] == 304 * 448 * 147 * 64
    t = W.trunk_macs(101, (608, 896))
    fwd = 3 * (t["trunk"] + t["rpn"]) + 4128 * hand
    assert W.step_flops(101, (608, 896), 3, 4128, True) == \
        2.0 * (3 * fwd - 3 * t["conv0"])
    assert W.step_flops(101, (608, 896), 3, 4128, False) == 2.0 * fwd
    # ROI pool: the map read once, the pooled rows written once, the boxes
    one = 38 * 56 * 1024 * 4 + 128 * 49 * 1024 * 4 + 128 * 16
    assert W.roi_pool_bytes(1, (38, 56), 1024, 128, False) == one
    assert W.roi_pool_bytes(1, (38, 56), 1024, 128, True) == \
        one + 38 * 56 * 1024 * 4


def test_metric_readers_arithmetic():
    class Tr:
        window_s, busy_s = 2.0, 1.5

        def kernel_seconds(self, *needles):
            return (8, 0.004) if "roi_pool_fwd_" in needles else (16, 0.02)

    ctx = {"images": 30, "seconds": 5.0, "peak_bytes": 3 * 2 ** 30,
           "steps": 10, "step_flops": 8e12,
           "peak_flops": 495e12, "trace": Tr(), "trace_steps": 4,
           "roi_pool_launches_per_step": 2, "roi_pool_fwd_bytes": 3.35e8,
           "roi_pool_bwd_bytes": 6.7e8, "peak_bytes_per_s": 3.35e12,
           "feed_wait_s": [0.001, 0.003], "step_device_s": [0.5, 0.7],
           "setup_s": 12.5}
    read = {m: harness.reader(m)(ctx) for m in (
        "train_images_per_s", "train_peak_gib", "mfu.train",
        "roi_pool_fwd_roofline.train", "roi_pool_bwd_roofline.train",
        "device_idle.train", "feed_wait_ms.train", "step_device_ms.train",
        "setup_s")}
    assert read["train_images_per_s"] == 6.0
    assert read["train_peak_gib"] == 3.0
    assert read["mfu.train"] == pytest.approx(100 * 16e12 / 495e12)
    # 4 steps x 3.35e8 B at 3.35e12 B/s = 0.4 ms of 4 ms
    assert read["roi_pool_fwd_roofline.train"] == pytest.approx(10.0)
    assert read["roi_pool_bwd_roofline.train"] == pytest.approx(4.0)
    assert read["device_idle.train"] == pytest.approx(25.0)
    assert read["feed_wait_ms.train"] == pytest.approx(2.0)
    assert read["step_device_ms.train"] == pytest.approx(600.0)
    assert read["setup_s"] == 12.5
    # a trace with another number of forward launches reads nothing
    ctx["trace_steps"] = 3
    assert harness.reader("roi_pool_fwd_roofline.train")(ctx) is None


def test_reference_names_every_parameter_of_the_port():
    import torch
    from hbench import reference as R
    from wssdl_bus_tpu_torch.models.detector import build_detector

    for depth in (50, 101):
        sd = build_detector("Resnet_train", depth=depth, norm="BN",
                            device="meta").state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            dict(R.param_spec(depth))
    assert torch  # imported for the meta device


def test_reference_follows_the_port_at_a_tiny_size(sound):
    run = sound["runs"][0]
    assert run["correct"], run
    n = run["numbers"]
    # f32 against f32: the first step's outputs agree to rounding; losses
    # and worst leaves also carry the max pools' routing, which rounding
    # can flip
    assert n["rpn_gap"] < 1e-4 and n["head_gap"] < 1e-4
    assert n["loss_gap"] < 1e-3
    # the feed and the proposal layer on the same inputs agree
    assert n["feed_gap"] < 1e-4 and n["proposal_slots_differing"] == 0


def test_a_run_loads_no_jax(sound):
    mods = set(sound["modules"])
    assert "wssdl_bus_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "optax", "orbax",
                       "wssdl_bus_tpu"}


def test_control_and_faults_come_out_incorrect():
    runs = rehearse([["bf16", None], [None, "unchanged"],
                     [None, "half_batch"], [None, "feed_altered"],
                     [None, "proposal_altered"]])["runs"]
    for r in runs:
        assert not r["correct"], r
    # each planted fault in the feed and the proposal layer fails the
    # number that compares that stage
    limits = harness.find_cell(BENCH, CELLS[-1])["limits"]
    by_fault = {r["fault"]: r["numbers"] for r in runs}
    assert by_fault["feed_altered"]["feed_gap"] > limits["feed_gap"]
    assert by_fault["proposal_altered"]["proposal_slots_differing"] > \
        limits["proposal_slots_differing"]


def test_run_without_a_card_prints_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[-1],
         "--seed", str(2 ** 31 + 9), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert list(result)[-1] == "checks"
