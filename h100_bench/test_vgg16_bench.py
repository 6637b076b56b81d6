"""CPU tests of the benchmark's VGG16 cell (run from the repository's root:
``python -m pytest h100_bench -q``).

They cover its mix against ``train_combined.json``, the VGG16 work count
against a hand count, the two new readers (nothing where the program or
the trace lacks what they read), finding the cell with its metrics, and
the traffic kind's ``Run`` at a tiny size on the CPU: the sound run
within its limits and loading nothing of JAX, the bf16 control and every
fault beyond at least one limit."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import run as harness  # noqa: E402
from hbench import program_trace as PT  # noqa: E402
from hbench import work as W  # noqa: E402
from hbench import work_vgg16 as WV  # noqa: E402

BENCH = harness.load_json(ROOT, "BENCHMARK.json")
VGG = "vgg16.train_combined"
NEW_METRICS = {"stem_device_ms.train", "roi_pool_bwd_active_share.train"}
FAULTS = ("unchanged", "half_batch", "feed_altered", "proposal_altered",
          "keep_altered", "stem_trained")

# the tiny mix of test_h100_bench_harness.py: 1 + 2 images of 192 px,
# 300 -> 24 proposals, 16 ROIs
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
from hbench import train_combined_vgg16 as TV
found = harness.find_cell(harness.load_json({root!r}, "BENCHMARK.json"),
                          {cell!r})
mix, tiny = found["mix"], json.loads({tiny!r})
for key in ("imdb", "settings"):
    mix[key].update(tiny.pop(key))
mix.update(tiny)
out = []
for control, fault in json.loads({variants!r}):
    with tempfile.TemporaryDirectory() as d:
        run = TV.Run(found["config"], mix, 2 ** 31 + 77, d, device="cpu",
                     control=control, fault=fault)
        rec = run.checked_steps()
        run.close()
        numbers = TV.reference_check(run, rec)
    correct, checks = harness.judge(numbers, found["limits"])
    out.append({{"control": control, "fault": fault, "correct": correct,
                "failed": sorted(k for k, c in checks.items()
                                 if c["value"] > c["limit"]),
                "numbers": {{k: v for k, v in numbers.items()
                            if k != "info"}}}})
print(json.dumps({{"runs": out, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def rehearse(variants):
    code = REHEARSAL.format(here=HERE, root=ROOT, cell=VGG,
                            tiny=json.dumps(TINY_MIX),
                            variants=json.dumps(variants))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------- #
def test_the_vgg16_mix_is_train_combined_but_for_kind():
    base = harness.load_json(HERE, "traffic", "train_combined.json")
    vgg = harness.load_json(HERE, "traffic", "train_combined_vgg16.json")
    assert set(vgg) == set(base)
    for k in ("canvas", "check_steps", "trace_steps", "imdb", "settings"):
        assert vgg[k] == base[k], k
    assert vgg["kind"] == "train_combined_vgg16"


def test_the_cell_finds_its_files_and_metrics():
    found = harness.find_cell(BENCH, VGG)
    assert found["limits"] == {
        "rpn_gap": 0.005, "head_gap": 0.003, "loss_gap": 0.06,
        "grad_gap": 0.02, "change_gap": 0.1, "feed_gap": 0.05,
        "proposal_slots_differing": 0, "frozen_moved": 0}
    assert {m["name"] for m in found["end_to_end"]} == {
        "setup_s", "train_images_per_s", "train_peak_gib"}
    assert {m["name"] for m in found["per_layer"]} == NEW_METRICS | {
        "feed_wait_ms.train", "step_device_ms.train", "mfu.train",
        "roi_pool_fwd_roofline.train", "roi_pool_bwd_roofline.train",
        "device_idle.train"}
    for m in found["end_to_end"] + found["per_layer"]:
        assert callable(harness.reader(m["name"]))
    # the new metrics are read in this cell alone
    for m in BENCH["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [VGG]


def test_work_counts_by_hand():
    # a 64 x 96 canvas: stages at 64x96, 32x48, 16x24, 8x12, 4x6
    def conv(h, w, cin, cout):
        return h * w * 9 * cin * cout

    stem = conv(64, 96, 3, 64) + conv(64, 96, 64, 64) \
        + conv(32, 48, 64, 128) + conv(32, 48, 128, 128)
    c31 = conv(16, 24, 128, 256)
    trunk = stem + c31 + 2 * conv(16, 24, 256, 256) \
        + conv(8, 12, 256, 512) + 2 * conv(8, 12, 512, 512) \
        + 3 * conv(4, 6, 512, 512)
    rpn = 4 * 6 * (9 * 512 * 512 + 512 * 18 + 512 * 36)
    head = 7 * 7 * 512 * 512 + 512 * 512 + 512 * 3 + 512 * 12
    assert WV.feature_hw((64, 96)) == (4, 6)
    assert WV.trunk_macs((64, 96)) == {"stem": stem, "conv3_1": c31,
                                       "trunk": trunk, "rpn": rpn}
    assert WV.head_macs_per_roi() == head == 13_114_880
    fwd = 3 * (trunk + rpn) + 100 * head
    assert WV.step_flops((64, 96), 3, 100, False) == 2.0 * fwd
    # the stem has no backward, conv3_1 no input gradient
    assert WV.step_flops((64, 96), 3, 100, True) == \
        2.0 * (3 * fwd - 3 * (2 * stem + c31))
    # the cell's step: 10.97 TFLOP at 608 x 896, 4 + 8 images, 16512 ROIs
    assert WV.step_flops((608, 896), 12, 16512, True) == \
        pytest.approx(10.9657e12, rel=1e-4)
    assert W.roi_pool_bytes(1, (38, 56), WV.CHANNELS, 128, True) == \
        2 * 38 * 56 * 512 * 4 + 128 * 49 * 512 * 4 + 128 * 16


def _program_trace(stem: bool):
    """Two 100 ms steps, each with a trunk launch and, with ``stem``, a
    launch of 3 ms under a ``stem`` span nested in the trunk."""
    ms = 1_000_000
    ops, calls, spans = [], [], []
    for k, t in enumerate((0, 100)):
        spans += [("train_step", 1, t * ms, (t + 90) * ms),
                  ("trunk", 1, (t + 10) * ms, (t + 40) * ms)]
        calls.append(("cudaLaunchKernel", 1, (t + 30) * ms,
                      (t + 31) * ms, 10 * k + 1))
        ops.append(("conv", (t + 31) * ms, (t + 36) * ms, 10 * k + 1))
        if stem:
            spans.append(("stem", 1, (t + 12) * ms, (t + 20) * ms))
            calls.append(("cudaLaunchKernel", 1, (t + 13) * ms,
                          (t + 14) * ms, 10 * k + 2))
            ops.append(("conv1", (t + 14) * ms, (t + 17) * ms, 10 * k + 2))
    return PT.ProgramTrace(ops, calls, spans, (0, 200 * ms))


def test_the_new_readers():
    stem = harness.reader("stem_device_ms.train")
    share = harness.reader("roi_pool_bwd_active_share.train")
    assert stem({"program_trace": _program_trace(True)}) == pytest.approx(3.0)
    # a trace without the span (a ResNet, or a program without it), or no
    # trace: nothing
    assert stem({"program_trace": _program_trace(False)}) is None
    assert stem({"program_trace": None}) is None
    assert stem({}) is None
    assert share({"pool_bwd_rows": (16512 * 5, 520 * 5)}) == \
        pytest.approx(100 * 520 / 16512)
    # a program without the counters, or a window without a backward
    assert share({"pool_bwd_rows": None}) is None
    assert share({"pool_bwd_rows": (0, 0)}) is None
    assert share({}) is None


@pytest.fixture(scope="module")
def sound():
    return rehearse([[None, None]])


def test_the_vgg16_run_follows_the_reference_at_a_tiny_size(sound):
    run = sound["runs"][0]
    assert run["correct"], run
    n = run["numbers"]
    assert n["rpn_gap"] < 1e-4 and n["head_gap"] < 1e-4
    assert n["loss_gap"] < 1e-2
    assert n["feed_gap"] < 1e-4 and n["proposal_slots_differing"] == 0
    assert n["frozen_moved"] == 0.0
    mods = set(sound["modules"])
    assert "wssdl_bus_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_control_and_faults_come_out_incorrect():
    runs = rehearse([["bf16", None]] + [[None, f] for f in FAULTS])["runs"]
    for r in runs:
        assert not r["correct"] and r["failed"], r
    by_fault = {r["fault"]: set(r["failed"]) for r in runs}
    # each fault fails the number that compares the stage it breaks
    assert "feed_gap" in by_fault["feed_altered"]
    assert "proposal_slots_differing" in by_fault["proposal_altered"]
    assert "head_gap" in by_fault["keep_altered"]
    assert "frozen_moved" in by_fault["stem_trained"]
    assert {"grad_gap", "change_gap"} <= by_fault["unchanged"]
