"""The port's snapshots (``train/checkpoint.py``): the round trip of
variables, optimizer states and host state, the overlapped writer, and
``latest_checkpoint``'s manifest-first rule (a half-written snapshot is
skipped for the one before it), as the JAX package's
``train/checkpoint.py`` does with orbax."""

import os
import pickle

import pytest
import torch

from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.train.checkpoint import (_ckpt_dir, _is_complete,
                                                  latest_checkpoint,
                                                  load_checkpoint,
                                                  load_host_state,
                                                  make_snapshot_writers,
                                                  save_checkpoint,
                                                  wait_snapshot_writers)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a.weight": torch.randn(3, 4, generator=g),
            "a.bias": torch.randn(4, generator=g),
            "count": torch.tensor(seed)}


@pytest.mark.parametrize("overlapped", [False, True])
def test_round_trip(tmp_path, overlapped):
    variables = _state(1)
    opt = {"m": [torch.ones(3)], "step": 7}
    opt_ws = {"m": [torch.zeros(2)], "step": 3}
    writers = make_snapshot_writers() if overlapped else None
    path = save_checkpoint(str(tmp_path), "vgg16", "_joint", 40, variables,
                           opt, opt_ws, host_state={"rng": [1, 2, 3]},
                           checkpointers=writers)
    if overlapped:
        variables["a.bias"].add_(100.0)     # the write holds its own copy
        wait_snapshot_writers(writers)
    assert path == _ckpt_dir(str(tmp_path), "vgg16", "_joint", 40)
    assert os.path.basename(path) == "vgg16_joint_iter_40"
    v, step, o, ows = load_checkpoint(path, opt_state=True,
                                      opt_state_ws=True)
    assert step == 40 and sorted(v) == sorted(variables)
    want = _state(1)
    for k in want:
        assert torch.equal(v[k], want[k])
    assert o["step"] == 7 and torch.equal(o["m"][0], torch.ones(3))
    assert ows["step"] == 3
    host = load_host_state(path)
    assert host == {"rng": [1, 2, 3], "components": [
        "variables", "opt_state", "opt_state_ws"]}
    assert sorted(os.listdir(path)) == ["host_state.pkl", "opt_state.pt",
                                        "opt_state_ws.pt", "variables.pt"]
    assert latest_checkpoint(str(tmp_path)) == path


def test_model_state_dict_round_trip(tmp_path):
    """A full VGG16 detector's weights survive save and load bit for bit."""
    model = build_detector("VGGnet_test", device="cpu")
    path = save_checkpoint(str(tmp_path), "m", "", 1, model.state_dict())
    other = build_detector("VGGnet_test", device="cpu")
    v, step = load_checkpoint(path)
    other.load_state_dict(v)
    assert step == 1
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    assert load_checkpoint(path, opt_state_ws=True)[2] is None


def test_latest_skips_half_written_snapshots(tmp_path):
    out = str(tmp_path)
    good = save_checkpoint(out, "p", "", 10, _state(0), {"s": 1})
    # step 20: the manifest lists opt_state, which never landed
    p20 = save_checkpoint(out, "p", "", 20, _state(0), {"s": 1})
    os.remove(os.path.join(p20, "opt_state.pt"))
    # step 30: variables still at its temporary name
    p30 = save_checkpoint(out, "p", "", 30, _state(0))
    os.replace(os.path.join(p30, "variables.pt"),
               os.path.join(p30, "variables.pt.tmp"))
    # step 40: a truncated manifest
    p40 = save_checkpoint(out, "p", "", 40, _state(0))
    with open(os.path.join(p40, "host_state.pkl"), "wb") as f:
        f.write(pickle.dumps({"components": ["variables"]})[:5])
    # a stray entry and a file that only looks like a snapshot
    os.makedirs(os.path.join(out, "p_iter_x"))
    open(os.path.join(out, "p_iter_50"), "w").close()
    assert [_is_complete(p) for p in (good, p20, p30, p40)] == \
        [True, False, False, False]
    assert latest_checkpoint(out) == good
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    # a snapshot without a manifest is judged on variables.pt alone
    p60 = save_checkpoint(out, "p", "", 60, _state(0), {"s": 1})
    os.remove(os.path.join(p60, "host_state.pkl"))
    os.remove(os.path.join(p60, "opt_state.pt"))
    assert latest_checkpoint(out) == p60


def test_writer_reports_a_failed_write(tmp_path):
    """A write that fails on the writer's thread raises at the wait, and
    its component never appears, so the snapshot is not taken as whole."""
    writers = make_snapshot_writers()
    path = save_checkpoint(str(tmp_path), "p", "", 1, _state(0),
                           opt_state={"bad": lambda: None},
                           checkpointers=writers)
    with pytest.raises(RuntimeError, match="snapshot write failed"):
        wait_snapshot_writers(writers)
    assert not os.path.exists(os.path.join(path, "opt_state.pt"))
    assert latest_checkpoint(str(tmp_path)) is None
