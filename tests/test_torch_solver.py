"""The port's training entry points on the CPU: ``python -m
wssdl_bus_tpu_torch.main.train`` and ``main.train_alter`` (their ``main``)
over a synthetic SNUBH-layout imdb (``tests/test_torch_dataset.py:
write_bus_imdb``) at a tiny config (64-px scale, full VGG16 width,
default ``TRAIN.DEVICE_PREP``), and the pieces of the solver held against
the JAX package's.

  * artifacts: snapshots at every SNAPSHOT_ITERS, ``log.txt``, the in-loop
    evaluation's ``test/detections.pkl`` and ``eval.txt``;
  * exact resume, with and without the prefetch thread: a run resumed from
    the iteration-2 snapshot writes a final snapshot whose
    parameters, optimizer moments and counts, test losses, generator state
    and data-layer state (so the next batches) are equal bit for bit to the
    uninterrupted run's;
  * the alternating regime: two optimizer states, each stepped 3 times, and
    ``ws_step`` 3 (iteration 0 supervised, 1-2 both, 3 weak), resumed
    exactly too;
  * ``periodic_eval``'s host half against the JAX Solver's: both engines'
    ``eval_step`` are replaced by one returning the same arrays, so the
    test losses, the CorLoc report (``eval.txt``), the detections per class
    and image and their scores must be equal; box coordinates to 1e-6
    relative, since the box decode's ``exp`` is torch's (SLEEF, within an
    ulp) on one side and XLA's on the other, which round ~1 in 20 values
    of this data 1 ulp apart;
  * ``models/convert.py:opt_state_from_jax``: after three optax steps, one
    more step from the converted state against optax, within the Adam
    tolerance of ``tests/test_torch_losses.py`` (rtol 1e-6, atol 1e-7);
  * without a card the CLIs raise unless ``--device cpu``;
  * the step clock keeps a bounded window of each series beside the run's
    counts and means, and the logger warns where ``output_dir`` is not a
    local path."""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dataset import write_bus_imdb
from wssdl_bus_tpu.config import Config as JaxConfig
from wssdl_bus_tpu.data import dataset as jax_dataset
from wssdl_bus_tpu.train.engine import make_optimizer as jax_make_optimizer
from wssdl_bus_tpu.train.engine import vgg_frozen_mask
from wssdl_bus_tpu.train.solver import Solver as JaxSolver
from wssdl_bus_tpu.train.schedules import build_schedule as jax_schedule
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.data import dataset
from wssdl_bus_tpu_torch.data.loader import RoIDataLayer, RoIDataLayerJoint
from wssdl_bus_tpu_torch.main import train, train_alter
from wssdl_bus_tpu_torch.models.convert import (opt_state_from_jax,
                                                params_from_jax)
from wssdl_bus_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  load_host_state)
from wssdl_bus_tpu_torch.train.engine import Optimizer
from wssdl_bus_tpu_torch.train.schedules import build_schedule
from wssdl_bus_tpu_torch.train.solver import Solver
from wssdl_bus_tpu_torch.utils.logging import MetricLogger

SIZES = [(150, 200), (120, 180), (170, 150), (140, 210)]
CFGS = ["TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96",
        "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
        "ANCHOR_SCALES", "(2, 4, 8)",
        "TRAIN.RPN_PRE_NMS_TOP_N", "100", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "32",
        "TEST.RPN_PRE_NMS_TOP_N", "50", "TEST.RPN_POST_NMS_TOP_N", "8",
        "TRAIN.SNAPSHOT_ITERS", "2", "TRAIN.DISPLAY", "1"]
SNAP = "VGGnet_fast_rcnn_iter_{}"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("bus"))
    write_bus_imdb(root, seed=3, sizes=SIZES)
    return root


@pytest.fixture
def runs(tmp_path):
    """A directory for the runs' output, removed after the test: a
    full-width snapshot with its optimizer state takes ~330 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _argv(data_dir, out, *extra, iters=4, test_iters=2):
    return ["--max_iters", str(iters), "--output_dir", out, "--data_dir",
            data_dir, "--device", "cpu", "--eval_batch", "2", *extra,
            "--set_cfgs", *CFGS, "TRAIN.TEST_ITERS", str(test_iters)]


def _resume_copy(src, dst, step=2):
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, SNAP.format(step)),
                    os.path.join(dst, SNAP.format(step)))


def _assert_same_snapshot(a, b, opt_names, n_evals):
    va, sa, *oa = load_checkpoint(a, opt_state=True, opt_state_ws=True)
    vb, sb, *ob = load_checkpoint(b, opt_state=True, opt_state_ws=True)
    assert sa == sb
    assert va.keys() == vb.keys()
    for k in va:
        assert torch.equal(va[k], vb[k]), k
    for name, x, y in zip(("opt_state", "opt_state_ws"), oa, ob):
        if name not in opt_names:
            assert x is None and y is None
            continue
        assert x["count"] == y["count"] and x["name"] == y["name"]
        for m in ("mu", "nu"):
            assert x[m].keys() == y[m].keys()
            for k in x[m]:
                assert torch.equal(x[m][k], y[m][k]), (name, m, k)
    ha, hb = load_host_state(a), load_host_state(b)
    assert ha["test_loss_logs"] == hb["test_loss_logs"]
    assert len(ha["test_loss_logs"]) == n_evals
    assert torch.equal(ha["generator"], hb["generator"])
    np.testing.assert_array_equal(ha["eval_rng"][1], hb["eval_rng"][1])
    np.testing.assert_array_equal(ha["training_loss"], hb["training_loss"])
    assert ha["ws_step"] == hb["ws_step"]
    return ha, hb, oa


def _next_batches(solver, ha, hb, joint):
    """The batches a run continued from each host state would draw next."""
    cfg, db = solver.cfg, solver.roidb_train_s
    out = []
    for h in (ha, hb):
        if joint:
            layer = RoIDataLayerJoint(db, solver.roidb_train_ws,
                                      solver.net_name, cfg,
                                      solver.eng.canvas_hw, device_prep=True)
            layer.load_state_dict(h["data_layers"]["joint"])
        else:
            layer = RoIDataLayer(db, solver.net_name, cfg,
                                 solver.eng.canvas_hw, True,
                                 device_prep=True)
            layer.load_state_dict(h["data_layers"]["s"])
        out.append([layer.forward() for _ in range(2)])
    for x, y in zip(*out):
        assert x.keys() == y.keys() and "raw" in x
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("prefetch", [False, True])
def test_train_artifacts_and_exact_resume(data_dir, runs, prefetch):
    extra = ["--prefetch"] if prefetch else ["--no_prefetch"]
    a, b = str(runs / "a"), str(runs / "b")
    # 3 iterations: a snapshot at 2 and the final one at 3, an evaluation
    # after every iteration
    kw = dict(iters=3, test_iters=1)
    solver = train.main(_argv(data_dir, a, "--unfreeze_stem", *extra, **kw))
    names = set(os.listdir(a))
    assert {SNAP.format(2), SNAP.format(3), "log.txt", "test"} <= names
    assert {"detections.pkl", "eval.txt"} <= set(os.listdir(
        os.path.join(a, "test")))
    with open(os.path.join(a, "log.txt")) as f:
        log = f.read()
    assert log.count("test loss") == 3 and "iter: 3 / 3" in log
    assert solver.cfg.TRAIN.DEVICE_PREP and solver.use_prefetch == prefetch
    st = solver.stats["train"]
    assert len(st["iter_ms_host"]) == 3 and len(st["upload_bytes"]) == 3
    # the uint8 staging blob: under the f32 3-channel canvas (here the
    # images are larger than the 64-px canvas: the saving is smaller)
    h, w = solver.eng.canvas_hw
    assert max(st["upload_bytes"]) < 3 * h * w * 3 * 4
    assert len(solver.stats["eval"]) == 3
    for e in solver.stats["eval"]:
        assert np.isfinite(e["test_loss"]).all() and e["images"] == 4

    _resume_copy(a, b)
    resumed = train.main(_argv(data_dir, b, "--unfreeze_stem", "--resume",
                               *extra, **kw))
    assert resumed.start_iter == 2
    ha, hb, _ = _assert_same_snapshot(os.path.join(a, SNAP.format(3)),
                                      os.path.join(b, SNAP.format(3)),
                                      ("opt_state",), n_evals=3)
    _next_batches(solver, ha, hb, joint=True)


def test_train_alter_two_optimizer_states(data_dir, runs):
    a, b = str(runs / "a"), str(runs / "b")
    alter = ["--s_end_iter", "2", "--ws_start_iter", "1"]
    solver = train_alter.main(_argv(data_dir, a, *alter))
    assert solver.ws_step == 3
    snap = os.path.join(a, SNAP.format(4))
    _, _, opt, opt_ws = load_checkpoint(snap, opt_state=True,
                                        opt_state_ws=True)
    assert opt["count"] == 3 and opt_ws["count"] == 3
    assert load_host_state(snap)["ws_step"] == 3
    # conv1/conv2 frozen (no --unfreeze_stem): not in either state
    assert not any(".conv1_" in k for k in opt["mu"])
    # the two moment sets differ: each optimizer saw its own gradients
    assert any(not torch.equal(opt["mu"][k], opt_ws["mu"][k])
               for k in opt["mu"])

    _resume_copy(a, b)
    resumed = train_alter.main(_argv(data_dir, b, "--resume", *alter))
    assert resumed.ws_step == 3
    ha, hb, _ = _assert_same_snapshot(snap, os.path.join(b, SNAP.format(4)),
                                      ("opt_state", "opt_state_ws"),
                                      n_evals=2)
    _next_batches(solver, ha, hb, joint=False)


def test_cli_raises_without_a_card(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(data_dir, str(tmp_path / "x"))
    argv = [a for a in argv if a not in ("--device", "cpu")]
    for main in (train.main, train_alter.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
    with pytest.raises(NotImplementedError, match="A10"):
        train.main(["--mesh_data", "2"] + argv)


def test_step_clock_keeps_a_bounded_window():
    from wssdl_bus_tpu_torch.train.solver import _WINDOW, _StepClock

    clock = _StepClock(torch.device("cpu"))
    n = _WINDOW + 50
    for i in range(n):
        clock.add("feed_ms_host", float(i))
        with clock.step():
            pass
        clock.end_iter(2.0 * i)
    st = clock.summary()
    assert st["iter_ms_host"] == [2.0 * i for i in range(n - _WINDOW, n)]
    assert st["count"]["iter_ms_host"] == st["count"]["feed_ms_host"] == n
    assert st["count"]["iter_ms_cuda"] == 0 and st["iter_ms_cuda"] == []
    assert st["mean"]["iter_ms_host"] == 2.0 * (n - 1) / 2
    assert st["mean"]["feed_ms_host"] == (n - 1) / 2


def test_metric_logger_warns_on_a_remote_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="not a local path"):
        logger = MetricLogger("gs://bucket/run")
    assert logger._tb is None


# ---------------------------------------------------------------------- #
R = 8     # TRAIN.BATCH_SIZE of CFGS


def _fake_eval_outputs(blobs, num_classes=3):
    """Deterministic eval-step outputs for a batch (a function of its
    im_info only): ROIs inside each image, softmax scores, small deltas,
    a few unfilled slots, per-image losses."""
    info = np.asarray(blobs["im_info"])
    b = len(info)
    rng = np.random.RandomState(int(info[:, :3].sum() * 1000) % (2 ** 31))
    rois = np.zeros((b * R, 5), np.float32)
    for i in range(b):
        h, w = info[i, :2]
        x1 = rng.uniform(0, w * 0.6, R)
        y1 = rng.uniform(0, h * 0.6, R)
        rois[i * R:(i + 1) * R] = np.stack(
            [np.full(R, i), x1, y1, x1 + rng.uniform(8, w * 0.4, R),
             y1 + rng.uniform(8, h * 0.4, R)], 1)
    logits = rng.standard_normal((b * R, num_classes)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    bbox = (rng.standard_normal((b * R, 4 * num_classes)) * 0.1).astype(
        np.float32)
    labels = rng.randint(-1, num_classes, b * R).astype(np.int32)
    losses = [rng.uniform(0.1, 2.0, b).astype(np.float32) for _ in range(6)]
    return losses, rois, prob.astype(np.float32), bbox, labels


class _PortEng:
    def __init__(self, canvas):
        self.canvas_hw = canvas

    def eval_step(self, blobs, step=0, draws=None):
        ls, *rest = _fake_eval_outputs(blobs)
        return ([torch.from_numpy(x) for x in ls],
                *(torch.from_numpy(x) for x in rest))


class _JaxEng:
    def __init__(self, canvas):
        self.canvas_hw = canvas

    def eval_step(self, variables, batch, key, step=0):
        ls, *rest = _fake_eval_outputs(
            {k: np.asarray(v) for k, v in batch.items()})
        return ([jnp.asarray(x) for x in ls], *(jnp.asarray(x) for x in rest))


def _bare_solver(cls, cfg, imdb, roidb, canvas, out, eng, **extra):
    """A Solver with only what ``periodic_eval`` reads (no model)."""
    s = cls.__new__(cls)
    s.cfg, s.imdb_test, s.roidb_test = cfg, imdb, roidb
    s.output_dir, s.eval_batch, s.net_name = out, 3, "VGGnet_train"
    s.eng, s.vis, s.max_iters = eng, False, 10
    s.eval_rng = np.random.RandomState(5)
    s.logger = MetricLogger(out, tensorboard=False)
    for k, v in extra.items():
        setattr(s, k, v)
    return s


def test_periodic_eval_host_half_matches_jax(data_dir, tmp_path):
    from wssdl_bus_tpu.utils import MetricLogger as JaxLogger

    cfg = Config().with_overrides(CFGS)
    jcfg = JaxConfig().with_overrides(CFGS)
    imdb = dataset.get_imdb("bus_test", data_dir)
    jimdb = jax_dataset.get_imdb("bus_test", data_dir)
    roidb, jroidb = dataset.prepare_roidb(imdb), \
        jax_dataset.prepare_roidb(jimdb)
    canvas = (96, 128)
    port = _bare_solver(Solver, cfg, imdb, roidb, canvas,
                        str(tmp_path / "port"), _PortEng(canvas), stats={},
                        schedule=build_schedule("rop", 1e-3, 10))
    jax_s = _bare_solver(JaxSolver, jcfg, jimdb, jroidb, canvas,
                         str(tmp_path / "jax"), _JaxEng(canvas),
                         variables=None, key=jax.random.PRNGKey(0),
                         schedule=jax_schedule("rop", 1e-3, 10))
    jax_s.logger = JaxLogger(jax_s.output_dir, tensorboard=False)
    logs_p, logs_j = [], []
    for it in (1, 3):
        tl = np.arange(6, dtype=np.float64)
        got = port.periodic_eval(it, 1e-3, tl.copy(), logs_p)
        want = jax_s.periodic_eval(it, 1e-3, tl.copy(), logs_j)
        np.testing.assert_array_equal(got, want)
        with open(os.path.join(port.output_dir, "test",
                               "detections.pkl"), "rb") as f:
            pb = pickle.load(f)
        with open(os.path.join(jax_s.output_dir, "test",
                               "detections.pkl"), "rb") as f:
            jb = pickle.load(f)
        n_dets = 0
        for j in range(1, 3):
            for i in range(len(roidb)):
                got, want = np.asarray(pb[j][i]), np.asarray(jb[j][i])
                assert got.shape == want.shape, (j, i)
                np.testing.assert_array_equal(got[:, 4], want[:, 4])
                np.testing.assert_allclose(got[:, :4], want[:, :4],
                                           rtol=1e-6, atol=0)
                n_dets += len(got)
        assert n_dets > 0
        with open(os.path.join(port.output_dir, "test", "eval.txt")) as f:
            pe = f.read()
        with open(os.path.join(jax_s.output_dir, "test", "eval.txt")) as f:
            je = f.read()
        assert pe == je and "CorLoc =" in pe
    assert logs_p == logs_j
    assert port.schedule.state_dict() == jax_s.schedule.state_dict()


@pytest.mark.parametrize("opt_name", ["adam", "amsgrad", "sgd"])
def test_opt_state_from_jax(opt_name):
    rng = np.random.RandomState(4)
    params = {"trunk": {"backbone": {
        "conv1_1": {"conv": {"kernel": rng.randn(3, 3, 2, 4),
                             "bias": rng.randn(4)}},
        "conv5_3": {"conv": {"kernel": rng.randn(3, 3, 4, 5),
                             "bias": rng.randn(5)}}}},
        "head": {"fc7": {"dense": {"kernel": rng.randn(6, 7),
                                   "bias": rng.randn(7)}}}}
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    tx = jax_make_optimizer(opt_name, JaxConfig(), vgg_frozen_mask(params))
    state = tx.init(params)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rng.randn(*x.shape) * 0.3, jnp.float32), params) for _ in range(4)]
    for g, lr in zip(grads[:3], (5e-4, 1e-3, 2e-4)):
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        upd, state = tx.update(g, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)

    named = params_from_jax({p: {"params": jax.tree.map(np.asarray,
                                                        params[p])}
                             for p in ("trunk", "head")})
    trainable = {k: torch.nn.Parameter(v.clone()) for k, v in named.items()
                 if ".conv1_" not in k}
    opt = Optimizer(opt_name, list(trainable.items()), momentum=0.9)
    converted = opt_state_from_jax(jax.tree.map(np.asarray, state))
    assert converted["name"] == opt_name and converted["count"] == 3
    opt.load_state_dict(converted)
    assert opt.count == 3 and opt.state_dict()["mu"].keys() == \
        trainable.keys()

    state.hyperparams["learning_rate"] = jnp.float32(5e-4)
    upd, state = tx.update(grads[3], state, params)
    params = jax.tree.map(lambda p, u: p + u, params, upd)
    g_named = params_from_jax({p: {"params": jax.tree.map(np.asarray,
                                                          grads[3][p])}
                               for p in ("trunk", "head")})
    for k, p in trainable.items():
        p.grad = g_named[k]
    opt.step(5e-4)
    want = params_from_jax({p: {"params": jax.tree.map(np.asarray,
                                                       params[p])}
                            for p in ("trunk", "head")})
    after = opt_state_from_jax(jax.tree.map(np.asarray, state))
    for k, p in trainable.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(opt.state_dict()["mu"][k].numpy(),
                                   after["mu"][k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert not np.array_equal(want["head.fc7.dense.weight"].numpy(),
                              named["head.fc7.dense.weight"].numpy())
