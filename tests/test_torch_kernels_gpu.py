"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the served and trained paths' shapes and at awkward ones.  Marked
``gpu``: they skip without a CUDA device.

The card's machine has no JAX, which ``tests/conftest.py`` imports, so this
file imports none and runs there without the conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from wssdl_bus_tpu_torch.ops.conv1 import vgg_stem_plain
from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
from wssdl_bus_tpu_torch.ops.conv2_pool import vgg_conv2_pool_plain
from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool
from wssdl_bus_tpu_torch.ops.int8_conv import int8_conv_plain, pack_weight
from wssdl_bus_tpu_torch.ops.int8_conv_cuda import int8_conv
from wssdl_bus_tpu_torch.ops.nms import nms_mask
from wssdl_bus_tpu_torch.ops.nms_cuda import nms_keep
from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool_grad, roi_pool_grad_bf16
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (forward_plan, roi_pool_fc,
                                                   roi_pool_fc_backward,
                                                   roi_pool_fc_backward_bf16,
                                                   roi_pool_fc_bf16,
                                                   roi_pool_fc_plain,
                                                   roi_pool_grouped,
                                                   roi_pool_grouped_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sorted_boxes(rng, b, n, scale=800.0):
    xy = rng.uniform(0, scale, (b, n, 2))
    wh = rng.uniform(5, scale / 3, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return np.ascontiguousarray(boxes.transpose(0, 2, 1))   # [B, 4, N]


@pytest.mark.parametrize("b,n,invalid", [
    (8, 6000, 0.1),     # the served path: 8 images at the TEST budget
    (3, 12000, 0.05),   # the TRAIN budget
    (2, 1111, 0.3),     # N not a multiple of 64
    (1, 1, 0.0),
    (2, 130, 1.0),      # every box invalid
    (2, 63, 0.1),       # one tile, one short of full
    (2, 64, 0.1),       # one full tile: no row words
    (2, 65, 0.1),       # a second tile of one box
    (1, 4097, 0.1),
    (1, 20000, 0.05),   # tile rows wider than one stage: several chunks
])
def test_nms_kernel_matches_plain(cuda, b, n, invalid):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(_sorted_boxes(rng, b, n)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) >= invalid).to(cuda)
    before = nms_keep.launches
    got = nms_keep(boxes, valid, 0.7)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    want = nms_mask(boxes, valid, 0.7)
    assert torch.equal(got, want)
    assert not (got & ~valid).any()


def test_nms_kernel_threshold_is_inclusive(cuda):
    boxes = torch.tensor([[[0, 0, 9, 9], [0, 0, 9, 6], [0, 0, 9, 5]]],
                         dtype=torch.float32).transpose(1, 2).contiguous()
    valid = torch.ones(1, 3, dtype=torch.bool)
    got = nms_keep(boxes.to(cuda), valid.to(cuda), 0.7).cpu()
    assert got.tolist() == [[True, False, True]]   # IoU 0.7 and 0.6


def _chain(kind, n):
    """Boxes in which each suppresses only the next at 0.7: nested boxes
    sharing a corner (side + 1 shrinking by 0.86, IoU 0.74 with the next,
    0.55 with the one after), or 11 x 11 boxes sliding 1.5 px (IoU 0.76 and
    0.57).  Kept and removed alternate down the whole chain."""
    z = np.zeros(n)
    if kind == "nested":
        side = 1e5 * 0.86 ** np.arange(n) - 1
        boxes = np.stack([z, z, side, side])
    else:
        x = np.arange(n) * 1.5
        boxes = np.stack([x, z, x + 10, z + 10])
    return torch.from_numpy(boxes.astype(np.float32)[None].copy())


@pytest.mark.parametrize("kind,n", [("nested", 64), ("sliding", 200),
                                    ("sliding", 5000)])
def test_nms_kernel_deep_suppression_chains(cuda, kind, n):
    """A chain as deep as the tile (nested) and across 4 and 79 tiles
    (sliding): the settle's fixpoint and the walk's order."""
    boxes = _chain(kind, n).to(cuda)
    valid = torch.ones(1, n, dtype=torch.bool, device=cuda)
    got = nms_keep(boxes, valid, 0.7)
    assert torch.equal(got, nms_mask(boxes, valid, 0.7))
    assert got[0].cpu().tolist() == [k % 2 == 0 for k in range(n)]


def test_nms_kernel_identical_boxes_keep_one(cuda):
    boxes = torch.tensor([10.0, 20.0, 90.0, 80.0]).reshape(1, 4, 1) \
        .expand(2, 4, 300).contiguous().to(cuda)
    valid = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    valid[1, 0] = False                  # then the second box is the one
    got = nms_keep(boxes, valid, 0.7).cpu()
    assert got.sum(dim=1).tolist() == [1, 1]
    assert got[0, 0] and got[1, 1]


@pytest.mark.parametrize("thresh", [0.0, 1.0])
def test_nms_kernel_threshold_edges(cuda, thresh):
    """0.0 takes the full division for every pair (disjoint ones suppress:
    IoU 0 >= 0); 1.0 suppresses identical boxes only, by the inclusive
    compare."""
    rng = np.random.RandomState(9)
    boxes = torch.from_numpy(_sorted_boxes(rng, 2, 700))
    boxes[:, :, 300:320] = boxes[:, :, 5:6]          # copies of box 5
    boxes = boxes.contiguous().to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(2, 700)) >= 0.1).to(cuda)
    valid[:, 5] = True
    got = nms_keep(boxes, valid, thresh)
    assert torch.equal(got, nms_mask(boxes, valid, thresh))
    if thresh == 0.0:
        assert got.sum(dim=1).tolist() == [1, 1]
    else:
        assert not got[:, 300:320].any()


def _rois(rng, b, p, h, w):
    x1 = rng.uniform(-20, w * 16, (b, p))
    y1 = rng.uniform(-20, h * 16, (b, p))
    x2 = x1 + rng.uniform(0, 500, (b, p))
    y2 = y1 + rng.uniform(0, 500, (b, p))
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _path(b, p, h, w, c):
    """The forward path the wrapper picks for these shapes."""
    return "smem" if forward_plan(b, h, w, c, p)[0] else "direct"


def _launch_counted(wrapper, path, fn):
    """fn()'s result, checking that it launched ``wrapper``'s kernel once,
    on ``path``."""
    before, paths = wrapper.launches, dict(wrapper.paths)
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    paths[path] += 1
    assert wrapper.paths == paths
    return out


@pytest.mark.parametrize("b,p,h,w,c", [
    (8, 300, 38, 51, 512),   # the served path at the 608x816 canvas
    (1, 1, 38, 51, 512),     # P = 1
    (2, 37, 7, 9, 12),       # small map, C not a multiple of 32
    (1, 128, 38, 56, 512),   # the training groups: supervised
    (2, 2000, 38, 56, 512),  # and weak
    (8, 128, 38, 56, 512),   # the in-training eval step: 8 images x 128
    (2, 300, 38, 51, 20),    # C % 16 != 0: a 4-channel tail slice
    (1, 300, 38, 51, 516),
    (8, 300, 63, 63, 512),   # 8-channel slices
    (1, 40, 5, 300, 8),      # wider than one TMA box
    (1, 40, 300, 5, 8),      # taller than one TMA box
    (1, 50, 128, 128, 8),    # the direct path
])
@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_roi_pool_kernel_matches_plain(cuda, b, p, h, w, c, flavor):
    rng = np.random.RandomState(p)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(cuda)
    rois = torch.from_numpy(_rois(rng, b, p, h, w)).to(cuda)
    got = _launch_counted(roi_pool_fc, _path(b, p, h, w, c),
                          lambda: roi_pool_fc(feat, rois, flavor=flavor))
    want = roi_pool_fc_plain(feat, rois, flavor=flavor)
    assert torch.equal(got, want)
    grouped = roi_pool_grouped(feat, rois, flavor=flavor)
    assert grouped.shape == (b, p, 7, 7, c)
    assert torch.equal(grouped.reshape(got.shape), want)


@pytest.mark.parametrize("h,w,c", [(38, 51, 512), (38, 51, 20),
                                   (128, 128, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_roi_pool_kernel_propagates_nan(cuda, h, w, c, dtype):
    """NaNs in the map (a diverged step): every bin whose window holds one
    is NaN, as in the plain version, on both paths; the rest is equal."""
    rng = np.random.RandomState(c)
    feat = rng.randn(2, h, w, c).astype(np.float32)
    ys, xs = rng.randint(0, h, 30), rng.randint(0, w, 30)
    feat[rng.randint(0, 2, 30), ys, xs, rng.randint(0, c, 30)] = np.nan
    feat = torch.from_numpy(feat).to(cuda)
    rois = torch.from_numpy(_rois(rng, 2, 200, h, w)).to(cuda)
    wrapper = roi_pool_fc_bf16 if dtype == torch.bfloat16 else roi_pool_fc
    got = _launch_counted(wrapper, _path(2, 200, h, w, c),
                          lambda: roi_pool_fc(feat, rois, out_dtype=dtype))
    want = roi_pool_fc_plain(feat, rois, out_dtype=dtype)
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])


def _cotangent(rng, b, p, d, pattern):
    g = rng.randn(b, p, d).astype(np.float32)
    if pattern == "mil":      # one active row per bag, as MIL leaves it
        keep = np.zeros((b, p), bool)
        keep[np.arange(b), rng.randint(0, p, b)] = True
        g[~keep] = 0.0
    elif pattern == "half":
        g[:, ::2] = 0.0
    return g


@pytest.mark.parametrize("b,p,h,w,c,pattern", [
    (1, 128, 38, 51, 512, "dense"),   # the supervised group of a train step
    (2, 2000, 38, 51, 512, "mil"),    # the weak group: 1 of 2000 rows active
    (1, 300, 20, 23, 8, "half"),
    (2, 37, 7, 9, 12, "dense"),       # small map, C not a multiple of 32
])
@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_roi_pool_backward_kernel_matches_plain(cuda, b, p, h, w, c, pattern,
                                                flavor):
    """Identical dfeat, bit for bit: the kernel adds in the plain
    version's order.  The map is post-ReLU, so zero ties abound."""
    rng = np.random.RandomState(p + c)
    feat = np.maximum(rng.randn(b, h, w, c), 0).astype(np.float32)
    feat = torch.from_numpy(feat).to(cuda)
    rois = torch.from_numpy(_rois(rng, b, p, h, w)).to(cuda)
    g = torch.from_numpy(_cotangent(rng, b, p, 49 * c, pattern)).to(cuda)
    before = roi_pool_fc_backward.launches
    got = roi_pool_fc_backward(feat, rois, g, flavor=flavor)
    torch.cuda.synchronize()
    assert roi_pool_fc_backward.launches == before + 1
    want = roi_pool_grad(feat, rois, g, flavor=flavor)
    assert torch.equal(got != 0, want != 0)
    assert torch.equal(got, want)
    assert (got != 0).any()


def test_roi_pool_backward_kernel_tie_goes_to_one_cell(cuda):
    """A constant bin: its whole cotangent lands on one cell."""
    feat = torch.full((1, 16, 16, 4), 3.0, device=cuda)
    rois = torch.tensor([[[0.0, 0.0, 16 * 7 - 1, 16 * 7 - 1]]], device=cuda)
    g = torch.ones(1, 1, 49 * 4, device=cuda)
    got = roi_pool_fc_backward(feat, rois, g)
    assert torch.equal(got, roi_pool_grad(feat, rois, g))
    assert float(got.sum()) == 49 * 4
    assert set(got.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}


def _backward_case(case, rng, h=38, w=56, c=512):
    """(feat, rois [1, P, 4], g) for the awkward backward cases."""
    feat = np.maximum(rng.randn(1, h, w, c), 0).astype(np.float32)
    if case == "identical":       # every cell's chain is 128 adds long
        rois = np.repeat(_rois(rng, 1, 1, h, w), 128, axis=1)
    elif case == "whole_map":
        rois = np.tile(np.array([0, 0, w * 16 - 1, h * 16 - 1], np.float32),
                       (1, 6, 1))
    elif case == "outside":       # bins past the map's edge are empty
        rois = np.array([[[-300, -200, 100, 90], [w * 16 - 60, -40,
                          w * 16 + 400, 200], [-50, h * 16 - 70, 120,
                          h * 16 + 300], [w * 8, h * 8, w * 40, h * 40]]],
                        np.float32)
    else:                         # ties: a map of three values
        feat = (1.0 + rng.randint(0, 3, (1, h, w, c)) / 4096.0) \
            .astype(np.float32)
        rois = _rois(rng, 1, 40, h, w)
    g = rng.randn(1, rois.shape[1], 49 * c).astype(np.float32)
    return feat, rois, g


@pytest.mark.parametrize("case", ["identical", "whole_map", "outside",
                                  "ties"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_roi_pool_backward_kernel_awkward_cases(cuda, case, bf16, flavor):
    """Both instances equal their plain versions bit for bit where the
    gather's order and the argmax table are hardest."""
    rng = np.random.RandomState(len(case))
    feat, rois, g = (torch.from_numpy(a).to(cuda)
                     for a in _backward_case(case, rng))
    kernel = roi_pool_fc_backward_bf16 if bf16 else roi_pool_fc_backward
    plain = roi_pool_grad_bf16 if bf16 else roi_pool_grad
    if bf16:
        g = g.to(torch.bfloat16)
    got = kernel(feat, rois, g, flavor=flavor)
    want = plain(feat, rois, g, flavor=flavor)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("b,p,h,w,c,pattern", [
    (8, 300, 38, 51, 256, None),     # ResNet-18/34 served
    (1, 128, 38, 56, 256, "dense"),  # ... training: the supervised group
    (2, 2000, 38, 56, 256, "mil"),   # ... and the weak group
    (8, 300, 38, 51, 1024, None),    # ResNet-50/101 served
    (1, 128, 38, 56, 1024, "dense"),  # four 256-channel backward blocks
    (2, 2000, 38, 56, 1024, "mil"),
])
def test_roi_pool_grouped_matches_plain(cuda, b, p, h, w, c, pattern):
    """The ResNet head's pool (#3 and its backward #4) at the ResNet widths
    under autograd: the forward counts on ``roi_pool_grouped`` (not on
    ``roi_pool_fc``), values equal the plain version's; the backward
    launches once and dfeat equals the plain autograd's bit for bit, on a
    post-ReLU map full of zero ties.  ``pattern`` None: forward only (the
    served path)."""
    rng = np.random.RandomState(p + c)
    feat = np.maximum(rng.randn(b, h, w, c), 0).astype(np.float32)
    rois = torch.from_numpy(_rois(rng, b, p, h, w)).to(cuda)
    fk = torch.from_numpy(feat).to(cuda).requires_grad_(pattern is not None)
    fp = torch.from_numpy(feat).to(cuda).requires_grad_(pattern is not None)
    fc = roi_pool_fc.launches
    bwd = roi_pool_fc_backward.launches
    got = _launch_counted(roi_pool_grouped, _path(b, p, h, w, c),
                          lambda: roi_pool_grouped(fk, rois))
    want = roi_pool_grouped_plain(fp, rois)
    assert got.shape == (b, p, 7, 7, c) and torch.equal(got, want)
    assert roi_pool_fc.launches == fc
    if pattern is None:
        return
    g = torch.from_numpy(_cotangent(rng, b, p, 49 * c, pattern)).to(cuda)
    got.backward(g.view_as(got))
    want.backward(g.view_as(want))
    torch.cuda.synchronize()
    assert roi_pool_fc_backward.launches == bwd + 1
    assert torch.equal(fk.grad, fp.grad) and (fk.grad != 0).any()


def test_roi_pool_fc_autograd_on_the_card(cuda):
    """roi_pool_fc's backward launches the kernel, keeps only (feat, rois)
    for it, and agrees with the plain autograd path."""
    rng = np.random.RandomState(0)
    feat = torch.from_numpy(rng.randn(2, 12, 15, 16).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 2, 40, 12, 15)).to(cuda)
    g = torch.from_numpy(rng.randn(2, 40, 49 * 16).astype(np.float32))
    fk = feat.to(cuda).requires_grad_(True)
    fp = feat.to(cuda).requires_grad_(True)
    fwd, bwd = roi_pool_fc.launches, roi_pool_fc_backward.launches
    out = roi_pool_fc(fk, rois)
    saved = out.grad_fn.saved_tensors
    assert [t.shape for t in saved] == [fk.shape, rois.shape]
    out.backward(g.to(cuda))
    roi_pool_fc_plain(fp, rois).backward(g.to(cuda))
    torch.cuda.synchronize()
    assert (roi_pool_fc.launches, roi_pool_fc_backward.launches) == \
        (fwd + 1, bwd + 1)
    assert torch.equal(fk.grad, fp.grad)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    feat = torch.zeros(1, 4, 4, 6, device=cuda)
    rois = torch.zeros(1, 2, 4, device=cuda)
    with pytest.raises(ValueError, match="C % 4"):
        roi_pool_fc(feat, rois)
    with pytest.raises(ValueError, match="CUDA"):
        roi_pool_fc(feat[..., :4].contiguous(), rois.cpu())
    with pytest.raises(TypeError):
        roi_pool_fc(feat[..., :4].double().contiguous(), rois.double())
    with pytest.raises(ValueError, match="grad"):
        roi_pool_fc_backward(feat[..., :4].contiguous(), rois,
                             torch.zeros(1, 2, 49 * 8, device=cuda))
    boxes = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        nms_keep(boxes, torch.ones(1, 8, device=cuda), 0.7)


@pytest.mark.parametrize("b,p,h,w,c", [
    (8, 300, 38, 51, 512),   # the served path's shapes
    (2, 37, 7, 9, 12),
    (1, 128, 38, 56, 512),   # the training groups
    (2, 2000, 38, 56, 512),
    (2, 300, 38, 51, 20),    # a 4-channel tail slice
    (8, 300, 63, 63, 512),   # 8-channel slices
    (1, 40, 5, 300, 8),      # several TMA boxes
    (1, 50, 128, 128, 8),    # the direct path
])
def test_roi_pool_bf16_forward_matches_plain(cuda, b, p, h, w, c):
    rng = np.random.RandomState(p)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(cuda)
    rois = torch.from_numpy(_rois(rng, b, p, h, w)).to(cuda)
    got = _launch_counted(
        roi_pool_fc_bf16, _path(b, p, h, w, c),
        lambda: roi_pool_fc(feat, rois, out_dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = roi_pool_fc_plain(feat, rois, out_dtype=torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(got, roi_pool_fc(feat, rois).to(torch.bfloat16))


@pytest.mark.parametrize("b,p,h,w,c,pattern", [
    (1, 128, 38, 56, 512, "dense"),   # the supervised group of a train step
    (2, 2000, 38, 56, 512, "mil"),    # the weak group
    (2, 37, 7, 9, 12, "dense"),
])
def test_roi_pool_bf16_backward_matches_plain(cuda, b, p, h, w, c, pattern):
    """Identical dfeat with routing on bf16(feat): a post-ReLU map whose
    values, rounded to bf16, tie often."""
    rng = np.random.RandomState(p + c)
    feat = np.maximum(rng.randn(b, h, w, c), 0).astype(np.float32)
    feat = torch.from_numpy(feat).to(cuda)
    rois = torch.from_numpy(_rois(rng, b, p, h, w)).to(cuda)
    g = torch.from_numpy(_cotangent(rng, b, p, 49 * c, pattern)).to(cuda) \
        .to(torch.bfloat16)
    before = roi_pool_fc_backward_bf16.launches
    got = roi_pool_fc_backward_bf16(feat, rois, g)
    torch.cuda.synchronize()
    assert roi_pool_fc_backward_bf16.launches == before + 1
    want = roi_pool_grad_bf16(feat, rois, g)
    assert got.dtype == torch.float32
    assert torch.equal(got != 0, want != 0)
    assert torch.equal(got, want)


def test_roi_pool_bf16_autograd_on_the_card(cuda):
    rng = np.random.RandomState(1)
    feat = torch.from_numpy(rng.randn(2, 12, 15, 16).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 2, 40, 12, 15)).to(cuda)
    g = torch.from_numpy(rng.randn(2, 40, 49 * 16).astype(np.float32)) \
        .to(cuda).to(torch.bfloat16)
    fk = feat.to(cuda).requires_grad_(True)
    fp = feat.to(cuda).requires_grad_(True)
    counts = (roi_pool_fc_bf16.launches, roi_pool_fc_backward_bf16.launches,
              roi_pool_fc_backward.launches)
    out = roi_pool_fc(fk, rois, out_dtype=torch.bfloat16)
    out.backward(g)
    roi_pool_fc_plain(fp, rois, out_dtype=torch.bfloat16).backward(g)
    torch.cuda.synchronize()
    assert (roi_pool_fc_bf16.launches, roi_pool_fc_backward_bf16.launches,
            roi_pool_fc_backward.launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2])
    assert fk.grad.dtype == torch.float32
    assert torch.equal(fk.grad, fp.grad)


def _stem_weights(rng, cuda):
    w1 = rng.randn(3, 3, 3, 64) * np.sqrt(2 / 27) / 64
    w2 = rng.randn(3, 3, 64, 64) * np.sqrt(2 / 576)
    return [torch.from_numpy(a.astype(np.float32)).to(cuda)
            for a in (w1, rng.randn(64) * 0.1, w2, rng.randn(64) * 0.1)]


def _dyadic(rng, *shape, top=1.0):
    """Multiples of 1/8 in [-top, top]."""
    k = int(8 * top)
    return (rng.randint(-k, k + 1, shape) / 8.0).astype(np.float32)


def _dyadic_stem_weights(rng, cuda):
    return [torch.from_numpy(a).to(cuda) for a in (
        _dyadic(rng, 3, 3, 3, 64), _dyadic(rng, 64),
        _dyadic(rng, 3, 3, 64, 64, top=0.5), _dyadic(rng, 64))]


# The kernels sum conv1_2's exact bf16 products on the tensor cores in
# wgmma's order, the plain versions in a fixed (dy, dx, c) order: on random
# data they agree to f32 reassociation, every element within REL_TOL of the
# output's largest magnitude.  On a dyadic grid every partial sum is exact,
# so any order gives the same bits.
REL_TOL = 1e-5
STEM_SHAPES = [
    (8, 608, 816, 3),    # the served batch
    (3, 608, 896, 3),    # the training batch
    (1, 16, 16, 3),
    (2, 48, 20, 3),      # W not a multiple of the 16-wide tile
]
TAIL_SHAPES = [
    (8, 608, 816, 64),
    (3, 608, 896, 64),
    (1, 16, 32, 64),
    (2, 48, 80, 64),
    (2, 24, 48, 64),     # H not a multiple of the 16-high tile
]


def _within_tol(got, want):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= REL_TOL * float(want.abs().max()), err


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_matches_plain(cuda, shape):
    """Within f32 reassociation of the same exact bf16 products."""
    rng = np.random.RandomState(shape[2])
    x = torch.from_numpy((rng.randn(*shape) * 50).astype(np.float32)).to(cuda)
    w1, b1, w2, b2 = _stem_weights(rng, cuda)
    before = vgg_stem_fused.launches
    got = vgg_stem_fused(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert vgg_stem_fused.launches == before + 1
    want = vgg_stem_plain(x, w1, b1, w2, b2)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    _within_tol(got, want)
    assert (got > 0).float().mean() > 0.2


@pytest.mark.parametrize("shape", TAIL_SHAPES[:4])
def test_stem_tail_kernel_matches_plain(cuda, shape):
    rng = np.random.RandomState(shape[2])
    a1 = torch.from_numpy(np.abs(rng.randn(*shape)).astype(np.float32)) \
        .to(cuda).to(torch.bfloat16)
    _, _, w2, b2 = _stem_weights(rng, cuda)
    before = vgg_conv2_pool.launches
    got = vgg_conv2_pool(a1, w2, b2)
    torch.cuda.synchronize()
    assert vgg_conv2_pool.launches == before + 1
    want = vgg_conv2_pool_plain(a1, w2, b2)
    _within_tol(got, want)
    assert (got > 0).float().mean() > 0.2


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_bit_for_bit_on_dyadic_grid(cuda, shape):
    """Integer x in [-4, 4], kernels and biases multiples of 1/8: exact
    partial sums, so tiling, halo, SAME zeros and pool are held exactly."""
    rng = np.random.RandomState(shape[2] + 1)
    x = torch.from_numpy(rng.randint(-4, 5, shape).astype(np.float32)) \
        .to(cuda)
    ws = _dyadic_stem_weights(rng, cuda)
    got = vgg_stem_fused(x, *ws)
    want = vgg_stem_plain(x, *ws)
    assert torch.equal(got, want)
    assert (want > 0).float().mean() > 0.3


@pytest.mark.parametrize("shape", TAIL_SHAPES)
def test_stem_tail_kernel_bit_for_bit_on_dyadic_grid(cuda, shape):
    """a1 multiples of 1/8 in [0, 4] (exact in bf16), dyadic conv1_2."""
    rng = np.random.RandomState(shape[2] + 1)
    a1 = torch.from_numpy(rng.randint(0, 33, shape) / 8.0).to(cuda) \
        .to(torch.bfloat16)
    _, _, w2, b2 = _dyadic_stem_weights(rng, cuda)
    got = vgg_conv2_pool(a1, w2, b2)
    want = vgg_conv2_pool_plain(a1, w2, b2)
    assert torch.equal(got, want)
    assert (want > 0).float().mean() > 0.3


def _loud_border(t, value):
    """``t`` [B, H, W, C] with its outermost rows and columns set to
    ``value``: a halo or out-of-bounds error moves outputs by a lot."""
    t = t.clone()
    t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = value, value, value, value
    return t


@pytest.mark.parametrize("shape", [(2, 48, 20, 3), (1, 32, 48, 3)])
def test_stem_kernel_with_a_loud_image_border(cuda, shape):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randint(-2, 3, shape).astype(np.float32))
    x = _loud_border(x, 16.0).to(cuda)
    ws = _dyadic_stem_weights(rng, cuda)
    assert torch.equal(vgg_stem_fused(x, *ws), vgg_stem_plain(x, *ws))


@pytest.mark.parametrize("shape", [(2, 48, 80, 64), (2, 24, 48, 64)])
def test_stem_tail_kernel_with_a_loud_image_border(cuda, shape):
    rng = np.random.RandomState(7)
    a1 = torch.from_numpy(rng.randint(0, 17, shape) / 8.0)
    a1 = _loud_border(a1, 64.0).to(cuda).to(torch.bfloat16)
    _, _, w2, b2 = _dyadic_stem_weights(rng, cuda)
    got = vgg_conv2_pool(a1, w2, b2)
    assert torch.equal(got, vgg_conv2_pool_plain(a1, w2, b2))
    assert float(got.abs().max()) > 64.0


def test_stem_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 16, 16, 3, device=cuda)
    w1 = torch.zeros(3, 3, 3, 64, device=cuda)
    b = torch.zeros(64, device=cuda)
    w2 = torch.zeros(3, 3, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="chunking"):
        vgg_stem_fused(x[:, :8], w1, b, w2, b)
    with pytest.raises(TypeError):
        vgg_stem_fused(x.double(), w1, b, w2, b)
    with pytest.raises(TypeError):
        vgg_stem_fused(x, w1.cpu(), b, w2, b)
    with pytest.raises(ValueError):
        vgg_stem_fused(x, w1.permute(0, 1, 3, 2), b, w2, b)
    with pytest.raises(ValueError, match="chunking"):
        vgg_conv2_pool(torch.zeros(1, 16, 24, 64, device=cuda), w2, b)


def _same_with_nans(got, want):
    nan = want.isnan()
    return bool(torch.equal(got.isnan(), nan)) and bool(
        torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0)))


def _nan_case(case, rng, b, p, h, w, c):
    """(feat, rois, g) with the NaNs (or infinities) of one backward case;
    ROIs 0..3 of each image carry them, and the cotangent is MIL-sparse
    (ROI 0 of each image) for p >= 1000, dense otherwise."""
    feat = np.maximum(rng.randn(b, h, w, c), 0).astype(np.float32)
    rois = _rois(rng, b, p, h, w)
    rois[:, 1] = [-200, -120, 60, 40]          # bins off the map: empty
    g = rng.randn(b, p, 49 * c).astype(np.float32)
    if p >= 1000:
        g[:, 1:] = 0.0
    q = np.floor(rois * np.float32(1 / 16) + np.float32(0.5)).astype(int)
    for bi in range(b):
        for r in (0, 2, 3):
            x1, y1, x2, y2 = (int(v) for v in q[bi, r])
            x1, y1 = min(max(x1, 0), w - 1), min(max(y1, 0), h - 1)
            x2, y2 = min(max(x2, x1), w - 1), min(max(y2, y1), h - 1)
            ch = rng.randint(c)
            if case == "in_bins":
                feat[bi, (y1 + y2) // 2, (x1 + x2) // 2, ch] = np.nan
            elif case == "below_bins":
                feat[bi, min(y1 + max((y2 - y1) // 7, 1) + 1, h - 1), x1,
                     ch] = np.nan
            elif case == "outside_columns":
                x = x2 + 2 if x2 + 2 < w else x1 - 2
                if x >= 0:
                    feat[bi, y1, x, ch] = np.nan
            elif case == "infinities":
                feat[bi, y1:y2 + 1, x1, ch] = -np.inf
                feat[bi, y1, x2, (ch + 1) % c] = np.inf
                feat[bi, y2, x1, (ch + 2) % c] = 3e30
            elif case == "g_some_rois":
                g[bi, r, rng.randint(49) * c + ch] = np.nan
                g[bi, 1, rng.randint(49) * c + ch] = np.inf
    if case == "g_all":
        g[:] = np.nan
    return feat, rois, g


@pytest.mark.parametrize("case", ["in_bins", "below_bins", "outside_columns",
                                  "infinities", "g_some_rois", "g_all"])
@pytest.mark.parametrize("shape", [(2, 9, 12, 15, 8), (1, 128, 38, 56, 512),
                                   (2, 2000, 38, 56, 512),
                                   # the ResNet widths: 1 and 4 blocks
                                   (1, 128, 38, 56, 256),
                                   (1, 128, 38, 56, 1024)])
@pytest.mark.parametrize("bf16", [False, True])
def test_roi_pool_backward_kernel_nan_routing(cuda, case, shape, bf16):
    """Both backward kernels route NaNs and infinities as their plain
    versions do, which follow the Pallas kernels: a NaN in a bin row's
    window (even outside the bin or the ROI) takes the bin; an f32 channel
    block with a NaN cotangent is skipped; the bf16 kernel lists it; an
    empty bin's non-finite cotangent lands over its row's window.  The
    same NaN positions, equal values elsewhere."""
    b, p, h, w, c = shape
    rng = np.random.RandomState(p + len(case))
    feat, rois, g = (torch.from_numpy(a).to(cuda)
                     for a in _nan_case(case, rng, b, p, h, w, c))
    kernel = roi_pool_fc_backward_bf16 if bf16 else roi_pool_fc_backward
    plain = roi_pool_grad_bf16 if bf16 else roi_pool_grad
    if bf16:
        g = g.to(torch.bfloat16)
    got = kernel(feat, rois, g)
    want = plain(feat, rois, g)
    torch.cuda.synchronize()
    assert _same_with_nans(got, want)
    if case == "g_all":
        assert want.isnan().any() == bf16


def test_native_host_library_loads(cuda):
    """The port's native host runtime builds with the machine's g++ and
    loads (the evaluation path's resize, rotation and per-class NMS)."""
    from wssdl_bus_tpu_torch import native

    assert native.available()
    dets = np.array([[0, 0, 10, 10, 0.9], [1, 1, 10, 10, 0.8]], np.float32)
    assert native.nms(dets, 0.5) == [0]


@pytest.mark.parametrize("k,stride,cin,cout,h,w", [
    (3, 1, 64, 64, 19, 23),     # VGG16 3x3 SAME, a ragged M tile
    (3, 1, 3, 64, 16, 20),      # conv1_1: Cin = 3, K = 27 (byte gather)
    (7, 2, 3, 64, 24, 32),      # conv0: pads 2 / 3
    (7, 2, 3, 64, 23, 31),      # conv0, odd sides: pads 3 / 3
    (3, 2, 64, 128, 12, 14),    # 3x3/2, pads 0 / 1
    (3, 2, 128, 256, 7, 7),     # the group3 head's 7x7 ROIs: pads 1 / 1
    (1, 1, 256, 1024, 9, 11),   # bottleneck 1x1, Cout % 128 == 0
    (1, 2, 64, 128, 10, 13),    # 1x1/2 shortcut
    (3, 1, 512, 512, 4, 4),     # K = 4608, the largest sums
])
@pytest.mark.parametrize("relu", [False, True])
def test_int8_conv_kernel_matches_plain(cuda, k, stride, cin, cout, h, w,
                                        relu):
    """Bit for bit: the int32 sum is exact and the epilogue rounds as the
    plain version does; +-127 extremes included."""
    rng = np.random.RandomState(k * 1000 + cin + stride)
    xq = torch.from_numpy(rng.randint(-127, 128, (3, h, w, cin))
                          .astype(np.int8))
    xq[0] = 127
    wt = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    wt[..., 0] = 127
    packed = pack_weight(torch.from_numpy(wt))
    scale = torch.from_numpy(rng.uniform(1e-6, 1e-3, cout)
                             .astype(np.float32))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    args = [t.to(cuda) for t in (xq, packed)] + [k, k] \
        + [t.to(cuda) for t in (scale, bias)] + [stride, relu]
    before = int8_conv.launches
    got = int8_conv(*args)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    want = int8_conv_plain(*args)
    assert got.shape == want.shape == (3, -(-h // stride), -(-w // stride),
                                       cout)
    assert torch.equal(got, want)
