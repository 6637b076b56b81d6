"""Numpy emulation of the ROI-pool forward's shared-memory schedule
(``csrc/roi_pool.cu``: ``fwd_tile``, ``roi_pool_fwd_smem_kernel``), held at
small sizes against the plain version and the JAX package.

A block (channel slice, ROI block, image) stages its slice with TMA boxes
into 128-byte aligned regions of shared memory (zeros past the map's
edge and past C), packs its ROIs' bin edges, and its threads take items
(ROI, bin, 4 channels), walk the bin's window in 2 x 2 steps (the
second row and column clamped to the window) and store it.  The emulation
follows the kernel's index algebra and checks that every output element is
written exactly once, that every read hits a staged cell of the block's
own slice (never a zero fill or a region's padding) inside the item's
window, that every window cell is read, and that the values equal the
plain ``roi_pool_fc_plain`` bit for bit (NaN positions included).  Also
the
size rule (``ops/roi_pool_cuda.py:forward_plan``) at the shapes the paths
give it, and the plain forward's NaN propagation against the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_pool_pallas import make_case
from wssdl_bus_tpu.ops.roi_pool_pallas import roi_pool_fc as jax_roi_pool_fc
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (BOX_MAX, SMEM_PER_BLOCK,
                                                   SMS, forward_plan,
                                                   roi_pool_fc_plain,
                                                   staged_tile_bytes)

F32 = np.float32
SCALE = 1.0 / 16.0
THREADS = 1024          # csrc/roi_pool.cu kFwdThreads


def fwd_tile(h, w, cs):
    """csrc/roi_pool.cu fwd_tile: (bh, bw, nby, nbx, cell, region)."""
    if w <= BOX_MAX:
        nbx, bw = 1, w
        nby = -(-h // BOX_MAX)
        bh = -(-h // nby)
    else:
        nby, bh = h, 1
        nbx = -(-w // BOX_MAX)
        bw = -(-w // nbx)
    cell = cs * 4
    return bh, bw, nby, nbx, cell, -(-bh * bw * cell // 128) * 128


def cell_offset(t, y, x):
    """Byte offset of cell (y, x): the kernel's cell_offset (its one-box
    form (y * w + x) * cell is the same when nby = nbx = 1)."""
    bh, bw, _, nbx, cell, region = t
    return ((y // bh) * nbx + x // bw) * region + ((y % bh) * bw + x % bw) * cell


def stage(feat_b, c0, t):
    """The block's TMA requests: shared memory as f32 words, and for each
    word the flat feat index it holds (-1: zero fill past the map or past
    C; -2: a region's padding, never written)."""
    h, w, c = feat_b.shape
    bh, bw, nby, nbx, cell, region = t
    cs = cell // 4
    words = nby * nbx * region // 4
    smem = np.full(words, np.nan, F32)
    src = np.full(words, -2, np.int64)
    yy, xx, ch = np.meshgrid(np.arange(bh), np.arange(bw), np.arange(cs),
                             indexing="ij")
    for ky in range(nby):
        for kx in range(nbx):
            gy, gx, gc = ky * bh + yy, kx * bw + xx, c0 + ch
            inside = (gy < h) & (gx < w) & (gc < c)
            dst = ((ky * nbx + kx) * region + (yy * bw + xx) * cell) // 4 + ch
            assert (src[dst] == -2).all(), "two requests write one word"
            flat = np.where(inside, (gy * w + gx) * c + gc, -1)
            src[dst] = flat
            smem[dst] = np.where(inside, feat_b.reshape(-1)[np.maximum(
                flat, 0)], F32(0))
    # the barrier's transaction count: every box's bytes, zeros included
    assert nby * nbx * bh * bw * cell <= nby * nbx * region
    return smem, src


def roi_edges(rois, h, w, flavor, ph=7, pw=7):
    """The block's packed bin edges, unpacked: [R, ph] / [R, pw] lo, hi."""
    q = np.floor(rois.astype(F32) * F32(SCALE) + F32(0.5)).astype(np.int64)
    rsw, rsh = q[:, 0], q[:, 1]
    rw = np.maximum(q[:, 2] - rsw + 1, 1)
    rh = np.maximum(q[:, 3] - rsh + 1, 1)

    def edges(start, size, pooled, limit):
        k = np.arange(pooled)[None]
        lo = (k * size[:, None]) // pooled + start[:, None]
        hi = ((k + 1) * size[:, None] + (pooled - 1 if flavor == "gpu"
                                         else 0)) // pooled + start[:, None]
        lo, hi = np.clip(lo, 0, limit), np.clip(hi, 0, limit)
        packed = lo | (hi << 16)             # what the kernel stores
        return packed & 0xFFFF, packed >> 16

    return edges(rsh, rh, ph, h), edges(rsw, rw, pw, w)


def fwd_schedule(feat, rois, flavor="gpu", out_dtype=torch.float32,
                 rblk=None):
    """The kernel's schedule on [B, H, W, C] / [B, P, 4] -> (out [B, P,
    49 * C] in out_dtype, the plan (cs, rblk))."""
    b_n, h, w, c = feat.shape
    p = rois.shape[1]
    cs, plan_rblk = forward_plan(b_n, h, w, c, p)
    assert cs > 0, "the direct path: no schedule to emulate"
    rblk = rblk or plan_rblk
    kvec = 4
    t = fwd_tile(h, w, cs)
    assert t[2] * t[3] * t[5] == staged_tile_bytes(h, w, cs)
    out = np.full(b_n * p * 49 * c, np.nan, F32)
    writes = np.zeros(out.shape, np.int64)
    for bi in range(b_n):
        for s in range(-(-c // cs)):
            c0 = s * cs
            smem, src = stage(feat[bi], c0, t)
            for r0 in range(0, p, rblk):
                nr = min(rblk, p - r0)
                (hlo, hhi), (wlo, whi) = roi_edges(rois[bi, r0:r0 + nr], h,
                                                   w, flavor)
                # thread t: channel vector t % kvs (idle past C), and
                # (ROI, bin) pairs t // kvs, t // kvs + THREADS // kvs, ...
                kvs = cs // kvec
                tid = np.arange(THREADS)
                tid = tid[c0 + (tid % kvs) * kvec < c]
                pairs = [np.arange(t // kvs, nr * 49, THREADS // kvs)
                         for t in tid]
                v = np.concatenate([np.full(len(q), t % kvs)
                                    for t, q in zip(tid, pairs)])
                kb = np.concatenate(pairs)
                it = kb
                k, bin_ = kb // 49, kb % 49
                i, j = bin_ // 7, bin_ % 7
                y0, y1 = hlo[k, i], hhi[k, i]
                x0, x1 = wlo[k, j], whi[k, j]
                empty = (y1 <= y0) | (x1 <= x0)
                lane = np.arange(kvec)
                chan = c0 + v[:, None] * kvec + lane
                seen = np.zeros((len(it), h, w), bool)
                m = np.full((len(it), kvec), -np.inf, F32)
                # the window in 2 x 2 steps, the second row and column
                # clamped to the window
                for dy in range(0, int((y1 - y0).max(initial=0)), 2):
                    for dx in range(0, int((x1 - x0).max(initial=0)), 2):
                        live = ~empty & (y0 + dy < y1) & (x0 + dx < x1)
                        ya, xa = y0 + dy, x0 + dx
                        yb = np.minimum(ya + 1, y1 - 1)
                        xb = np.minimum(xa + 1, x1 - 1)
                        for y, x in ((ya, xa), (ya, xb), (yb, xa), (yb, xb)):
                            word = (cell_offset(t, y, x) + v * kvec * 4) // 4
                            word = np.where(live[:, None], word[:, None]
                                            + lane, 0)
                            got = src[word]
                            ok = (got >= 0) & (got % c == chan) & (chan < c)
                            assert ok[live].all(), "a read outside the slice"
                            assert ((y[live] < y1[live])
                                    & (x[live] < x1[live])).all()
                            seen[live, y[live], x[live]] = True
                            m = np.where(live[:, None],
                                         np.maximum(m, smem[word]), m)
                m[empty] = 0.0
                # every cell of every window was read
                area = np.maximum(y1 - y0, 0) * np.maximum(x1 - x0, 0)
                assert np.array_equal(seen.sum((1, 2)), area)
                dst = ((((bi * p + r0 + k) * 49 + bin_) * c + c0 + v * kvec)
                       [:, None] + lane)
                np.add.at(writes, dst, 1)
                out[dst] = m
    assert (writes == 1).all(), "an output element written != once"
    out = torch.from_numpy(out.reshape(b_n, p, 49 * c)).to(out_dtype)
    return out, (cs, rblk)


def _assert_same(got, want):
    """Bit for bit up to NaN payloads: the same NaN positions, every other
    value equal."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])


def _check(feat, rois, flavor="gpu", out_dtype=torch.float32, rblk=None):
    got, plan = fwd_schedule(feat, rois, flavor, out_dtype, rblk)
    want = roi_pool_fc_plain(torch.from_numpy(feat), torch.from_numpy(rois),
                             flavor=flavor, out_dtype=out_dtype)
    _assert_same(got, want)
    return got, plan


def _batch(rng, h=12, w=15, c=4, p=9):
    cases = [make_case(rng, h=h, w=w, c=c, p=p) for _ in range(2)]
    return (np.stack([f for f, _ in cases]),
            np.stack([r for _, r in cases]))


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
@pytest.mark.parametrize("c", [4, 12, 20, 516])
def test_fwd_schedule_random_rois(rng, c, flavor, out_dtype):
    """Two images, 9 ROIs each (one forced 1x1); C of one short slice, one
    slice of 12, 16 + a 4-channel tail, 32 slices + a tail."""
    feat, rois = _batch(rng, c=c)
    got, (cs, _) = _check(feat, rois, flavor, out_dtype)
    assert cs == max(x for x in (16, 8, 4) if x <= c)


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["f32", "bf16"])
def test_fwd_schedule_whole_map_and_outside_rois(rng, out_dtype):
    """Whole-map ROIs, ROIs past the map (bins clipped to nothing) and one
    starting beyond it."""
    feat, _ = _batch(rng, c=24)
    h, w = feat.shape[1:3]
    rois = np.array([[0, 0, w * 16 - 1, h * 16 - 1],
                     [-200, -120, 60, 40],
                     [w * 16 - 40, h * 16 - 30, w * 16 + 300, h * 16 + 200],
                     [w * 16 + 50, h * 16 + 50, w * 16 + 90, h * 16 + 70],
                     [0, 0, w * 16 - 1, h * 16 - 1]], F32)
    rois = np.stack([rois, rois[::-1].copy()])
    got, _ = _check(feat, rois, out_dtype=out_dtype)
    assert (got.reshape(2, 5, 49, 24) == 0).all(-1).any()


def test_fwd_schedule_cpu_flavor_empty_bins(rng):
    """The truncated "cpu" edges leave bins empty inside small ROIs; they
    write exactly 0 over an all-positive map."""
    feat = (rng.randn(1, 12, 14, 8) + 10.0).astype(F32)
    rois = np.array([[[16, 16, 16 * 4, 16 * 3], [32, 0, 32 + 16 * 2, 16 * 5],
                      [0, 0, 0, 0]]], F32)
    got, _ = _check(feat, rois, "cpu")
    assert (got.reshape(3, 49, 8) == 0).all(-1).any()


@pytest.mark.parametrize("rblk", [4, 7])
def test_fwd_schedule_partial_roi_block(rng, rblk):
    """P = 9 in blocks of 4 (4 + 4 + 1) or 7 (7 + 2): the last block's
    items stop at its own ROIs."""
    feat, rois = _batch(rng, c=20)
    _check(feat, rois, rblk=rblk)


@pytest.mark.parametrize("h,w", [(5, 300), (300, 5), (3, 520)])
def test_fwd_schedule_several_boxes(rng, h, w):
    """Maps taller or wider than one 256-cell box: near-equal row bands, or
    each row cut into pieces, each box in its own aligned region."""
    feat = rng.randn(1, h, w, 8).astype(F32)
    x1 = rng.uniform(-30, w * 16, (1, 12))
    y1 = rng.uniform(-30, h * 16, (1, 12))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, 1500, (1, 12)),
                     y1 + rng.uniform(0, 1500, (1, 12))], -1).astype(F32)
    t = fwd_tile(h, w, 16)
    assert t[2] * t[3] > 1 and max(t[0], t[1]) <= BOX_MAX
    for out_dtype in DTYPES:
        _check(feat, rois, out_dtype=out_dtype)


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["f32", "bf16"])
def test_fwd_schedule_propagates_nan(rng, out_dtype):
    """NaNs planted in the map: every bin whose window holds one is NaN,
    as the plain version's amax makes it."""
    feat, rois = _batch(rng, c=20)
    rois[:, 1] = [0, 0, 15 * 16 - 1, 12 * 16 - 1]     # the whole map
    feat[0, 3, 4, :7] = np.nan
    feat[1, 6:8, 2, 17] = np.nan
    got, _ = _check(feat, rois, out_dtype=out_dtype)
    assert got.isnan().any()


@pytest.mark.parametrize("shape,plan", [
    ((8, 38, 51, 512, 300), (16, 300)),    # served: 256 blocks, 124 KB tiles
    ((1, 38, 56, 512, 128), (16, 32)),     # training, supervised group
    ((2, 38, 56, 512, 2000), (16, 1000)),  # training, weak group
    ((8, 63, 63, 512, 300), (8, 300)),     # a 1008-pixel canvas: 16 misses
    ((1, 125, 125, 512, 300), (0, 0)),     # the direct path
    ((1, 128, 128, 8, 5), (0, 0)),
    ((2, 12, 15, 516, 9), (16, 3)),
    ((1, 38, 51, 512, 5000), (16, 1250)),
    ((1, 1, 1, 4, 1), (4, 1)),
])
def test_forward_plan_size_rule(shape, plan):
    """The widest slice that fits; the number of ROI blocks nearest one
    wave of resident blocks (one of 16 channels an SM, else two); other
    pooled sizes go direct."""
    b, h, w, c, p = shape
    assert forward_plan(b, h, w, c, p) == plan
    assert forward_plan(b, h, w, c, p, 6, 6) == (0, 0)
    cs, rblk = plan
    if cs == 0:     # even 4 channels do not fit
        assert staged_tile_bytes(h, w, 4) > SMEM_PER_BLOCK - 144
        return
    smem = 128 + staged_tile_bytes(h, w, cs) + 16 + rblk * 14 * 4
    assert smem <= SMEM_PER_BLOCK
    wider = {16: None, 8: 16, 4: 8}[cs]
    if wider and c >= wider:
        assert 128 + staged_tile_bytes(h, w, wider) > SMEM_PER_BLOCK - 16
    resident = 1 if smem > SMEM_PER_BLOCK // 2 else 2
    grid_x = -(-c // cs) * b
    n = min(p, max(1, round(SMS * resident / grid_x)))
    assert rblk == -(-p // n) or smem > SMEM_PER_BLOCK - 56


def _nan_case(rng):
    feat, rois = _batch(rng, h=10, w=13, c=12, p=8)
    rois[:, 1] = [0, 0, 13 * 16 - 1, 10 * 16 - 1]     # the whole map
    feat[0, 2:4, 5, :5] = np.nan
    feat[1, 7, 0:3, 11] = np.nan
    return feat, rois


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_plain_forward_nan_matches_jax(rng, flavor, out_dtype):
    """The port's plain forward against the JAX package's roi_pool_fc (its
    CPU fallback) with NaNs planted in some windows: the same NaN
    positions, every other value equal."""
    feat, rois = _nan_case(rng)
    got = roi_pool_fc_plain(torch.from_numpy(feat), torch.from_numpy(rois),
                            flavor=flavor, out_dtype=out_dtype)
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax_roi_pool_fc(jnp.asarray(feat), jnp.asarray(rois),
                                      flavor=flavor, out_dtype=jdt)
                      .astype(jnp.float32))
    got = got.float().numpy()
    nan = np.isnan(want)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])
