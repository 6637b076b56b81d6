"""The int8 conv of int8 serving (``ops/int8_conv.py``, the plain version
of the kernel ``csrc/int8_conv.cu``) against a numpy int64 oracle and
against the JAX package's s8 x s8 -> s32 conv
(``wssdl_bus_tpu/models/quantize.py:_conv(..., preferred_element_type=
int32)``), exactly, at every kernel / stride / padding kind the int8
trunks run: 3x3 stride 1, 3x3 stride 2 and 7x7 stride 2 with TF-SAME's
asymmetric pads on even and odd sides, 1x1 stride 1 and 2, Cin = 3 (K =
27 and 147, padded to the kernel's K step) and +-127 extremes.  The
epilogue and the quantize step are held against the JAX package's bit for
bit (power-of-two grids for the epilogue, so the JAX side's own rounding
is exact; ties at .5 for the quantize step), and so is the requantizing
conv (``out_scale``: the next layer's quantize step in the epilogue) and
the int8 2x2 max-pool it feeds.  The kernel's index algebra (its tile
plan, TMA boxes at the conv's stride with zero fill, taps and channel
blocks, the Cin = 3 path's staged patch and offset table, the epilogue's
row -> pixel map and its int8 lane exchange) is emulated in numpy and held
against the plain accumulator exactly."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.models.layers import max_pool as jax_max_pool
from wssdl_bus_tpu.models.quantize import _conv as jax_conv
from wssdl_bus_tpu.models.quantize import _quantize as jax_quantize
from wssdl_bus_tpu_torch.models.quantize import _max_pool
from wssdl_bus_tpu_torch.ops.int8_conv import (K_STEP, conv_pads, epilogue,
                                               int8_conv_acc_plain,
                                               int8_conv_plain, pack_weight,
                                               quantize, unpack_weight)
from wssdl_bus_tpu_torch.ops.int8_conv_cuda import (HALO_TH, HALO_TW,
                                                    PATCH_MAX, SMALL_KPAD,
                                                    Plan, int8_conv,
                                                    tile_plan)

# (kernel, stride, Cin, Cout, H, W): every kind the int8 trunks run
CASES = [
    (3, 1, 16, 64, 9, 11),     # VGG16 / ResNet 3x3 SAME
    (3, 1, 3, 64, 8, 10),      # conv1_1: Cin = 3, K = 27
    (3, 2, 32, 64, 10, 12),    # 3x3/2, even sides: pads 0 / 1
    (3, 2, 32, 64, 7, 9),      # 3x3/2, odd sides: pads 1 / 1
    (7, 2, 3, 64, 16, 20),     # conv0, even sides: pads 2 / 3, K = 147
    (7, 2, 3, 64, 15, 13),     # conv0, odd sides: pads 3 / 3
    (1, 1, 64, 128, 5, 7),     # bottleneck 1x1
    (1, 2, 64, 128, 6, 7),     # 1x1/2 shortcut
]


def oracle(x, w, stride):
    """numpy int64 TF-SAME conv of NHWC x with HWIO w."""
    kh, kw, _, cout = w.shape
    b, h, wd, _ = x.shape
    ho, wo = -(-h // stride), -(-wd // stride)
    ph = max((ho - 1) * stride + kh - h, 0)
    pw = max((wo - 1) * stride + kw - wd, 0)
    xp = np.pad(x.astype(np.int64), ((0, 0), (ph // 2, ph - ph // 2),
                                     (pw // 2, pw - pw // 2), (0, 0)))
    out = np.zeros((b, ho, wo, cout), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            win = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                     dx:dx + (wo - 1) * stride + 1:stride]
            out += np.einsum("bhwc,cd->bhwd", win, w[dy, dx].astype(np.int64))
    return out


def _case(k, ci, co, h, w, rng, extreme=False):
    if extreme:
        # +-127 with one sign per image and per output channel: interior
        # sums reach 127^2 * k^2 * Cin in magnitude
        x = np.empty((2, h, w, ci), np.int8)
        x[0], x[1] = 127, -127
        wt = np.broadcast_to(rng.choice(np.array([-127, 127], np.int8), co),
                             (k, k, ci, co)).copy()
    else:
        x = rng.randint(-127, 128, (2, h, w, ci)).astype(np.int8)
        wt = rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8)
    return x, wt


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("k,stride,ci,co,h,w", CASES)
def test_acc_exact_against_oracle_and_jax(k, stride, ci, co, h, w, extreme):
    rng = np.random.RandomState(k * 100 + stride * 10 + ci + extreme)
    x, wt = _case(k, ci, co, h, w, rng, extreme)
    packed = pack_weight(torch.from_numpy(wt))
    acc = int8_conv_acc_plain(torch.from_numpy(x), packed, k, k, stride)
    assert acc.dtype == torch.int32
    want = oracle(x, wt, stride)
    np.testing.assert_array_equal(acc.numpy(), want)
    jacc = jax_conv(jnp.asarray(x), jnp.asarray(wt), "SAME", stride=stride,
                    preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    if extreme:   # the largest sums of this K
        assert np.abs(want).max() == 127 * 127 * k * k * ci


@pytest.mark.parametrize("k,ci", [(3, 3), (7, 3), (3, 64), (1, 256)])
def test_pack_layout(k, ci):
    """[Cout, Kpad]: taps in (dy, dx, ci) order, zeros to a multiple of the
    kernel's K step; unpack inverts it."""
    rng = np.random.RandomState(k + ci)
    wt = rng.randint(-127, 128, (k, k, ci, 64)).astype(np.int8)
    packed = pack_weight(torch.from_numpy(wt))
    kk = k * k * ci
    assert packed.shape == (64, -(-kk // K_STEP) * K_STEP)
    assert packed.is_contiguous() and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed[:, :kk].numpy(),
                                  wt.reshape(kk, 64).T)
    assert not packed[:, kk:].any()
    np.testing.assert_array_equal(
        unpack_weight(packed, k, k, ci).numpy(), wt)


@pytest.mark.parametrize("relu", [False, True])
def test_epilogue_bitwise_against_jax_on_pow2_grids(relu):
    """float(acc) * scale + bias (+ ReLU) equals the JAX package's
    ``acc.astype(f32) * scale + bias`` bit for bit: scales and biases on
    power-of-two grids make every product and sum exact in f32, so the JAX
    side's own rounding (fused or not) cannot differ."""
    rng = np.random.RandomState(5)
    acc = rng.randint(-2 ** 20, 2 ** 20, (2, 3, 4, 64)).astype(np.int32)
    scale = (2.0 ** rng.randint(-12, -4, 64)).astype(np.float32)
    bias = (rng.randint(-64, 65, 64) * 2.0 ** -6).astype(np.float32)
    got = epilogue(torch.from_numpy(acc), torch.from_numpy(scale),
                   torch.from_numpy(bias), relu).numpy()
    y = jnp.asarray(acc).astype(jnp.float32) * scale + bias
    want = np.asarray(jnp.maximum(y, 0.0) if relu else y)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got != 0).any()


def test_quantize_bitwise_against_jax():
    """clip(round(x / scale)) in [-127, 127], round half to even, exactly
    the JAX package's ``_quantize``, ties and clipping included."""
    rng = np.random.RandomState(6)
    scale = np.float32(0.037)
    x = (rng.randn(4, 5, 6, 16) * 3).astype(np.float32)
    ties = (np.arange(-130, 131) + 0.5).astype(np.float32)  # k + .5 exact
    got = quantize(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_quantize(
        jnp.asarray(x), jnp.float32(scale))))
    got_t = quantize(torch.from_numpy(ties), torch.tensor(1.0)).numpy()
    np.testing.assert_array_equal(got_t, np.asarray(jax_quantize(
        jnp.asarray(ties), jnp.float32(1.0))))
    assert got_t.dtype == np.int8 and got_t.min() == -127 \
        and got_t.max() == 127
    assert (got_t[129:132] == [0, 0, 2]).all()    # -0.5, 0.5, 1.5 -> even


@pytest.mark.parametrize("k,stride,ci,co,h,w", CASES[:5])
def test_wrapper_takes_the_plain_version_on_the_cpu(k, stride, ci, co, h, w):
    """On CPU tensors ``int8_conv`` is the plain version and launches
    nothing; the full function holds against the oracle + epilogue."""
    rng = np.random.RandomState(9)
    x, wt = _case(k, ci, co, h, w, rng)
    scale = rng.uniform(1e-4, 1e-3, co).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    args = (torch.from_numpy(x), pack_weight(torch.from_numpy(wt)), k, k,
            torch.from_numpy(scale), torch.from_numpy(bias), stride, True)
    before = int8_conv.launches
    got = int8_conv(*args)
    assert int8_conv.launches == before
    np.testing.assert_array_equal(got.numpy(), int8_conv_plain(*args).numpy())
    want = np.maximum(oracle(x, wt, stride).astype(np.float32) * scale
                      + bias, 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("k,stride,ci,co,h,w", [CASES[1], CASES[2],
                                                CASES[4], CASES[6]])
def test_requant_conv_bitwise_against_jax_on_pow2_grids(k, stride, ci, co, h,
                                                         w, relu):
    """``int8_conv_plain(..., out_scale=s)`` equals the JAX package's
    ``_quantize([relu](acc * scale + bias), s)`` of its own s8 conv bit for
    bit: scales, biases and ``s`` on power-of-two grids make the epilogue
    and the division exact on both sides, so any codes that differ come
    from the rounding or the clamp (ties at .5 occur: round half to even;
    both clamp edges are reached)."""
    rng = np.random.RandomState(k * 10 + ci + relu)
    x, wt = _case(k, ci, co, h, w, rng)
    scale = (2.0 ** rng.randint(-14, -10, co)).astype(np.float32)
    bias = (rng.randint(-64, 65, co) * 2.0 ** -3).astype(np.float32)
    s_next = np.float32(2.0 ** -4)
    got = int8_conv_plain(torch.from_numpy(x),
                          pack_weight(torch.from_numpy(wt)), k, k,
                          torch.from_numpy(scale), torch.from_numpy(bias),
                          stride, relu, torch.tensor(s_next))
    acc = jax_conv(jnp.asarray(x), jnp.asarray(wt), "SAME", stride=stride,
                   preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * scale + bias
    want = np.asarray(jax_quantize(jnp.maximum(y, 0.0) if relu else y,
                                   s_next))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 127).any() and (want == 0).any()
    if not relu:
        assert (want == -127).any()
    assert (np.abs(np.asarray(y) / s_next % 1.0) == 0.5).any()   # ties


@pytest.mark.parametrize("h,w", [(8, 10), (7, 9), (5, 4), (3, 5)])
def test_int8_max_pool_equals_f32_pool_then_quantize(h, w):
    """The int8 hand-off's 2x2/2 VALID pool of the codes equals the f32
    pool then the quantize step (the JAX package's order), odd last rows
    and columns dropped: the quantize map is monotone."""
    rng = np.random.RandomState(h * w)
    y = np.maximum(rng.randn(2, h, w, 16) * 3, 0).astype(np.float32)
    s = np.float32(0.037)
    q = quantize(torch.from_numpy(y), torch.tensor(s))
    got = _max_pool(q, 2, 2)
    assert got.dtype == torch.int8 and got.shape == (2, h // 2, w // 2, 16)
    np.testing.assert_array_equal(
        got.numpy(), quantize(_max_pool(torch.from_numpy(y), 2, 2),
                              torch.tensor(s)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_quantize(
        jax_max_pool(jnp.asarray(y), 2, 2, "VALID"), s)))
    with pytest.raises(ValueError, match="2x2"):
        _max_pool(q, 3, 2)


# --------------------------------------------------------------------- #
# the kernel's index algebra, emulated (csrc/int8_conv.cu)
# --------------------------------------------------------------------- #
def _tile_at(t, plan, mt_x, mt_y, bn_cols, cout):
    """csrc/int8_conv.cu:tile_at -> (n0, oy0, ox0, co0)."""
    nt = cout // bn_cols
    co0 = (t % nt) * bn_cols
    m = t // nt
    ox0 = (m % mt_x) * plan.bw
    m //= mt_x
    oy0 = (m % mt_y) * plan.bh
    return (m // mt_y) * plan.bn, oy0, ox0, co0


def _tma_box(x, c0, x0, y0, n0, box, step):
    """One TMA tile-mode box of NHWC ``x`` at (c0, x0, y0, n0), innermost
    first, ``box`` elements traversed at ``step``: ceil(box / step)
    elements a dimension land, zeros outside the tensor -> [n, y, x, c]."""
    idx = [np.arange(o, o + b, s) for o, b, s in zip((c0, x0, y0, n0), box,
                                                     step)]
    out = np.zeros([len(i) for i in idx[::-1]], np.int64)
    inside = [(i >= 0) & (i < d) for i, d in zip(idx, x.shape[::-1])]
    sub = x[np.ix_(idx[3][inside[3]], idx[2][inside[2]], idx[1][inside[1]],
                   idx[0][inside[0]])]
    out[np.ix_(*[np.nonzero(m)[0] for m in inside[::-1]])] = sub
    return out


def _emulate_store(acc_tile, plan, tc, ho, wo, b, out, written):
    """The epilogue's row -> output pixel map (csrc/int8_conv.cu:
    store_tile): tile row r -> (n0 + r / (bw bh), oy0 + r / bw % bh,
    ox0 + r % bw), rows past bw bh bn and pixels outside dropped."""
    n0, oy0, ox0, co0 = tc
    for r in range(acc_tile.shape[0]):
        xq, yq = r % plan.bw, r // plan.bw
        oy, ox, n = oy0 + yq % plan.bh, ox0 + xq, n0 + yq // plan.bh
        if r < plan.bw * plan.bh * plan.bn and n < b and oy < ho and ox < wo:
            out[n, oy, ox, co0:co0 + acc_tile.shape[1]] = acc_tile[r]
            written[n, oy, ox, co0:co0 + acc_tile.shape[1]] += 1


def _emulate_halo(x, pk, plan, out, written):
    """csrc/int8_conv.cu:int8_conv_halo_kernel: per 8 x 16 tile, the 10 x
    18 halo as four planes of 16-byte channel chunks (a TMA box each at
    (0, c, x0 - 1, y0 - 1, n)), row-major with pitch 18 pixels of 16
    bytes, planes kPlane bytes apart; a tap's operand for m64 block mi and
    k-step kk read as wgmma reads an unswizzled K-major descriptor (start
    + 8-row group g * SBO + row i * 16 + chunk j * LBO); B, all 9 taps, in
    64-byte rows; M row 8 g + i of block mi -> pixel (y0 + g, x0 + 8 mi +
    i)."""
    b, ho, wo, cin = x.shape
    assert (plan.bh, plan.bw, cin) == (HALO_TH, HALO_TW, 64)
    hh, hw = HALO_TH + 2, HALO_TW + 2
    plane = -(-hh * hw * 16 // 128) * 128
    lbo, sbo = plane, hw * 16
    g, i = np.divmod(np.arange(64), 8)
    for t in range(b * -(-ho // HALO_TH) * -(-wo // HALO_TW)):
        tx = -(-wo // HALO_TW)
        x0, y0 = (t % tx) * HALO_TW, (t // tx % -(-ho // HALO_TH)) * HALO_TH
        n = t // (tx * -(-ho // HALO_TH))
        smem = np.zeros(4 * plane, np.int64)
        for c in range(4):
            box = _tma_box(x, 16 * c, x0 - 1, y0 - 1, n, (16, hw, hh, 1),
                           (1, 1, 1, 1))
            smem[c * plane:c * plane + hh * hw * 16] = box.reshape(-1)
        acc = np.zeros((128, out.shape[-1]), np.int64)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for kk in range(2):
                bt = pk[:, tap * 64 + 32 * kk:tap * 64 + 32 * kk + 32]
                for mi in range(2):
                    start = 2 * kk * plane + (dy * hw + 8 * mi + dx) * 16
                    rows = start + g * sbo + i * 16
                    a = np.concatenate([smem[(rows + j * lbo)[:, None]
                                             + np.arange(16)]
                                        for j in range(2)], axis=1)
                    acc[64 * mi:64 * mi + 64] += a @ bt.T
        for mi in range(2):
            for r in range(64):
                oy, ox = y0 + r // 8, x0 + 8 * mi + r % 8
                if oy < ho and ox < wo:
                    out[n, oy, ox] = acc[64 * mi + r]
                    written[n, oy, ox] += 1


def emulate_int8_conv_acc(x, packed, k, stride, plan, rng):
    """The kernel's int32 accumulator of the TF-SAME conv, computed the way
    its tiles compute it: the TMA path (one box of the input and one of the
    packed weights per (tap, channel block of 128, or 64 where Cin % 128 !=
    0), rows past the box's filled with garbage, as stale shared memory),
    the halo path (:func:`_emulate_halo`), or the Cin = 3 path (the staged
    patch, the per-k offset table, the k-steps holding real K)."""
    b, h, w, cin = x.shape
    cout, kpad = packed.shape
    (pt, _), (pl, _), (ho, wo) = conv_pads(h, w, k, k, stride)
    mt_x, mt_y, mt_n = -(-wo // plan.bw), -(-ho // plan.bh), -(-b // plan.bn)
    loaded = plan.bw * plan.bh * plan.bn
    assert loaded <= plan.rows
    out = np.zeros((b, ho, wo, cout), np.int64)
    written = np.zeros(out.shape, np.int64)
    pk = packed.astype(np.int64)
    if plan.path == "halo":
        _emulate_halo(x, pk, plan, out, written)
    elif plan.path == "tma":
        bn_cols = 128 if cout % 128 == 0 else 64
        cb_bytes = 128 if cin % 128 == 0 else 64
        kc = cin // cb_bytes
        for t in range(mt_x * mt_y * mt_n * (cout // bn_cols)):
            tc = _tile_at(t, plan, mt_x, mt_y, bn_cols, cout)
            n0, oy0, ox0, co0 = tc
            ix0, iy0 = ox0 * stride - pl, oy0 * stride - pt
            acc = np.zeros((plan.rows, bn_cols), np.int64)
            for kk in range(k * k * kc):
                tap, cb = divmod(kk, kc)
                dy, dx = divmod(tap, k)
                a = rng.randint(-128, 128, (plan.rows, cb_bytes))
                a[:loaded] = _tma_box(
                    x, cb * cb_bytes, ix0 + dx, iy0 + dy, n0,
                    (cb_bytes, plan.bw * stride, plan.bh * stride, plan.bn),
                    (1, stride, stride, 1)).reshape(loaded, cb_bytes)
                k0 = tap * cin + cb * cb_bytes
                acc += a @ pk[co0:co0 + bn_cols, k0:k0 + cb_bytes].T
            _emulate_store(acc, plan, tc, ho, wo, b, out, written)
    else:
        assert cout == 64 and kpad <= SMALL_KPAD
        ph, pw = (plan.bh - 1) * stride + k, (plan.bw - 1) * stride + k
        assert plan.bn * ph * pw * cin <= PATCH_MAX
        k_real = k * k * cin
        koff = np.full(kpad, -1)
        for kk in range(k_real):
            tap, ci = divmod(kk, cin)
            dy, dx = divmod(tap, k)
            koff[kk] = (dy * pw + dx) * cin + ci
        nk32 = -(-k_real // 32)
        for t in range(mt_x * mt_y * mt_n):
            tc = _tile_at(t, plan, mt_x, mt_y, 64, cout)
            n0, oy0, ox0, _ = tc
            patch = _tma_box(x, 0, ox0 * stride - pl, oy0 * stride - pt, n0,
                             (cin, pw, ph, plan.bn), (1, 1, 1, 1)).reshape(-1)
            # A as the kernel writes it: 4 bytes a word, into 64-byte rows
            # in the 64-byte swizzle, a block of `rows` rows per 64 K bytes
            smem = np.zeros(kpad * plan.rows, np.int64)
            for r in range(plan.rows):
                xx, yq = r % plan.bw, r // plan.bw
                rb = (((yq // plan.bh) * ph + (yq % plan.bh) * stride) * pw
                      + xx * stride) * cin
                for k0 in range(0, nk32 * 32, 4):
                    ko = koff[k0:k0 + 4]
                    word = np.where(ko >= 0, patch[rb + np.maximum(ko, 0)]
                                    if r < loaded else 0, 0)
                    off = (k0 >> 6) * plan.rows * 64 + r * 64 \
                        + ((((k0 >> 4) & 3) ^ ((r >> 1) & 3)) << 4) + (k0 & 15)
                    smem[off:off + 4] = word
            # wgmma's view of the swizzled rows: logical (r, k)
            kk = np.arange(nk32 * 32)
            rr = np.arange(plan.rows)[:, None]
            a = smem[(kk >> 6) * plan.rows * 64 + rr * 64
                     + ((((kk >> 4) & 3) ^ ((rr >> 1) & 3)) << 4) + (kk & 15)]
            acc = a @ pk[:, :nk32 * 32].T
            _emulate_store(acc, plan, tc, ho, wo, b, out, written)
    assert (written == 1).all(), "an output written twice or never"
    return out


EMU_CASES = [
    # (k, stride, Cin, Cout, B, H, W, plan or None for tile_plan's)
    (3, 1, 64, 64, 2, 9, 11, None),          # the halo path, ragged tiles
    (3, 1, 64, 128, 1, 17, 35, None),        # the halo path, Cout 128
    (3, 1, 64, 128, 2, 9, 11, Plan(3, 2, 2, 256, "tma")),  # ragged, 2 images
    (3, 2, 64, 128, 2, 10, 12, None),        # pads 0 / 1
    (3, 2, 192, 64, 2, 7, 9, None),          # pads 1 / 1, 3 channel blocks
    (3, 1, 256, 128, 2, 5, 6, None),         # 128-channel blocks (2)
    (3, 2, 128, 64, 5, 7, 7, Plan(4, 4, 16, 256, "tma")),  # the head's ROIs
    (1, 2, 64, 128, 2, 7, 13, None),         # 1x1/2 shortcut, odd sides
    (1, 1, 128, 128, 3, 4, 4, Plan(4, 4, 8, 256, "tma")),
    (3, 1, 3, 64, 2, 8, 10, None),           # conv1_1, K = 27
    (7, 2, 3, 64, 2, 16, 20, None),          # conv0: pads 2 / 3, K = 147
    (7, 2, 3, 64, 3, 15, 13, Plan(3, 2, 2, 256, "small")),  # odd, 2 images
]


@pytest.mark.parametrize("k,stride,ci,co,b,h,w,plan", EMU_CASES)
def test_kernel_index_algebra_emulated(k, stride, ci, co, b, h, w, plan):
    rng = np.random.RandomState(k + 7 * ci + stride)
    x = rng.randint(-127, 128, (b, h, w, ci)).astype(np.int8)
    wt = rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8)
    packed = pack_weight(torch.from_numpy(wt))
    plan = plan or tile_plan(b, h, w, ci, co, k, stride)
    assert (plan.path == "small") == (ci % 64 != 0)
    got = emulate_int8_conv_acc(x, packed.numpy(), k, stride, plan, rng)
    want = int8_conv_acc_plain(torch.from_numpy(x), packed, k, k, stride)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("b,h,w,ci,co,k,stride", [
    (8, 608, 816, 3, 64, 3, 1), (8, 608, 816, 64, 64, 3, 1),
    (8, 38, 51, 512, 512, 3, 1), (8, 608, 816, 3, 64, 7, 2),
    (8, 76, 102, 128, 256, 3, 2), (2400, 7, 7, 256, 512, 3, 2),
    (2400, 7, 7, 1024, 512, 1, 1), (2400, 4, 4, 512, 2048, 1, 1)])
def test_tile_plan_at_the_served_shapes(b, h, w, ci, co, k, stride):
    """The plan at the batch-8 int8 steps' layer shapes meets the kernel's
    limits (csrc/int8_conv.cu:wssdl_int8_conv) and wastes at most a third
    of its tiles' rows."""
    p = tile_plan(b, h, w, ci, co, k, stride)
    _, _, (ho, wo) = conv_pads(h, w, k, k, stride)
    assert p.bw * p.bh * p.bn <= p.rows
    tiles = -(-wo // p.bw) * -(-ho // p.bh) * -(-b // p.bn)
    assert b * ho * wo >= tiles * p.rows * 2 / 3
    if p.path == "halo":
        assert (k, stride, ci, p.bw, p.bh, p.bn, p.rows) == (3, 1, 64, 16, 8,
                                                             1, 128)
    elif p.path == "small":
        assert p.rows == 256 and p.bn * ((p.bh - 1) * stride + k) \
            * ((p.bw - 1) * stride + k) * ci <= PATCH_MAX
    else:
        assert p.rows == 256 and p.bw * stride <= 256 \
            and p.bh * stride <= 256 and p.bn <= 256


def test_int8_store_lane_exchange_emulated():
    """The epilogue's int8 store (csrc/int8_conv.cu:store_tile): each lane
    q of a quad holds the two codes of channels 8i + 2q, 8i + 2q + 1 for
    every group i; after the two shuffles lane q stores the eight codes of
    group 4j + q, in channel order, for each block of four groups j."""
    rng = np.random.RandomState(0)
    # ch[j, c]: block j of four groups, channel c = 8 g + 2 q + e
    ch = rng.randint(0, 256, (4, 32)).astype(np.uint32)
    m16 = 0xffff
    for j in range(4):
        p = [[int(ch[j, 8 * g + 2 * q]) | int(ch[j, 8 * g + 2 * q + 1]) << 8
              for g in range(4)] for q in range(4)]
        w0 = [p[q][0] | p[q][1] << 16 for q in range(4)]
        w1 = [p[q][2] | p[q][3] << 16 for q in range(4)]
        snd = [((w0[q] & m16) | (w1[q] << 16)) & 0xffffffff if q & 1
               else (w0[q] >> 16) | (w1[q] & 0xffff0000) for q in range(4)]
        rcv = [snd[q ^ 1] for q in range(4)]
        a0 = [(rcv[q] & m16) | (w0[q] & 0xffff0000) if q & 1
              else (w0[q] & m16) | ((rcv[q] << 16) & 0xffffffff)
              for q in range(4)]
        a1 = [(rcv[q] >> 16) | (w1[q] & 0xffff0000) if q & 1
              else (w1[q] & m16) | (rcv[q] & 0xffff0000) for q in range(4)]
        snd2 = [a0[q] if q & 2 else a1[q] for q in range(4)]
        rcv2 = [snd2[q ^ 2] for q in range(4)]
        for q in range(4):
            lo, hi = (rcv2[q], a1[q]) if q & 2 else (a0[q], rcv2[q])
            stored = [(lo >> (8 * i)) & 0xff for i in range(4)] \
                + [(hi >> (8 * i)) & 0xff for i in range(4)]
            assert stored == ch[j, 8 * q:8 * q + 8].tolist(), (j, q)


def test_wrapper_passes_out_scale_to_the_plain_version_on_the_cpu():
    """On CPU tensors ``int8_conv(..., out_scale)`` is the plain
    requantizing conv, int8 out, no launch."""
    rng = np.random.RandomState(3)
    x, wt = _case(3, 64, 128, 6, 7, rng)
    args = (torch.from_numpy(x), pack_weight(torch.from_numpy(wt)), 3, 3,
            torch.full((128,), 1e-4), torch.zeros(128), 1, True,
            torch.tensor(0.05))
    before = int8_conv.launches
    got = int8_conv(*args)
    assert int8_conv.launches == before and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), int8_conv_plain(*args).numpy())
    np.testing.assert_array_equal(got.numpy(), quantize(
        int8_conv_plain(*args[:8]), args[8]).numpy())


def _rn32(x: Fraction) -> np.float32:
    """The binary32 nearest to the rational ``x``, ties to even."""
    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - x)
        even = not (cand.view(np.uint32) & 1)
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return best[1]


def _fma(a, b, c):
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _quotient(y, s, r):
    """csrc/int8_conv.cu:quotient with exact fmas."""
    q = _rn32(Fraction(float(y)) * Fraction(float(r)))
    if abs(q) < 512:
        q = _fma(_fma(-q, s, y), r, q)
        q = _fma(_fma(-q, s, y), r, q)
    return q


def test_requant_quotient_is_the_ieee_quotient():
    """The kernel's division-free quotient (RN(y / s) by a reciprocal and
    two fma corrections) equals numpy's IEEE f32 division wherever |y / s|
    < 512, and rounds and clamps as it does elsewhere: near-ties (k + 0.5
    within a few ulps), exact ties, zeros, random and huge dividends."""
    rng = np.random.RandomState(17)
    f32 = np.float32
    ys, ss = [], []
    for _ in range(3000):
        s = f32(np.exp(rng.uniform(np.log(1e-4), np.log(1e3))))
        k = rng.randint(-140, 141) + 0.5
        y = f32(k * float(s))
        for _ in range(rng.randint(0, 4)):
            y = np.nextafter(y, f32(np.inf) if rng.rand() < 0.5
                             else f32(-np.inf))
        ys.append(y)
        ss.append(s)
    for _ in range(500):      # exact ties: s a power of two
        s = f32(2.0 ** rng.randint(-12, 8))
        ys.append(f32((rng.randint(-140, 141) + 0.5) * float(s)))
        ss.append(s)
    for _ in range(500):      # random, zeros, huge
        s = f32(np.exp(rng.uniform(np.log(1e-4), np.log(1e3))))
        ys.append(f32(rng.choice([0.0, rng.randn() * 1e3,
                                  rng.randn() * 1e30])))
        ss.append(s)
    ties = 0
    for y, s in zip(ys, ss):
        r = f32(1) / s
        want = y / s
        got = _quotient(y, s, r)
        if abs(want) < 512:
            assert got == want, (y, s, got, want)
            ties += float(want) % 1.0 == 0.5
        code = lambda q: int(np.clip(np.rint(q), -127, 127))  # noqa: E731
        assert code(got) == code(want), (y, s)
    assert ties > 100
