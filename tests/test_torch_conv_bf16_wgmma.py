"""The bf16 wgmma conv kernel's layout and arithmetic, emulated on the CPU.

`ops/csrc/conv_bf16.cuh` runs conv + bias + act at bf16 as an implicit
GEMM, [M, K] x [K, OC] with M = B * OH * OW and K = KH * KW * C in (ki, kj,
c) order, on wgmma: output tiles of 128 x 128, K in 64-deep slices through
a ring in shared memory, each 32-deep half slice summed in fresh f32
accumulators and joined to the running f32 sum in one add, then bias and
the activation in f32 and one rounding to bf16. The route (`cuda_kernels.
conv_bf16_route`, the rule of `wgmma_route` over the header's `kRoute`
constants) gives it C % 64 == 0 and OC % 8 == 0 within the encoding of
TMA's im2col mode; the producer brings each A slice (128 rows of the
virtual im2col matrix by 64 k, one tap) by one TMA load in im2col mode. No
kernel runs here (no card, no nvcc); this file repeats in numpy what the
kernel computes and where it puts it:

  - the TMA im2col walk: from the tile's first window origin, W fastest,
    then H, then the image, inside the bounding box whose corners the
    kernel encodes (-pad, and pad - (k - 1) past the last index), at the
    conv's strides; it must visit exactly the tile's rows' window origins;
  - the im2col load: which x element (or zero) each (row, 16-byte chunk) of
    each 64-deep slice reads, from the walk's origin shifted by the slice's
    tap, and the byte of the tile it lands on. Every (m, k) of the im2col
    matrix lands exactly once, at chunk c ^ (r & 7) of row r: the 128-byte
    swizzle that the wgmma descriptor reads (address bits 4-6 xor bits
    7-9);
  - the K walk: f32 sums of the exact bf16 products, 16-deep k-step by
    k-step into a fresh part for each 32-deep half slice, each part added
    to the running f32 sum; z = sum + bias and act(z) in f32, rounded once
    to bf16.

The K walk is held against the JAX package on bf16 inputs made by numpy
from a seed: the conv seam through its Pallas kernel in the interpreter
(`pk.enable(interpret=True, use_conv=True)`), at bf16 (its f32 dot, bias
and activation, one cast) and on f32 copies of the bf16 values (its f32
result before any rounding); `_conv2d_bias_act_default` on the f32 copies;
and the port's plain version (`conv2d_bias_act_ref`, bf16). Tolerances,
over the reference's max |value| M: f32 against f32, 2e-6 M (the same exact
products summed in other orders over K <= 1152); bf16 against bf16, max
|diff| <= 2^-7 M (one bf16 ulp of the largest element: a rounding may flip
where the f32 sums differ) and mean |diff| <= 1e-3 M, the gates of
chip_smoke.py phase 22. Shapes: AlexNet's conv2 and conv3 at B <= 2, and
stride 2 SAME with OC = 72.

The route's rule is read from the header, the one table of its limits; the
card's own answer is held against it by chip_smoke.py phase 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import activations
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

BM, BN, BK = 128, 128, 64  # the kernel's tile rows, columns, K per slice
ROW = 128                  # bytes of a swizzled row (64 bf16)
ULP7, MEAN, F32_TOL = 2.0 ** -7, 1e-3, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(a):
    """float32 rounded to bf16 (to nearest, ties to even), back as f32."""
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def swizzle128(addr):
    """The 128-byte swizzle of a tile aligned on 1024 bytes: the 16-byte
    chunk index (bits 4-6) xor the row within the 8-row atom (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def geometry(H, W, KH, KW, stride, padding):
    OH, OW, pads = ck.conv_geometry(H, W, KH, KW, stride, padding)
    return OH, OW, pads


def im2col(x, KH, KW, stride, pads, OH, OW):
    """[M, K] rows of the virtual im2col matrix, K in (ki, kj, c) order,
    zeros where the window reaches the pads."""
    B, H, W, C = x.shape
    xp = np.pad(x, ((0, 0), pads[0], pads[1], (0, 0)))
    sh, sw = stride
    cols = [xp[:, ki:ki + sh * (OH - 1) + 1:sh, kj:kj + sw * (OW - 1) + 1:sw]
            for ki in range(KH) for kj in range(KW)]
    return np.stack(cols, axis=3).reshape(B * OH * OW, KH * KW * C)


def im2col_walk(B, H, W, OH, OW, stride, pads, m0, rows=BM):
    """The window origins (n, h, w) a TMA im2col load visits from the
    tile's first one, inside the bounding box of the kernel's corners
    (csrc/conv_bf16.cuh `im2col_corners`)."""
    sh, sw = stride
    lo_w, lo_h = -pads[1][0], -pads[0][0]
    up_w = (OW - 1) * sw - pads[1][0] - (W - 1)
    up_h = (OH - 1) * sh - pads[0][0] - (H - 1)
    q, ow = divmod(m0, OW)
    n, oh = divmod(q, OH)
    w, h = ow * sw - pads[1][0], oh * sh - pads[0][0]
    out = []
    for _ in range(rows):
        out.append((n, h, w))
        w += sw
        if w > W - 1 + up_w:
            w, h = lo_w, h + sh
            if h > H - 1 + up_h:
                h, n = lo_h, n + 1
    return out


@pytest.mark.parametrize("B,H,W,K,stride,padding", [
    (2, 16, 16, 3, (1, 1), "SAME"),            # AlexNet conv2's geometry
    (3, 8, 8, 3, (1, 1), "SAME"),              # conv3's: two images a tile
    (3, 12, 11, 3, (2, 2), "SAME"),            # stride 2 SAME, pads (0, 1)
    (1, 9, 9, 5, (2, 1), ((2, 1), (0, 3))),    # explicit asymmetric pads
    (3, 7, 7, 3, (2, 2), "VALID"),             # a column the walk skips
    (2, 5, 6, 1, (1, 1), "VALID"),             # 1 x 1
])
def test_im2col_walk_visits_the_tiles_window_origins(B, H, W, K, stride,
                                                     padding):
    OH, OW, pads = geometry(H, W, K, K, stride, padding)
    sh, sw = stride
    M = B * OH * OW
    assert ck.conv_bf16_route(B, H, W, 64, K, K, 8, stride, padding) \
        == "wgmma"
    for m0 in range(0, M, BM):
        walk = im2col_walk(B, H, W, OH, OW, stride, pads, m0)
        for r, (n, h, w) in enumerate(walk):
            m = m0 + r
            if m >= M:  # rows past M walk into images past B: zeros
                assert n >= B
                continue
            q, ow = divmod(m, OW)
            img, oh = divmod(q, OH)
            assert (n, h, w) == (img, oh * sh - pads[0][0],
                                 ow * sw - pads[1][0])


def im2col_load(B, H, W, C, KH, KW, stride, pads, OH, OW, m0, sl):
    """The TMA im2col load of one A slice: {tile byte: (x element offset of
    the chunk's first channel, or None for zeros, row, chunk)}. The slice
    is 64 channels of one tap (C % 64 == 0); row r reads the r-th window
    origin of the walk, shifted by the tap, channels from the slice's
    first; an origin or position outside x reads zeros; the 128-byte
    swizzle places chunk c of row r."""
    k = sl * BK
    tap, c0 = divmod(k, C)
    ki, kj = divmod(tap, KW)
    plan = {}
    for r, (n, h, w) in enumerate(im2col_walk(B, H, W, OH, OW, stride, pads,
                                              m0)):
        ih, iw = h + ki, w + kj
        inside = n < B and 0 <= ih < H and 0 <= iw < W
        for c in range(8):
            src = (((n * H + ih) * W + iw) * C + c0 + 8 * c if inside
                   else None)
            dst = swizzle128(r * ROW + 16 * c)
            assert dst not in plan
            plan[dst] = (src, r, c)
    return plan


@pytest.mark.parametrize("B,H,W,C,K,stride,padding", [
    (2, 16, 16, 64, 3, (1, 1), "SAME"),    # AlexNet conv2's geometry
    (3, 8, 8, 128, 3, (1, 1), "SAME"),     # conv3's: two slices a tap
    (3, 12, 11, 64, 3, (2, 2), "SAME"),    # stride 2 SAME, pads (0, 1)
    (1, 9, 9, 64, 5, (2, 1), ((2, 1), (0, 3))),  # B = 1, asymmetric pads
    (3, 7, 9, 128, 3, (1, 2), "VALID"),    # M tail: M = 60
    (2, 5, 6, 192, 1, (1, 1), "VALID"),    # 1 x 1, three slices a tap
])
def test_im2col_load_lands_every_element_once_at_its_swizzled_place(
        B, H, W, C, K, stride, padding):
    rng = np.random.default_rng(C + K)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    OH, OW, pads = geometry(H, W, K, K, stride, padding)
    assert ck.conv_bf16_route(B, H, W, C, K, K, 8, stride, padding) \
        == "wgmma"
    M, KK = B * OH * OW, K * K * C
    want = np.zeros((-(-M // BM) * BM, KK), np.float32)
    want[:M] = im2col(x, K, K, stride, pads, OH, OW)
    flat = x.reshape(-1)
    for m0 in range(0, M, BM):
        for sl in range(KK // BK):
            plan = im2col_load(B, H, W, C, K, K, stride, pads, OH, OW, m0,
                               sl)
            # 1024 chunks of 16 bytes: the whole 16 KiB tile, once each
            assert sorted(plan) == list(range(0, BM * ROW, 16))
            tile = np.zeros(BM * ROW // 2, np.float32)  # bf16 slots
            for dst, (src, r, c) in plan.items():
                if src is not None:
                    assert src + 8 <= flat.size and (src % C) + 8 <= C
                    tile[dst // 2:dst // 2 + 8] = flat[src:src + 8]
            # read back as the wgmma descriptor reads a K-major tile
            got = np.empty((BM, BK), np.float32)
            for r in range(BM):
                for c in range(8):
                    a = swizzle128(r * ROW + 16 * c) // 2
                    got[r, 8 * c:8 * c + 8] = tile[a:a + 8]
            np.testing.assert_array_equal(
                got, want[m0:m0 + BM, sl * BK:(sl + 1) * BK])


def test_route_limits_are_the_headers():
    """The Python rule reads its limits from csrc/conv_bf16.cuh, and the
    header states each once."""
    import pathlib
    import re
    lim = ck.conv_bf16_route_limits()
    assert lim == {"kRouteC": 64, "kRouteOC": 8, "kRouteAlign": 16,
                   "kRouteMaxM": 2 ** 31 - 129, "kRouteMaxStride": 8,
                   "kRouteCornerLo": -128, "kRouteCornerHi": 127,
                   "kRouteMaxTap": 256}
    text = (pathlib.Path(ck.__file__).with_name("csrc")
            / "conv_bf16.cuh").read_text()
    for name in lim:
        assert len(re.findall(rf"constexpr [a-z ]+ {name} =", text)) == 1


def test_route():
    route = ck.conv_bf16_route
    # AlexNet-CIFAR10's three convs, LeNet-MNIST's conv2
    assert route(512, 32, 32, 3, 3, 3, 64) == "mma_sync"
    assert route(512, 16, 16, 64, 3, 3, 128) == "wgmma"
    assert route(512, 8, 8, 128, 3, 3, 256) == "wgmma"
    assert route(512, 12, 12, 20, 5, 5, 50, padding="VALID") == "mma_sync"
    # C a multiple of 64 (a K slice is one tap), OC of 8
    assert route(2, 12, 11, 64, 5, 5, 72, (2, 2)) == "wgmma"
    assert route(2, 6, 5, 192, 1, 1, 40, padding="VALID") == "wgmma"
    for C in (8, 16, 24, 32, 96):
        assert route(2, 12, 11, C, 3, 3, 72) == "mma_sync"
    assert route(2, 12, 11, 64, 3, 3, 50) == "mma_sync"
    assert route(2, 12, 11, 64, 3, 3, 4) == "mma_sync"
    # x and w 16-byte aligned
    assert route(2, 8, 8, 64, 3, 3, 64, x_ptr=8) == "mma_sync"
    assert route(2, 8, 8, 64, 3, 3, 64, w_ptr=2) == "mma_sync"
    assert route(2, 8, 8, 64, 3, 3, 64, x_ptr=1 << 20, w_ptr=48) == "wgmma"
    # M = B * OH * OW at most 2^31 - 129
    assert route(2 ** 31 - 129, 1, 1, 64, 1, 1, 64, padding="VALID") \
        == "wgmma"
    assert route(2 ** 31 - 128, 1, 1, 64, 1, 1, 64, padding="VALID") \
        == "mma_sync"
    # what TMA's im2col mode encodes: strides, corners, taps
    assert route(1, 64, 64, 64, 3, 3, 64, (8, 8)) == "wgmma"
    assert route(1, 64, 64, 64, 3, 3, 64, (9, 9)) == "mma_sync"
    assert route(1, 64, 64, 64, 3, 3, 64, (1, 9)) == "mma_sync"
    assert route(1, 8, 8, 64, 3, 3, 64, padding=((128, 0), (1, 1))) \
        == "wgmma"
    assert route(1, 8, 8, 64, 3, 3, 64, padding=((129, 0), (1, 1))) \
        == "mma_sync"
    # the upper corner is the pad after, less k - 1
    assert route(1, 8, 8, 64, 3, 3, 64, padding=((1, 1), (1, 129))) \
        == "wgmma"
    assert route(1, 8, 8, 64, 3, 3, 64, padding=((1, 1), (1, 130))) \
        == "mma_sync"
    # taps: KH at most 256 (the upper corner is -128 in both)
    assert route(1, 200, 1, 64, 256, 1, 64,
                 padding=((0, 127), (0, 0))) == "wgmma"
    assert route(1, 200, 1, 64, 257, 1, 64,
                 padding=((0, 128), (0, 0))) == "mma_sync"


def emulate_conv(x, w, b, *, stride, padding, activation):
    """(f32 z, bf16 act(z), bf16 z) as the kernel computes them on bf16
    values: slices of 64 k (zeros past K), each half of two 16-deep k-steps
    summed in a fresh f32 part that joins the running f32 sum, bias and act
    in f32, one rounding."""
    B, H, W, _ = x.shape
    KH, KW, C, OC = w.shape
    OH, OW, pads = geometry(H, W, KH, KW, stride, padding)
    K = KH * KW * C
    Kp = -(-K // BK) * BK
    a = np.zeros((B * OH * OW, Kp), np.float32)
    a[:, :K] = im2col(x, KH, KW, stride, pads, OH, OW)
    bm = np.zeros((Kp, OC), np.float32)
    bm[:K] = w.reshape(K, OC)
    acc = np.zeros((a.shape[0], OC), np.float32)
    for h0 in range(0, Kp, 32):
        part = np.zeros_like(acc)
        for k0 in range(h0, h0 + 32, 16):
            # one k-step: 16 exact products (bf16 x bf16 fits f32) summed in
            # f64 and rounded once, then added to the part
            step = (a[:, k0:k0 + 16].astype(np.float64)
                    @ bm[k0:k0 + 16].astype(np.float64)).astype(np.float32)
            part = (part + step).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    z = (acc + b).astype(np.float32)
    y = activations.get(activation)(torch.from_numpy(z)).numpy()
    shape = (B, OH, OW, OC)
    return z.reshape(shape), bf16(y).reshape(shape), bf16(z).reshape(shape)


SAME = ((1, 1), (1, 1))
# (B, H, W, C, K, OC, stride, padding, activation)
CASES = {
    "alexnet_conv2": (2, 16, 16, 64, 3, 128, (1, 1), SAME, "relu"),
    "alexnet_conv3": (2, 8, 8, 128, 3, 256, (1, 1), SAME, "relu"),
    "stride2_same_oc72": (2, 12, 11, 64, 5, 72, (2, 2), "SAME", "tanh"),
}


def _case(name, seed):
    B, H, W, C, K, OC, stride, padding, act = CASES[name]
    rng = np.random.default_rng(seed)
    x = bf16(rng.normal(size=(B, H, W, C)))
    w = bf16(rng.normal(size=(K, K, C, OC)) / np.sqrt(K * K * C))
    b = bf16(rng.normal(size=(OC,)) * 0.1)
    assert ck.conv_bf16_route(B, H, W, C, K, K, OC, stride, padding) \
        == "wgmma"
    return x, w, b, dict(stride=stride, padding=padding, activation=act)


def _bf16_gates(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(
        want, np.ndarray) else want
    m = np.abs(want).max()
    d = np.abs(got - want)
    assert d.max() <= ULP7 * m, (d.max(), m)
    assert d.mean() <= MEAN * m, (d.mean(), m)


def _f32_gate(got, want):
    want = np.asarray(want, np.float32)
    m = np.abs(want).max()
    assert np.abs(got - want).max() <= F32_TOL * m, (
        np.abs(got - want).max(), m)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k_walk_matches_jax_pallas_kernel_interpreted(name):
    x, w, b, kw = _case(name, seed=len(name))
    z, y, _ = emulate_conv(x, w, b, **kw)
    act = activations.get(kw["activation"])
    pk.enable(interpret=True, use_conv=True)
    try:
        jb = jhelpers.conv2d_bias_act(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(b, jnp.bfloat16), dilation=(1, 1), **kw)
        # the identity epilogue on f32 copies: the kernel's f32 z
        jz = jhelpers.conv2d_bias_act(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=(1, 1),
            **{**kw, "activation": "identity"})
    finally:
        pk.disable()
    assert jb.dtype == jnp.bfloat16 and jb.shape == y.shape
    _bf16_gates(y, jb)
    _f32_gate(z, jz)
    # act(z) of the f32 sums, against act of JAX's
    _f32_gate(act(torch.from_numpy(z)).numpy(),
              act(torch.from_numpy(np.array(jz))).numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_k_walk_matches_jax_default(name):
    x, w, b, kw = _case(name, seed=3 * len(name))
    z, y, _ = emulate_conv(x, w, b, **kw)
    jy = jhelpers._conv2d_bias_act_default(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=(1, 1),
        **kw)
    jz = jhelpers._conv2d_bias_act_default(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=(1, 1),
        **{**kw, "activation": "identity"})
    _f32_gate(z, jz)
    _bf16_gates(y, bf16(np.asarray(jy)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_k_walk_matches_the_ports_plain_version(name):
    x, w, b, kw = _case(name, seed=5 * len(name))
    _, y, zb = emulate_conv(x, w, b, **kw)
    t = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, w, b)]
    ry, rz = ck.conv2d_bias_act_ref(*t, want_pre=True, **kw)
    assert ry.dtype == torch.bfloat16 and rz.dtype == torch.bfloat16
    _bf16_gates(y, ry.float().numpy())
    _bf16_gates(zb, rz.float().numpy())
    # the wrapper on CPU tensors is the plain version
    wy = ck.conv2d_bias_act(*t, **kw)
    assert torch.equal(wy, ry)
