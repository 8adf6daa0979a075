"""The tensor-core conv kernel's arithmetic, emulated on the CPU.

`ops/csrc/conv2d_bias_act.cu` runs the implicit GEMM of conv + bias + act,
[M, K] x [K, OC] with M = B * OH * OW and K = KH * KW * C in (ki, kj, c)
order, on the tensor cores (`mma.sync` m16n8k8, tf32 in, f32 accumulators)
with the 3xTF32 split: hi = tf32(x) rounded to nearest, ties away, lo =
tf32(x - hi), and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b. No kernel runs
here (no card, no nvcc); this file repeats its arithmetic in numpy, in its
order:

  - K in slices of 32 (zero-padded past K); each slice sums in fresh
    accumulators, which join the running f32 sum in one add;
  - a slice as four 8-wide k-steps, three tf32 products each (the two lo
    terms first); k-step 2i + h of the 16 k's 16i ... 16i + 15 holds k =
    16i + 4t + 2h + {0, 1}, t < 4, as the kernel reads them;
  - the epilogue: bias, then the activation, on the f32 sum.

The emulation is held against the JAX package on the CPU, with inputs made
by numpy from a seed: the conv seam through its Pallas kernel in the
interpreter (`pk.enable(interpret=True, use_conv=True)`) and the XLA default
(`_conv2d_bias_act_default`). Shapes: AlexNet's three convs and LeNet's
conv2 at B <= 2 (K = 27, 576, 1152, 500), and stride-2 SAME with OC = 33.
Tolerance: 2e-6 of max |reference|, fifty times inside the chip gate of
1e-4 x max |plain| (chip_smoke.py phase 5): the references sum in another
order, and the tensor cores truncate inside an mma where numpy rounds. Plain
TF32 (hi only) lands over the chip gate at K = 1152, which is why the kernel
splits.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_conv_tc.py

prints the emulation's errors, 3xTF32 and plain TF32, at K = 1152.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import activations
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

SLICE = 32  # K per slice of the kernel's ring
TOL = 2e-6  # of max |reference|


def tf32(x):
    """float32 rounded to tf32 (10 mantissa bits), to nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def k_steps(K):
    """The k indices of each 8-wide k-step, in the kernel's order: per 16
    k's, k-step 2i + h takes 16i + 4t + 2h + {0, 1} for t < 4."""
    return [np.array([16 * i + 4 * t + 2 * h + e for t in range(4)
                      for e in range(2)])
            for i in range(K // 16) for h in range(2)]


def im2col(x, KH, KW, stride, pads, OH, OW):
    """[M, K] rows of the virtual im2col matrix, K in (ki, kj, c) order,
    zeros where the window reaches the pads."""
    B, H, W, C = x.shape
    xp = np.pad(x, ((0, 0), pads[0], pads[1], (0, 0)))
    sh, sw = stride
    cols = [xp[:, ki:ki + sh * (OH - 1) + 1:sh, kj:kj + sw * (OW - 1) + 1:sw]
            for ki in range(KH) for kj in range(KW)]
    return np.stack(cols, axis=3).reshape(B * OH * OW, KH * KW * C)


def emulate_conv(x, w, b, *, stride, padding, activation, plain=False):
    """act(conv(x, w) + b) [B, OH, OW, OC] as the kernel computes it;
    ``plain`` keeps hi_a hi_b alone."""
    B, H, W, _ = x.shape
    KH, KW, C, OC = w.shape
    OH, OW, pads = ck.conv_geometry(H, W, KH, KW, stride, padding)
    K = KH * KW * C
    Kp = -(-K // SLICE) * SLICE
    a = np.zeros((B * OH * OW, Kp), np.float32)
    a[:, :K] = im2col(x, KH, KW, stride, pads, OH, OW)
    bm = np.zeros((Kp, OC), np.float32)
    bm[:K] = w.reshape(K, OC)
    ah, al = split(a)
    bh, bl = split(bm)
    acc = np.zeros((a.shape[0], OC), np.float32)
    steps = k_steps(Kp)
    for s0 in range(0, len(steps), SLICE // 8):
        part = np.zeros_like(acc)
        for ks in steps[s0:s0 + SLICE // 8]:
            if not plain:
                part = part + al[:, ks] @ bh[ks]
                part = part + ah[:, ks] @ bl[ks]
            part = part + ah[:, ks] @ bh[ks]
        acc = acc + part
    z = torch.from_numpy(acc + b)
    return activations.get(activation)(z).numpy().reshape(B, OH, OW, OC)


def _inputs(B, H, W, C, K, OC, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(K, K, C, OC)) / np.sqrt(K * K * C)).astype(
        np.float32)
    b = (rng.normal(size=(OC,)) * 0.1).astype(np.float32)
    return x, w, b


def rel_err(got, want):
    return float(np.abs(got - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


SAME = ((1, 1), (1, 1))
# (B, H, W, C, K, OC, stride, padding, activation): AlexNet's conv1-3 (K =
# 27, 576, 1152), LeNet's conv2 (K = 500, OC = 50), stride-2 SAME (OC = 33)
CASES = {
    "alexnet_conv1": (2, 32, 32, 3, 3, 64, (1, 1), SAME, "relu"),
    "alexnet_conv2": (2, 16, 16, 64, 3, 128, (1, 1), SAME, "identity"),
    "alexnet_conv3": (2, 8, 8, 128, 3, 256, (1, 1), SAME, "relu"),
    "lenet_conv2": (2, 12, 12, 20, 5, 50, (1, 1), "VALID", "identity"),
    "stride2_same": (1, 13, 11, 8, 5, 33, (2, 2), "SAME", "tanh"),
}


def _case(name, seed):
    B, H, W, C, K, OC, stride, padding, act = CASES[name]
    x, w, b = _inputs(B, H, W, C, K, OC, seed)
    return x, w, b, dict(stride=stride, padding=padding, activation=act)


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_matches_jax_default(name):
    x, w, b, kw = _case(name, seed=len(name))
    got = emulate_conv(x, w, b, **kw)
    want = jhelpers._conv2d_bias_act_default(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=(1, 1), **kw)
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL, rel_err(got, want)


@pytest.mark.parametrize("name", ["alexnet_conv1", "alexnet_conv3",
                                  "lenet_conv2", "stride2_same"])
def test_3xtf32_matches_jax_pallas_kernel_interpreted(name):
    x, w, b, kw = _case(name, seed=7 * len(name))
    got = emulate_conv(x, w, b, **kw)
    pk.enable(interpret=True, use_conv=True)
    try:
        want = jhelpers.conv2d_bias_act(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), dilation=(1, 1), **kw)
    finally:
        pk.disable()
    assert rel_err(got, want) <= TOL, rel_err(got, want)


def test_plain_tf32_misses_the_chip_gate_at_k_1152():
    """hi alone rounds each product's inputs to 11 significant bits: at
    AlexNet's conv3 (K = 1152) the error lands over chip_smoke.py's 1e-4 x
    max |plain| and far over the split's, so the kernel splits."""
    x, w, b, kw = _case("alexnet_conv3", seed=3)
    want = jhelpers._conv2d_bias_act_default(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=(1, 1), **kw)
    split_err = rel_err(emulate_conv(x, w, b, **kw), want)
    plain_err = rel_err(emulate_conv(x, w, b, plain=True, **kw), want)
    assert plain_err > 1e-4 and plain_err > 50 * split_err, (plain_err,
                                                             split_err)


def test_k_steps_cover_each_slice_once():
    steps = k_steps(64)
    assert len(steps) == 8
    for s0 in range(0, 8, 4):  # each slice of 32 is its four k-steps
        ks = np.sort(np.concatenate(steps[s0:s0 + 4]))
        np.testing.assert_array_equal(ks, np.arange(32 * s0 // 4,
                                                    32 * s0 // 4 + 32))
    # the first k-step pairs columns (t, t + 4) with k = 4t and 4t + 1
    np.testing.assert_array_equal(steps[0], [0, 1, 4, 5, 8, 9, 12, 13])


def test_im2col_matches_the_plain_conv():
    """The emulation's im2col times w is the port's plain conv (f64, so
    only the layout is tested)."""
    x, w, _, kw = _case("stride2_same", seed=11)
    B, H, W, _ = x.shape
    KH, KW, C, OC = w.shape
    OH, OW, pads = ck.conv_geometry(H, W, KH, KW, kw["stride"],
                                    kw["padding"])
    cols = im2col(x.astype(np.float64), KH, KW, kw["stride"], pads, OH, OW)
    got = (cols @ w.astype(np.float64).reshape(-1, OC)).reshape(B, OH, OW,
                                                                OC)
    want = ck.conv2d_ref(torch.from_numpy(x).double(),
                         torch.from_numpy(w).double(), stride=kw["stride"],
                         padding=kw["padding"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


if __name__ == "__main__":
    x, w, b, kw = _case("alexnet_conv3", seed=3)
    want = jhelpers._conv2d_bias_act_default(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=(1, 1), **kw)
    for plain in (False, True):
        err = rel_err(emulate_conv(x, w, b, plain=plain, **kw), want)
        print(f"{'plain TF32' if plain else '3xTF32'} conv [2, 8, 8, 128] "
              f"-> 256, 3x3 SAME (K = 1152): max|diff|/max|ref| {err!r}")
