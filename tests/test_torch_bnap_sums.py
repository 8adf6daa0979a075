"""Port parity: the bnap_sums kernel's partition and summation order.

The CUDA kernel (ops/csrc/bnap_sums.cu) cannot run here, so a numpy float32
emulation replays its exact partition (cuda_kernels.bnap_sums_plan) and
order of sums: each thread's pooled positions in kernel order, window
element by window element (db += g_z, dg = fma(g_z, x_hat, dg)); the block's
thread rows in order; the partial rows by groups, strided over thread rows
and then in order; the group rows the same way. The emulation is held
against the JAX `_bnap_sums_kernel` run by the Pallas interpreter, through
the custom VJP of `_get_bnap_fn` (its d gamma and d beta), on the same numpy
inputs and the same batch stats, within 1e-5 of max |reference| (f32 sums
over up to 2048 window positions per channel in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

EPS = 1e-5
# AlexNet-CIFAR10's three BN+pool channel counts at B = 2, then the edge
# set of the card's check (4-way ties, sigmoid, tanh at C = 40, identity
# with ties), C = 6, whose lanes are one channel wide, and two batches
# large enough that a block owns several pooled rows, each thread one
# column of each: 2 (the two-row loop alone) and 3 (the loop, then the odd
# row)
SHAPES = [((2, 32, 32, 64), "relu", False),
          ((2, 16, 16, 128), "relu", False),
          ((2, 8, 8, 256), "relu", False),
          ((2, 4, 4, 8), "relu", True),
          ((1, 4, 4, 8), "sigmoid", False),
          ((3, 6, 10, 40), "tanh", False),
          ((4, 8, 6, 16), "identity", True),
          ((2, 4, 6, 6), "relu", False),
          ((528, 2, 32, 64), "relu", False),
          ((600, 2, 32, 64), "tanh", False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, tied, seed):
    B, H, W, C = shape
    rng = np.random.default_rng(seed)
    if tied:  # every 2x2 window holds four equal values: a 4-way tie
        x = np.repeat(np.repeat(rng.normal(size=(B, H // 2, W // 2, C)),
                                2, axis=1), 2, axis=2)
    else:
        x = rng.normal(size=shape)
    gamma = rng.uniform(0.5, 1.5, size=C)
    beta = rng.normal(size=C) * 0.1
    gp = rng.normal(size=(B, H // 2, W // 2, C))
    return [a.astype(np.float32) for a in (x, gamma, beta, gp)]


@pytest.fixture(scope="module")
def jax_sums():
    """{case index: (p [4, C], (d gamma, d beta))} of the JAX kernel, run
    once per shape by the Pallas interpreter."""
    pk._INTERPRET = True
    out = {}
    try:
        for i, (shape, act, tied) in enumerate(SHAPES):
            x, gamma, beta, gp = _inputs(shape, tied, seed=i)
            fn = pk._get_bnap_fn(EPS, act, "hwbc")
            _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(gamma),
                             jnp.asarray(beta))
            C = shape[-1]
            zeros = jnp.zeros((C,), jnp.float32)
            _, dgam, dbet = vjp((jnp.asarray(gp), zeros, zeros))
            mean, var = jhelpers.bn_batch_stats(jnp.asarray(x))
            p = np.stack([np.asarray(mean), np.asarray(jax.lax.rsqrt(var + EPS)),
                          gamma, beta]).astype(np.float32)
            out[i] = (p, (np.asarray(dgam), np.asarray(dbet)))
    finally:
        pk._INTERPRET = False
    return out


# -- the emulation -------------------------------------------------------------

def _act(z, act):
    """(act(z), act'(z)) in f32, as csrc/activations.cuh computes them."""
    one = np.float32(1)
    if act == "relu":
        return np.maximum(z, np.float32(0)), (z > 0).astype(np.float32)
    if act == "tanh":
        t = np.tanh(z)
        return t, one - t * t
    if act == "sigmoid":
        s = one / (one + np.exp(-z))
        return s, s * (one - s)
    return z, np.ones_like(z)


def _recompute(x, g, p, act):
    """x_hat and g_z [R, W/2, 4, C] in window order, every step rounded to
    f32 as bnap_common.cuh's `bnap_recompute_vals` rounds it."""
    B, H, W, C = x.shape
    R, W2 = B * H // 2, W // 2
    xv = x.reshape(R, 2, W2, 2, C).transpose(0, 2, 1, 3, 4).reshape(
        R, W2, 4, C)
    xh = (xv - p[0]) * p[1]
    z = xh * p[2] + p[3]
    a, da = _act(z, act)
    eq = a == a.max(axis=2, keepdims=True)
    cnt = eq.sum(axis=2, keepdims=True).astype(np.float32)
    share = g.reshape(R, W2, 1, C) / cnt
    gz = np.where(eq, share, np.float32(0)) * da
    return xh.astype(np.float32), gz.astype(np.float32)


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _block_sum(rows):
    """A block's thread rows [pl, 2, C] added in order (csrc block_sum)."""
    t = np.zeros(rows.shape[1:], np.float32)
    for r in rows:
        t = t + r
    return t


def _fold(rows, pl):
    """Partial rows [n, 2, C]: thread row ty adds rows ty, ty + pl, ... in
    order (csrc fold_rows), then the block adds its thread rows."""
    threads = np.zeros((pl,) + rows.shape[1:], np.float32)
    for ty in range(pl):
        for q in range(ty, len(rows), pl):
            threads[ty] = threads[ty] + rows[q]
    return _block_sum(threads)


def emulate_sums(xh, gz, plan):
    """(d gamma, d beta) as the kernel sums them under ``plan``."""
    R, W2, _, C = xh.shape
    pl, pwn, rl, rpb = plan["pl"], plan["pwn"], plan["rl"], plan["rpb"]
    part = np.zeros((plan["rblocks"], 2, C), np.float32)
    for by in range(plan["rblocks"]):
        r_end = min(R, (by + 1) * rpb)
        threads = np.zeros((pl, 2, C), np.float32)
        for ty in range(pl):
            ry, pwl = divmod(ty, pwn)
            if ry >= rl:
                continue
            sb = np.zeros(C, np.float32)
            sg = np.zeros(C, np.float32)

            def add(r, pw):
                nonlocal sb, sg
                for j in range(4):
                    sb = sb + gz[r, pw, j]
                    sg = _fma(gz[r, pw, j], xh[r, pw, j], sg)
            r = by * rpb + ry
            while r + rl < r_end:
                for pw in range(pwl, W2, pwn):
                    add(r, pw)
                    add(r + rl, pw)
                r += 2 * rl
            if r < r_end:
                for pw in range(pwl, W2, pwn):
                    add(r, pw)
            threads[ty] = sb, sg
        part[by] = _block_sum(threads)
    G = plan["group"]
    gpart = np.stack([_fold(part[i * G:(i + 1) * G], pl)
                      for i in range(plan["ngroups"])])
    db, dg = _fold(gpart, pl)
    return dg, db


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_emulated_kernel_matches_jax_kernel(jax_sums, case):
    """The kernel's order of sums under its plan, against the interpreted
    JAX kernel."""
    shape, act, tied = SHAPES[case]
    x, _, _, gp = _inputs(shape, tied, seed=case)
    p, want = jax_sums[case]
    B, H, W, C = shape
    vec = 4 if C % 4 == 0 else 1
    xh, gz = _recompute(x, gp, p, act)
    plan = ck.bnap_sums_plan(B, H, W, C, vec)
    if B > 500:
        assert plan["rl"] == 1 and plan["rpb"] == (2 if B == 528 else 3)
    got = emulate_sums(xh, gz, plan)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    # the port's plain version, which CPU tensors run, on the same p
    ref = ck.bnap_sums(torch.from_numpy(x), torch.from_numpy(gp),
                       torch.from_numpy(p), activation=act)
    for a, b in zip(ref, want):
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (3, 6, 10, 40),
                                   (5, 2, 18, 12), (1, 14, 2, 3),
                                   (7, 6, 4, 260), (2, 4, 4, 1024),
                                   (700, 2, 6, 3), (263, 4, 2, 20),
                                   (300, 2, 4, 1028)])
def test_plan_covers_every_position_once(shape):
    """Sums of ones count every window element exactly once, whatever
    the plan's lanes, rows, groups and channel blocks."""
    B, H, W, C = shape
    for vec in ((4, 1) if C % 4 == 0 else (1,)):
        plan = ck.bnap_sums_plan(B, H, W, C, vec)
        assert plan["cl"] * plan["pl"] <= ck._BNAP_THREADS
        assert plan["rl"] * plan["pwn"] <= plan["pl"]
        assert plan["cblocks"] * plan["cl"] * vec >= C
        assert plan["rblocks"] * plan["rpb"] >= B * H // 2
        assert (plan["rblocks"] - 1) * plan["rpb"] < B * H // 2
        ones = np.ones((B * H // 2, W // 2, 4, C), np.float32)
        dg, db = emulate_sums(ones, ones, plan)
        assert (db == B * H * W).all() and (dg == B * H * W).all()


def test_plan_at_alexnet_shapes_is_one_wave_of_whole_rows():
    """At AlexNet-CIFAR10's three shapes (B = 512) the grid is one wave of
    equal blocks at two blocks per SM, a thread takes one pooled column of
    every row of its block, and the partial rows go in about sqrt-sized
    groups."""
    for H, C in ((32, 64), (16, 128), (8, 256)):
        plan = ck.bnap_sums_plan(512, H, H, C, 4)
        assert plan["cl"] * plan["pl"] == ck._BNAP_THREADS
        assert plan["pwn"] == H // 2 and plan["rl"] == 1
        assert plan["cblocks"] * plan["rblocks"] <= ck._BNAP_TARGET_BLOCKS
        assert plan["rblocks"] * plan["rpb"] == 512 * H // 2
        assert plan["group"] == plan["ngroups"] == 16
