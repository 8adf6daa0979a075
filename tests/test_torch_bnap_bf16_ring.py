"""Port parity: the bf16 BN+act+pool backward's ring route (the persistent
bnap_sums and bnap_dx kernels fed by bulk copies through an mbarrier ring,
ops/csrc/bnap_common.cuh), its plan, its order of sums and its route.

The CUDA kernels cannot run here, so a numpy float32 emulation replays the
sums kernel's walk (cuda_kernels.bnap_bf16_plan) and order of sums: block b
takes items b, b + grid, ... (wn pooled columns of one pooled row each);
consumer (slot, lane) adds the item's columns slot, slot + P, ... window
element by window element (db += g_z, dg = fma(g_z, x_hat, dg)); the block
adds its slots in order; the last block of each group adds the group's
partial rows in order, and the last group the group rows. The recompute is
bnap_common.cuh's at bf16: x and g widened to f32, every step rounded to
f32, the activations rounded to bf16 (to nearest even) before the maximum
and the tie count, a 3-way tie's share RN(g / 3). The emulation is held against the JAX
`_bnap_sums_kernel` at bf16, run by the Pallas interpreter through the
custom VJP of `_get_bnap_fn`, on the same numpy inputs and the same batch
stats, within 1e-5 of max |reference| (f32 sums in another order). dx needs
no emulation: the ring kernel computes each element as the plain version
does (bnap_dx_ref), which the bf16 CNN tests hold against JAX.
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
# AlexNet-CIFAR10's three BN+pool channel counts at B = 2; the edge set of
# the card's check with C % 8 == 0 (4-way ties, sigmoid, tanh at C = 40,
# identity with ties); rows wider than one stage (16, 3 and 5 items a
# row, C = 1024 a column an item); more items than the grid's blocks
SHAPES = [((2, 32, 32, 64), "relu", False),
          ((2, 16, 16, 128), "relu", False),
          ((2, 8, 8, 256), "relu", False),
          ((2, 4, 4, 8), "relu", True),
          ((1, 4, 4, 8), "sigmoid", False),
          ((3, 6, 10, 40), "tanh", False),
          ((4, 8, 6, 16), "identity", True),
          ((2, 4, 64, 512), "relu", False),
          ((1, 2, 6, 1024), "tanh", False),
          ((3, 4, 40, 256), "sigmoid", False),
          ((400, 4, 4, 64), "relu", False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """f32 array rounded to bf16 (to nearest even) and back to f32."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(
        0xFFFF0000)
    return r.view(np.float32)


def _inputs(shape, tied, seed):
    """x and g rounded to bf16 (held as f32), gamma and beta f32."""
    B, H, W, C = shape
    rng = np.random.default_rng(seed)
    if tied:  # every 2x2 window holds four equal values: a 4-way tie
        x = np.repeat(np.repeat(rng.normal(size=(B, H // 2, W // 2, C)),
                                2, axis=1), 2, axis=2)
    else:
        x = rng.normal(size=shape)
    gamma = rng.uniform(0.5, 1.5, size=C).astype(np.float32)
    beta = (rng.normal(size=C) * 0.1).astype(np.float32)
    gp = rng.normal(size=(B, H // 2, W // 2, C))
    return _bf16(x.astype(np.float32)), gamma, beta, _bf16(
        gp.astype(np.float32))


@pytest.fixture(scope="module")
def jax_sums():
    """{case index: (p [4, C], (d gamma, d beta))} of the JAX kernel at
    bf16, run once per shape by the Pallas interpreter."""
    pk._INTERPRET = True
    out = {}
    try:
        for i, (shape, act, tied) in enumerate(SHAPES):
            x, gamma, beta, gp = _inputs(shape, tied, seed=100 + i)
            jx = jnp.asarray(x).astype(jnp.bfloat16)
            fn = pk._get_bnap_fn(EPS, act, "hwbc")
            _, vjp = jax.vjp(fn, jx, jnp.asarray(gamma), jnp.asarray(beta))
            C = shape[-1]
            zeros = jnp.zeros((C,), jnp.float32)
            _, dgam, dbet = vjp((jnp.asarray(gp).astype(jnp.bfloat16), zeros,
                                 zeros))
            mean, var = jhelpers.bn_batch_stats(jx)
            p = np.stack([np.asarray(mean), np.asarray(jax.lax.rsqrt(var + EPS)),
                          gamma, beta]).astype(np.float32)
            out[i] = (p, (np.asarray(dgam, np.float32),
                          np.asarray(dbet, np.float32)))
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
    """x_hat and g_z [R, W/2, 4, C] in window order, as bnap_common.cuh's
    `bnap_recompute_vals<true>` computes them from x and g widened."""
    B, H, W, C = x.shape
    R, W2 = B * H // 2, W // 2
    xv = x.reshape(R, 2, W2, 2, C).transpose(0, 2, 1, 3, 4).reshape(
        R, W2, 4, C)
    xh = (xv - p[0]) * p[1]
    z = xh * p[2] + p[3]
    a, da = _act(z, act)
    a = _bf16(a)
    eq = a == a.max(axis=2, keepdims=True)
    cnt = eq.sum(axis=2, keepdims=True).astype(np.float32)
    share = g.reshape(R, W2, 1, C) / cnt
    gz = np.where(eq, share, np.float32(0)) * da
    return xh.astype(np.float32), gz.astype(np.float32)


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _fold(rows):
    """Rows [n, 2, C] added in order from 0 (csrc ring_fold and the
    block's fold over its slots)."""
    t = np.zeros(rows.shape[1:], np.float32)
    for r in rows:
        t = t + r
    return t


def emulate_ring_sums(xh, gz, plan):
    """(d gamma, d beta) as the ring kernel sums them under ``plan``."""
    R, W2, _, C = xh.shape
    wn, nch, grid, P = (plan[k] for k in ("wn", "nchunks", "grid", "slots"))
    part = np.zeros((grid, 2, C), np.float32)

    def add(sums, n, r, at):
        for j in range(4):
            sums[:n, 0] = sums[:n, 0] + gz[r, at, j]
            sums[:n, 1] = _fma(gz[r, at, j], xh[r, at, j], sums[:n, 1])

    for b in range(grid):
        sums = np.zeros((P, 2, C), np.float32)  # slot's (db, dg)
        for i in range(b, plan["items"], grid):
            r, k = divmod(i, nch)
            w0 = k * wn
            cols = min(wn, W2 - w0)
            for c0 in range(0, cols, P):  # slot s takes column c0 + s
                n = min(P, cols - c0)
                add(sums, n, r, slice(w0 + c0, w0 + c0 + n))
        part[b] = _fold(sums)
    G = plan["group"]
    gpart = np.stack([_fold(part[i * G:(i + 1) * G])
                      for i in range(plan["ngroups"])])
    db, dg = _fold(gpart)
    return dg, db


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_emulated_ring_sums_match_jax_kernel(jax_sums, case):
    """The ring kernel's order of sums under its plan, against the
    interpreted JAX kernel at bf16; and the port's plain version, which
    CPU tensors run, on the same p."""
    shape, act, tied = SHAPES[case]
    x, _, _, gp = _inputs(shape, tied, seed=100 + case)
    p, want = jax_sums[case]
    B, H, W, C = shape
    assert ck.bnap_bf16_route(B, H, W, C) == "ring"
    plan = ck.bnap_bf16_plan(B, H, W, C)
    got = emulate_ring_sums(*_recompute(x, gp, p, act), plan)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    ref = ck.bnap_sums(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(gp).to(torch.bfloat16),
                       torch.from_numpy(p), activation=act)
    for a, b in zip(ref, want):
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("shape", [(7, 130, 8, 16), (397, 2, 4, 8),
                                   (5, 2, 18, 8), (1, 14, 2, 1024),
                                   (3, 2, 64, 1024), (263, 4, 6, 40),
                                   (9, 2, 2100, 8), (3, 2, 60, 40),
                                   (1, 2, 2, 8), (801, 2, 2, 24)])
def test_ring_plan_covers_every_position_once(shape):
    """Sums of ones count every window element exactly once, whatever the
    plan's items, chunks (a last chunk narrower than wn), slots and
    groups, with item counts that are not a multiple of the grid."""
    B, H, W, C = shape
    plan = ck.bnap_bf16_plan(B, H, W, C)
    lim = ck.bnap_bf16_route_limits()
    assert 2 * plan["wn"] * C <= lim["kRingRowCap"]
    assert plan["nchunks"] * plan["wn"] >= W // 2 > (
        plan["nchunks"] - 1) * plan["wn"]
    assert plan["grid"] == min(plan["items"],
                               lim["kRingBlocksPerSm"] * ck._H100_SMS)
    assert plan["grid"] * plan["per_block"] >= plan["items"] > plan[
        "grid"] * (plan["per_block"] - 1)
    assert plan["lanes"] * plan["slots"] <= lim["kRingConsumers"]
    assert plan["group"] * plan["ngroups"] >= plan["grid"]
    ones = np.ones((B * H // 2, W // 2, 4, C), np.float32)
    dg, db = emulate_ring_sums(ones, ones, plan)
    assert (db == B * H * W).all() and (dg == B * H * W).all()


def test_ring_plan_at_alexnet_shapes_is_one_wave_of_whole_rows():
    """At AlexNet-CIFAR10's three shapes (B = 512) an item is a whole
    pooled row (8 KiB of x, 2 KiB of g), every consumer takes one window
    of it, and the grid is one wave of kRingBlocksPerSm blocks on every
    SM, each block per_block items or one fewer."""
    lim = ck.bnap_bf16_route_limits()
    for H, C in ((32, 64), (16, 128), (8, 256)):
        plan = ck.bnap_bf16_plan(512, H, H, C)
        assert plan["wn"] == H // 2 and plan["nchunks"] == 1
        assert 2 * 2 * plan["wn"] * C * 2 == 8192
        assert plan["lanes"] * plan["slots"] == lim["kRingConsumers"]
        assert plan["slots"] == plan["wn"]
        assert plan["items"] == 512 * H // 2
        assert plan["grid"] == lim["kRingBlocksPerSm"] * ck._H100_SMS
        assert 0 <= plan["grid"] * plan["per_block"] - plan["items"] < plan[
            "grid"]


def test_route_limits_are_the_headers():
    """The limits the route and the plan read are the constants of
    csrc/bnap_common.cuh, one table for Python and the kernels."""
    lim = ck.bnap_bf16_route_limits()
    assert lim["kRingC"] == 8 and lim["kRingAlign"] == 16
    assert lim["kRingMaxC"] == 1024 and lim["kRingMaxElems"] == 2 ** 31 - 1
    assert lim["kRingLaneC"] == 8
    assert lim["kRingMaxC"] <= lim["kRingLaneC"] * lim["kRingConsumers"]
    assert 2 * lim["kRingMaxC"] <= lim["kRingRowCap"]


@pytest.mark.parametrize("args,route", [
    ((2, 4, 4, 8), "ring"), ((2, 4, 4, 6), "lanes"),
    ((2, 4, 4, 12), "lanes"), ((2, 4, 4, 1024), "ring"),
    ((2, 4, 4, 1032), "lanes"), ((3, 6, 10, 40), "ring"),
    ((2, 4, 4, 8, 8), "lanes"), ((2, 4, 4, 8, 16, 24), "lanes"),
    ((2, 4, 4, 8, 16, 32, 40), "lanes"), ((2, 4, 4, 8, 48, 64, 4096), "ring"),
    ((67108863, 2, 2, 8), "ring"), ((67108864, 2, 2, 8), "lanes"),
    ((1, 2, 2 ** 20, 1024), "lanes"), ((1, 2, 2 ** 20 - 2, 1024), "ring")])
def test_bnap_bf16_route_at_its_boundaries(args, route):
    """C = 8 against 6 and 12, C = 1024 against 1032; x, g or dx 8 bytes
    off 16; B H W C = 2^31 - 32 against 2^31, and 2^31 - 4096 against 2^31
    at C = 1024 (every offset an int)."""
    assert ck.bnap_bf16_route(*args) == route


def test_route_of_a_misaligned_view():
    """A contiguous view 8 bytes into its storage takes the lane kernels;
    its aligned copy the ring."""
    buf = torch.zeros(4 + 2 * 4 * 4 * 8, dtype=torch.bfloat16)
    x = buf[4:].view(2, 4, 4, 8)
    g = torch.zeros((2, 2, 2, 8), dtype=torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    assert ck.bnap_bf16_route(*x.shape, x.data_ptr(), g.data_ptr()) == "lanes"
    xc = x.clone()
    assert ck.bnap_bf16_route(*xc.shape, xc.data_ptr(), g.data_ptr()) == "ring"
