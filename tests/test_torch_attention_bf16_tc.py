"""The bf16 attention forward kernels' arithmetic, emulated on the CPU.

`ops/csrc/flash_attention_fwd.cu` and `splash_attention_fwd.cu` at bf16
run over `attn_fwd_bf16.cuh`: s = q k^T on wgmma with f32 accumulators
(bf16 products are exact in f32, so s is an f32 sum of exact products),
one 128-row query block at a time, keys in 128-key tiles, the online
softmax in f32 in log2 units (running max m of the raw scores, p =
exp2(fma(s, c, -m c)) with c = scale log2(e) for flash and log2(e) for
splash, sum l of the unrounded p, the output scaled by exp2((m - m_new) c)
before each tile's p v joins it), o = acc / l rounded to bf16, lse = m
scale + log(l) in natural log. What differs between the two walks is p v:
flash rounds p (relative to the running max of the tiles so far) to bf16
for one product, as the library's `p.astype(v.dtype)`; splash takes p as
bf16(p) + bf16(p - bf16(p)) in two products, which is p in f32 to about
2^-17. No kernel runs here (no card, no nvcc); this file repeats that
arithmetic in torch, in the kernels' tile order (the FMA emulated in
float64 and rounded once to f32), and holds it against the JAX package's
splash kernel at bf16 in the Pallas interpreter and against the port's
plain versions (the phase-20 chip gate's reference), on inputs made with
numpy from a seed.

Gates, over max |reference| of o: splash 2^-7 and flash 2^-6 against the
interpreted JAX splash kernel (flash rounds p, the splash library does
not: see tests/test_torch_bf16_attention.py), both 2^-7 against their own
plain versions (the chip gate), mean |diff| within 1e-3; lse within 1e-4.
The emulation of flash's per-tile rounding also stays within the chip gate
of the plain version's rounding against the row's final max, which is
what phase 20 of chip_smoke.py holds on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import splash_mask

ROWS, KEYS = 128, 128  # query rows per CUDA block, keys per K/V tile
LOG2E = np.float32(1.4426950408889634)
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(x):
    return x.to(BF).float()


def emulate_fwd_bf16(q, k, v, *, flash, causal, scale=None):
    """The bf16 forward core on q, k, v [L, D] bf16 (one head): o [L, D]
    bf16 and lse [L] f32, tile by tile as the kernel walks them. ``flash``:
    the scale folded into the exponent's FMA, -inf for masked scores, p
    rounded for p v; splash: q pre-scaled by the caller, the library's mask
    value, p split in two."""
    L, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    mask_value = float(np.float32(splash_mask.DEFAULT_MASK_VALUE))
    neg = -float("inf") if flash else mask_value
    # c takes raw scores to log2 units; lse_scale takes m to natural units
    c = np.float32(scale) * LOG2E if flash else LOG2E
    lse_scale = np.float32(scale) if flash else np.float32(1.0)
    c32 = torch.tensor(c, dtype=torch.float32)
    o = torch.empty(L, D)
    lse = torch.empty(L)
    for q0 in range(0, L, ROWS):
        rows = torch.arange(q0, min(q0 + ROWS, L))
        m = torch.full((len(rows), 1), neg)
        l = torch.zeros(len(rows), 1)
        acc = torch.zeros(len(rows), D)
        last = min(L, q0 + ROWS) if causal else L
        for k0 in range(0, last, KEYS):
            cols = torch.arange(k0, min(k0 + KEYS, L))
            s = qf[rows] @ kf[cols].T
            if causal:
                s = torch.where(cols[None, :] <= rows[:, None], s,
                                torch.tensor(neg))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_use = torch.where(m_new == -float("inf"), 0.0, m_new) \
                if flash else m_new
            mc = m_use * c32
            alpha = torch.exp2((m - m_use) * c32)
            # fma(s, c, -m c): one rounding of the exact value
            p = torch.exp2((s.double() * float(c) - mc.double()).float())
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = _bf(p)
            pv = hi @ vf[cols] if flash else \
                (_bf(p - hi) @ vf[cols]) + hi @ vf[cols]
            acc = acc * alpha + pv
            m = m_new
        o[rows] = acc / l
        lse[rows] = (m * torch.tensor(lse_scale) + torch.log(l))[:, 0]
    return o.to(BF), lse


def _inputs(L, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, L, 1, D)).astype(
        np.float32)).to(BF) for _ in range(3)]


def _jax_splash_o(q, k, v, causal):
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        o = pk._splash_call(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                              for t in (q, k, v)), causal, None)
    finally:
        pk._INTERPRET = old
    return torch.from_numpy(np.array(o.astype(jnp.float32)))


def _err(a, b):
    d, m = (a.float() - b.float()).abs(), b.float().abs().max()
    return float(d.max() / m), float(d.mean() / m)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L,D", [(256, 64), (384, 128)])
def test_bf16_forward_emulation_matches_jax_and_the_plain_versions(L, D,
                                                                   causal):
    q, k, v = _inputs(L, D, seed=L + D + causal)
    scale = D ** -0.5
    want = _jax_splash_o(q, k, v, causal)[0, :, 0]
    # flash: the kernel's walk on unscaled q, the scale on s
    fo, flse = emulate_fwd_bf16(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                                flash=True, causal=causal, scale=scale)
    po, plse = ck.flash_attention_fwd_ref(q, k, v, causal=causal,
                                          scale=scale)
    for ref, gate in ((want, 2.0 ** -6), (po[0, :, 0], 2.0 ** -7)):
        mx, mean = _err(fo, ref)
        assert mx <= gate and mean <= 1e-3, (mx, mean)
    assert float((flse - plse[0, 0]).abs().max()) <= 1e-4
    # splash: q pre-scaled in bf16, as `_splash` folds it
    qs = q * torch.full((), scale, dtype=BF)
    so, slse = emulate_fwd_bf16(qs[0, :, 0], k[0, :, 0], v[0, :, 0],
                                flash=False, causal=causal)
    po, plse = ck.splash_attention_fwd_ref(
        qs, k, v, splash_mask.splash_tables(L, 1, causal))
    for ref in (want, po[0, :, 0]):
        mx, mean = _err(so, ref)
        assert mx <= 2.0 ** -7 and mean <= 1e-3, (mx, mean)
    assert float((slse - plse[0, 0]).abs().max()) <= 1e-4


def test_splash_split_keeps_p_in_f32_and_flash_rounding_does_not():
    """p = bf16(p) + bf16(p - bf16(p)) is p to about 2^-17 relative; p
    rounded once is off by up to 2^-9."""
    gen = torch.Generator().manual_seed(0)
    p = torch.rand(4096, generator=gen) * 0.999 + 1e-3
    hi = _bf(p)
    split = hi + _bf(p - hi)
    assert float(((split - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((hi - p).abs() / p).max()) > 2.0 ** -12
