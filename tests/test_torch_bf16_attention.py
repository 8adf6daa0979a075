"""Port parity: the attention kernels' plain versions at bf16.

The six plain versions (flash and splash: forward, dK/dV, dQ) at bf16 make
the roundings of the library kernel each CUDA kernel replaces: the scores
and softmax statistics in f32 from the bf16 operands; flash rounds p to
bf16 before p v, splash keeps p in f32; both round p and ds to bf16 before
the backward products; o, dq, dk and dv are summed in f32 and written in
bf16, lse stays f32, di is f32. Here they run under the attention seam's
autograd Function on CPU tensors (what the bf16 kernels compute, on the
card) and are held against the JAX package's `_splash_call` at bf16 in the
Pallas interpreter, forward and `jax.vjp`, with K/V of one KV head
repeated to the query heads before the seam (GQA) on the D = 128 cases.
Inputs are made with numpy from a seed.

Tolerances, over each output's max |JAX value|:
  - splash: max |diff| <= 2^-7 (one bf16 ulp of the largest element: the
    two sum in f32 in other orders, so an output's rounding may flip) and
    mean |diff| <= 1e-3 (a wrong rounding rule would move the mean);
  - flash: max |diff| <= 2^-6 (two ulps: flash rounds p to bf16, which the
    interpreted splash kernel does not; that rounding alone moves o by
    about 6.6e-3 of max |o| at the max) and the same mean gate;
  - lse: within 1e-4 of the f64 log-sum-exp of the bf16 inputs' scores.
The f32 plain versions are held bit for bit against the formulas they had
before their bf16 paths were added.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers, splash_mask

BF = torch.bfloat16
ULP7, ULP6, MEAN, LSE_ABS = 2.0 ** -7, 2.0 ** -6, 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """numpy f32 -> the bf16 values, as f32 numpy (what both sides see)."""
    return torch.from_numpy(a).to(BF).float().numpy()


def _inputs(L, D, gqa, seed, B=1, H=2):
    """q [B, L, H, D], k and v [B, L, 1 | H, D], w (the cotangent of o)
    [B, L, H, D], all bf16-exact f32 numpy."""
    rng = np.random.default_rng(seed)
    hkv = 1 if gqa else H
    return (_bf16(rng.normal(size=(B, L, H, D)).astype(np.float32)),
            _bf16(rng.normal(size=(B, L, hkv, D)).astype(np.float32)),
            _bf16(rng.normal(size=(B, L, hkv, D)).astype(np.float32)),
            _bf16(rng.normal(size=(B, L, H, D)).astype(np.float32)))


def _jax_splash(q, k, v, w, causal):
    """o and (dq, dk, dv) of the JAX splash kernel at bf16, interpreted;
    K/V repeated to q's heads inside, so dk, dv are of the compact K/V."""
    H = q.shape[2]
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        def f(q, k, v):
            rep = H // k.shape[2]
            return pk._splash_call(q, jnp.repeat(k, rep, axis=2),
                                   jnp.repeat(v, rep, axis=2), causal, None)
        o, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.bfloat16)
                              for a in (q, k, v)))
        grads = vjp(jnp.asarray(w, jnp.bfloat16))
    finally:
        pk._INTERPRET = old
    return ([np.asarray(o.astype(jnp.float32))]
            + [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(fn, q, k, v, w, causal):
    """o and (dq, dk, dv) of the port's seam Function ``fn`` on bf16 CPU
    tensors, K/V repeated to q's heads before the seam."""
    H = q.shape[2]
    ins = [torch.from_numpy(a).to(BF).requires_grad_(True) for a in (q, k, v)]
    rep = H // ins[1].shape[2]
    n0 = dict(ck.LAUNCHES)
    o = fn(ins[0], ins[1].repeat_interleave(rep, dim=2),
           ins[2].repeat_interleave(rep, dim=2), causal=causal)
    o.backward(torch.from_numpy(w).to(BF))
    assert ck.LAUNCHES == n0  # CPU tensors run the plain versions
    outs = [o] + [t.grad for t in ins]
    assert all(t.dtype == BF for t in outs)
    return [t.detach().float().numpy() for t in outs]


def _flash_plain(q, k, v, *, causal):
    return helpers._flash(q, k, v, causal, None, ck.flash_attention_fwd_ref,
                          ck.flash_attention_bwd_dkv_ref,
                          ck.flash_attention_bwd_dq_ref)


def _errs(got, want):
    """[(max |diff| / max |want|, mean |diff| / max |want|)] of o, dq, dk,
    dv."""
    out = []
    for g, r in zip(got, want):
        d, m = np.abs(g - r), np.abs(r).max()
        out.append((float(d.max() / m), float(d.mean() / m)))
    return out


CASES = [(256, 64, False), (384, 64, False), (256, 128, True),
         (384, 128, True)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L,D,gqa", CASES,
                         ids=[f"L{L}-D{D}{'-gqa' if g else ''}"
                              for L, D, g in CASES])
def test_bf16_plain_versions_match_jax_splash_interpreted(L, D, gqa, causal):
    q, k, v, w = _inputs(L, D, gqa, seed=L + D + causal)
    want = _jax_splash(q, k, v, w, causal)
    for fn, gate in ((helpers.splash_attention_plain, ULP7),
                     (_flash_plain, ULP6)):
        errs = _errs(_port(fn, q, k, v, w, causal), want)
        for name, (mx, mean) in zip(("o", "dq", "dk", "dv"), errs):
            assert mx <= gate, (fn.__name__, name, mx)
            assert mean <= MEAN, (fn.__name__, name, mean)


@pytest.mark.parametrize("family", ["flash", "splash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_lse_is_f32_logsumexp_of_the_scores(family, causal):
    q, k, v, _ = _inputs(256, 64, False, seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(BF) for a in (q, k, v))
    scale = 64 ** -0.5
    if family == "flash":
        o, lse = ck.flash_attention_fwd(tq, tk, tv, causal=causal,
                                        scale=scale)
        qs = q.astype(np.float64) * scale
    else:
        qs_t = tq * torch.full((), scale, dtype=BF)
        o, lse = ck.splash_attention_fwd(
            qs_t, tk, tv, splash_mask.splash_tables(256, 2, causal))
        qs = qs_t.float().numpy().astype(np.float64)
    assert o.dtype == BF and lse.dtype == torch.float32
    s = np.einsum("bqhd,bkhd->bhqk", qs, k.astype(np.float64))
    if causal:
        s = np.where(np.tril(np.ones((256, 256), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert np.abs(lse.numpy() - ref).max() <= LSE_ABS


def test_di_is_f32_and_outputs_follow_the_input_dtype():
    q, k, v, w = (torch.from_numpy(a).to(BF)
                  for a in _inputs(128, 32, False, seed=4))
    seen = []

    def dkv(*a, **kw):
        seen.append((a[3].dtype, a[4].dtype, a[5].dtype))
        return ck.flash_attention_bwd_dkv_ref(*a, **kw)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = helpers._flash(*ins, True, None, ck.flash_attention_fwd_ref, dkv,
                       ck.flash_attention_bwd_dq_ref)
    o.backward(w)
    assert seen == [(BF, torch.float32, torch.float32)]  # dO, lse, di
    assert o.dtype == BF and all(t.grad.dtype == BF for t in ins)
    # the seam itself: bf16 in, bf16 out and bf16 gradients
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = helpers.attention(*ins, causal=True)
    y.backward(w)
    assert y.dtype == BF and all(t.grad.dtype == BF for t in ins)


def test_other_dtypes_raise_type_error():
    t = splash_mask.splash_tables(128, 2, True)
    f16 = torch.zeros(1, 128, 2, 32, dtype=torch.float16)
    lse = torch.zeros(1, 2, 128)
    kw = dict(causal=True, scale=1.0)
    calls = (
        lambda x: ck.flash_attention_fwd(x, x, x, **kw),
        lambda x: ck.flash_attention_bwd_dkv(x, x, x, x, lse, lse, **kw),
        lambda x: ck.flash_attention_bwd_dq(x, x, x, x, lse, lse, **kw),
        lambda x: ck.splash_attention_fwd(x, x, x, t),
        lambda x: ck.splash_attention_bwd_dkv(x, x, x, x, lse, lse, t),
        lambda x: ck.splash_attention_bwd_dq(x, x, x, x, lse, lse, t),
        lambda x: helpers.attention(x, x, x, causal=True))
    for call in calls:
        with pytest.raises(TypeError, match="dtype"):
            call(f16)
    bf, f32 = torch.zeros(1, 128, 2, 32, dtype=BF), torch.zeros(1, 128, 2, 32)
    with pytest.raises(TypeError, match="dtype"):  # mixed dtypes
        ck.flash_attention_fwd(bf, f32, f32, **kw)
    with pytest.raises(TypeError, match="dtype"):  # dO not in q's dtype
        ck.splash_attention_bwd_dq(bf, bf, bf, f32, lse, lse, t)
    assert ck._flash_checks("t", bf, bf, bf) == (1, 128, 2, 32)
    assert ck._splash_checks("t", bf, bf, bf, tables=t) == (1, 128, 2, 32)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq", "splash_attention_fwd",
                 "splash_attention_bwd_dkv", "splash_attention_bwd_dq"):
        assert ck.LAUNCHES[name + "_bf16"] == 0  # counted apart, on the card


# -- the f32 plain versions, bit for bit against their earlier formulas -------

def _old_flash(q, k, v, do, causal, scale):
    s = ck.attention_scores(q, k, causal, scale)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    lse = torch.logsumexp(s, dim=-1)
    di = (o * do).sum(dim=-1).permute(0, 2, 1).contiguous()
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - di[..., None])
    return (o, lse, di, torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, do),
            torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale)


def _old_splash(q, k, v, do, tables, step):
    B, L, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=q.dtype)
    g = tables.grid_on(q.device, "fwd")
    for r0 in range(0, L, step):
        s = ck._splash_masked_scores(q, k, g, r0, r0 + step)
        o[:, r0:r0 + step] = torch.einsum("bhqk,bkhd->bqhd",
                                          torch.softmax(s, -1), v)
        lse[:, :, r0:r0 + step] = torch.logsumexp(s, dim=-1)
    di = (o * do).sum(dim=-1).permute(0, 2, 1).contiguous()
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.empty_like(q)
    for which in ("dkv", "dq"):
        g = tables.grid_on(q.device, which)
        for r0 in range(0, L, step):
            p, ds = ck._splash_probs_and_ds(q, k, v, do, lse, di, g, r0,
                                            r0 + step)
            if which == "dkv":
                dk += torch.einsum("bhqk,bqhd->bkhd", ds, q[:, r0:r0 + step])
                dv += torch.einsum("bhqk,bqhd->bkhd", p, do[:, r0:r0 + step])
            else:
                dq[:, r0:r0 + step] = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    return o, lse, di, dk, dv, dq


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_f32_plain_versions_keep_their_bits(causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(256, 32, False,
                                                          seed=5))
    kw = dict(causal=causal, scale=0.3)
    o, lse, di, dk, dv, dq = _old_flash(q, k, v, do, causal, 0.3)
    got = (*ck.flash_attention_fwd_ref(q, k, v, **kw),
           *ck.flash_attention_bwd_dkv_ref(q, k, v, do, lse, di, **kw),
           ck.flash_attention_bwd_dq_ref(q, k, v, do, lse, di, **kw))
    for a, b in zip(got, (o, lse, dk, dv, dq)):
        assert torch.equal(a, b)
    t = splash_mask.splash_tables(256, 2, causal)
    o, lse, di, dk, dv, dq = _old_splash(q, k, v, do, t, 128)
    part = functools.partial
    got = (*ck.splash_attention_fwd_ref(q, k, v, t, q_chunk=128),
           *part(ck.splash_attention_bwd_dkv_ref, q_chunk=128)(
               q, k, v, do, lse, di, t),
           part(ck.splash_attention_bwd_dq_ref, q_chunk=128)(
               q, k, v, do, lse, di, t))
    for a, b in zip(got, (o, lse, dk, dv, dq)):
        assert torch.equal(a, b)
