"""The bf16 dK/dV core's arithmetic, emulated on the CPU.

`ops/csrc/flash_attention_bwd.cu` and `splash_attention_bwd.cu` at bf16
run their dK/dV kernels over `attn_dkv_bf16.cuh`: one block per 128 keys,
two warpgroups of 64 keys each, q and dO in tiles of 64 query rows in the
walk's order (flash: from the diagonal tile when causal, all of them when
not; splash: the q blocks its column of the dK/dV table lists, two tiles
each). Per tile and warpgroup, on wgmma with f32 accumulators:
s^T = k q^T and dp^T = v dO^T are f32 sums of exact bf16 products; p =
exp2(fma(s, c, -lse log2(e))) (c = scale log2(e) for flash, log2(e) for
splash, lse log2(e) one f32 product), masked pairs at -inf (flash) or the
library's mask value (splash); ds = p (dp - di) in f32, times scale for
flash; p and ds rounded to bf16; dv += bf16(p)^T dO and dk += bf16(ds)^T q,
each tile's product summed in a fresh f32 accumulator and added to dv or
dk in one f32 add, tile after tile; dk and dv rounded to bf16 once. A tile
whose every pair is masked for the warpgroup's 64 keys is skipped; query
rows past L take lse +inf and di 0, so they add nothing. No kernel runs
here (no card, no nvcc): this file repeats that arithmetic in torch (the
FMA and the exact sums in float64, rounded once to f32), on inputs made
with numpy from a seed, and holds it against the JAX package's splash
kernel at bf16 in the Pallas interpreter (dk and dv through `jax.vjp` of
`_splash_call`) and against the port's plain versions (the phase-20 chip
gate's reference).

Gates, over max |reference| of dk and of dv: one bf16 ulp (2^-7) against
the plain versions, as phase 20 holds the kernels on the card; against
the interpreted JAX kernel 2^-7 for splash and 2^-6 for flash (the flash
library scales s and ds where splash scales q, which rounds differently:
see tests/test_torch_bf16_attention.py); mean |diff| within 1e-3 of it
throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import splash_mask

KEYS, WG_KEYS, QT = 128, 64, 64  # keys per block, per warpgroup; q tile
LOG2E = np.float32(1.4426950408889634)
BF = torch.bfloat16
ULP7, ULP6, MEAN = 2.0 ** -7, 2.0 ** -6, 1e-3


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


def _sum64(a, b):
    """a @ b in float64 (bf16 products are exact), rounded once to f32."""
    return (a.double() @ b.double()).float()


def _tiles(L, k0, *, flash, causal, tables):
    """The kernel's walk for the key block at k0: (q0, kind) of each q tile
    in order; kind 1 where the mask may cut a pair (splash kind-1 blocks,
    flash causal), 2 where it cuts none."""
    if flash:
        first = k0 // QT if causal else 0
        return [(q0, 1 if causal else 2)
                for q0 in range(first * QT, L, QT)]
    bl = tables.lists["dkv"]
    kb = k0 // splash_mask.BLOCK
    n = int(bl.counts[0, kb])
    per = splash_mask.BLOCK // QT
    return [(int(bl.blocks[0, kb, i // per]) * splash_mask.BLOCK
             + (i % per) * QT, int(bl.kinds[0, kb, i // per]))
            for i in range(per * n)]


def emulate_dkv_bf16(q, k, v, do, lse, di, *, flash, causal, scale=None,
                     tables=None):
    """The bf16 dK/dV core on one head: q, k, v, do [L, D] bf16, lse and di
    [L] f32 -> dk, dv [L, D] bf16, tile by tile as the kernel walks them.
    ``flash``: the scale on s (in the exponent's FMA) and on ds, -inf for
    masked pairs; splash: q pre-scaled by the caller, the library's mask
    value, ``tables`` from `splash_mask.splash_tables(L, 1, causal)`."""
    L, D = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    mask = -float("inf") if flash else float(
        np.float32(splash_mask.DEFAULT_MASK_VALUE))
    c = float(np.float32(scale) * LOG2E if flash else LOG2E)
    lse2 = lse * torch.tensor(LOG2E)  # one f32 product
    dk = torch.zeros(L, D)
    dv = torch.zeros(L, D)
    for k0 in range(0, L, KEYS):
        for kw0 in range(k0, min(k0 + KEYS, L), WG_KEYS):
            keys = torch.arange(kw0, min(kw0 + WG_KEYS, L))
            acc_k = torch.zeros(len(keys), D)
            acc_v = torch.zeros(len(keys), D)
            for q0, kind in _tiles(L, k0, flash=flash, causal=causal,
                                   tables=tables):
                if kind == 1 and q0 + QT - 1 < kw0:
                    continue  # every pair masked for these 64 keys
                rows = torch.arange(q0, min(q0 + QT, L))
                s = _sum64(kf[keys], qf[rows].T)  # s^T [keys, rows]
                if kind == 1:
                    s = torch.where(rows[None, :] >= keys[:, None], s,
                                    torch.tensor(mask))
                arg = (s.double() * c - lse2[rows].double()[None, :]).float()
                p = torch.exp2(arg)
                dp = _sum64(vf[keys], dof[rows].T)
                ds = p * (dp - di[rows][None, :])
                if flash:
                    ds = ds * torch.tensor(np.float32(scale))
                acc_v = acc_v + _sum64(_bf(p), dof[rows])
                acc_k = acc_k + _sum64(_bf(ds), qf[rows])
            dk[keys] = acc_k
            dv[keys] = acc_v
    return dk.to(BF), dv.to(BF)


def _inputs(L, D, seed):
    """q, k, v, do [1, L, 1, D] bf16 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, L, 1, D)).astype(
        np.float32)).to(BF) for _ in range(4)]


def _lse_di(o, lse, do):
    """lse [L] and di = sum_d o dO [L] of head 0, both f32."""
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1)
    return lse[0, 0].contiguous(), di[0, 0].contiguous()


def _err(a, b):
    d, m = (a.float() - b.float()).abs(), b.float().abs().max()
    return float(d.max() / m), float(d.mean() / m)


def _jax_splash_dkv(q, k, v, do, causal):
    """dk and dv of the JAX splash kernel at bf16, interpreted (its q scale
    folded inside, as `_splash_call` folds it)."""
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        _, vjp = jax.vjp(lambda a, b, c: pk._splash_call(a, b, c, causal,
                                                         None),
                         *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                           for t in (q, k, v)))
        _, gk, gv = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    finally:
        pk._INTERPRET = old
    return [torch.from_numpy(np.array(g.astype(jnp.float32)))[0, :, 0]
            for g in (gk, gv)]


FLASH = [(L, D) for L in (7, 129, 256) for D in (16, 64, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L,D", FLASH, ids=[f"L{L}-D{D}" for L, D in FLASH])
def test_flash_dkv_emulation_matches_the_plain_version(L, D, causal):
    q, k, v, do = _inputs(L, D, seed=3 * L + D + causal)
    scale = D ** -0.5
    o, lse = ck.flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale)
    lse1, di1 = _lse_di(o, lse, do)
    dk, dv = emulate_dkv_bf16(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                              do[0, :, 0], lse1, di1, flash=True,
                              causal=causal, scale=scale)
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    rdk, rdv = ck.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                          causal=causal, scale=scale)
    assert rdk.dtype == BF and dk.dtype == BF
    for got, want in ((dk, rdk[0, :, 0]), (dv, rdv[0, :, 0])):
        mx, mean = _err(got, want)
        assert mx <= ULP7 and mean <= MEAN, (mx, mean)
    if L % splash_mask.BLOCK == 0:
        for got, want in zip((dk, dv), _jax_splash_dkv(q, k, v, do, causal)):
            mx, mean = _err(got, want)
            assert mx <= ULP6 and mean <= MEAN, (mx, mean)


SPLASH = [(L, D) for L in (128, 256) for D in (16, 64, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L,D", SPLASH, ids=[f"L{L}-D{D}" for L, D in SPLASH])
def test_splash_dkv_emulation_matches_jax_and_the_plain_version(L, D, causal):
    q, k, v, do = _inputs(L, D, seed=5 * L + D + causal)
    qs = q * torch.full((), D ** -0.5, dtype=BF)  # as `_splash` folds it
    tb = splash_mask.splash_tables(L, 1, causal)
    o, lse = ck.splash_attention_fwd_ref(qs, k, v, tb)
    lse1, di1 = _lse_di(o, lse, do)
    dk, dv = emulate_dkv_bf16(qs[0, :, 0], k[0, :, 0], v[0, :, 0],
                              do[0, :, 0], lse1, di1, flash=False,
                              causal=causal, tables=tb)
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    rdk, rdv = ck.splash_attention_bwd_dkv(qs, k, v, do, lse, di, tb)
    for got, want in ((dk, rdk[0, :, 0]), (dv, rdv[0, :, 0])):
        mx, mean = _err(got, want)
        assert mx <= ULP7 and mean <= MEAN, (mx, mean)
    for got, want in zip((dk, dv), _jax_splash_dkv(q, k, v, do, causal)):
        mx, mean = _err(got, want)
        assert mx <= ULP7 and mean <= MEAN, (mx, mean)


def test_the_walk_skips_only_tiles_masked_for_all_64_keys():
    """Causal, L = 512: key block 0's consumers walk the 8 q tiles from
    the diagonal (flash) or the listed blocks' 8 tiles (splash); the
    second consumer (keys 64-127) skips the first tile (queries 0-63) and
    no other, and full masks skip nothing."""
    tb = splash_mask.splash_tables(512, 1, True)
    for flash in (True, False):
        walk = _tiles(512, 0, flash=flash, causal=True,
                      tables=None if flash else tb)
        assert [q0 for q0, _ in walk] == list(range(0, 512, QT))
        skipped = [q0 for q0, kind in walk if kind == 1 and q0 + QT - 1 < 64]
        assert skipped == [0]
        walk3 = _tiles(512, 384, flash=flash, causal=True,
                       tables=None if flash else tb)
        assert [q0 for q0, _ in walk3] == [384, 448]
    full = splash_mask.splash_tables(256, 1, False)
    assert all(kind == 2 for _, kind in _tiles(256, 128, flash=False,
                                               causal=False, tables=full))
