"""The bf16 dQ core's arithmetic, emulated on the CPU.

`ops/csrc/flash_attention_bwd.cu` and `splash_attention_bwd.cu` at bf16
run their dQ kernels over `attn_dq_bf16.cuh`: one block per 128 query
rows, two warpgroups of 64 rows each, k and v in tiles of 64 keys in the
walk's order (flash: up to the block's last row when causal, all of them
when not; splash: the kv blocks its row of the dQ table lists, two tiles
each). Per tile and warpgroup, on wgmma with f32 accumulators: s = q k^T
and dp = dO v^T are f32 sums of exact bf16 products; p = exp2(fma(s, c,
-lse log2(e))) (c = scale log2(e) for flash, log2(e) for splash, lse
log2(e) one f32 product), masked pairs at -inf (flash: keys past L too) or
the library's mask value (splash); ds = p (dp - di) in f32, times scale for
flash; ds rounded to bf16; dq += bf16(ds) k, each tile's product summed in
a fresh f32 accumulator and added to dq in one f32 add, tile after tile;
dq rounded to bf16 once. A tile whose every pair is masked for the
warpgroup's 64 rows is skipped; rows past L take lse +inf and di 0, so
they add nothing, and are never stored. No kernel runs here (no card, no
nvcc): this file repeats that arithmetic in torch (the FMA and the exact
sums in float64, rounded once to f32), on inputs made with numpy from a
seed, and holds it against the JAX package's splash kernel at bf16 in the
Pallas interpreter (dq through `jax.vjp` of `_splash_call`) and against
the port's plain versions (the phase-20 chip gate's reference).

Gates, over max |reference| of dq: one bf16 ulp (2^-7) against the plain
versions, as phase 20 holds the kernels on the card; against the
interpreted JAX kernel 2^-7 for splash and 2^-6 for flash (the flash
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

ROWS, WG_ROWS, KT = 128, 64, 64  # query rows per block, per warpgroup; tile
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


def _tiles(L, q0, *, flash, causal, tables):
    """The kernel's walk for the query block at q0: (k0, kind) of each k/v
    tile in order; kind 1 where the mask may cut a pair (splash kind-1
    blocks; flash causal, or a tile reaching past L), 2 where it cuts
    none."""
    if flash:
        n = -(-L // KT)
        if causal:
            n = min(n, (q0 + ROWS) // KT)
        return [(k0, 1 if causal or k0 + KT > L else 2)
                for k0 in range(0, n * KT, KT)]
    bl = tables.lists["dq"]
    qb = q0 // splash_mask.BLOCK
    n = int(bl.counts[0, qb])
    per = splash_mask.BLOCK // KT
    return [(int(bl.blocks[0, qb, i // per]) * splash_mask.BLOCK
             + (i % per) * KT, int(bl.kinds[0, qb, i // per]))
            for i in range(per * n)]


def _mode(k0, kind, w0, L, *, flash, causal):
    """The walk's mode of a tile for the warpgroup at w0 (FlashDqWgWalk and
    SplashWalk<64, 64> in the kernels): -1 skipped, 1 mask code, 0 none."""
    if flash:
        if w0 >= L or (causal and k0 > w0 + WG_ROWS - 1):
            return -1
        return 1 if k0 + KT > L or (causal and k0 + KT - 1 > w0) else 0
    if kind != 1:
        return 0
    if k0 > w0 + WG_ROWS - 1:
        return -1
    return 1 if k0 + KT - 1 > w0 else 0


def _keep(rows, keys, L, *, flash, causal):
    """[rows, keys] bool: the pairs the mask keeps."""
    r, c = rows[:, None], keys[None, :]
    if flash:
        return (c < L) & ((c <= r) if causal else torch.ones_like(c > r))
    return c <= r if causal else torch.ones(len(rows), len(keys),
                                            dtype=torch.bool)


def emulate_dq_bf16(q, k, v, do, lse, di, *, flash, causal, scale=None,
                    tables=None):
    """The bf16 dQ core on one head: q, k, v, do [L, D] bf16, lse and di
    [L] f32 -> dq [L, D] bf16, tile by tile as the kernel walks them.
    ``flash``: the scale on s (in the exponent's FMA) and on ds, -inf for
    masked pairs; splash: q pre-scaled by the caller, the library's mask
    value, ``tables`` from `splash_mask.splash_tables(L, 1, causal)`."""
    L, D = q.shape
    pad = -(-L // KT) * KT - L  # k and v rows past L arrive as zeros
    qf, dof = q.float(), do.float()
    kf = torch.cat([k.float(), torch.zeros(pad, D)])
    vf = torch.cat([v.float(), torch.zeros(pad, D)])
    mask = -float("inf") if flash else float(
        np.float32(splash_mask.DEFAULT_MASK_VALUE))
    c = float(np.float32(scale) * LOG2E if flash else LOG2E)
    nl = -(lse * torch.tensor(LOG2E))  # one f32 product
    dq = torch.zeros(L, D)
    for q0 in range(0, L, ROWS):
        for w0 in range(q0, min(q0 + ROWS, L), WG_ROWS):
            rows = torch.arange(w0, min(w0 + WG_ROWS, L))
            acc = torch.zeros(len(rows), D)
            for k0, kind in _tiles(L, q0, flash=flash, causal=causal,
                                   tables=tables):
                mode = _mode(k0, kind, w0, L, flash=flash, causal=causal)
                if mode < 0:
                    continue
                keys = torch.arange(k0, k0 + KT)
                s = _sum64(qf[rows], kf[keys].T)  # [rows, keys]
                if mode == 1:
                    s = torch.where(_keep(rows, keys, L, flash=flash,
                                          causal=causal), s,
                                    torch.tensor(mask))
                arg = (s.double() * c + nl[rows].double()[:, None]).float()
                p = torch.exp2(arg)
                dp = _sum64(dof[rows], vf[keys].T)
                ds = p * (dp - di[rows][:, None])
                if flash:
                    ds = ds * torch.tensor(np.float32(scale))
                acc = acc + _sum64(_bf(ds), kf[keys])
            dq[rows] = acc
    return dq.to(BF)


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


def _jax_splash_dq(q, k, v, do, causal):
    """dq of the JAX splash kernel at bf16, interpreted, with respect to the
    unscaled q (its q scale folded inside, as `_splash_call` folds it)."""
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        _, vjp = jax.vjp(lambda a, b, c: pk._splash_call(a, b, c, causal,
                                                         None),
                         *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                           for t in (q, k, v)))
        gq, _, _ = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    finally:
        pk._INTERPRET = old
    return torch.from_numpy(np.array(gq.astype(jnp.float32)))[0, :, 0]


def _unscaled(dq, scale):
    """dq of the pre-scaled q taken to the unscaled q, as autograd takes it
    through q * scale in bf16."""
    return (dq.float() * scale).to(BF)


FLASH = [(L, D) for L in (7, 129, 256) for D in (16, 64, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L,D", FLASH, ids=[f"L{L}-D{D}" for L, D in FLASH])
def test_flash_dq_emulation_matches_the_plain_version(L, D, causal):
    q, k, v, do = _inputs(L, D, seed=7 * L + D + causal)
    scale = D ** -0.5
    o, lse = ck.flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale)
    lse1, di1 = _lse_di(o, lse, do)
    dq = emulate_dq_bf16(q[0, :, 0], k[0, :, 0], v[0, :, 0], do[0, :, 0],
                         lse1, di1, flash=True, causal=causal, scale=scale)
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    rdq = ck.flash_attention_bwd_dq(q, k, v, do, lse, di, causal=causal,
                                    scale=scale)
    assert rdq.dtype == BF and dq.dtype == BF
    mx, mean = _err(dq, rdq[0, :, 0])
    assert mx <= ULP7 and mean <= MEAN, (mx, mean)
    if L % splash_mask.BLOCK == 0:
        # the flash kernel's dq is the gradient of the unscaled q already
        mx, mean = _err(dq, _jax_splash_dq(q, k, v, do, causal))
        assert mx <= ULP6 and mean <= MEAN, (mx, mean)


SPLASH = [(L, D) for L in (128, 256) for D in (16, 64, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L,D", SPLASH, ids=[f"L{L}-D{D}" for L, D in SPLASH])
def test_splash_dq_emulation_matches_jax_and_the_plain_version(L, D, causal):
    q, k, v, do = _inputs(L, D, seed=11 * L + D + causal)
    scale = D ** -0.5
    qs = q * torch.full((), scale, dtype=BF)  # as `_splash` folds it
    tb = splash_mask.splash_tables(L, 1, causal)
    o, lse = ck.splash_attention_fwd_ref(qs, k, v, tb)
    lse1, di1 = _lse_di(o, lse, do)
    dq = emulate_dq_bf16(qs[0, :, 0], k[0, :, 0], v[0, :, 0], do[0, :, 0],
                         lse1, di1, flash=False, causal=causal, tables=tb)
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    rdq = ck.splash_attention_bwd_dq(qs, k, v, do, lse, di, tb)
    mx, mean = _err(dq, rdq[0, :, 0])
    assert mx <= ULP7 and mean <= MEAN, (mx, mean)
    mx, mean = _err(_unscaled(dq, scale), _jax_splash_dq(q, k, v, do, causal))
    assert mx <= ULP7 and mean <= MEAN, (mx, mean)


WALKS = ([("flash", L, c) for L in (7, 129, 300) for c in (True, False)]
         + [("splash", L, c) for L in (128, 256) for c in (True, False)])


@pytest.mark.parametrize("family,L,causal", WALKS,
                         ids=[f"{f}-L{L}-{'causal' if c else 'full'}"
                              for f, L, c in WALKS])
def test_the_walk_skips_exactly_the_tiles_masked_for_all_64_rows(
        family, L, causal):
    """For every warpgroup with a row below L, a tile is skipped (mode -1)
    exactly when the mask drops every pair of its rows below L, and a tile
    that runs no mask code (mode 0) keeps every such pair."""
    flash = family == "flash"
    tb = None if flash else splash_mask.splash_tables(L, 1, causal)
    walked = skipped = 0
    for q0 in range(0, L, ROWS):
        for w0 in range(q0, min(q0 + ROWS, L), WG_ROWS):
            rows = torch.arange(w0, min(w0 + WG_ROWS, L))
            for k0, kind in _tiles(L, q0, flash=flash, causal=causal,
                                   tables=tb):
                keep = _keep(rows, torch.arange(k0, k0 + KT), L,
                             flash=flash, causal=causal)
                mode = _mode(k0, kind, w0, L, flash=flash, causal=causal)
                assert (mode < 0) == (not bool(keep.any())), (q0, w0, k0)
                if mode == 0:
                    assert bool(keep.all()), (q0, w0, k0)
                walked += 1
                skipped += mode < 0
    assert walked > 0
    # causal walks list the diagonal tile past the first warpgroup's rows
    assert (skipped > 0) == (causal and L > WG_ROWS), skipped
