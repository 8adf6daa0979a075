"""The tensor-core attention forward kernels' arithmetic, emulated on the CPU.

`ops/csrc/flash_attention_fwd.cu` and `splash_attention_fwd.cu` run both
products of attention, s = q k^T and o += p v, on the tensor cores
(`mma.sync` m16n8k8, tf32 in, f32 accumulators) with the 3xTF32 split: hi
= tf32(x) rounded to nearest, ties away, lo = tf32(x - hi), and a b ~ hi_a
hi_b + hi_a lo_b + lo_a hi_b. No kernel runs here (no card, no nvcc); this
file repeats their arithmetic in numpy, in their order:

  - one 128-row query tile at a time, keys in 64-key tiles, the online
    softmax (running max m, sum l, the output scaled by exp(m - m_new)),
    each tile's p v summed apart and added to the output, expf and logf,
    o = acc * (1 / l), lse = m + log(l);
  - each product as 8-wide k-steps, three tf32 products each (the two lo
    terms first), summed in f32; the head dims of q k^T in the kernels'
    order (k-steps of d = 16i + 4t + {0, 1} and 16i + 4t + {2, 3});
  - flash: the scale on the scores, -inf for masked scores, the m_use guard,
    causal tiles up to the diagonal; splash: q pre-scaled, the forward
    block list of `ops/splash_mask.py`, kind-1 blocks filled with the mask
    value where q < k.

The emulation is held against the JAX package on the CPU with inputs made by
numpy from a seed: `_attention_default` for o and a JAX logsumexp of the same
scores for lse, and the JAX splash kernel in the Pallas interpreter for o.
Tolerance: 2e-6 of max |reference|, five times inside the chip gate of 1e-5
(chip_smoke.py phases 9 and 11). The tensor cores truncate inside an mma
where numpy rounds, hence the headroom. Plain TF32 (hi only) misses the chip
gate, which is why the kernels split.

The splash dQ kernel (`splash_attention_bwd.cu` over `attn_dq_tc.cuh`) is
emulated the same way: per 128-row query block the kv blocks of the dQ block
list in tiles of 32 keys at D = 128 (64 below), s = q k^T and dp = dO v^T in
3xTF32 (head dims in the kernels' order), kind-1 tiles filled with the mask
value where q < k, p = exp(s - lse), ds = p (dp - di), and each tile's ds k
summed apart and added to dq. It takes lse and o from the forward's
emulation, as the kernels take them from the forward kernel, and is held
against `jax.grad` of the dense default evaluated in f64 at the same 2e-6 of
max |reference|, and against `jax.grad` of the JAX splash kernel in the
Pallas interpreter (f32) at 4e-6: at L = 1024, full, an f32 reference's own
error reaches 1.8e-6 of max |dq| against f64 (the emulation's 8.5e-7). The
chip gate is 1e-5 of the largest plain gradient.

The dK/dV kernels (`splash_attention_bwd.cu` and `flash_attention_bwd.cu`
over `attn_dkv_tc.cuh`) are emulated with the axes swapped: per block of
128 keys the query tiles of the kernel's walk, 32 rows at D = 128 (64
below) — splash: the dK/dV block list, kind-1 tiles filled with the mask
value where q < k; flash: from the diagonal tile on when causal, the scale
on s and on dk, -inf for pairs past L or above the diagonal — s^T = k q^T
and dp^T = v dO^T in 3xTF32 (head dims in the kernels' order), p^T =
exp(s^T - lse), ds^T = p^T (dp^T - di), and each tile's p^T dO and ds^T q
summed apart and added to dv and dk. Held, over the larger of max |dk| and
max |dv| of the reference, against `jax.grad` of the dense default in f64
at 2e-6 (flash and splash) and of the JAX splash kernel in the Pallas
interpreter (f32) at 4e-6 (the JAX flash kernel runs on a TPU only).

The flash dQ kernel (`flash_attention_bwd.cu` over the same `attn_dq_tc.cuh`
as splash dQ) is emulated by `emulate_flash_dq`: per 128-row query block the
key tiles of the flash walk (32 keys at D = 128, 64 below; up to the block's
last row when causal), s = q k^T times the scale, -inf for keys past L or
above the diagonal, rows past L zero-filled with lse = di = 0, and dq times
the scale. It is held against `jax.grad` w.r.t. q of the dense default in
f64 at 2e-6 of the largest of the three reference gradients (at L = 1, dq is
0 up to rounding), the denominator chip_smoke.py's gate uses.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_attention_tc.py

prints the emulation's errors, 3xTF32 and plain TF32, at L = 1024, D = 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import splash_mask

ROWS, KEYS = 128, 64  # query rows per CUDA block, keys per K/V tile
TOL = 2e-6            # of max |reference|, for o and lse (and dq vs f64)
TOL_F32_DQ = 4e-6     # of max |dq| against an f32 reference of dq
MASK = np.float32(splash_mask.DEFAULT_MASK_VALUE)


def tf32(x):
    """float32 rounded to tf32 (10 mantissa bits), to nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(acc, a, b, plain=False):
    """acc [M, N] + a [M, K] b [K, N] in 8-wide k-steps of three tf32
    products each (lo_a hi_b, hi_a lo_b, hi_a hi_b), every sum in f32;
    ``plain`` keeps hi_a hi_b alone."""
    ah, al = split(a)
    bh, bl = split(b)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        if not plain:
            acc = acc + al[:, s] @ bh[s]
            acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
    return acc


def head_dim_order(D):
    """The head dims of q k^T in the kernels' k-step order: for each 16
    dims, d = 4t + {0, 1} (t < 4), then 4t + {2, 3}."""
    return np.array([16 * i + 4 * t + 2 * half + e for i in range(D // 16)
                     for half in (0, 1) for t in range(4) for e in (0, 1)])


def emulate_fwd(q, k, v, *, scale=None, causal=False, tables=None,
                plain=False):
    """(o [B, L, H, D], lse [B, H, L]) as the forward kernels compute them:
    flash with ``scale`` when ``tables`` is None, else splash (q
    pre-scaled) over ``tables``' forward block list."""
    B, L, H, D = q.shape
    order = head_dim_order(D)
    nq = -(-L // ROWS)
    pad = nq * ROWS - L
    o = np.zeros((B, L, H, D), np.float32)
    lse = np.zeros((B, H, L), np.float32)
    bl = None if tables is None else tables.lists["fwd"]
    for b in range(B):
        for h in range(H):
            Q, K, V = (np.pad(x[b, :, h], ((0, pad), (0, 0))) for x in (q, k, v))
            Q, K = Q[:, order], K[:, order]
            for qt in range(nq):
                q0 = qt * ROWS
                rows = q0 + np.arange(ROWS)
                if bl is None:
                    nk = -(-L // KEYS)
                    if causal:
                        nk = min(nk, 2 * qt + 2)
                    tiles = [(KEYS * j, 0) for j in range(nk)]
                    m = np.full(ROWS, -np.inf, np.float32)
                else:
                    r = 0 if bl.counts.shape[0] == 1 else h
                    tiles = [(int(bl.blocks[r, qt, e]) * ROWS + sub * KEYS,
                              int(bl.kinds[r, qt, e]))
                             for e in range(bl.counts[r, qt])
                             for sub in (0, 1)]
                    m = np.full(ROWS, MASK, np.float32)
                l = np.zeros(ROWS, np.float32)
                acc = np.zeros((ROWS, D), np.float32)
                for k0, kind in tiles:
                    cols = k0 + np.arange(KEYS)
                    s = mma(np.zeros((ROWS, KEYS), np.float32),
                            Q[q0:q0 + ROWS], K[k0:k0 + KEYS].T, plain)
                    if bl is None:
                        s = s * np.float32(scale)
                        keep = cols[None, :] < L
                        if causal:
                            keep = keep & (cols[None, :] <= rows[:, None])
                        s = np.where(keep, s, np.float32(-np.inf))
                    elif kind == 1:
                        s = np.where(rows[:, None] >= cols[None, :], s, MASK)
                    m_new = np.maximum(m, s.max(axis=1))
                    m_use = m_new
                    if bl is None:
                        m_use = np.where(m_new == -np.inf, np.float32(0),
                                         m_new)
                    alpha = np.exp(m - m_use)
                    p = np.exp(s - m_use[:, None])
                    l = l * alpha + p.sum(axis=1, dtype=np.float32)
                    acc = acc * alpha[:, None] + mma(
                        np.zeros((ROWS, D), np.float32), p, V[k0:k0 + KEYS],
                        plain)
                    m = m_new
                live = min(ROWS, L - q0)
                o[b, q0:q0 + live, h] = (acc * (np.float32(1) / l)[:, None]
                                         )[:live]
                lse[b, h, q0:q0 + live] = (m + np.log(l))[:live]
    return o, lse


def streamed_rows(D):
    """Rows per streamed tile of the backward kernels: keys per K/V tile of
    dQ (attn_dq_tc.cuh `Dq<D>::kKeys`), query rows per q/dO tile of dK/dV
    (attn_dkv_tc.cuh `Dkv<D>::kQT`)."""
    return 32 if D == 128 else 64


def emulate_splash_dq(qs, k, v, do, lse, di, tables, plain=False):
    """dq [B, L, H, D], the gradient of the pre-scaled q, as the splash dQ
    kernel computes it over ``tables``' dQ block list."""
    B, L, H, D = qs.shape
    order = head_dim_order(D)
    keys = streamed_rows(D)
    bl = tables.lists["dq"]
    dq = np.zeros((B, L, H, D), np.float32)
    for b in range(B):
        for h in range(H):
            Q, dO = qs[b, :, h][:, order], do[b, :, h][:, order]
            K, V = k[b, :, h], v[b, :, h]
            Ko, Vo = K[:, order], V[:, order]
            r = 0 if bl.counts.shape[0] == 1 else h
            for qb in range(L // ROWS):
                rows = qb * ROWS + np.arange(ROWS)
                lr = lse[b, h, rows][:, None]
                dr = di[b, h, rows][:, None]
                acc = np.zeros((ROWS, D), np.float32)
                for e in range(bl.counts[r, qb]):
                    kind = int(bl.kinds[r, qb, e])
                    for sub in range(ROWS // keys):
                        k0 = int(bl.blocks[r, qb, e]) * ROWS + sub * keys
                        cols = k0 + np.arange(keys)
                        zero = np.zeros((ROWS, keys), np.float32)
                        s = mma(zero, Q[rows], Ko[cols].T, plain)
                        dp = mma(zero, dO[rows], Vo[cols].T, plain)
                        if kind == 1:
                            s = np.where(rows[:, None] >= cols[None, :], s,
                                         MASK)
                        ds = np.exp(s - lr) * (dp - dr)
                        acc = acc + mma(np.zeros((ROWS, D), np.float32), ds,
                                        K[cols], plain)
                dq[b, rows, h] = acc
    return dq


def emulate_flash_dq(q, k, v, do, lse, di, *, scale, causal, plain=False):
    """dq [B, L, H, D] as the flash dQ kernel computes it: per 128-row query
    block the key tiles of its walk, the scale on s and on dq."""
    B, L, H, D = q.shape
    order = head_dim_order(D)
    keys = streamed_rows(D)
    nq = -(-L // ROWS)
    all_tiles = -(-L // keys)
    pad = max(nq * ROWS, all_tiles * keys) - L
    dq = np.zeros((B, L, H, D), np.float32)
    for b in range(B):
        for h in range(H):
            Q, K, V, dO = (np.pad(x[b, :, h], ((0, pad), (0, 0)))
                           for x in (q, k, v, do))
            lr, dr = (np.pad(x[b, h], (0, pad)) for x in (lse, di))
            Qo, Ko, Vo, dOo = (x[:, order] for x in (Q, K, V, dO))
            for qb in range(nq):
                rows = qb * ROWS + np.arange(ROWS)
                n = all_tiles
                if causal:
                    n = min(n, -(-(qb * ROWS + ROWS) // keys))
                acc = np.zeros((ROWS, D), np.float32)
                for i in range(n):
                    cols = i * keys + np.arange(keys)
                    zero = np.zeros((ROWS, keys), np.float32)
                    s = mma(zero, Qo[rows], Ko[cols].T, plain) * np.float32(
                        scale)
                    dp = mma(zero, dOo[rows], Vo[cols].T, plain)
                    keep = cols[None, :] < L
                    if causal:
                        keep = keep & (cols[None, :] <= rows[:, None])
                    s = np.where(keep, s, np.float32(-np.inf))
                    ds = np.exp(s - lr[rows][:, None]) * (
                        dp - dr[rows][:, None])
                    acc = acc + mma(np.zeros((ROWS, D), np.float32), ds,
                                    K[cols], plain)
                live = min(ROWS, L - qb * ROWS)
                dq[b, qb * ROWS:qb * ROWS + live, h] = (
                    acc * np.float32(scale))[:live]
    return dq


def emulate_dkv(q, k, v, do, lse, di, *, scale=None, causal=False,
                tables=None, plain=False):
    """(dk, dv) [B, L, H, D] as the dK/dV kernels compute them: flash with
    ``scale`` when ``tables`` is None, else splash (q pre-scaled) over
    ``tables``' dK/dV block list."""
    B, L, H, D = q.shape
    order = head_dim_order(D)
    qt = streamed_rows(D)
    nk = -(-L // ROWS)
    pad = nk * ROWS - L
    bl = None if tables is None else tables.lists["dkv"]
    dk = np.zeros((B, L, H, D), np.float32)
    dv = np.zeros((B, L, H, D), np.float32)
    for b in range(B):
        for h in range(H):
            Q, K, V, dO = (np.pad(x[b, :, h], ((0, pad), (0, 0)))
                           for x in (q, k, v, do))
            lr, dr = (np.pad(x[b, h], (0, pad)) for x in (lse, di))
            Qo, Ko, Vo, dOo = (x[:, order] for x in (Q, K, V, dO))
            for kb in range(nk):
                keys = kb * ROWS + np.arange(ROWS)
                if bl is None:
                    first = kb * ROWS // qt if causal else 0
                    tiles = [(qt * i, 0) for i in range(first, -(-L // qt))]
                else:
                    r = 0 if bl.counts.shape[0] == 1 else h
                    tiles = [(int(bl.blocks[r, kb, e]) * ROWS + sub * qt,
                              int(bl.kinds[r, kb, e]))
                             for e in range(bl.counts[r, kb])
                             for sub in range(ROWS // qt)]
                adk = np.zeros((ROWS, D), np.float32)
                adv = np.zeros((ROWS, D), np.float32)
                for q0, kind in tiles:
                    rows = q0 + np.arange(qt)
                    zero = np.zeros((ROWS, qt), np.float32)
                    s = mma(zero, Ko[keys], Qo[rows].T, plain)
                    dp = mma(zero, Vo[keys], dOo[rows].T, plain)
                    if bl is None:
                        s = s * np.float32(scale)
                        keep = (rows[None, :] < L) & (keys[:, None] < L)
                        if causal:
                            keep = keep & (rows[None, :] >= keys[:, None])
                        s = np.where(keep, s, np.float32(-np.inf))
                    elif kind == 1:
                        s = np.where(rows[None, :] >= keys[:, None], s, MASK)
                    p = np.exp(s - lr[rows][None, :])
                    ds = p * (dp - dr[rows][None, :])
                    zero = np.zeros((ROWS, D), np.float32)
                    adv = adv + mma(zero, p, dO[rows], plain)
                    adk = adk + mma(zero, ds, Q[rows], plain)
                if bl is None:
                    adk = adk * np.float32(scale)
                live = min(ROWS, L - kb * ROWS)
                dk[b, kb * ROWS:kb * ROWS + live, h] = adk[:live]
                dv[b, kb * ROWS:kb * ROWS + live, h] = adv[:live]
    return dk, dv


def _qkv(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32)
            for _ in range(3)]


def jax_reference(q, k, v, causal, scale):
    """o from the JAX package's dense default, lse the logsumexp of the
    same masked scores."""
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o = jhelpers._attention_default(jq, jk, jv, causal=causal, scale=scale)
    s = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * scale
    if causal:
        L = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((L, L), bool)), s,
                      jnp.finfo(s.dtype).min)
    return np.asarray(o), np.asarray(jax.nn.logsumexp(s, axis=-1))


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def flash_errors(B, L, H, D, causal, seed, plain=False):
    q, k, v = _qkv(B, L, H, D, seed)
    scale = D ** -0.5
    o, lse = emulate_fwd(q, k, v, scale=scale, causal=causal, plain=plain)
    ro, rlse = jax_reference(q, k, v, causal, scale)
    return rel_err(o, ro), rel_err(lse, rlse)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 7, 129, 300, 1024])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_3xtf32_matches_jax_default(causal, L, D):
    B, H = (1, 3) if causal else (3, 1)
    eo, el = flash_errors(B, L, H, D, causal, seed=L * 10 + D)
    assert eo <= TOL and el <= TOL, (eo, el)


def _splash_inputs(L, causal, seed, H=2, D=128):
    q, k, v = _qkv(1, L, H, D, seed)
    scale = D ** -0.5
    qs = q * np.float32(scale)
    tables = splash_mask.splash_tables(L, H, causal)
    return q, k, v, qs, scale, tables


@pytest.mark.parametrize("L", [128, 256, 1024])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_splash_3xtf32_matches_jax_default(causal, L):
    q, k, v, qs, scale, tables = _splash_inputs(L, causal, seed=L)
    o, lse = emulate_fwd(qs, k, v, tables=tables)
    ro, rlse = jax_reference(q, k, v, causal, scale)
    assert rel_err(o, ro) <= TOL and rel_err(lse, rlse) <= TOL, (
        rel_err(o, ro), rel_err(lse, rlse))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_splash_3xtf32_matches_jax_splash_kernel_interpreted(causal):
    q, k, v, qs, _, tables = _splash_inputs(256, causal, seed=5)
    o, _ = emulate_fwd(qs, k, v, tables=tables)
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        want = np.asarray(pk._splash_call(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal, None))
    finally:
        pk._INTERPRET = old
    assert rel_err(o, want) <= TOL, rel_err(o, want)


def splash_dq_errors(L, causal, seed, plain=False):
    """max |diff| / max |reference| of the dQ emulation's gradient of q
    against jax.grad of the JAX splash kernel in the Pallas interpreter (f32)
    and of the dense default in f64, at [1, L, 1, 128]."""
    q, k, v, qs, scale, tables = _splash_inputs(L, causal, seed, H=1)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(
        np.float32)
    o, lse = emulate_fwd(qs, k, v, tables=tables)
    di = np.einsum("blhd,blhd->bhl", o, do).astype(np.float32)
    got = emulate_splash_dq(qs, k, v, do, lse, di, tables, plain) * np.float32(
        scale)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))

    def dense(q, k, v, do):
        return jnp.sum(jhelpers._attention_default(
            q, k, v, causal=causal, scale=scale) * do)

    def splash(q):
        return jnp.sum(pk._splash_call(q, jk, jv, causal, None) * jdo)
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        want_splash = np.asarray(jax.grad(splash)(jq))
    finally:
        pk._INTERPRET = old
    with jax.enable_x64(True):
        want_dense = np.asarray(jax.grad(dense)(
            *(jnp.asarray(x, jnp.float64) for x in (q, k, v, do))))
    return rel_err(got, want_splash), rel_err(got, want_dense)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_splash_dq_3xtf32_matches_jax(causal):
    e_splash, e_dense = splash_dq_errors(1024, causal, seed=9)
    assert e_splash <= TOL_F32_DQ and e_dense <= TOL, (e_splash, e_dense)


def grad_err(got, want):
    """max |diff| of dk and of dv over the larger of max |dk| and max |dv|
    of the reference (at L = 1 dk is 0 up to rounding)."""
    top = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - w).max()) / top for g, w in zip(got, want))


def dense_grads_f64(q, k, v, do, causal, scale, argnums=(0, 1, 2)):
    """jax.grad w.r.t. ``argnums`` of (q, k, v) of the JAX dense default, in
    f64 (jitted: one compile per shape instead of one per operation)."""
    def f(q, k, v, do):
        return jnp.sum(jhelpers._attention_default(
            q, k, v, causal=causal, scale=scale) * do)
    with jax.enable_x64(True):
        return [np.asarray(x) for x in jax.jit(jax.grad(f, argnums))(
            *(jnp.asarray(x, jnp.float64) for x in (q, k, v, do)))]


def dense_dkv_f64(q, k, v, do, causal, scale):
    """jax.grad w.r.t. k and v of the JAX dense default, in f64."""
    return dense_grads_f64(q, k, v, do, causal, scale, (1, 2))


def flash_bwd_error(which, B, L, H, D, causal, seed, plain=False):
    """The flash backward emulation's error against the dense default in
    f64: ``which`` "dkv", max |diff| of dk and dv over the larger of max
    |dk| and max |dv| (`grad_err`); "dq", max |diff| of dq over the largest
    of max |dq|, max |dk| and max |dv|."""
    q, k, v = _qkv(B, L, H, D, seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(
        np.float32)
    scale = D ** -0.5
    o, lse = emulate_fwd(q, k, v, scale=scale, causal=causal)
    di = np.einsum("blhd,blhd->bhl", o, do).astype(np.float32)
    if which == "dkv":
        got = emulate_dkv(q, k, v, do, lse, di, scale=scale, causal=causal,
                          plain=plain)
        return grad_err(got, dense_dkv_f64(q, k, v, do, causal, scale))
    got = emulate_flash_dq(q, k, v, do, lse, di, scale=scale, causal=causal,
                           plain=plain)
    want = dense_grads_f64(q, k, v, do, causal, scale)
    top = max(float(np.abs(w).max()) for w in want)
    return float(np.abs(got - want[0]).max()) / top


# every head dim of the flash backward walks meets its odd-L masks, causal
# and full, plus one long causal case
FLASH_BWD_CASES = [(c, L, D) for c in (True, False)
                   for L in (1, 7, 129, 300) for D in (16, 64, 128)] + [
                       (True, 1024, 128)]


def _flash_bwd_ids(x):
    return ("causal" if x else "full") if isinstance(x, bool) else str(x)


def _flash_bwd_shape(causal, L):
    return ((1, 3) if causal else (3, 1)) if L < 1024 else (1, 1)


@pytest.mark.parametrize("causal, L, D", FLASH_BWD_CASES, ids=_flash_bwd_ids)
def test_flash_dkv_3xtf32_matches_jax_default(causal, L, D):
    B, H = _flash_bwd_shape(causal, L)
    err = flash_bwd_error("dkv", B, L, H, D, causal, seed=L * 10 + D)
    assert err <= TOL, err


@pytest.mark.parametrize("causal, L, D", FLASH_BWD_CASES, ids=_flash_bwd_ids)
def test_flash_dq_3xtf32_matches_jax_default(causal, L, D):
    B, H = _flash_bwd_shape(causal, L)
    err = flash_bwd_error("dq", B, L, H, D, causal, seed=L * 10 + D)
    assert err <= TOL, err


def splash_dkv_errors(L, causal, seed, D=128, plain=False):
    """The dK/dV emulation's (dk, dv) against jax.grad of the JAX splash
    kernel in the Pallas interpreter (f32) and of the dense default in f64,
    at [1, L, 1, D]."""
    q, k, v, qs, scale, tables = _splash_inputs(L, causal, seed, H=1, D=D)
    kinds = tables.lists["dkv"].kinds[tables.lists["dkv"].kinds > 0]
    assert set(kinds.tolist()) == ({1, 2} if causal else {2})
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(
        np.float32)
    o, lse = emulate_fwd(qs, k, v, tables=tables)
    di = np.einsum("blhd,blhd->bhl", o, do).astype(np.float32)
    got = emulate_dkv(qs, k, v, do, lse, di, tables=tables, plain=plain)
    jq, jdo = jnp.asarray(q), jnp.asarray(do)

    def splash(k, v):
        return jnp.sum(pk._splash_call(jq, k, v, causal, None) * jdo)
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        want = [np.asarray(x) for x in jax.grad(splash, (0, 1))(
            jnp.asarray(k), jnp.asarray(v))]
    finally:
        pk._INTERPRET = old
    return (grad_err(got, want),
            grad_err(got, dense_dkv_f64(q, k, v, do, causal, scale)))


@pytest.mark.parametrize("L, D, causal", [(1024, 128, True),
                                          (1024, 128, False),
                                          (512, 64, True)],
                         ids=["causal-1024-128", "full-1024-128",
                              "causal-512-64"])
def test_splash_dkv_3xtf32_matches_jax(L, D, causal):
    e_splash, e_dense = splash_dkv_errors(L, causal, seed=13 + D, D=D)
    assert e_splash <= TOL_F32_DQ and e_dense <= TOL, (e_splash, e_dense)


def test_plain_tf32_dkv_misses_the_chip_gate():
    """hi alone: the dK/dV emulation lands over chip_smoke.py's 1e-5 of
    the largest gradient, as the forward's does."""
    err = flash_bwd_error("dkv", 1, 1024, 1, 128, True, seed=10368,
                          plain=True)
    assert err > 1e-5, err


def test_plain_tf32_misses_the_chip_gate():
    """hi alone rounds each product's inputs to 11 significant bits: the
    error lands far over chip_smoke.py's 1e-5, so the kernels split."""
    eo, el = flash_errors(1, 1024, 1, 128, True, seed=0, plain=True)
    assert max(eo, el) > 1e-5, (eo, el)


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)  # tf32's spacing at 1
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -20,
                  -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, one, -(one + ulp), one + 2 * ulp],
                          np.float32))
    x = np.float32(np.pi)
    hi, lo = split(np.array([x]))
    assert hi[0] == np.float32(3.140625) and lo[0] != 0
    assert abs(float(hi[0]) + float(lo[0]) - float(x)) <= 2.0 ** -22 * x


def test_forward_wrappers_raise_for_misaligned_inputs():
    """The kernels copy 16-byte chunks: every input must start on 16
    bytes. A view offset by one float does not. The dK/dV and dQ wrappers
    check the same (q, k, v and dO)."""
    ok = torch.zeros(1, 3, 2, 64)
    ck._check_aligned("flash_attention_fwd", ok, ok, ok)
    shifted = torch.zeros(ok.numel() + 1)[1:].view(1, 3, 2, 64)
    assert shifted.is_contiguous()
    for name in ("flash_attention_fwd", "splash_attention_fwd",
                 "flash_attention_bwd_dkv", "splash_attention_bwd_dkv",
                 "flash_attention_bwd_dq", "splash_attention_bwd_dq"):
        with pytest.raises(ValueError, match="16 bytes"):
            ck._check_aligned(name, ok, shifted, ok)


if __name__ == "__main__":
    for plain in (False, True):
        eo, el = flash_errors(1, 1024, 1, 128, True, seed=0, plain=plain)
        print(f"{'plain TF32' if plain else '3xTF32'} flash causal [1, 1024, "
              f"1, 128]: max|diff|/max|ref| o {eo!r}, lse {el!r}; dk/dv "
              f"{flash_bwd_error('dkv', 1, 1024, 1, 128, True, 10368, plain)!r}"
              f" of max(|dk|, |dv|), dq "
              f"{flash_bwd_error('dq', 1, 1024, 1, 128, True, 10368, plain)!r}"
              f" of max(|dq|, |dk|, |dv|) against the dense default in f64")
        for causal in (True, False):
            es, ed = splash_dq_errors(1024, causal, seed=9, plain=plain)
            print(f"{'plain TF32' if plain else '3xTF32'} splash dq "
                  f"{'causal' if causal else 'full'} [1, 1024, 1, 128]: "
                  f"max|diff|/max|ref| vs the JAX splash kernel {es!r}, vs "
                  f"the dense default in f64 {ed!r}")
            es, ed = splash_dkv_errors(1024, causal, seed=141, plain=plain)
            print(f"{'plain TF32' if plain else '3xTF32'} splash dk/dv "
                  f"{'causal' if causal else 'full'} [1, 1024, 1, 128]: "
                  f"max|diff|/max(|dk|, |dv|) vs the JAX splash kernel "
                  f"{es!r}, vs the dense default in f64 {ed!r}")
