"""The split-over-pages paged decode kernel's walk and combine, emulated on
the CPU.

`ops/csrc/paged_decode_attention.cu` splits each (row, kv-head) page walk
over S blocks (S from `cuda_kernels._paged_splits`, a formula of the shapes):
split s walks the live pages among [s P, (s + 1) P), P =
`_paged_split_pages(nb, S)`; inside a block, work item (g, c) is query head
g over the split's pages c, c + C, ... (C = max(1, 4 // G) page classes a
head, one warp an item), each with an f32 online softmax over chunks of 32 /
ceil(Dh / 32) positions; the block merges its items per head (class 0
first), and a second kernel merges the splits in order (M = max m_s, out =
sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s, splits with l_s = 0 skipped).
With S = 1 the walk writes acc / l itself. No kernel runs here (no card, no
nvcc); `emulate_paged_split` repeats that walk and those merges in numpy f32,
int8 rows dequantized cast-then-multiply.

It is held against the JAX package on the CPU with inputs made by numpy from
a seed: `pallas_kernels._xla_paged_reference` (the gather path) and
`_paged_decode_call` in the Pallas interpreter (the TPU kernel's page walk),
at 2e-6 of max |reference|, for fp32 and int8 pages, MHA (8/8) and GQA
(8/2), at depths 0, 15, 16, either side of a split's end, nb * block - 1 and
the overflow sentinel 1 << 30, where rows at depth 0 or 15 leave every split
but the first without a live page; and at a one-page table bucket, where S
= 1 and the walk writes the output itself. The sums run in another order
than the reference's, hence a tolerance and not bit equality; the chip gate
is 1e-4 (chip_smoke.py phase 2).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import kvquant
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

TOL = 2e-6  # of max |reference|
BLOCK, DH, H = 16, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_ranges(nb, S, last):
    """The pages [start, stop) of each split, as the kernel assigns them."""
    P = ck._paged_split_pages(nb, S)
    return [(s * P, min((s + 1) * P, last + 1)) for s in range(S)]


def emulate_paged_split(q, kp, vp, table, pos, ks=None, vs=None):
    """out [B, 1, H, Dh] as the split page walk and its combine compute it;
    also returns S."""
    B, _, H, Dh = q.shape
    block, Hkv = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    G = H // Hkv
    C = max(1, ck._PAGED_WARPS // G)
    nl = -(-Dh // 32)
    chunk = 32 // next(n for n in (1, 2, 4, 8) if n >= nl)
    S = ck._paged_splits(B, Hkv, nb)
    sqrt_dh = np.sqrt(np.float32(Dh))
    out = np.zeros((B, 1, H, Dh), np.float32)
    for b in range(B):
        depth = int(pos[b])
        last = min(nb - 1, depth // block)
        for hkv in range(Hkv):
            parts = []  # per split: [G] (acc [Dh], m, l)
            for j0, j1 in split_ranges(nb, S, last):
                per_head = []
                for g in range(G):
                    qv = q[b, 0, hkv * G + g]
                    items = []
                    for c in range(C):
                        acc = np.zeros(Dh, np.float32)
                        m, l = np.float32(-np.inf), np.float32(0)
                        for j in range(j0 + c, j1, C):
                            page = int(table[b, j])
                            n_valid = min(block, depth - j * block + 1)
                            k = kp[page, :n_valid, hkv].astype(np.float32)
                            v = vp[page, :n_valid, hkv].astype(np.float32)
                            if ks is not None:
                                k = k * ks[page, :n_valid, hkv, None]
                                v = v * vs[page, :n_valid, hkv, None]
                            for t0 in range(0, n_valid, chunk):
                                sc = (k[t0:t0 + chunk] @ qv) / sqrt_dh
                                mx = max(m, sc.max())
                                alpha = np.exp(m - mx)
                                p = np.exp(sc - mx)
                                acc = acc * alpha + p @ v[t0:t0 + chunk]
                                l = l * alpha + p.sum(dtype=np.float32)
                                m = mx
                        items.append((acc, m, l))
                    per_head.append(_merge(items, Dh))
                parts.append(per_head)
            for g in range(G):
                if S == 1:
                    acc, _, l = parts[0][g]
                    out[b, 0, hkv * G + g] = acc / l
                else:
                    acc, _, l = _merge([p[g] for p in parts], Dh)
                    out[b, 0, hkv * G + g] = acc / l
    return out, S


def _merge(states, Dh):
    """(acc, m, l) states merged in order, those with l = 0 skipped."""
    M = np.float32(max(m for _, m, _ in states))
    acc = np.zeros(Dh, np.float32)
    lsum = np.float32(0)
    for a, m, l in states:
        if l > 0:
            w = np.exp(m - M)
            acc = acc + w * a
            lsum = lsum + w * l
    return acc, M, lsum


def _inputs(Hkv, quantized, depths, nb, seed):
    rng = np.random.default_rng(seed)
    B = len(depths)
    pages = B * nb + 1
    kp = rng.normal(size=(pages, BLOCK, Hkv, DH)).astype(np.float32)
    vp = rng.normal(size=(pages, BLOCK, Hkv, DH)).astype(np.float32)
    table = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    pos = np.asarray(depths, np.int32)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    ks = vs = None
    if quantized:
        kp, ks = (np.asarray(x) for x in kvquant.quantize_kv_rows(kp))
        vp, vs = (np.asarray(x) for x in kvquant.quantize_kv_rows(vp))
    return q, kp, vp, table, pos, ks, vs


def _check(Hkv, quantized, depths, nb, seed):
    args = _inputs(Hkv, quantized, depths, nb, seed)
    got, S = emulate_paged_split(*args)
    ref = np.asarray(pk._xla_paged_reference(*args))
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        kern = np.asarray(pk._paged_decode_call(*args))
    finally:
        pk._INTERPRET = old
    top = float(np.abs(ref).max())
    for want in (ref, kern):
        err = float(np.abs(got - want).max()) / top
        assert err <= TOL, err
    return S


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("Hkv", [8, 2], ids=["mha", "gqa"])
def test_split_walk_matches_jax_at_edge_depths(Hkv, quantized):
    nb = 8
    B = 8
    S = ck._paged_splits(B, Hkv, nb)
    end = ck._paged_split_pages(nb, S) * BLOCK  # split 0's first dead position
    depths = [0, BLOCK - 1, BLOCK, end - 1, end, 3 * BLOCK + 5,
              nb * BLOCK - 1, 1 << 30]
    assert len(depths) == B and S > 1
    # depths 0 and 15: every split but the first has no live page
    assert all(j0 >= j1 for j0, j1 in split_ranges(nb, S, 0)[1:])
    assert _check(Hkv, quantized, depths, nb, seed=Hkv * 2 + quantized) == S


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_one_page_bucket_writes_directly(quantized):
    """A one-page table bucket: S = 1, the walk writes the output."""
    S = _check(8, quantized, [0, 7, BLOCK - 1, 1 << 30], nb=1,
               seed=20 + quantized)
    assert S == 1


def test_splits_cover_every_page_once():
    """Every page of the table lies in exactly one split, page 0 in split
    0; S is at most nb and at least 1."""
    for B in (1, 2, 5, 8, 33, 300):
        for Hkv in (1, 2, 8):
            for nb in (1, 2, 3, 4, 7, 16, 63, 64, 65, 300):
                S = ck._paged_splits(B, Hkv, nb)
                assert 1 <= S <= nb
                owner = {}
                for s, (j0, j1) in enumerate(split_ranges(nb, S, nb - 1)):
                    for j in range(j0, j1):
                        assert j not in owner
                        owner[j] = s
                assert sorted(owner) == list(range(nb)) and owner[0] == 0


def test_split_count_fills_the_card_from_shapes():
    """About two blocks per SM of an H100 (132 SMs), from the shapes alone:
    the serving shapes (8 slots, 8 or 2 kv-heads, a 64-page bucket), one
    row, and a bucket of one page."""
    assert ck._paged_splits(8, 8, 64) == 5
    assert ck._paged_splits(8, 2, 64) == 17
    assert ck._paged_splits(1, 8, 64) == 33
    assert ck._paged_splits(8, 8, 1) == 1
    assert ck._paged_splits(300, 8, 64) == 1
