"""Long-context attention: ring attention and Ulysses sequence
parallelism — port of deeplearning4j_tpu/parallel/ring.py (JAX :36-153).

  - `full_attention`: dense attention in plain PyTorch, the reference;
  - `ring_attention`: the sequence is split over the mesh's ``seq`` ranks
    (L/n each); the K/V chunks rotate between neighbours (each rank sends
    its chunk to the next and takes the previous rank's) while each rank
    keeps a streaming softmax — running max, denominator and weighted
    sum, `_block_attend` (JAX :50-70) with its fully-masked-row guard
    (Liu et al., "Ring Attention with Blockwise Transformers");
  - `ulysses_attention`: an all-to-all turns the split over sequence into
    a split over heads, each rank attends over the full length on its
    H/n heads through `ops.helpers.attention` (on the card the flash
    forward kernel, PERF.md §6 row 6a, at H/n heads: JAX's seam
    `ophelpers.attention`, :143), and a second all-to-all turns it back
    (DeepSpeed-Ulysses).

The inputs are the global [B, L, H, D] tensors on the driver (rank 0);
the driver sends each rank of its ``axis`` group its L/n chunk, the ranks
compute, and the output is gathered back to the driver (one all-gather).
On a mesh of more axes the group on ``axis`` through rank 0 computes and
the others sit it out. Both are forward-only, as in JAX. A ring rotates
the K/V chunks n - 1 times: JAX's loop rotates them a last time, back to
their home rank, and discards them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import SEQ_AXIS, SERVICE_OPS

Tensor = torch.Tensor

OP_RING, OP_ULYSSES = SERVICE_OPS, SERVICE_OPS + 1
_FACTORY = "deeplearning4j_tpu_torch.parallel.ring:_service"


def _scale(D: int, dtype) -> Tensor:
    # JAX: 1 / sqrt(D) taken in the inputs' dtype
    return 1.0 / torch.sqrt(torch.tensor(float(D), dtype=dtype))


def full_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = False,
                   scale: Optional[float] = None) -> Tensor:
    """Dense reference attention. q, k, v: [B, L, H, D] -> [B, L, H, D]."""
    D = q.shape[-1]
    scale = scale or _scale(D, q.dtype).to(q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((Lq, Lk), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s,
                        torch.tensor(torch.finfo(s.dtype).min, dtype=s.dtype,
                                     device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _block_attend(q, k, v, m, l, o, scale, q_off: int, k_off: int,
                  causal: bool):
    """One streaming-softmax accumulation step (JAX :50-70). q: [B, Lq, H,
    D]; k, v: [B, Lk, H, D]; m, l: [B, H, Lq]; o: [B, Lq, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mn = torch.tensor(torch.finfo(s.dtype).min, dtype=s.dtype,
                      device=s.device)
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(Lq, device=q.device)
        kpos = k_off + torch.arange(Lk, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None]
        s = torch.where(mask, s, mn)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new could be -inf-like)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    corr = torch.exp(m - m_safe)
    p = torch.exp(s - m_safe[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_safe, l_new, o_new


def _ring_local(ac, q, k, v, causal: bool) -> Tensor:
    """A rank's ring: its query chunk against every K/V chunk as they pass
    by; the output chunk."""
    n, idx = ac.size, ac.rank
    B, chunk, H, D = q.shape
    scale = _scale(D, q.dtype).to(q.device)
    m = torch.full((B, H, chunk), torch.finfo(q.dtype).min, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros((B, H, chunk), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    kc, vc = k, v
    for step in range(n):
        # after `step` rotations this rank holds the chunk that started
        # on rank (idx - step) mod n
        src = (idx - step) % n
        m, l, o = _block_attend(q, kc, vc, m, l, o, scale, idx * chunk,
                                src * chunk, causal)
        if step < n - 1:
            kc = ac.exchange(kc, (idx + 1) % n, (idx - 1) % n)
            vc = ac.exchange(vc, (idx + 1) % n, (idx - 1) % n)
    denom = torch.clamp_min(l, 1e-20).transpose(1, 2)[..., None]
    return o / denom


def _ulysses_local(ac, q, k, v, causal: bool) -> Tensor:
    """A rank's Ulysses step: [B, L/n, H, D] chunks to [B, L, H/n, D]
    heads, attention through the seam, and back."""
    from ..ops import helpers as ophelpers

    def seq_to_head(x):
        return ac.all_to_all(x, 2, 1)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    oh = ophelpers.attention(qh.contiguous(), kh.contiguous(),
                             vh.contiguous(), causal=causal)
    return ac.all_to_all(oh, 1, 2)


def _rank_part(comm, meta, chunks=None) -> Optional[Tensor]:
    """Every rank's part of one call: the chunks from the driver (rank 0
    of the group), the local work, the output gathered on the group's
    ranks (the driver returns it)."""
    if not comm.on_axis_of_rank0(meta["axis"]):
        return None
    ac = comm.axis_comm(meta["axis"])
    dt = getattr(torch, meta["dtype"])
    if chunks is None:
        chunks = [ac.recv(meta["shape"], dt, 0, device=comm.device)
                  for _ in range(3)]
    else:
        for r in range(1, ac.size):
            for t in chunks:
                ac.send(t[r], r)
        chunks = [t[0] for t in chunks]
    q, k, v = chunks
    with torch.no_grad():
        fn = _ring_local if meta["kind"] == "ring" else _ulysses_local
        out = fn(ac, q, k, v, meta["causal"])
        return ac.all_gather(out, 1)


class _Service:
    def __init__(self, comm, payload):
        self.comm = comm

    def handle(self, cmd) -> None:
        import pickle
        meta = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        _rank_part(self.comm, meta)


def _service(comm, payload) -> _Service:
    return _Service(comm, payload)


def _as_tensor(a, device) -> Tensor:
    t = a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device)


def _run(kind: str, q, k, v, mesh, axis: str, causal: bool) -> Tensor:
    n = mesh.shape[axis]
    q, k, v = (_as_tensor(a, mesh.device) for a in (q, k, v))
    B, L, H, D = q.shape
    if kind == "ring" and L % n:
        raise ValueError(f"sequence length {L} not divisible by {axis}={n}")
    if kind == "ulysses" and (H % n or L % n):
        raise ValueError(f"heads {H} and length {L} must divide {axis}={n}")
    c = L // n
    chunks = [[t[:, r * c:(r + 1) * c].contiguous() for r in range(n)]
              for t in (q, k, v)]
    meta = {"kind": kind, "axis": axis, "causal": bool(causal),
            "shape": (B, c, H, D), "dtype": str(q.dtype).split(".")[-1]}
    return mesh.run_service(_FACTORY, OP_RING if kind == "ring"
                            else OP_ULYSSES, meta,
                            lambda: _rank_part(mesh, meta, chunks))


def ring_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                   causal: bool = False) -> Tensor:
    """Sequence-parallel attention over ``mesh[axis]`` (see the module
    docstring): global [B, L, H, D] inputs, the global output on the
    driver's device. L must divide by the axis size."""
    return _run("ring", q, k, v, mesh, axis, causal)


def ulysses_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                      causal: bool = False) -> Tensor:
    """All-to-all sequence parallelism (see the module docstring); H and
    L must divide by the axis size."""
    return _run("ulysses", q, k, v, mesh, axis, causal)
