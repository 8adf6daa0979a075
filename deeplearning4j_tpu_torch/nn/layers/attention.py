"""Multi-head self-attention layer — port of
deeplearning4j_tpu/nn/layers/attention.py.

Three paths, as in the JAX package:

  - ``forward``: full-sequence attention (no cache) through the
    ``attention`` seam (ops/helpers.py; the flash or splash kernels on the
    card): the training path, the uncached `generate_transformer` path
    and `ComputationGraph.output`;
  - ``_contiguous_step``: the KV-cached step of `rnn_time_step` and
    `generate_transformer(use_cache=True)`, over a per-row cache ``k``/
    ``v`` [B, max_cache_len, Hkv, Dh] from ``init_state``, at a scalar or
    [B] position, any T (decode or a prefill chunk);
  - ``_paged_step``: the paged-KV inference step the decode engine runs
    (inference/engine.py). K/V rows live in pool-wide page arrays
    ``k_pages``/``v_pages`` [pages, block, Hkv, Dh] (page 0 the scratch
    page), reached through an int32 block ``table`` [B, nb] injected per
    call.

Both cached steps update their K/V arrays IN PLACE (the JAX steps return
new arrays; the caller owns the only reference to its cache, so the port
saves a copy of the cache per step) and return them in their state.

Layout: x [B, T, F]; q [B, T, H, Dh]; K/V [B, T, Hkv, Dh] with query
head h = hkv * G + g (G = H / Hkv), RoPE half-split ("rotate-half":
dim i pairs with i + Dh/2).
"""
from __future__ import annotations

import math

import torch

from .base import BaseRecurrentImpl, register_impl
from .. import weights as winit
from ...ops import helpers as ophelpers
from ...ops.kvquant import dequantize_kv_rows, quantize_kv_rows
from ...parallel.tp_autograd import copy_to_tp, reduce_from_tp

# the overflow sentinel: an absolute position past every table bucket
# the scheduler may present later (JAX attention.py:374)
OVERFLOW_POS = 1 << 30


def _tracing() -> bool:
    """Whether the step is being captured (a CUDA graph) or compiled, where
    a position cannot be read on the host: the counterpart of a JAX
    tracer."""
    return torch.compiler.is_compiling() or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


@register_impl("SelfAttentionLayer")
class SelfAttentionLayerImpl(BaseRecurrentImpl):
    WEIGHT_KEYS = ("Wq", "Wk", "Wv", "Wo")
    TBPTT_STATE = False  # the KV cache is inference-only state
    # a tensor-parallel rank's communicator (inference/sharding.py): the
    # conf then carries the rank's local heads, Wo its rows of them
    tp_comm = None
    # tensor-parallel training (parallel/tp_autograd.py): the input's
    # copy_to_tp communicator; ``tp_kv`` when the heads are split but
    # K/V stay whole (GQA whose Hkv the axis does not divide): each rank
    # takes its heads of the repeated K/V, and Wk/Wv's gradients are
    # summed over the axis
    tp_copy = None
    tp_kv = None

    def _kv_heads(self) -> int:
        conf = self.conf
        kv = getattr(conf, "n_kv_heads", None)
        if self.tp_kv is not None:
            return kv
        if kv is None:
            return conf.n_heads
        if kv <= 0 or conf.n_heads % kv:
            raise ValueError(f"n_kv_heads={kv} must be a positive divisor "
                             f"of n_heads={conf.n_heads}")
        return kv

    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        conf = self.conf
        model = conf.n_out
        kv_dim = self._kv_heads() * (model // conf.n_heads)

        def mk(i, o):
            return winit.init_weights(gen, (i, o),
                                      conf.weight_init or winit.XAVIER,
                                      dtype, device)
        return {
            "Wq": mk(conf.n_in, model),
            "Wk": mk(conf.n_in, kv_dim),
            "Wv": mk(conf.n_in, kv_dim),
            "Wo": mk(model, model),
            "b": torch.full((model,), float(conf.bias_init or 0.0),
                            dtype=dtype, device=device),
        }

    def init_state(self, batch: int, dtype=torch.float32,
                   device=torch.device("cpu")):
        """An empty contiguous KV cache (JAX attention.py :80): K/V [batch,
        max_cache_len, Hkv, Dh] zeros (GQA's cache holds the compact KV
        heads) and the scalar position 0."""
        conf = self.conf
        Dh = conf.n_out // conf.n_heads
        L = int(getattr(conf, "max_cache_len", 1024))
        shape = (batch, L, self._kv_heads(), Dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def _qkv(self, params, x, pos0=0):
        """Projections as [B, T, heads, Dh]; K/V keep their n_kv_heads."""
        conf = self.conf
        B, T, _ = x.shape
        H = conf.n_heads
        Dh = conf.n_out // H
        Hkv = self._kv_heads()
        Wk, Wv = params["Wk"], params["Wv"]
        if self.tp_kv is not None:
            Wk, Wv = copy_to_tp(self.tp_kv, Wk), copy_to_tp(self.tp_kv, Wv)
        q = (x @ params["Wq"]).reshape(B, T, H, Dh)
        k = (x @ Wk).reshape(B, T, Hkv, Dh)
        v = (x @ Wv).reshape(B, T, Hkv, Dh)
        if getattr(conf, "rope", False):
            q = self._rope(q, pos0)
            k = self._rope(k, pos0)
        return q, k, v

    def _rope(self, a, pos0):
        """Rotary position embedding on [B, T, H, Dh], half-split pairing.
        ``pos0``: an int (whole batch at one depth) or a [B] tensor (each
        row at its own depth)."""
        B, T, H, Dh = a.shape
        if Dh % 2:
            raise ValueError(f"rope requires an even head dim, got {Dh}")
        half = Dh // 2
        dev = a.device
        # the base is filled on the device (no host copy), so the step can
        # be captured into a CUDA graph
        freq = torch.full((), self.conf.rope_base, dtype=torch.float32,
                          device=dev) ** (
            -torch.arange(half, dtype=torch.float32, device=dev) / half)
        t = torch.arange(T, dtype=torch.float32, device=dev)
        if isinstance(pos0, torch.Tensor) and pos0.dim():
            ang = (pos0.to(torch.float32)[:, None]
                   + t[None, :])[:, :, None] * freq[None, None]
            cos = torch.cos(ang)[:, :, None, :].to(a.dtype)
            sin = torch.sin(ang)[:, :, None, :].to(a.dtype)
        else:
            ang = (float(pos0) + t)[:, None] * freq[None]
            cos = torch.cos(ang)[None, :, None, :].to(a.dtype)
            sin = torch.sin(ang)[None, :, None, :].to(a.dtype)
        a1, a2 = a[..., :half], a[..., half:]
        return torch.cat([a1 * cos - a2 * sin, a1 * sin + a2 * cos], dim=-1)

    def _out(self, params, o, B, T):
        out = o.reshape(B, T, self.conf.n_out) @ params["Wo"]
        if self.tp_comm is not None:
            # row-split Wo: sum the ranks' partial products, then add the
            # replicated bias once
            out = reduce_from_tp(self.tp_comm, out)
        out = out + params["b"]
        return self.activation_fn()(out)

    def _grouped_attention(self, q, k, v, *, causal, qpos0=0):
        """Dense attention with q grouped over compact KV heads (JAX
        attention.py :173): the body of both cached steps. q: [B, T, H,
        Dh]; k, v: [B, L, Hkv, Dh] -> [B, T, H, Dh]. ``qpos0``: an int or
        0-dim tensor (the batch at one depth), or a [B] tensor of per-row
        depths; query t of row b sees keys up to qpos0[b] + t."""
        B, T, H, Dh = q.shape
        L, Hkv = k.shape[1], k.shape[2]
        dev = q.device
        qg = q.reshape(B, T, Hkv, H // Hkv, Dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(Dh)
        if causal:
            ar = torch.arange(L, device=dev)
            tt = torch.arange(T, device=dev)
            if isinstance(qpos0, torch.Tensor) and qpos0.dim():
                valid = ar[None, None, :] <= (qpos0.long()[:, None, None]
                                              + tt[None, :, None])
                valid = valid[:, None, None]
            else:
                valid = (ar[None, :] <= int(qpos0) + tt[:, None])[
                    None, None, None]
            s = torch.where(valid, s.to(torch.float32),
                            torch.finfo(torch.float32).min)
        p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, T, H, Dh)

    def _expand_kv(self, a):
        """Repeat [B, T, Hkv, Dh] K/V over the n_heads query heads (head h
        reads kv-head h // G, G = H / Hkv)."""
        if self.tp_kv is not None:
            # this rank's heads of the whole K/V, repeated
            H = self.conf.n_heads
            G = H * self.tp_kv.size // a.shape[2]
            return torch.repeat_interleave(a, G, dim=2).narrow(
                2, self.tp_kv.rank * H, H)
        G = self.conf.n_heads // a.shape[2]
        return a if G == 1 else torch.repeat_interleave(a, G, dim=2)

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        """Full-sequence attention through the ``attention`` seam (the
        flash kernels on the card), GQA's K/V repeated to the query heads
        first — what the JAX forward does when an attention helper is
        registered (attention.py :160-168). Input dropout at train time."""
        conf = self.conf
        x = copy_to_tp(self.tp_copy, self._dropout(x, train, gen))
        B, T, _ = x.shape
        q, k, v = self._qkv(params, x)
        o = ophelpers.attention(q, self._expand_kv(k), self._expand_kv(v),
                                causal=conf.causal)
        if mask is not None:
            o = o * mask[:, :, None, None].to(o.dtype)
        return self._out(params, o, B, T)

    def forward_with_state(self, params, x, state0, *, train=False, gen=None,
                           mask=None):
        """Full-sequence attention when training or when no cache state is
        given; the paged step when the state carries pages; else the
        contiguous step (JAX attention.py :199). Positions past the cache
        are unsupported: where the position can be read (always, unless
        the step is being captured or compiled) a write past
        ``max_cache_len`` raises here; the step itself poisons it."""
        if train or state0 is None:
            return self.forward(params, x, train=train, gen=gen,
                                mask=mask), state0
        if not self.conf.causal:
            raise NotImplementedError(
                "KV-cached decode requires causal=True: a non-causal "
                "layer's full forward attends to future positions the "
                "cache cannot know yet")
        if "k_pages" in state0:
            return self._paged_step(params, x, state0, mask=mask)
        pos = state0["pos"]
        L_cap = state0["k"].shape[1]
        T = x.shape[1]
        if not _tracing():
            deepest = int(pos.max())
            if deepest + T > L_cap:
                raise ValueError(
                    f"KV cache overflow: position {deepest}+{T} exceeds "
                    f"max_cache_len={L_cap}; raise SelfAttentionLayer."
                    f"max_cache_len or rnn_clear_previous_state()")
        return self._contiguous_step(params, x, state0, mask=mask)

    def _contiguous_step(self, params, x, state0, *, mask=None):
        """KV-cached incremental attention (JAX attention.py :214-261):
        ``state0`` {"k", "v" [B, L_cap, Hkv, Dh], "pos" scalar or [B]
        int32}. The T new K/V rows land at pos (clamped to [0, L_cap - T],
        as `dynamic_update_slice` clamps), then the grouped contraction
        reads the compact cache. A row whose write passes the cache gets
        NaN output, and its next position is frozen at L_cap + 1, so every
        later step poisons it too; only a fresh state (the graph's
        ``rnn_clear_previous_state``) recovers.

        An optional ``state0["slot"]`` ([B] int tensor) names the cache
        rows the batch owns: the write goes into those rows in place and
        the attention reads a gathered copy of them — the decode engine's
        captured prefill chunk, whose slot is a device index (JAX
        `_slice_slot`/`_scatter_slot`, engine.py:1352). An optional
        ``state0["wmask"]`` ([B, T] bool, per-row positions) writes the
        masked lanes' rows back unchanged: the decode engine's speculative
        verify, whose frozen rows must not land in another slot's real
        rows where the write window is clamped at the stripe's end."""
        B, T, _ = x.shape
        pos = state0["pos"]
        kc, vc = state0["k"], state0["v"]
        slot = state0.get("slot")
        L_cap = kc.shape[1]
        per_slot = pos.dim() > 0
        overflow = (pos + T) > L_cap
        q, k_new, v_new = self._qkv(params, x, pos0=pos)
        start = torch.clamp(pos.long(), min=0, max=max(L_cap - T, 0))
        at = start[..., None] + torch.arange(T, device=x.device)
        if slot is not None:
            rows = slot.long()[:, None]
            kc[rows, at] = k_new
            vc[rows, at] = v_new
            ka, va = kc.index_select(0, slot.long()), \
                vc.index_select(0, slot.long())
        elif per_slot:
            rows = torch.arange(B, device=x.device)[:, None]
            wmask = state0.get("wmask")
            if wmask is not None:
                keep = wmask[..., None, None]
                k_new = torch.where(keep, k_new, kc[rows, at])
                v_new = torch.where(keep, v_new, vc[rows, at])
            kc[rows, at] = k_new
            vc[rows, at] = v_new
            ka, va = kc, vc
        else:
            kc[:, at] = k_new
            vc[:, at] = v_new
            ka, va = kc, vc
        o = self._grouped_attention(q, ka, va, causal=True, qpos0=pos)
        if mask is not None:
            o = o * mask[:, :, None, None].to(o.dtype)
        y = self._out(params, o, B, T)
        y = torch.where(overflow[:, None, None] if per_slot else overflow,
                        float("nan"), y)
        next_pos = torch.where(overflow, L_cap + 1, pos + T).to(torch.int32)
        out = {"k": kc, "v": vc, "pos": next_pos}
        if slot is not None:
            out["slot"] = slot
        return y, out

    def _paged_step(self, params, x, state0, *, mask=None):
        """Paged-KV inference step (JAX attention.py:263).

        ``state0``: {"k_pages", "v_pages", ["k_scales", "v_scales"], "pos"
        [B] int32, "table" [B, nb] int32, optional "wmask" [B, T] bool,
        optional "paged_kernel" "on"|"off"}. The write at absolute
        position p lands in ``pages[table[b, p // block], p % block]``;
        lanes masked off by ``wmask`` (idle slots, padded prefill lanes)
        are redirected to the scratch page AND zeroed — a non-finite row
        in page 0 would leak into every reader. int8 pages quantize on
        write. T=1 reads through the ``paged_decode_attention`` seam (the
        CUDA kernel on the card); otherwise, or with paged_kernel "off",
        the gather body below reads the whole table back in logical order.
        Rows whose write would pass the table get NaN output and the
        overflow sentinel as their next position."""
        B, T, _ = x.shape
        pos = state0["pos"]
        table = state0["table"]
        kp, vp = state0["k_pages"], state0["v_pages"]
        Bk = kp.shape[1]
        nb = table.shape[1]
        L = nb * Bk
        wmask = state0.get("wmask")
        ks, vs = state0.get("k_scales"), state0.get("v_scales")
        quantized = ks is not None
        overflow = (pos + T) > L
        q, k_new, v_new = self._qkv(params, x, pos0=pos)
        p = pos.long()[:, None] + torch.arange(T, device=x.device)[None, :]
        blk = torch.gather(table.long(), 1, torch.clamp(p // Bk, max=nb - 1))
        if wmask is not None:
            blk = torch.where(wmask, blk, 0)
            keep = wmask[..., None, None]
            k_new = torch.where(keep, k_new, 0.0)
            v_new = torch.where(keep, v_new, 0.0)
        blk = torch.where(p // Bk < nb, blk, 0)
        off = p % Bk
        if quantized:
            kq, ksc = quantize_kv_rows(k_new)
            vq, vsc = quantize_kv_rows(v_new)
            kp[blk, off] = kq
            vp[blk, off] = vq
            ks[blk, off] = ksc
            vs[blk, off] = vsc
        else:
            kp[blk, off] = k_new
            vp[blk, off] = v_new
        o = None
        if T == 1:
            o = ophelpers.paged_decode_attention(
                q.contiguous(), kp, vp, table, pos, k_scales=ks, v_scales=vs,
                mode=state0.get("paged_kernel", "on"))
        if o is None:
            dt = q.dtype
            tl = table.long()
            if quantized:
                kc = dequantize_kv_rows(kp[tl], ks[tl], dt).reshape(
                    B, L, kp.shape[2], kp.shape[3])
                vc = dequantize_kv_rows(vp[tl], vs[tl], dt).reshape(
                    B, L, vp.shape[2], vp.shape[3])
            else:
                kc = kp[tl].reshape(B, L, kp.shape[2], kp.shape[3])
                vc = vp[tl].reshape(B, L, vp.shape[2], vp.shape[3])
            o = self._grouped_attention(q, kc, vc, causal=True, qpos0=pos)
        if mask is not None:
            o = o * mask[:, :, None, None].to(o.dtype)
        y = self._out(params, o, B, T)
        y = torch.where(overflow[:, None, None], float("nan"), y)
        next_pos = torch.where(overflow, OVERFLOW_POS, pos + T).to(torch.int32)
        out_state = {"k_pages": kp, "v_pages": vp, "pos": next_pos}
        if quantized:
            out_state["k_scales"] = ks
            out_state["v_scales"] = vs
        return y, out_state
