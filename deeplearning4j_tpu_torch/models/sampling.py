"""Autoregressive generation — port of deeplearning4j_tpu/models/sampling.py
(`generate_transformer` for the transformer graph, `generate_rnn` for the
recurrent MultiLayerNetwork).

Sampling runs on the host with numpy, from a per-request
``np.random.default_rng(seed)``, exactly as in the JAX package: given the
same probability row and seed both packages draw the same token, which is
what lets their decode engines be compared token for token.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _sample_logits(probs: np.ndarray, temperature: float, top_k: Optional[int],
                   rng: np.random.Generator,
                   top_p: Optional[float] = None,
                   allow: Optional[np.ndarray] = None) -> int:
    """Pick a token id from one probability row [V]: greedy at
    temperature <= 0, else temperature / top-k / top-p sampling (JAX
    sampling.py :17).

    ``allow`` (bool [V], grammar-constrained decoding,
    `inference/logitproc.py`): forbidden tokens get ``-inf`` logits, so
    their probability is exactly zero, with one ``rng.choice`` draw
    either way (the RNG stream stays in step with unconstrained decode).
    An all-True row changes no value: an admit-all grammar is
    token-identical to ``allow=None``. The caller guarantees one allowed
    token at least."""
    if temperature <= 0.0:  # greedy
        if allow is not None:
            # probs are softmax outputs (>= 0): -1 can never win argmax
            return int(np.where(allow, probs, -1.0).argmax())
        return int(probs.argmax())
    p = sampling_distribution(probs, temperature, top_k, top_p, allow)
    return int(rng.choice(p.shape[-1], p=p))


def sampling_distribution(probs: np.ndarray, temperature: float,
                          top_k: Optional[int],
                          top_p: Optional[float] = None,
                          allow: Optional[np.ndarray] = None) -> np.ndarray:
    """The distribution [V] that `_sample_logits` draws from at
    ``temperature`` > 0: the row's log-probabilities over the
    temperature, masked by ``allow``, top-k and top-p, renormalised."""
    logits = np.log(np.maximum(probs, 1e-30)) / temperature
    if allow is not None:
        logits = np.where(allow, logits, -np.inf)
    if top_k is not None and top_k > 0 and top_k < logits.shape[-1]:
        cutoff = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits >= cutoff, logits, -np.inf)
    if top_p is not None and 0.0 < top_p < 1.0:
        order = np.argsort(logits)[::-1]
        lmax = logits[order[0]]
        ps = np.exp(logits[order] - lmax)
        ps /= ps.sum()
        keep_n = int(np.searchsorted(np.cumsum(ps), top_p) + 1)
        drop = order[keep_n:]
        logits[drop] = -np.inf
    logits = logits - logits.max()
    p = np.exp(logits)
    p /= p.sum()
    return p


# the decode engine selects tokens through the SAME function the solo
# generator uses: one sampling definition, two decode loops
sample_logits = _sample_logits


def onehot(ids: Sequence[int], vocab_size: int) -> np.ndarray:
    """[1, T, vocab] float32 one-hot rows of ``ids``."""
    ids = np.asarray(ids, dtype=np.int64)
    x = np.zeros((1, len(ids), vocab_size), np.float32)
    x[0, np.arange(len(ids)), ids] = 1.0
    return x


def _cache_capacity_check(net, needed: int, prompt_len: int,
                          n_tokens: int) -> None:
    """Refuse up front a cached generation that would overflow an attention
    layer's ``max_cache_len``, before any token is consumed."""
    layer_confs = list(getattr(net.conf, "layers", []) or [])
    for v in getattr(net.conf, "vertices", {}).values():  # graph nets
        if getattr(v, "layer", None) is not None:
            layer_confs.append(v.layer)
    for conf in layer_confs:
        cap = getattr(conf, "max_cache_len", None)
        if (type(conf).__name__ == "SelfAttentionLayer" and cap is not None
                and needed > int(cap)):
            raise ValueError(
                f"prompt ({prompt_len}) + n_tokens ({n_tokens}) needs a KV "
                f"cache of {needed} but max_cache_len={int(cap)}; raise "
                f"max_cache_len or generate fewer tokens (checked upfront "
                f"so no tokens are consumed before the failure)")


def _host_probs(t) -> np.ndarray:
    """A next-token distribution on the host; bf16 (a bf16 net's output)
    comes as f32, which holds it exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def generate_transformer(net, prompt_ids: Sequence[int], n_tokens: int,
                         vocab_size: int, *, temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None, seed: int = 0,
                         max_context: Optional[int] = None,
                         use_cache: bool = False) -> list:
    """Continue ``prompt_ids`` by ``n_tokens`` with a transformer_lm
    ComputationGraph on the net's device (JAX sampling.py :65).

    use_cache=False re-forwards the context (its last ``max_context``
    tokens when given) per token; use_cache=True streams through the
    attention layers' contiguous KV cache (`rnn_time_step`: the prompt
    once, then one token per step; it needs prompt + n_tokens - 1 <=
    max_cache_len, and resets, and on exit clears, the net's streaming
    state)."""
    if not len(prompt_ids):
        raise ValueError("prompt_ids must be non-empty (the model needs at "
                         "least one token of context)")
    if use_cache and max_context is not None:
        raise ValueError("max_context (sliding window) is not supported "
                         "with use_cache=True: the KV cache never evicts; "
                         "use the re-forward path for windowed generation")
    rng = np.random.default_rng(seed)
    out = []
    if use_cache:
        _cache_capacity_check(net, len(prompt_ids) + max(n_tokens - 1, 0),
                              len(prompt_ids), n_tokens)
        net.rnn_clear_previous_state()
        try:
            probs = _host_probs(net.rnn_time_step(
                onehot(prompt_ids, vocab_size))[0][0, -1])
            for i in range(n_tokens):
                nxt = _sample_logits(probs, temperature, top_k, rng, top_p)
                out.append(nxt)
                if i + 1 < n_tokens:  # the final token needs no forward
                    probs = _host_probs(net.rnn_time_step(
                        onehot([nxt], vocab_size))[0][0, -1])
        finally:
            net.rnn_clear_previous_state()
        return out
    ids = [int(i) for i in prompt_ids]
    for _ in range(n_tokens):
        ctx = ids if max_context is None else ids[-max_context:]
        probs = _host_probs(net.output(onehot(ctx, vocab_size))[0][0, -1])
        nxt = _sample_logits(probs, temperature, top_k, rng, top_p)
        ids.append(nxt)
        out.append(nxt)
    return out


def generate_rnn(net, prompt_ids: Sequence[int], n_tokens: int,
                 vocab_size: int, *, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0) -> list:
    """Continue ``prompt_ids`` by ``n_tokens`` with a recurrent
    MultiLayerNetwork through stateful one-token `rnn_time_step` calls
    (JAX sampling.py :136): the prompt primes the state one token at a
    time, then each token's probability row is read back to the host and
    sampled with `sample_logits` from ``np.random.default_rng(seed)``, so
    a seeded stream is the JAX package's where the rows agree. Clears the
    net's streaming state first."""
    if not len(prompt_ids):
        raise ValueError("prompt_ids must be non-empty (the model needs at "
                         "least one token of context)")
    rng = np.random.default_rng(seed)
    net.rnn_clear_previous_state()

    def step(tok):
        return _host_probs(net.rnn_time_step(onehot([tok], vocab_size)))

    for tok in prompt_ids:  # prime the state one step at a time
        probs = step(tok)
    out = []
    for _ in range(n_tokens):
        nxt = _sample_logits(probs[0, -1], temperature, top_k, rng, top_p)
        out.append(nxt)
        probs = step(nxt)
    return out
