"""Autoregressive generation — port of deeplearning4j_tpu/models/sampling.py.

Sampling runs on the host with numpy, from a per-request
``np.random.default_rng(seed)``, exactly as in the JAX package: given the
same probability row and seed both packages draw the same token, which is
what lets their decode engines be compared token for token.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _sample_logits(probs: np.ndarray, temperature: float, top_k: Optional[int],
                   rng: np.random.Generator,
                   top_p: Optional[float] = None) -> int:
    """Pick a token id from one probability row [V]: greedy at
    temperature <= 0, else temperature / top-k / top-p sampling. (The JAX
    function's ``allow`` mask comes with the logit-processor slice.)"""
    if temperature <= 0.0:  # greedy
        return int(probs.argmax())
    logits = np.log(np.maximum(probs, 1e-30)) / temperature
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
    return int(rng.choice(p.shape[-1], p=p))


# the decode engine selects tokens through the SAME function the solo
# generator uses: one sampling definition, two decode loops
sample_logits = _sample_logits


def onehot(ids: Sequence[int], vocab_size: int) -> np.ndarray:
    """[1, T, vocab] float32 one-hot rows of ``ids``."""
    ids = np.asarray(ids, dtype=np.int64)
    x = np.zeros((1, len(ids), vocab_size), np.float32)
    x[0, np.arange(len(ids)), ids] = 1.0
    return x


def generate_transformer(net, prompt_ids: Sequence[int], n_tokens: int,
                         vocab_size: int, *, temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         seed: int = 0) -> list:
    """Continue ``prompt_ids`` by ``n_tokens`` with a transformer_lm
    ComputationGraph, re-forwarding the full context per token on the
    net's device. (The JAX function's context window and KV-cached solo
    path come with the contiguous-cache slice.)"""
    if not len(prompt_ids):
        raise ValueError("prompt_ids must be non-empty (the model needs at "
                         "least one token of context)")
    rng = np.random.default_rng(seed)
    ids = [int(i) for i in prompt_ids]
    out = []
    for _ in range(n_tokens):
        probs = net.output(onehot(ids, vocab_size))[0][0, -1].cpu().numpy()
        nxt = _sample_logits(probs, temperature, top_k, rng, top_p)
        ids.append(nxt)
        out.append(nxt)
    return out
