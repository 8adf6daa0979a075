"""Speculative decoding and best-of-n fork groups — a port of
deeplearning4j_tpu/inference/speculative.py, host-only apart from the
draft's build.

  - :func:`shallow_draft_conf` / :func:`build_shallow_draft` (JAX
    :217-312): the self-speculative draft, a derived ComputationGraph that
    runs the target's first K transformer blocks and jumps straight to the
    target's own output head. Its params are the target's tensors by
    reference (read at build time; no copy, no extra weight bytes). The
    surgery needs the pre-LN residual trunk `models/zoo.transformer_lm`
    builds; any other graph raises ValueError, and the engine then wants
    an explicit ``draft_net``.
  - :func:`accept_tokens` (JAX :153-214): the acceptance rule. Each chain
    position samples from the TARGET distribution with the sequence's own
    RNG, in order, up to the first draw that leaves the draft; every
    emitted token is the one solo decode would emit, greedy and sampled
    alike. Draft quality moves only the acceptance rate.
  - :class:`ForkGroup`, `submit_fork_group`, `await_fork_group` (JAX
    :53-150): best-of-n. n candidates over one prompt share the prompt's
    paged KV blocks through copy-on-write: the first-submitted candidate
    is the *primary*; in paged mode the engine keeps the followers queued
    until the primary's prefill publishes the prompt's blocks
    (`DecodeScheduler._fork_publish`), and each follower then restores
    them as a block-table remap, copying only the block it writes into.
    Candidate i samples with ``seed + i``, so candidate 0 is the n = 1
    output.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..models.sampling import sample_logits

__all__ = ["ForkGroup", "accept_tokens", "await_fork_group",
           "build_shallow_draft", "shallow_draft_conf", "submit_fork_group"]


class ForkGroup:
    """Shared bookkeeping of one best-of-n candidate set.

    ``primary_handle`` is bound by the first ``engine.submit(...,
    fork=group)`` (candidates are submitted one after another, so there is
    no race); ``published`` is written by the scheduler thread only. A
    reader one iteration stale only delays a follower's admission by one
    pass. The group rides the supervisor's resubmission kwargs: after an
    engine swap ``published`` may refer to a pool the new engine does not
    have, which degrades to a cold prefill (a trie miss), never a wait
    without end."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"fork group size must be >= 1, got {n}")
        self.n = int(n)
        self.published = False
        self.primary_handle = None

    def bind_primary(self, handle) -> None:
        """The first submitted candidate becomes the primary."""
        if self.primary_handle is None:
            self.primary_handle = handle

    def waiting(self, handle) -> bool:
        """True while ``handle`` (a follower) should stay queued: the
        primary is alive and has not published the prompt's blocks yet. A
        finished primary opens the gate: the followers then prefill cold
        rather than wait for ever."""
        p = self.primary_handle
        return (not self.published and p is not None and handle is not p
                and not p.done())


def submit_fork_group(submit: Callable, prompt_ids: Sequence[int], n: int,
                      max_new_tokens: int, *, seed: int = 0,
                      request_id: Optional[str] = None, **kw) -> List:
    """Fan one prompt out into ``n`` candidates through ``submit`` (the
    engine's or the supervisor's). Candidate i samples with ``seed + i``
    and, given a base ``request_id``, carries ``<id>.cI``. If a later
    submit fails (queue full, the ladder, an engine recovering), every
    candidate submitted already is cancelled before the error
    propagates."""
    group = ForkGroup(n)
    handles: List = []
    try:
        for i in range(n):
            handles.append(submit(
                prompt_ids, max_new_tokens, seed=seed + i, fork=group,
                request_id=f"{request_id}.c{i}" if request_id else None,
                **kw))
    except BaseException:
        for h in handles:
            h.cancel()
        raise
    return handles


def await_fork_group(handles: Sequence, timeout: Optional[float],
                     clock: Callable[[], float] = time.monotonic) -> None:
    """Wait for every candidate against one shared deadline; a timeout
    cancels every unfinished candidate before it propagates."""
    deadline = (clock() + timeout) if timeout is not None else None
    try:
        for h in handles:
            h.result(None if deadline is None
                     else max(0.0, deadline - clock()))
    except TimeoutError:
        for h in handles:
            if not h.done():
                h.cancel()
        raise


def accept_tokens(rows: np.ndarray, proposals: Sequence[int],
                  temperature: float, top_k: Optional[int],
                  top_p: Optional[float], rng: np.random.Generator,
                  max_tokens: int, eos_id: Optional[int],
                  proc=None) -> Tuple[List[int], int]:
    """Token-identical acceptance over one verified chain (JAX :153).

    ``rows``: the target's next-token distributions for the chain
    ``[last_token, d_1, ..., d_g]`` (``rows[j]`` follows chain position
    ``j``; rows ``0..len(proposals)`` are read). ``proposals``: the g draft
    tokens. Walks the chain sampling each row with the sequence's ``rng``
    and stops at the first token that leaves the draft (later rows are
    conditioned on rejected context), at EOS or at ``max_tokens``; when
    every draft matches, the last row gives one bonus token. The RNG is
    never drawn past the stop, so it stays in step with solo decode.

    ``proc`` (`logitproc.LogitState` or None): each row is penalty-adjusted
    and grammar-masked as solo decode's `_consume` does, and the pipeline
    observes each emitted token here, in emission order; a grammar that
    completes mid-chain stops the walk.

    Returns ``(emitted, matched)``: the 1..g+1 accepted tokens, and how many
    draft proposals they confirmed (the acceptance-rate numerator)."""
    g = len(proposals)
    emitted: List[int] = []
    matched = 0
    for j in range(g + 1):
        if len(emitted) >= max_tokens:
            break
        if proc is not None and proc.exhausted():
            break  # grammar complete: later rows must not draw
        row = rows[j]
        allow = None
        if proc is not None:
            row = proc.adjust(row)
            allow = proc.allow_row()
        tok = sample_logits(row, temperature, top_k, rng, top_p, allow=allow)
        emitted.append(tok)
        if proc is not None:
            proc.advance(tok)
        if eos_id is not None and tok == eos_id:
            if j < g and tok == proposals[j]:
                matched += 1
            break
        if j < g:
            if tok != proposals[j]:
                break  # rows[j+1:] follow the rejected draft
            matched += 1
    return emitted, matched


def shallow_draft_conf(conf, draft_blocks: int):
    """The early-exit draft configuration (JAX :217): the first
    ``draft_blocks`` transformer blocks of ``conf`` wired straight into the
    target's head chain (final LayerNorm + output layer).

    The shape it cuts (`models/zoo.transformer_lm`, pre-LN residual trunk):
    each attention layer sits behind a single-input normalization vertex
    whose input is the block's trunk entry, blocks join through
    ElementWise vertices, and the head is a chain of single-input
    non-ElementWise vertices. Any other graph raises ValueError."""
    from ..nn.conf.graph import ElementWiseVertex, LayerVertex

    order = conf.topological_order()
    attns = [name for name in order
             if isinstance(conf.vertices[name], LayerVertex)
             and type(conf.vertices[name].layer).__name__
             == "SelfAttentionLayer"]
    if len(attns) < 2:
        raise ValueError(
            f"self-speculative draft needs >= 2 attention blocks to cut "
            f"between, found {len(attns)}")
    K = int(draft_blocks)
    if not 1 <= K < len(attns):
        raise ValueError(
            f"draft_blocks={K} must be in [1, {len(attns) - 1}] "
            f"(the model has {len(attns)} attention blocks)")
    # block K's trunk entry: the input of the pre-LN feeding attention K
    ln_k = conf.vertex_inputs[attns[K]][0]
    entry = conf.vertex_inputs[ln_k][0]
    if entry not in conf.vertices:
        raise ValueError(f"block {K}'s trunk entry '{entry}' is a network "
                         "input: nothing to cut")
    # the head chain: back from the output through single-input,
    # non-residual vertices, to the last block's residual join
    head: List[str] = []
    v = conf.network_outputs[0]
    while (v in conf.vertices
           and not isinstance(conf.vertices[v], ElementWiseVertex)
           and len(conf.vertex_inputs.get(v, [])) == 1):
        head.append(v)
        v = conf.vertex_inputs[v][0]
    if not head or not isinstance(conf.vertices.get(v), ElementWiseVertex):
        raise ValueError(
            "could not identify the output head chain (expected a "
            "single-input chain ending at a residual ElementWise vertex)")
    keep = set(head)
    stack = [entry]
    while stack:
        n = stack.pop()
        if n in keep or n not in conf.vertices:
            continue
        keep.add(n)
        stack.extend(conf.vertex_inputs.get(n, []))
    draft = copy.deepcopy(conf)
    draft.vertices = {n: vx for n, vx in draft.vertices.items() if n in keep}
    draft.vertex_inputs = {n: list(draft.vertex_inputs[n])
                           for n in draft.vertices}
    # the deepest head vertex (the final LayerNorm) exits from block K's
    # trunk output instead of block N's
    draft.vertex_inputs[head[-1]] = [entry]
    for n, ins in draft.vertex_inputs.items():
        for src in ins:
            if src not in draft.vertices and src not in draft.network_inputs:
                raise ValueError(
                    f"draft surgery left vertex '{n}' referencing removed "
                    f"vertex '{src}': graph shape not supported")
    return draft


def build_shallow_draft(net, draft_blocks: int,
                        max_cache_len: Optional[int] = None):
    """The early-exit draft as a ComputationGraph on ``net``'s device whose
    params are the target's tensors by reference (JAX :291), bound at
    build time. ``max_cache_len``: the draft's attention cache depth (a
    paged engine caps its private contiguous cache there)."""
    from ..nn.graph import ComputationGraph

    dconf = shallow_draft_conf(net.conf, draft_blocks)
    if max_cache_len is not None:
        for vx in dconf.vertices.values():
            layer = getattr(vx, "layer", None)
            if layer is not None and hasattr(layer, "max_cache_len"):
                layer.max_cache_len = int(max_cache_len)
    draft = ComputationGraph(dconf, device=net.device)
    draft._initialized = True
    draft.params = {name: net.params[name] for name in draft._impls}
    return draft
