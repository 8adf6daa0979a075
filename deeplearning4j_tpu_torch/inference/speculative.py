"""Best-of-n fork groups — the `ForkGroup`, `submit_fork_group` and
`await_fork_group` of deeplearning4j_tpu/inference/speculative.py (JAX
:53-150), host-only.

n candidates over one prompt share the prompt's paged KV blocks through
copy-on-write: the first-submitted candidate is the *primary*; in paged
mode the engine keeps the followers queued until the primary's prefill
publishes the prompt's blocks (`DecodeScheduler._fork_publish`), and each
follower then restores them as a block-table remap, copying only the
block it writes into. Candidate i samples with ``seed + i``, so candidate
0 is the n = 1 output.

The rest of the JAX module (the shallow-exit draft, the acceptance rule
and the engine's speculation programs) is not ported yet (ROADMAP A4):
`DecodeScheduler(speculate > 0)` raises.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

__all__ = ["ForkGroup", "await_fork_group", "submit_fork_group"]


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
