"""Per-request token streams — the `TokenStream` of
deeplearning4j_tpu/inference/logitproc.py (JAX :793-862), host-only.

The rest of the JAX module (the stop matcher, penalties, grammar DFAs,
`MaskPool` and the masked programs) is not ported yet (ROADMAP A4); the
port's server refuses the request fields that would need them.
"""
from __future__ import annotations

import queue
import time
from typing import Optional


class TokenStream:
    """Thread-safe per-request token event queue — the backing store of
    one SSE response.

    Producer side (the scheduler thread, via `DecodeHandle`): ``push`` one
    event per released token, ``close`` once with the terminal event.
    Pushes are deduplicated by token INDEX: a supervisor crash-recovery
    re-decode (token-identical by construction) re-emits from index 0,
    and the already-streamed prefix is skipped — the client sees each
    token exactly once, across engine restarts.

    Consumer side (the HTTP handler thread): iterate :meth:`events` until
    the terminal event (``{"done": true, ...}`` carrying the final token
    list, ``finish_reason``, ``request_id`` and the per-phase ``timings``
    breakdown)."""

    def __init__(self):
        self._q: "queue.SimpleQueue[dict]" = queue.SimpleQueue()
        self._sent = 0      # next unstreamed token index (producer only)
        self._closed = False

    @property
    def sent(self) -> int:
        return self._sent

    def push(self, index: int, tok: int) -> None:
        if index < self._sent or self._closed:
            return  # crash-recovery re-emission of an already-sent token
        self._sent = index + 1
        self._q.put({"token": int(tok), "index": int(index)})

    def close(self, handle, error: Optional[BaseException] = None) -> None:
        """Terminal event (exactly once): flush any tokens not pushed yet
        (``handle.tokens`` is final), then the done record."""
        if self._closed:
            return
        tokens = list(handle.tokens)
        for i in range(self._sent, len(tokens)):
            self._sent = i + 1
            self._q.put({"token": int(tokens[i]), "index": i})
        evt = {"done": True, "request_id": handle.request_id,
               "tokens": tokens,
               "finish_reason": getattr(handle, "finish_reason", None),
               "timings": handle.timings()}
        if error is not None:
            evt["error"] = str(error)
        self._closed = True
        self._q.put(evt)

    def events(self, deadline: Optional[float] = None):
        """Yield events until the terminal one. ``deadline``: absolute
        `time.monotonic` cutoff — expiry raises TimeoutError (the SSE
        writer cancels the request and answers in-band)."""
        while True:
            if deadline is None:
                evt = self._q.get()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("stream deadline exceeded")
                try:
                    evt = self._q.get(timeout=remaining)
                except queue.Empty:
                    raise TimeoutError("stream deadline exceeded")
            yield evt
            if evt.get("done"):
                return
