"""Continuous micro-batching for request/response inference, and the shape
buckets — a port of deeplearning4j_tpu/inference/batcher.py.

`MicroBatcher` (JAX :111) is the batched-session layer behind the
server's ``/predict``:

  - a bounded request queue with backpressure (`QueueFullError` once
    ``max_queue`` requests wait) and a per-request deadline (expired
    requests are failed with `RequestTimeoutError` without being
    dispatched);
  - a collator that aggregates waiting requests into ONE padded batch
    whose row count is a power of two up to ``max_batch`` (the JAX
    package compiles once per bucket; here the buckets keep the shapes
    the kernels see to a small set);
  - a single dispatcher thread that owns every model call — the model
    needs no lock — and scatters result rows back to per-request
    futures. The forward runs under ``torch.no_grad()`` and its output
    comes to the host with ONE copy per dispatch, not per request.

Per-row independence is the contract: ``forward_fn`` must compute row i
of the output from row i of the input only (true of every inference
forward in the package: BN runs on its running statistics).

The decode engine pads prefill chunks and block-table widths to the same
`pow2_buckets`, as the JAX engine does, so both engines run the same
shapes.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import failpoints
from .metrics import MetricsRegistry, default_registry
from .trace import FlightRecorder, default_recorder


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity."""


class RequestTimeoutError(TimeoutError):
    """The request's deadline expired before results were ready."""


class InferenceFuture:
    """Completion handle for one submitted request (an Event; the
    dispatcher resolves it directly)."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, result: np.ndarray) -> None:
        self._result = result
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise RequestTimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("x", "future", "deadline", "t_enqueue")

    def __init__(self, x: np.ndarray, deadline: Optional[float]):
        self.x = x
        self.future = InferenceFuture()
        self.deadline = deadline
        self.t_enqueue = time.monotonic()


def pow2_buckets(max_batch: int) -> List[int]:
    """Ascending powers of two below ``max_batch``, then ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def bucket_for(n: int, buckets: List[int]) -> int:
    """Smallest bucket covering ``n`` (buckets ascending)."""
    return next(b for b in buckets if b >= n)


def _to_host(out) -> np.ndarray:
    """The dispatch's one device->host copy (a no-op for numpy); a bf16
    net's output comes as f32, which holds it exactly."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu()
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()
    return np.asarray(out)


class MicroBatcher:
    """Aggregates concurrent `submit()` calls into bucketed padded batches
    executed by one dispatcher thread.

    ``forward_fn``: np.ndarray [B, ...] -> a tensor or array [B, ...],
    row-wise independent (typically the net's ``output``).
    ``batch_window_s``: how long the collator waits for more requests
    after the first one arrives — the latency/occupancy knob.
    """

    def __init__(self, forward_fn: Callable[[np.ndarray], object], *,
                 max_batch: int = 64, max_queue: int = 256,
                 batch_window_s: float = 0.002,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[FlightRecorder] = None,
                 name: str = "batcher"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.forward_fn = forward_fn
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.batch_window_s = float(batch_window_s)
        self.buckets = pow2_buckets(self.max_batch)
        self.metrics = metrics if metrics is not None else default_registry()
        # one span per dispatched batch on this batcher's own track (two
        # per-signature batchers sharing a recorder must not interleave
        # same-name spans on one track) + reject instants
        self.tracer = tracer if tracer is not None else default_recorder()
        self._name = name
        self._track = name + self.tracer.track_scope(name)
        self._queue: List[_Request] = []
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # instruments (created eagerly so /metrics shows them at depth 0)
        m = self.metrics
        self._m_queue_depth = m.gauge(f"{name}_queue_depth")
        self._m_occupancy = m.histogram(f"{name}_batch_occupancy",
                                        lo=1.0, hi=float(self.max_batch) + 1,
                                        per_decade=12)
        self._m_rows = m.counter(f"{name}_rows_total")
        self._m_batches = m.counter(f"{name}_batches_total")
        self._m_requests = m.counter(f"{name}_requests_total")
        self._m_rejected = m.counter(f"{name}_rejected_total")
        self._m_timeouts = m.counter(f"{name}_timeouts_total")
        self._m_queue_time = m.histogram(f"{name}_queue_time_sec")
        self._m_latency = m.histogram(f"{name}_latency_sec")

    # -- client side -------------------------------------------------------
    def submit(self, x, timeout_s: Optional[float] = None) -> InferenceFuture:
        """Enqueue one request ([rows, ...features]) and return its future.
        Raises QueueFullError when ``max_queue`` requests already wait;
        ``timeout_s`` sets the request deadline (None = no deadline)."""
        x = np.asarray(x)
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        req = _Request(x, deadline)
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is not running (call start())")
            if len(self._queue) >= self.max_queue:
                self._m_rejected.inc()
                self.tracer.instant("reject", track=self._track,
                                    args={"reason": "queue_full",
                                          "waiting": len(self._queue)})
                raise QueueFullError(
                    f"queue full ({self.max_queue} requests waiting)")
            self._queue.append(req)
            self._m_requests.inc()
            self._m_queue_depth.set(len(self._queue))
            self._cond.notify()
        return req.future

    def predict(self, x, timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking submit; raises RequestTimeoutError past the deadline."""
        fut = self.submit(x, timeout_s=timeout_s)
        # grace on the client wait: the dispatcher enforces the deadline;
        # a request picked up right AT it still needs the forward to run
        try:
            return fut.result(timeout_s + 30.0
                              if timeout_s is not None else None)
        except RequestTimeoutError:
            if fut._error is None:  # client-wait expiry (forward still
                self._m_timeouts.inc()  # running): not counted yet
            raise

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{self._name}-dispatch")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            pending = self._queue[:]
            self._queue.clear()
            self._cond.notify_all()
        for req in pending:
            req.future._fail(RuntimeError("batcher stopped"))
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- dispatcher --------------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Block until work exists, then collate up to ``max_batch`` rows,
        waiting at most ``batch_window_s`` past the first arrival."""
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(timeout=0.1)
            if not self._running:
                return []
            window_end = time.monotonic() + self.batch_window_s
            while self._running:
                rows = sum(r.x.shape[0] for r in self._queue)
                left = window_end - time.monotonic()
                if rows >= self.max_batch or left <= 0:
                    break
                self._cond.wait(timeout=left)
            taken, rows = [], 0
            while self._queue:
                nxt = self._queue[0].x.shape[0]
                if taken and rows + nxt > self.max_batch:
                    break  # leave it for the next dispatch cycle
                req = self._queue.pop(0)
                taken.append(req)
                rows += nxt
            self._m_queue_depth.set(len(self._queue))
            return taken

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._cond:
                    if not self._running:
                        return
                continue
            now = time.monotonic()
            live: List[_Request] = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    self._m_timeouts.inc()
                    req.future._fail(RequestTimeoutError(
                        "deadline expired after "
                        f"{now - req.t_enqueue:.3f}s in queue"))
                else:
                    self._m_queue_time.record(now - req.t_enqueue)
                    live.append(req)
            if not live:
                continue
            if self.tracer.enabled:
                self.tracer.begin(
                    "predict_batch", track=self._track,
                    args={"requests": len(live),
                          "rows": sum(r.x.shape[0] for r in live)})
            try:
                failpoints.fire("batcher.flush")  # chaos seam
                outs = self._dispatch([r.x for r in live])
            except Exception as e:  # model failure fails the REQUESTS,
                for req in live:    # never the dispatcher thread
                    req.future._fail(e)
                self.tracer.end("predict_batch", track=self._track,
                                args={"error": type(e).__name__})
                continue
            done = time.monotonic()
            self.tracer.end("predict_batch", track=self._track)
            for req, out in zip(live, outs):
                self._m_latency.record(done - req.t_enqueue)
                req.future._resolve(out)

    def _dispatch(self, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """One padded bucketed forward over the concatenated requests;
        splits the result rows back out per request. Oversized single
        requests are chunked at ``max_batch`` (each chunk still
        bucketed)."""
        cat = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        n = cat.shape[0]
        self._m_occupancy.record(len(xs))
        self._m_batches.inc()
        self._m_rows.inc(n)
        pieces = []
        for off in range(0, n, self.max_batch):
            chunk = cat[off:off + self.max_batch]
            bucket = bucket_for(chunk.shape[0], self.buckets)
            if bucket > chunk.shape[0]:
                pad = np.zeros((bucket - chunk.shape[0],) + chunk.shape[1:],
                               chunk.dtype)
                padded = np.concatenate([chunk, pad], axis=0)
            else:
                padded = chunk
            with torch.no_grad():
                out = _to_host(self.forward_fn(padded))
            pieces.append(out[:chunk.shape[0]])
        full = np.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]
        outs, off = [], 0
        for x in xs:
            outs.append(full[off:off + x.shape[0]])
            off += x.shape[0]
        return outs
