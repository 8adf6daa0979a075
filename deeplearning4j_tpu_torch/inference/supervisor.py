"""Engine supervisor: watchdog, crash recovery, degradation, draining — a
port of deeplearning4j_tpu/inference/supervisor.py (`EngineSupervisor`
:137).

The supervisor owns the decode engine (built from a ``factory``, so a
dead one can be rebuilt from scratch) and layers four mechanisms on top:

**Watchdog.** The scheduler loop stamps ``engine.heartbeat`` once per
pass, idle passes included, so staleness means stuck, not quiet. The
watchdog thread polls it; a heartbeat older than ``hang_timeout_s``, or
a recorded ``engine.crashed``, triggers recovery. An engine that has not
finished its first pass is judged by ``warmup_timeout_s`` instead. Time
in which the watchdog's own wake came a poll or more late is left out of
the heartbeat's age: the whole process stood still then (a full garbage
collection holds the GIL; the host's cores are taken), the engine's
thread with it, so it is no sign that the loop is stuck.

**Crash recovery.** The dead engine is fenced (a hung thread that wakes
later sees the fence and exits instead of double-finishing requests),
its device state is dropped (pages, runners and their CUDA graphs, the
graph pool: a restart must not keep one engine's memory per fault), a
replacement is built by the factory and warmed — which captures every
decode step and prefill chunk graph again inside the recovery window,
before any request reaches it — and every tracked in-flight request is
resubmitted at the front of the queue with its ORIGINAL (reset) handle:
the caller blocked in ``result()`` never observes the restart. Decode is
deterministic per request (the seed reseeds, the prompt re-prefills), so
the re-run gives the same tokens. Consecutive restarts back off
exponentially with seeded jitter; each request carries a retry budget,
and exhaustion fails it with :class:`RetryBudgetExceededError` (the
server's structured 503 carrying the ``request_id``).

The factory must build the engine the server asked for: the same device,
``paged_kernel`` and ``decode_graphs`` (the server's factory passes them
through). A rebuild never comes back on the CPU, eagerly, or on a plain
version in place of a kernel, and a warmup that fails raises rather than
leaving an engine that would capture under traffic. A sticky CUDA error
(an illegal address in a kernel) poisons the process's CUDA context: no
rebuild inside the process recovers from it. Each failed rebuild counts
as an attempt of every request it strands, so the budget runs out into
the structured 503 instead of a hang, and the process stays unready:
replacing the process is the fleet's job (ROADMAP A8), not this one's.

**Graceful degradation.** Sustained queue pressure walks a ladder:
level 1 sheds the lowest-priority queued load (`LoadSheddedError`, a
retryable 503), level 2 also halves the prefill chunk cap (the smaller
chunk buckets' graphs are captured already: nothing is captured at level
2), level 3 rejects new admissions with :class:`AdmissionRejectedError`
(503 + ``Retry-After``). Sustained calm walks back down. The current
rung is the ``degradation_level`` gauge. With ``slo=`` (a
`profiler.SLOMonitor`) the ladder's second escalation input is the
latency budget's burn rate: queue pressure or a latency burn each count
a pressure hit, and the ladder walks down only when both are calm, so a
rung one input holds up does not flap when the other drains. The
``/readyz`` body then carries the monitor's burn-rate brief.

**Draining restart** (``/admin/drain``): stop admitting, let in-flight
work finish, swap in a fresh engine, resume.

Readiness (`/readyz`) is ``not draining AND not recovering AND heartbeat
fresh``; liveness (`/healthz`) is just "the process answers". Every
transition is traced (``engine_crash`` / ``engine_hang`` /
``engine_restart`` / ``degrade`` instants, and a per-request
``recovered`` span bridging the crash gap) and counted
(``engine_restarts_total``, ``requests_recovered_total``,
``serving_ready`` / ``degradation_level`` gauges). ``clock`` and
``sleep_fn`` are injectable, so the tests drive the watchdog on a fake
clock with no real sleeps.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batcher import QueueFullError
from .engine import DecodeHandle, DecodeScheduler
from .metrics import MetricsRegistry, default_registry
from .trace import FlightRecorder, default_recorder

__all__ = ["EngineSupervisor", "RetryBudgetExceededError",
           "ShuttingDownError", "AdmissionRejectedError"]


class RetryBudgetExceededError(RuntimeError):
    """The request's retry budget ran out across engine restarts: every
    attempt saw the engine die. Carries the ``request_id`` so the
    server's 503 body is actionable."""

    def __init__(self, request_id: str, attempts: int):
        self.request_id = request_id
        self.attempts = attempts
        super().__init__(
            f"request {request_id} abandoned after {attempts} engine "
            "crash(es): retry budget exhausted")


class ShuttingDownError(RuntimeError):
    """The server is tearing down; in-flight requests fail fast with this
    (a structured 503) instead of hanging against a stopped engine."""

    def __init__(self, request_id: Optional[str] = None):
        self.request_id = request_id
        super().__init__("server is shutting down")


class AdmissionRejectedError(RuntimeError):
    """Admission refused by the degradation ladder (level 3) or a drain
    in progress. ``retry_after_s`` feeds the HTTP ``Retry-After``
    header."""

    def __init__(self, reason: str, retry_after_s: float):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        super().__init__(f"not admitting requests ({reason}); retry "
                         f"after {retry_after_s:g}s")


class _Tracked:
    """One supervised in-flight request: everything needed to replay it
    from scratch on a rebuilt engine."""

    __slots__ = ("prompt", "max_new_tokens", "kwargs", "handle", "attempts",
                 "span_open")

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 kwargs: dict, handle: DecodeHandle):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.kwargs = kwargs
        self.handle = handle
        self.attempts = 1  # submissions so far (the first one included)
        # a `recovered` span is open on this request's track (a recovery
        # pass that fails and reruns must not open a second one)
        self.span_open = False


class EngineSupervisor:
    """Wraps a :class:`DecodeScheduler` with a watchdog, crash recovery,
    a degradation ladder and draining restarts.

    ``factory``: zero-arg callable building a configured (not started)
    DecodeScheduler, called once at construction and once per restart or
    drain swap. ``hang_timeout_s``: heartbeat staleness that declares the
    loop hung. ``retry_budget``: submissions allowed per request (a
    request is abandoned once its attempt count reaches the budget at a
    recovery). ``clock``/``sleep_fn``: injectable time. ``watchdog=False``
    skips the background thread (tests call :meth:`check`);
    ``warm_on_build=False`` skips ``engine.warmup()`` (stub engines).
    A build also captures the grammar-masked decode steps when a tracked
    request carries a grammar (JAX `_warm`).
    """

    def __init__(self, factory: Callable[[], DecodeScheduler], *,
                 hang_timeout_s: float = 5.0,
                 warmup_timeout_s: float = 60.0,
                 poll_interval_s: float = 0.05,
                 retry_budget: int = 3,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 backoff_jitter: float = 0.25,
                 backoff_seed: int = 0,
                 backoff_reset_s: float = 30.0,
                 shed_watermark: float = 0.75,
                 calm_watermark: float = 0.25,
                 ladder_patience: int = 3,
                 retry_after_s: float = 1.0,
                 slo=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[FlightRecorder] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 watchdog: bool = True, warm_on_build: bool = True):
        self._factory = factory
        self.hang_timeout_s = float(hang_timeout_s)
        # a fresh engine's first pass may stall the heartbeat (first
        # kernel builds, the allocator's first blocks): until it finishes
        # one pass, staleness is judged against this larger bound
        self.warmup_timeout_s = max(float(warmup_timeout_s),
                                    float(hang_timeout_s))
        self.poll_interval_s = float(poll_interval_s)
        self.retry_budget = int(retry_budget)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_jitter = float(backoff_jitter)
        self.backoff_reset_s = float(backoff_reset_s)
        self.shed_watermark = float(shed_watermark)
        self.calm_watermark = float(calm_watermark)
        self.ladder_patience = int(ladder_patience)
        self.retry_after_s = float(retry_after_s)
        # the ladder's latency input (profiler.SLOMonitor), or None
        self._slo = slo
        self.metrics = metrics if metrics is not None else default_registry()
        self.tracer = tracer if tracer is not None else default_recorder()
        self._clock = clock
        self._sleep = sleep_fn
        # seeded jitter: two replicas restarting off the same crash must
        # not retry in lockstep, but a chaos replay must be exact
        self._backoff_rng = np.random.default_rng(backoff_seed)
        self._lock = threading.RLock()  # engine identity + tracked set
        self._tracked: Dict[str, _Tracked] = {}
        self._stopping = False
        self._draining = False
        self._recovering = False
        self._restart_streak = 0
        self._last_restart: Optional[float] = None
        self._pressure_hits = 0
        self._calm_hits = 0
        self.degradation_level = 0
        self.restarts = 0
        # seconds from each fault's detection to the replacement serving
        # (fence, backoff, rebuild, warmup, requeue)
        self.recovery_seconds: List[float] = []
        # each restart's cause: "crash" or "hang", the dead engine's loop
        # passes and its heartbeat's age when the watchdog judged it
        self.restart_log: List[dict] = []
        # the watchdog's late wakes: (when it was due, seconds late), each a
        # stall of the whole process that a heartbeat's age leaves out
        self._stalls: Deque[Tuple[float, float]] = collections.deque(
            maxlen=64)
        m = self.metrics
        self._m_restarts = m.counter("engine_restarts_total")
        self._m_recovered = m.counter("requests_recovered_total")
        self._m_abandoned = m.counter("requests_abandoned_total")
        self._m_shed = m.counter("requests_shed_total")
        self._g_level = m.gauge("degradation_level")
        self._g_ready = m.gauge("serving_ready")
        self._warm_on_build = bool(warm_on_build)
        self._kick = threading.Event()  # crash callback -> prompt poll
        with self._lock:
            self.engine = self._spawn_engine()
        self._g_ready.set(1)
        self._watchdog: Optional[threading.Thread] = None
        if watchdog:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True, name="engine-supervisor")
            self._watchdog.start()

    # -- engine lifecycle --------------------------------------------------
    def _spawn_engine(self) -> DecodeScheduler:
        """Build, hook, warm and start a fresh engine. Warming captures
        every decode step and prefill chunk graph HERE, inside the
        recovery or drain window the supervisor owns, before the engine
        takes any request: nothing unconstrained is captured under
        traffic (the grammar-masked steps are warmed when a tracked
        request carries a grammar, else captured on first use). A warmup
        failure raises (a recovery pass then fails and the next poll
        retries)."""
        eng = self._factory()
        eng._on_crash = self._note_crash
        self._apply_degradation(eng, self.degradation_level)
        if self._warm_on_build:
            with self._lock:
                masks = any(
                    t.kwargs.get("grammar") is not None
                    for t in self._tracked.values())
            # the masks keyword only when needed: stub engines expose a
            # warmup() without it
            eng.warmup(masks=True) if masks else eng.warmup()
        eng.start()
        return eng

    def _note_crash(self, exc: BaseException) -> None:
        # runs on the dying scheduler thread: wake the watchdog so
        # recovery starts within one poll
        self._kick.set()

    def _watch(self) -> None:
        due = self._clock() + self.poll_interval_s
        while not self._stopping:
            self._kick.wait(timeout=self.poll_interval_s)
            self._kick.clear()
            if self._stopping:
                return
            self.note_wake(due)
            try:
                self.check()
            except Exception as e:
                # the supervisor's own loop survives anything recovery
                # throws (a factory failure); the next poll retries
                self.tracer.instant(
                    "supervisor_error", track="supervisor",
                    args={"error": type(e).__name__,
                          "detail": str(e)[:200]})
            due = self._clock() + self.poll_interval_s

    def note_wake(self, due: float) -> None:
        """The watchdog woke for the poll due at ``due``. A wake a poll or
        more late is a stall of the whole process, which the heartbeat's
        age leaves out (the watchdog thread calls this; tests driving
        :meth:`check` on a fake clock may too)."""
        late = self._clock() - due
        if late > self.poll_interval_s:
            self._stalls.append((due, late))

    def check(self) -> None:
        """One watchdog evaluation: crash/hang detection + the degradation
        ladder, under ``self._lock`` (reentrant: recovery retakes it)."""
        with self._lock:
            if self._stopping or self._draining:
                return
            eng = self.engine
            if eng.crashed is not None:
                self._recover("crash", eng)
                return
            limit = (self.hang_timeout_s if eng.iterations > 0
                     else self.warmup_timeout_s)
            if self._heartbeat_age(eng) > limit:
                self._recover("hang", eng)
                return
            self._evaluate_ladder(eng)
            self._prune_done()

    def _heartbeat_age(self, eng: DecodeScheduler) -> float:
        """Seconds since the engine's last heartbeat, less the process
        stalls the watchdog saw begin after it."""
        beat = eng.heartbeat
        stalled = sum(d for due, d in list(self._stalls) if due >= beat)
        return self._clock() - beat - stalled

    # -- crash recovery ----------------------------------------------------
    def _recover(self, reason: str, dead: DecodeScheduler) -> None:
        with self._lock:
            if self.engine is not dead or self._stopping:
                return  # someone else already swapped it
            self._recovering = True
            self._g_ready.set(0)
            try:
                self._recover_locked(reason, dead)
                self._g_ready.set(1)
            finally:
                # a failed rebuild must not latch readiness off forever:
                # the next watchdog poll re-enters and retries
                self._recovering = False

    def _recover_locked(self, reason: str, dead: DecodeScheduler) -> None:
        tr = self.tracer
        t_detect = self._clock()
        cause = {"reason": reason, "iterations": dead.iterations,
                 "heartbeat_age_s": round(t_detect - dead.heartbeat, 4)}
        tr.instant("engine_crash" if reason == "crash"
                   else "engine_hang", track="supervisor",
                   args={"reason": reason,
                         "error": type(dead.crashed).__name__
                         if dead.crashed else "heartbeat_stale",
                         "iterations": dead.iterations,
                         "inflight": len(self._tracked)})
        # fence FIRST: from here the dead engine's thread (hung, may wake
        # later) can no longer touch any handle; then a join grace, so
        # the common case (crashed: the thread is exiting) is quiesced
        dead.fence()
        if dead._thread is not None:
            dead._thread.join(timeout=self.poll_interval_s)
        release = getattr(dead, "_release_device", None)
        if release is not None:
            release()
        dead._on_crash = None  # no engine <-> supervisor cycle outlives it
        # sweep the tracked set: done or cancelled requests leave it,
        # survivors get a `recovered` span bridging the outage
        victims: List[_Tracked] = []
        for rid, t in list(self._tracked.items()):
            h = t.handle
            if h.done():
                del self._tracked[rid]
            elif h.cancelled():
                h._finish()  # the caller gave up; partial tokens
                del self._tracked[rid]
            else:
                victims.append(t)
        victims.sort(key=lambda t: t.handle.t_submit)
        for t in victims:
            if not t.span_open:
                t.span_open = True
                tr.begin("recovered", req=t.handle.request_id,
                         args={"reason": reason, "attempt": t.attempts})
        # bounded exponential backoff + seeded jitter between consecutive
        # restarts; the streak resets after a healthy stretch
        now = self._clock()
        if self._last_restart is not None and \
                now - self._last_restart > self.backoff_reset_s:
            self._restart_streak = 0
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** self._restart_streak))
        delay *= 1.0 + self.backoff_jitter * self._backoff_rng.random()
        self._restart_streak += 1
        self._last_restart = now
        if delay > 0:
            self._sleep(delay)
        try:
            # the degradation rung carries over to the rebuilt engine
            self.engine = self._spawn_engine()
        except Exception:
            # the rebuild failed (a sticky CUDA error cannot be rebuilt
            # away in this process): the pass counts as an attempt of
            # every stranded request, so the budget ends in a 503
            for t in victims:
                t.attempts += 1
                if t.attempts >= self.retry_budget:
                    self._abandon(t)
            raise
        self.restarts += 1
        self.restart_log.append(cause)
        self._m_restarts.inc()
        tr.instant("engine_restart", track="supervisor",
                   args={"restart": self.restarts, "reason": reason,
                         "backoff_s": round(delay, 4),
                         "recovering": len(victims)})
        # resubmit at the FRONT, newest first, so the final queue order is
        # oldest-submit-first
        recovered = 0
        for t in reversed(victims):
            h = t.handle
            rid = h.request_id
            if t.attempts >= self.retry_budget:
                self._abandon(t)
                continue
            t.attempts += 1
            h._reset_for_retry()
            t.span_open = False
            tr.end("recovered", req=rid)
            try:
                self.engine.submit(t.prompt, t.max_new_tokens,
                                   _handle=h, _front=True, **t.kwargs)
            except QueueFullError as e:
                # more victims than the rebuilt queue holds: the overflow
                # fails (a retryable 503), never hangs
                h._finish(e)
                del self._tracked[rid]
                continue
            except RuntimeError:
                # the replacement died before this resubmission landed:
                # leave it tracked; the next pass retries it
                continue
            recovered += 1
        if recovered:
            self._m_recovered.inc(recovered)
        self.recovery_seconds.append(self._clock() - t_detect)

    def _abandon(self, t: _Tracked) -> None:
        rid = t.handle.request_id
        self._m_abandoned.inc()
        if t.span_open:
            t.span_open = False
            self.tracer.end("recovered", req=rid,
                            args={"outcome": "retry_budget_exhausted"})
        t.handle._finish(RetryBudgetExceededError(rid, t.attempts))
        self._tracked.pop(rid, None)

    # -- degradation ladder ------------------------------------------------
    def _evaluate_ladder(self, eng: DecodeScheduler) -> None:
        """One ladder evaluation over both escalation inputs (JAX :456):
        queue pressure (the fraction of ``max_queue`` waiting) and, with
        an SLO monitor, the latency burn. Either hot counts a pressure
        hit; de-escalation needs the queue at or under the calm watermark
        AND latency inside budget. The patience counters debounce both
        directions."""
        frac = eng.queue_depth() / max(1, eng.max_queue)
        burning, latency_calm = (
            self._slo.pressure(self._clock())
            if self._slo is not None else (False, True))
        if frac >= self.shed_watermark or burning:
            self._pressure_hits += 1
            self._calm_hits = 0
        elif frac <= self.calm_watermark and latency_calm:
            self._calm_hits += 1
            self._pressure_hits = 0
        else:
            self._pressure_hits = 0
            self._calm_hits = 0
        if self._pressure_hits >= self.ladder_patience \
                and self.degradation_level < 3:
            self._set_level(self.degradation_level + 1,
                            source="latency" if burning
                            and frac < self.shed_watermark else "queue")
            self._pressure_hits = 0
        elif self._calm_hits >= self.ladder_patience \
                and self.degradation_level > 0:
            self._set_level(self.degradation_level - 1)
            self._calm_hits = 0
        if self.degradation_level >= 1:
            shed = eng.shed_queued(eng.max_queue // 2)
            if shed:
                self._m_shed.inc(shed)

    def _set_level(self, level: int, source: str = "queue") -> None:
        self.degradation_level = level
        self._g_level.set(level)
        self._apply_degradation(self.engine, level)
        self.tracer.instant("degrade", track="supervisor",
                            args={"level": level, "input": source})

    @staticmethod
    def _apply_degradation(eng: DecodeScheduler, level: int) -> None:
        """Project a rung onto an engine (also on every rebuild, so a
        restart under pressure comes up degraded)."""
        eng.chunk_cap = (max(1, eng.prefill_chunk // 2)
                         if level >= 2 else None)

    # -- admission / client side -------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int,
               **kw) -> DecodeHandle:
        """Supervised submit: tracked for crash recovery. Raises
        :class:`AdmissionRejectedError` at degradation level 3 or while
        draining (the server turns it into 503 + Retry-After)."""
        # the not-running retry window spans at least one full recovery
        deadline = self._clock() + max(5.0, 2 * self.backoff_max_s)
        while True:
            with self._lock:
                if self._stopping:
                    raise ShuttingDownError()
                if self._draining:
                    raise AdmissionRejectedError(
                        "draining restart in progress", self.retry_after_s)
                if self.degradation_level >= 3:
                    raise AdmissionRejectedError(
                        "degradation ladder level 3 (sustained overload)",
                        self.retry_after_s)
                try:
                    handle = self.engine.submit(prompt_ids, max_new_tokens,
                                                **kw)
                except QueueFullError:
                    raise
                except RuntimeError:
                    # the engine died between checks: recovery will swap
                    # it; on expiry a retryable 503, never a raw error
                    if self._clock() >= deadline:
                        raise AdmissionRejectedError(
                            "engine recovering (crash loop?)",
                            self.retry_after_s)
                    handle = None
                if handle is not None:
                    self._tracked[handle.request_id] = _Tracked(
                        [int(t) for t in prompt_ids], int(max_new_tokens),
                        dict(kw), handle)
                    return handle
            self._kick.set()  # nudge the watchdog at the dead engine
            self._sleep(self.poll_interval_s)

    def generate_handle(self, prompt_ids: Sequence[int],
                        max_new_tokens: int,
                        timeout: Optional[float] = 120.0,
                        **kw) -> DecodeHandle:
        """Blocking supervised generate — the `/generate` entry point. A
        timed-out wait cancels the request; the handle leaves the
        recovery set on exit either way."""
        handle = self.submit(prompt_ids, max_new_tokens, **kw)
        try:
            handle.result(timeout)
        except TimeoutError:
            handle.cancel()
            raise
        finally:
            self._untrack(handle.request_id)
        return handle

    def generate_many(self, prompt_ids: Sequence[int], n: int,
                      max_new_tokens: int,
                      timeout: Optional[float] = 120.0, *, seed: int = 0,
                      **kw) -> List[DecodeHandle]:
        """Supervised best-of-n (JAX :579): `speculative.submit_fork_group`
        over this supervisor's tracked submit, so each candidate is
        recovered on its own after a crash (the fork group rides the
        resubmission kwargs; a rebuilt engine without the published blocks
        prefills cold). A failed submit or a timeout cancels the
        candidates; every candidate leaves the tracking set on exit."""
        from .speculative import await_fork_group, submit_fork_group
        handles = submit_fork_group(self.submit, prompt_ids, n,
                                    max_new_tokens, seed=seed, **kw)
        try:
            await_fork_group(handles, timeout, clock=self._clock)
        finally:
            for h in handles:
                self._untrack(h.request_id)
        return handles

    def _untrack(self, request_id: str) -> None:
        with self._lock:
            self._tracked.pop(request_id, None)

    def untrack(self, request_id: str) -> None:
        """For callers that drive a `submit()` handle themselves (the SSE
        path): drop the recovery entry when the stream ends. Until then
        the request is tracked, so a crash mid-stream resubmits it and
        the stream resumes without a duplicate token."""
        self._untrack(request_id)

    def _prune_done(self) -> None:
        """Drop finished requests nobody untracked."""
        with self._lock:
            for rid in [rid for rid, t in self._tracked.items()
                        if t.handle.done()]:
                del self._tracked[rid]

    # -- readiness / draining ----------------------------------------------
    @property
    def ready(self) -> bool:
        """`/readyz`: able to take traffic NOW. Lock-free on purpose: the
        lock is held for a whole recovery (seconds), and a probe must
        answer "not ready" during it, not block. Each read is one atomic
        load; a probe racing a flag flip answers for an instant earlier."""
        if self._stopping or self._draining or self._recovering:
            return False
        eng = self.engine
        if eng.crashed is not None:
            return False
        limit = (self.hang_timeout_s if eng.iterations > 0
                 else self.warmup_timeout_s)
        return (self._clock() - eng.heartbeat) <= limit

    def status(self) -> dict:
        """The `/readyz` body; lock-free for the reason :attr:`ready`
        gives."""
        eng = self.engine
        out = {"ready": self.ready,
               "draining": self._draining,
               "recovering": self._recovering,
               "degradation_level": self.degradation_level,
               "restarts": self.restarts,
               "heartbeat_age_s": round(self._clock() - eng.heartbeat, 3),
               "inflight": len(self._tracked)}
        if self._slo is not None:
            # the brief: /readyz is polled constantly, and the full
            # snapshot sorts every route's window
            out["slo"] = self._slo.brief()
        return out

    def drain(self, timeout: Optional[float] = None,
              poll_s: float = 0.02) -> bool:
        """Draining restart: stop admitting (readiness flips false), let
        in-flight work finish, swap in a fresh engine, resume. Returns
        False if ``timeout`` expired with work still in flight (admission
        resumes on the old engine — nothing was dropped)."""
        with self._lock:
            if self._draining or self._stopping:
                return False
            self._draining = True
            inflight0 = self.engine.inflight()
        self._g_ready.set(0)
        self.tracer.instant("drain_begin", track="supervisor",
                            args={"inflight": inflight0})
        t0 = self._clock()
        try:
            while True:
                with self._lock:
                    # the swap decision and the swap share one lock hold:
                    # no submit slips into the old engine in between
                    if self.engine.inflight() == 0 \
                            and not self.engine.crashed:
                        old = self.engine
                        old.stop()
                        old._on_crash = None
                        self.engine = self._spawn_engine()
                        self.tracer.instant(
                            "drain_swap", track="supervisor",
                            args={"elapsed_s":
                                  round(self._clock() - t0, 3)})
                        return True
                    if self.engine.crashed:
                        # crashed mid-drain: crash recovery requeues the
                        # stragglers, then the drain finishes on the
                        # fresh engine
                        self._draining = False
                        self._recover("crash", self.engine)
                        self._draining = True
                if timeout is not None and self._clock() - t0 > timeout:
                    return False
                self._sleep(poll_s)
        finally:
            with self._lock:
                self._draining = False
            if not self._stopping:
                self._g_ready.set(1)

    def drain_async(self) -> threading.Thread:
        """`POST /admin/drain`: kick a drain and return at once (clients
        watch `/readyz` flip)."""
        th = threading.Thread(target=self.drain, daemon=True,
                              name="engine-drain")
        th.start()
        return th

    # -- teardown ----------------------------------------------------------
    def stop(self) -> None:
        """Fail-fast teardown: every tracked in-flight request gets a
        structured :class:`ShuttingDownError`, then the engine and the
        watchdog go down."""
        self._stopping = True
        self._kick.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
            self._watchdog = None
        with self._lock:
            for rid, t in list(self._tracked.items()):
                if not t.handle.done():
                    t.handle._finish(ShuttingDownError(rid))
            self._tracked.clear()
            self._g_ready.set(0)
            self.engine.stop()
            self.engine._on_crash = None
