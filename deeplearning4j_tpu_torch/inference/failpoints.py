"""Deterministic fault injection for the serving stack (chaos seams) —
the port's copy of deeplearning4j_tpu/inference/failpoints.py.

Host-only (numpy, no torch), kept name for name with the JAX module so
the same chaos specs arm either package. The supervisor's claim "the
watchdog restarts a crashed engine and no request is lost" is about code
paths that never run in a healthy process; these named seams make one
dispatch crash, one allocation report OOM, or one scheduler iteration
hang, and replay the same fault sequence from a seed.

Seams (each is one `fire(name)` call at the code site; the port plants
these):

  ``scheduler.iteration``  top of every DecodeScheduler iteration
  ``dispatch.decode``      before the all-slots decode step (the graph
                           replay on the card)
  ``dispatch.prefill``     before a prefill chunk (the chunk's replay)
  ``pool.alloc``           KVPool block allocation (paged engines)
  ``batcher.flush``        before a MicroBatcher batch dispatch
  ``http.handler``         top of every serving-server POST handler
  ``tier.spill``           a KV tier's capture of an evicted block
                           (`kvtier.TierManager.offer_spill`)
  ``tier.restore``         the tier worker's staging of a promotion
  ``directory.publish``    each prefix-directory event (the event is
                           dropped, the tier state kept)

Each engine seam fires on the host BEFORE the device work it guards, so
a fault never leaves a half-run graph behind, and a thread that wakes
from a ``hang`` raises at the seam instead of replaying anything.

Arming: ``arm("dispatch.decode", "crash@n:3")`` — the spec grammar is
``action[@trigger]``:

  action   ``crash`` (raise InjectedCrash) | ``oom`` (raise InjectedOOM,
           a MemoryError) | ``hang:<ms>`` (sleep ms, then raise
           InjectedHang — the sleep is the fault the watchdog must
           detect by heartbeat staleness; the raise on wake lets the
           abandoned scheduler thread exit through the ordinary crash
           path instead of racing its replacement engine)
  trigger  ``once`` (first hit only — the default) | ``always`` (every
           hit) | ``n:<K>`` (the Kth hit only) | ``p:<prob>[:<seed>]``
           (each hit fires with probability prob, drawn from a PRIVATE
           seeded RNG — the same seed replays the same trigger sequence)

Control planes: programmatic (`arm`/`disarm`), CLI (`serve --failpoint
name=spec`, repeatable), environment (``DL4J_FAILPOINTS="name=spec;
name2=spec"`` via :func:`arm_from_env`), and the opt-in HTTP endpoint
(`POST /admin/failpoints`, `serving/server.py`).

Disarmed cost is one module-level dict emptiness test: ``fire()``
returns at once while nothing is armed, so the seams stay in the hot
loop. Trigger bookkeeping runs only while a seam is armed, under a small
per-arm lock.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["InjectedFault", "InjectedCrash", "InjectedOOM", "InjectedHang",
           "SEAMS", "arm", "disarm", "fire", "snapshot", "arm_from_env",
           "bind_metrics", "parse_spec"]

# the seams the port plants (arming anything else is a spec error — a
# typo'd seam name must not silently never fire)
SEAMS = ("scheduler.iteration", "dispatch.decode", "dispatch.prefill",
         "dispatch.verify", "pool.alloc", "batcher.flush", "http.handler",
         "tier.spill", "tier.restore", "directory.publish")


class InjectedFault(RuntimeError):
    """Base class for injected faults: every fault carries the seam that
    raised it, so recovery paths and chaos asserts can tell injected
    failures from organic ones."""

    def __init__(self, seam: str, detail: str = ""):
        self.seam = seam
        super().__init__(f"injected fault at seam '{seam}'"
                         + (f": {detail}" if detail else ""))


class InjectedCrash(InjectedFault):
    """An uncaught-exception crash of the component owning the seam."""


class InjectedOOM(InjectedFault, MemoryError):
    """An allocation failure (MemoryError subclass, so code that guards
    `except MemoryError` treats it exactly like the real thing)."""


class InjectedHang(InjectedFault):
    """A stalled iteration: the seam slept ``ms`` before raising this.
    The *sleep* is the observable fault (heartbeat goes stale); the
    raise is the stalled thread's exit ramp."""

    def __init__(self, seam: str, ms: float):
        self.ms = float(ms)
        super().__init__(seam, f"hung {ms:g}ms")


class _Arm:
    """One armed seam: parsed spec + trigger state."""

    __slots__ = ("seam", "spec", "action", "ms", "trigger", "nth", "prob",
                 "seed", "rng", "hits", "triggers", "lock")

    def __init__(self, seam: str, spec: str):
        self.seam = seam
        self.spec = spec
        (self.action, self.ms, self.trigger,
         self.nth, self.prob, self.seed) = parse_spec(spec)
        # private PRNG: a p-trigger must replay identically from its
        # seed no matter what else in the process consumes randomness
        self.rng = np.random.default_rng(self.seed)
        self.hits = 0
        self.triggers = 0
        self.lock = threading.Lock()

    def should_fire(self) -> bool:
        with self.lock:
            self.hits += 1
            if self.trigger == "once":
                hit = self.hits == 1
            elif self.trigger == "always":
                hit = True
            elif self.trigger == "n":
                hit = self.hits == self.nth
            else:  # "p"
                hit = float(self.rng.random()) < self.prob
            if hit:
                self.triggers += 1
            return hit

    def state(self) -> dict:
        with self.lock:
            return {"spec": self.spec, "action": self.action,
                    "trigger": self.trigger, "hits": self.hits,
                    "triggers": self.triggers}


def parse_spec(spec: str):
    """``action[@trigger]`` -> (action, hang_ms, trigger, nth, prob, seed).
    Raises ValueError with the offending fragment on any malformed spec
    (an operator typo must fail arming, not arm a no-op)."""
    action_s, _, trigger_s = spec.partition("@")
    action_s = action_s.strip()
    ms = 0.0
    if action_s.startswith("hang"):
        action, _, ms_s = action_s.partition(":")
        if action != "hang" or not ms_s:
            raise ValueError(f"bad hang action {action_s!r} "
                             "(expected 'hang:<ms>')")
        ms = float(ms_s)
        if ms < 0:
            raise ValueError(f"hang ms must be >= 0, got {ms}")
        action_s = "hang"
    if action_s not in ("crash", "oom", "hang"):
        raise ValueError(f"unknown failpoint action {action_s!r} "
                         "(crash | oom | hang:<ms>)")
    trigger_s = trigger_s.strip() or "once"
    nth, prob, seed = 0, 0.0, 0
    if trigger_s in ("once", "always"):
        trigger = trigger_s
    elif trigger_s.startswith("n:"):
        trigger = "n"
        nth = int(trigger_s[2:])
        if nth < 1:
            raise ValueError(f"nth-hit trigger must be >= 1, got {nth}")
    elif trigger_s.startswith("p:"):
        trigger = "p"
        parts = trigger_s.split(":")
        prob = float(parts[1])
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {prob}")
        seed = int(parts[2]) if len(parts) > 2 else 0
    else:
        raise ValueError(f"unknown failpoint trigger {trigger_s!r} "
                         "(once | always | n:<K> | p:<prob>[:<seed>])")
    return action_s, ms, trigger, nth, prob, seed


# -- module state ------------------------------------------------------------
# `_armed` emptiness IS the fast path: fire() in a disarmed process is one
# lock-free dict bool test (a fire racing an arm either sees it or misses
# one hit — both fine). Every other access — arming, disarming, the armed
# path's lookup, and the bound metrics registry — goes through _arm_lock.
_armed: Dict[str, _Arm] = {}
_arm_lock = threading.Lock()
_metrics = None  # bound MetricsRegistry (failpoint_triggers_total)

# hang sleeps poll in small slices so a disarm (or test teardown) can cut
# a long hang short instead of holding the thread hostage
_HANG_SLICE_S = 0.05


def bind_metrics(registry) -> None:
    """Point ``failpoint_triggers_total`` at a server's MetricsRegistry
    (the arms are process-global; servers each own their metrics).
    Written under the arm lock, which ``fire()``'s armed path reads it
    under too."""
    global _metrics
    with _arm_lock:
        _metrics = registry


def arm(name: str, spec: str) -> None:
    """Arm one seam. Re-arming replaces the previous spec (trigger state
    resets — that is what makes seed replays exact)."""
    if name not in SEAMS:
        raise ValueError(f"unknown failpoint seam {name!r}; "
                         f"known seams: {', '.join(SEAMS)}")
    new = _Arm(name, spec)  # parse (and fail) before touching state
    with _arm_lock:
        _armed[name] = new


def disarm(name: Optional[str] = None) -> None:
    """Disarm one seam, or every seam when ``name`` is None."""
    with _arm_lock:
        if name is None:
            _armed.clear()
        else:
            _armed.pop(name, None)


def snapshot() -> Dict[str, dict]:
    """Armed seams with hit/trigger counts (the GET /admin/failpoints body
    and the chaos tests' determinism probe)."""
    with _arm_lock:
        arms = list(_armed.items())
    return {name: arm_.state() for name, arm_ in arms}


def arm_from_env(environ=None) -> List[str]:
    """Arm seams from ``DL4J_FAILPOINTS="name=spec;name2=spec"``. Returns
    the armed seam names (empty when the variable is unset)."""
    env = environ if environ is not None else os.environ
    raw = env.get("DL4J_FAILPOINTS", "")
    out = []
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, spec = entry.partition("=")
        if not sep:
            raise ValueError(
                f"bad DL4J_FAILPOINTS entry {entry!r} (want name=spec)")
        arm(name.strip(), spec.strip())
        out.append(name.strip())
    return out


def fire(name: str) -> None:
    """The seam call. Disarmed: one dict emptiness test, nothing else.
    Armed and triggered: raises the configured typed fault (after the
    configured sleep, for hangs)."""
    if not _armed:  # lock-free fast path, see the module state note
        return
    with _arm_lock:
        arm_ = _armed.get(name)
        metrics = _metrics
    if arm_ is None or not arm_.should_fire():
        return
    if metrics is not None:
        metrics.counter("failpoint_triggers_total").inc()
    if arm_.action == "crash":
        raise InjectedCrash(name, arm_.spec)
    if arm_.action == "oom":
        raise InjectedOOM(name, arm_.spec)
    # hang: sleep in slices (a disarm cuts the stall short), then raise
    deadline = time.monotonic() + arm_.ms / 1e3
    while time.monotonic() < deadline:
        with _arm_lock:
            current = _armed.get(name)
        if current is not arm_:
            break  # disarmed / re-armed mid-hang: release the thread
        time.sleep(min(_HANG_SLICE_S,
                       max(0.0, deadline - time.monotonic())))
    raise InjectedHang(name, arm_.ms)
