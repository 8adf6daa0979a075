"""Performance attribution and the SLO plane of the decode engine — a
port of deeplearning4j_tpu/inference/profiler.py (`burn_verdict` :66,
`device_peak_flops` :125, `cached_program_costs` :110, `program_costs`
:163, `StepPhaseProfiler` :267, `SLOMonitor` :513).

**Step-phase profiler** (:class:`StepPhaseProfiler`). The scheduler loop
stamps each iteration's phases — batch assembly (``admit``), the prefill
chunk (``prefill``), the draft catch-up (``draft``), pool ops and
candidate assembly (``pool``), the decode dispatch and its host read
(``decode``), host-side sampling (``accept``), the speculative round
(``verify``) and the metric flush (``flush``) — into per-phase
histograms (``decode_step_phase_seconds{phase=...}``) and a cumulative
decomposition. Stamps are host float arithmetic on preallocated
single-writer state: no lap reads the device or synchronizes it.

**Cost attribution** (:func:`program_costs` + the rolling FLOPs
window). The JAX package reads each program's FLOPs and bytes from XLA's
cost model; the port has no such model, so the table is analytic, from
the net's shapes, per invocation of each ``(family, bucket)`` the
scheduler stamps: every matmul as 2·m·n·k (each 2-D weight against the m
tokens of the invocation), the attention contractions over the bucket's
positions (4·m·H·Dh·L per attention layer, L = the table bucket's
positions, the stripe's, or the draft's), and as bytes the weights read
once plus the K/V rows the attention reads (``nb × block`` rows a layer
and slot through the paged kernel) and writes. It leaves out the
elementwise work (norms, activations, softmax, RoPE) that XLA's model
also counts. Live dispatch counts combine with the table into
``decode_tokens_per_sec``, ``device_flops_per_sec``,
``device_mfu_estimate`` (against :func:`device_peak_flops`: a per-card
table keyed by ``torch.cuda.get_device_name()`` and the compute dtype,
or ``DL4J_PEAK_FLOPS``), ``device_hbm_gbps`` and per-family FLOPs
shares — on `/metrics`, `/info` and ``GET /debug/engine``.

**SLO monitor** (:class:`SLOMonitor`). Sliding-window p50/p95/p99 per
HTTP route and multiwindow burn rates against a p99 objective
(``serve --slo-p99-ms``): the error budget is 1% of requests over the
objective, the burn rate the observed violation fraction over that
budget, on a fast (60 s) and a slow (600 s) window. ``burning()`` is the
degradation ladder's second escalation input
(`supervisor.EngineSupervisor(slo=...)`); the ladder de-escalates only
when both inputs are calm. Route histograms keep exemplars carrying the
``request_id``.
"""
from __future__ import annotations

import collections
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .metrics import MetricsRegistry, default_registry

__all__ = ["StepPhaseProfiler", "SLOMonitor", "program_costs",
           "cached_program_costs", "device_peak_flops", "burn_verdict",
           "family_flops"]


def burn_verdict(fast: float, slow: float, fast_burn: float = 6.0,
                 slow_burn: float = 3.0) -> Tuple[bool, bool]:
    """(burning, calm) from a (fast, slow) burn-rate pair: burning = both
    windows over their thresholds; calm = the fast window inside budget
    (< 1.0), the stricter de-escalation gate (hysteresis)."""
    return fast >= fast_burn and slow >= slow_burn, fast < 1.0


# iteration phases, in stamp order
PHASES = ("admit", "prefill", "draft", "pool", "decode", "accept",
          "verify", "flush")

# nominal peak FLOP/s by card name and compute dtype — the MFU
# denominator, an ESTIMATE for attribution, not a benchmark claim. The
# H100's: f32 outside the tensor cores, dense bf16 on them (the figures
# chip_smoke.py bounds its kernels with).
DEVICE_PEAK_FLOPS = {
    "H100": {torch.float32: 67e12, torch.bfloat16: 989e12,
             torch.float16: 989e12},
}
_CPU_PEAK_FLOPS = 1e11  # ~a few AVX cores; CPU MFU is order-of-magnitude


def device_peak_flops(device=None, dtype: torch.dtype = torch.float32,
                      default: float = _CPU_PEAK_FLOPS) -> float:
    """Per-device peak FLOP/s estimate: ``DL4J_PEAK_FLOPS``, else the
    card's row of the table at ``dtype`` (its f32 entry for another
    dtype), else ``default``."""
    env = os.environ.get("DL4J_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return default
    try:
        name = torch.cuda.get_device_name(dev)
    except Exception:
        return default
    for key, row in DEVICE_PEAK_FLOPS.items():
        if key.lower() in str(name).lower():
            return row.get(dtype, row[torch.float32])
    return default


# net -> {engine-shape tuple -> cost table}; weak on the net, so the cache
# dies with the model
_COST_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cost_shape_key(engine) -> tuple:
    return (engine.paged, engine.speculate, engine.kv_dtype,
            engine.n_slots, engine.kv_block, tuple(engine.table_buckets),
            tuple(engine.prefill_buckets), engine.paged_kernel,
            engine.decode_graphs, str(engine.device))


def cached_program_costs(engine):
    """The cost table for this (net, engine shape) if an earlier engine
    computed it, else None: a rebuilt engine's warmup takes it for free."""
    try:
        per_net = _COST_CACHE.get(engine.net)
    except TypeError:
        return None
    if per_net is None:
        return None
    cached = per_net.get(_cost_shape_key(engine))
    return dict(cached) if cached is not None else None


def _net_shapes(net):
    """(the elements of the net's 2-D weights, their bytes, the other
    params' bytes, [(H, Hkv, Dh) per attention layer])."""
    from ..nn.layers.attention import SelfAttentionLayerImpl
    ps = net.params
    leaves = [t for lp in (ps.values() if isinstance(ps, dict) else ps)
              for t in lp.values()]
    w_elems = sum(t.numel() for t in leaves if t.dim() == 2)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    impls = net._impls.values() if isinstance(net._impls, dict) \
        else net._impls
    attn = [(int(i.conf.n_heads), int(i._kv_heads()),
             int(i.conf.n_out) // int(i.conf.n_heads))
            for i in impls if isinstance(i, SelfAttentionLayerImpl)]
    return w_elems, w_bytes, attn


def family_flops(net, m: int, positions: int) -> float:
    """The matmul FLOPs of one invocation of ``net`` over ``m`` tokens
    whose attention reads ``positions`` keys each: 2·m per 2-D weight
    element, and 4·m·H·Dh·positions per attention layer (its two
    contractions)."""
    w_elems, _, attn = _net_shapes(net)
    return float(2 * m * w_elems
                 + sum(4 * m * H * Dh * positions for H, _, Dh in attn))


def _kv_row_bytes(engine, Hkv: int, Dh: int, pages: bool) -> int:
    """Bytes of one position's K and V rows of one layer."""
    if pages and engine.kv_dtype == "int8":
        return 2 * (Hkv * Dh + 4 * Hkv)
    itemsize = torch.empty((), dtype=engine._dtype).element_size()
    return 2 * Hkv * Dh * itemsize


def _entry(engine, net, m: int, rows: int, positions: int,
           pages: bool) -> Dict[str, float]:
    """One (family, bucket) entry: ``m`` tokens in ``rows`` sequences,
    each reading ``positions`` keys a layer."""
    _, w_bytes, attn = _net_shapes(net)
    kv = sum(_kv_row_bytes(engine, Hkv, Dh, pages) * (rows * positions + m)
             for _, Hkv, Dh in attn)
    return {"flops": family_flops(net, m, positions),
            "bytes": float(w_bytes + kv)}


def program_costs(engine) -> Dict[Tuple[str, int], Dict[str, float]]:
    """Per-invocation FLOPs/bytes of every family the engine dispatches,
    keyed ``(family, bucket)`` as the scheduler stamps them
    (:meth:`StepPhaseProfiler.count`; JAX profiler.py:163):

      - ``decode``: per table bucket (paged) or ``0``, all slots; each
        paged bucket carries ``fused`` — 1.0 where the hand-written
        kernel runs (the launches counted when its graph was captured,
        `engine.paged_kernel_status`), else 0.0;
      - ``prefill``: per chunk bucket, one slot (paged: at the smallest
        table bucket covering the chunk);
      - ``verify``: per table bucket / ``0``, G + 1 tokens a slot;
      - ``draft`` (``0``) and ``draft_prefill`` (per chunk bucket): the
        draft's step and chunk over its stripes.

    Recurrent nets have no attention: their entries are the matmuls.
    Cached per (net, engine shape), as in JAX."""
    from .batcher import bucket_for
    from .kvpool import blocks_for
    cached = cached_program_costs(engine)
    if cached is not None:
        return cached
    try:
        per_net = _COST_CACHE.setdefault(engine.net, {})
    except TypeError:
        per_net = None
    net, s, B = engine.net, engine.n_slots, engine.kv_block
    cap = engine._cache_cap or 0
    out: Dict[Tuple[str, int], Dict[str, float]] = {}
    if engine.paged:
        fused = engine.paged_kernel_status()["buckets"]
        for nb in engine.table_buckets:
            out[("decode", nb)] = _entry(engine, net, s, s, nb * B, True)
            out[("decode", nb)]["fused"] = 1.0 if fused.get(nb) else 0.0
        for b in engine.prefill_buckets:
            nb = bucket_for(max(1, blocks_for(b, B)), engine.table_buckets)
            out[("prefill", b)] = _entry(engine, net, b, 1, nb * B, True)
    else:
        out[("decode", 0)] = _entry(engine, net, s, s, cap, False)
        for b in engine.prefill_buckets:
            out[("prefill", b)] = _entry(engine, net, b, 1, cap, False)
    if engine.speculate:
        w = engine.speculate + 1
        for nb in (engine.table_buckets if engine.paged else [0]):
            out[("verify", nb)] = _entry(engine, net, s * w, s,
                                         nb * B if nb else cap, engine.paged)
        d, dcap = engine.draft, engine._draft_cap
        out[("draft", 0)] = _entry(engine, d, s, s, dcap, False)
        for b in engine.prefill_buckets:
            out[("draft_prefill", b)] = _entry(engine, d, b, 1, dcap, False)
    if per_net is not None:
        per_net[_cost_shape_key(engine)] = dict(out)
    return out


class StepPhaseProfiler:
    """Per-iteration phase decomposition + rolling cost attribution.

    Hot-path discipline (the flight recorder's): every method the
    scheduler loop calls is plain float/dict arithmetic on preallocated
    SINGLE-WRITER state — no locks, no allocation beyond one small ring
    entry per iteration, no device work. Cross-thread readers
    (`GET /debug/engine`, the gauges) see GIL-atomic snapshots one
    iteration stale at worst. ``enabled=False`` reduces every call to
    one attribute test (chip_smoke.py phase 28f prints the armed
    against the disarmed decode rate).
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None, *,
                 enabled: bool = True, window: int = 256,
                 gauge_every: int = 16,
                 peak_flops: Optional[float] = None,
                 peak_hbm_gbps: float = 3350.0):
        self.enabled = bool(enabled)
        self.metrics = metrics if metrics is not None else default_registry()
        self.peak_flops = (float(peak_flops) if peak_flops
                           else device_peak_flops())
        self.peak_hbm_gbps = float(peak_hbm_gbps)
        self._window = max(8, int(window))
        self._gauge_every = max(1, int(gauge_every))
        # cumulative per-phase seconds (scheduler-thread-only writes;
        # dict preallocated so the hot path never inserts keys)
        self.phase_seconds: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._hists = {
            p: self.metrics.histogram(
                "decode_step_phase_seconds",
                help="scheduler iteration wall time by phase "
                     "(admit=batch assembly, pool=pool ops + candidate "
                     "assembly, accept=host-side token acceptance)",
                labels={"phase": p})
            for p in PHASES} if self.enabled else {}
        # rolling ring of per-iteration (ts_end, flops, bytes, tokens):
        # preallocated, single-writer, index = iterations % window — the
        # trace ring's overwrite semantics
        self._ring: List[Optional[tuple]] = [None] * self._window
        self.iterations = 0
        # per-invocation cost table from program_costs(); {} until the
        # engine's warmup ingests it (dispatch counts still accumulate)
        self.costs: Dict[Tuple[str, int], Dict[str, float]] = {}
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.tokens_total = 0
        # per-family cumulative dispatch/flops tallies (debug snapshot +
        # flops-share gauges)
        self.family_dispatches: Dict[str, int] = {}
        self.family_flops: Dict[str, float] = {}
        # per-iteration scratch, reset by iter_begin
        self._iter_counts: List[Tuple[str, int, int]] = []
        self._t_iter = 0.0
        self._t_lap = 0.0
        self._t_gauges = 0.0  # last _refresh_gauges wall time
        if self.enabled:
            m = self.metrics
            self._g_tps = m.gauge(
                "decode_tokens_per_sec",
                help="rolling emitted-token rate over the last "
                     f"{self._window} scheduler iterations")
            self._g_flops = m.gauge(
                "device_flops_per_sec",
                help="rolling attributed device FLOP rate (the analytic "
                     "cost table per program family x live dispatch "
                     "counts)")
            self._g_mfu = m.gauge(
                "device_mfu_estimate",
                help="model-FLOPs-utilization estimate: attributed "
                     "FLOP/s over the card's peak (card-name table or "
                     "DL4J_PEAK_FLOPS)")
            self._g_hbm = m.gauge(
                "device_hbm_gbps",
                help="rolling attributed memory traffic (the analytic "
                     "table's bytes), GB/s")
            self._g_share: Dict[str, object] = {}

    # -- hot path (scheduler thread only) ----------------------------------
    def iter_begin(self) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        self._t_iter = now
        self._t_lap = now
        if self._iter_counts:
            self._iter_counts.clear()

    def lap(self, phase: str) -> None:
        """Close the current phase: everything since the previous lap
        (or iter_begin) is attributed to ``phase``. Skipped phases cost
        one monotonic read and land only in the decomposition (sub-µs
        laps stay out of the histograms, which would otherwise drown in
        zeros from phases that did not run this iteration)."""
        if not self.enabled:
            return
        now = time.monotonic()
        dt = now - self._t_lap
        self._t_lap = now
        self.phase_seconds[phase] += dt
        if dt >= 1e-6:
            self._hists[phase].record(dt)

    def count(self, family: str, bucket: int, n: int = 1) -> None:
        """Stamp ``n`` dispatches of ``(family, bucket)`` this iteration
        (one list append; costs resolve at iter_end)."""
        if self.enabled:
            self._iter_counts.append((family, bucket, n))

    def iter_end(self, tokens: int = 0) -> None:
        """Close the iteration: resolve this iteration's dispatches
        against the cost table, push one ring entry, and refresh the
        derived gauges every ``gauge_every`` iterations."""
        if not self.enabled:
            return
        self.lap("flush")
        flops = bytes_ = 0.0
        for family, bucket, n in self._iter_counts:
            c = self.costs.get((family, bucket))
            self.family_dispatches[family] = \
                self.family_dispatches.get(family, 0) + n
            if c is not None:
                f = c["flops"] * n
                flops += f
                bytes_ += c["bytes"] * n
                self.family_flops[family] = \
                    self.family_flops.get(family, 0.0) + f
        self.flops_total += flops
        self.bytes_total += bytes_
        self.tokens_total += tokens
        now = time.monotonic()
        idx = self.iterations % self._window
        # increment BEFORE the store: a concurrent rates() reader
        # indexes ring[iterations % window] as the oldest entry — with
        # store-then-increment it could grab the entry written
        # microseconds ago (dt ~ 0, rates report ~0 on a busy engine);
        # this order makes its view at worst one entry shorter
        self.iterations += 1
        self._ring[idx] = (
            now, self.flops_total, self.bytes_total, self.tokens_total)
        if self.iterations % self._gauge_every == 0:
            self._refresh_gauges(now)

    def idle_tick(self) -> None:
        """Called from the scheduler's IDLE wait (10 Hz wakeups):
        iter_end never runs on idle passes, so without this the rate
        gauges would freeze at the last busy burst's values forever —
        a Prometheus scrape of an hour-idle engine reporting 2000
        tokens/s. Recomputing against the fixed oldest ring entry
        decays the rates as the window stretches. Throttled to ~1 Hz;
        the idle-path cost is one monotonic read and a compare."""
        if not self.enabled or not self.iterations:
            return
        now = time.monotonic()
        if now - self._t_gauges >= 1.0:
            self._refresh_gauges(now)

    def _refresh_gauges(self, now: float) -> None:
        self._t_gauges = now
        oldest = self._ring[self.iterations % self._window] \
            if self.iterations >= self._window else self._ring[0]
        if oldest is None:
            return
        t0, f0, b0, k0 = oldest
        dt = now - t0
        if dt <= 0:
            return
        self._g_tps.set((self.tokens_total - k0) / dt)
        fps = (self.flops_total - f0) / dt
        self._g_flops.set(fps)
        if self.peak_flops > 0:
            self._g_mfu.set(fps / self.peak_flops)
        self._g_hbm.set((self.bytes_total - b0) / dt / 1e9)
        total_f = sum(self.family_flops.values())
        if total_f > 0:
            for fam, f in self.family_flops.items():
                g = self._g_share.get(fam)
                if g is None:
                    g = self._g_share[fam] = self.metrics.gauge(
                        "program_family_flops_share",
                        help="fraction of attributed device FLOPs by "
                             "program family (cumulative)",
                        labels={"family": fam})
                g.set(f / total_f)

    # -- ingestion / read side ---------------------------------------------
    def ingest_costs(self, costs: Dict[Tuple[str, int],
                                       Dict[str, float]]) -> None:
        """Install the per-invocation cost table (engine.warmup calls
        this with :func:`program_costs`' output). One dict rebind —
        GIL-atomic against the scheduler thread's lookups."""
        self.costs = dict(costs)

    def rates(self) -> Dict[str, float]:
        """Rolling-window rates (the gauges' values, computed fresh)."""
        if not self.iterations:
            return {"tokens_per_sec": 0.0, "flops_per_sec": 0.0,
                    "mfu_estimate": 0.0, "hbm_gbps": 0.0}
        now = time.monotonic()
        oldest = self._ring[self.iterations % self._window] \
            if self.iterations >= self._window else self._ring[0]
        if oldest is None:
            return {"tokens_per_sec": 0.0, "flops_per_sec": 0.0,
                    "mfu_estimate": 0.0, "hbm_gbps": 0.0}
        t0, f0, b0, k0 = oldest
        dt = max(1e-9, now - t0)
        fps = (self.flops_total - f0) / dt
        return {
            "tokens_per_sec": round((self.tokens_total - k0) / dt, 3),
            "flops_per_sec": round(fps, 1),
            "mfu_estimate": round(fps / self.peak_flops, 6)
            if self.peak_flops > 0 else 0.0,
            "hbm_gbps": round((self.bytes_total - b0) / dt / 1e9, 6),
        }

    def decomposition(self) -> Dict[str, dict]:
        """Cumulative per-phase seconds and shares — where every second
        of scheduler wall time went since construction."""
        totals = dict(self.phase_seconds)  # one-pass copy, atomic items
        whole = sum(totals.values()) or 1.0
        return {p: {"seconds": round(s, 6),
                    "share": round(s / whole, 4)}
                for p, s in totals.items()}

    def cost_snapshot(self) -> dict:
        """The `/debug/engine` ``costs`` block: per-family per-bucket
        invocation costs, cumulative dispatch counts, FLOPs shares, and
        the live rolling rates."""
        costs = dict(self.costs)
        fams = sorted({f for f, _ in costs})
        total_f = sum(self.family_flops.values())
        return {
            "per_invocation": {
                f: {str(b): costs[(f2, b)]
                    for f2, b in sorted(costs) if f2 == f}
                for f in fams},
            "dispatches": dict(self.family_dispatches),
            "family_flops_share": {
                f: round(v / total_f, 4)
                for f, v in sorted(self.family_flops.items())}
            if total_f > 0 else {},
            "peak_flops_per_device": self.peak_flops,
            **self.rates(),
        }


class SLOMonitor:
    """Sliding-window latency percentiles + multiwindow burn rate per
    HTTP route, against one p99 latency objective.

    ``objective_p99_s``: the target — None tracks percentiles but never
    burns (``burning()`` is False, the ladder input stays cold).
    ``error_budget``: allowed violation fraction (0.01 for a p99
    objective). ``burning()`` requires the burn rate over BOTH windows
    to exceed its threshold — fast-window-only spikes and slow-window
    leftovers both stay quiet, the standard multiwindow page condition.
    ``min_samples``: a window holding fewer samples reads burn 0 — on a
    2-requests-a-minute server one slow request is a 100% violation
    fraction, and without the floor that single blip would walk the
    ladder to full admission rejection.
    ``calm()`` is a stricter de-escalation gate (fast burn under 1.0 =
    currently spending within budget) so escalate/de-escalate use
    hysteresis instead of one shared edge.

    Thread-safe: observations arrive from every HTTP handler thread;
    one small lock guards the per-route deques (same discipline as the
    metrics instruments). ``clock`` is injectable so the burn-rate
    algebra is frozen-clock-testable like the supervisor's watchdog.
    """

    def __init__(self, objective_p99_s: Optional[float] = None, *,
                 error_budget: float = 0.01,
                 fast_window_s: float = 60.0, slow_window_s: float = 600.0,
                 fast_burn: float = 6.0, slow_burn: float = 3.0,
                 min_samples: int = 20, max_samples: int = 4096,
                 metrics: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.objective_p99_s = (float(objective_p99_s)
                                if objective_p99_s else None)
        self.error_budget = float(error_budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.min_samples = int(min_samples)
        self.max_samples = int(max_samples)
        self.metrics = metrics if metrics is not None else default_registry()
        self._clock = clock
        self._lock = threading.Lock()
        # per-route (ts, latency) deques: maxlen bounds memory, expired
        # heads popleft in O(expired) per observe — a list rebuild here
        # would be an O(max_samples) copy under the lock on EVERY
        # request once traffic outlives the slow window
        self._samples: Dict[str, collections.deque] = {}
        self._hists: Dict[str, object] = {}
        self._observed = 0
        m = self.metrics
        self._g_fast = m.gauge(
            "slo_burn_rate_fast",
            help="latency-SLO burn rate over the fast window "
                 "(violation fraction / error budget; 1.0 = spending "
                 "exactly the budget)")
        self._g_slow = m.gauge(
            "slo_burn_rate_slow",
            help="latency-SLO burn rate over the slow window")
        if self.objective_p99_s is not None:
            m.gauge("slo_objective_p99_ms",
                    help="configured p99 latency objective"
                    ).set(self.objective_p99_s * 1e3)
        self._g_p99: Dict[str, object] = {}

    def observe(self, route: str, latency_s: float,
                request_id: Optional[str] = None) -> None:
        """Record one request's end-to-end latency for ``route``. The
        labeled histogram keeps an exemplar carrying ``request_id``, so
        a Prometheus bucket links back into `GET /trace`."""
        now = self._clock()
        latency_s = float(latency_s)
        with self._lock:
            hist = self._hists.get(route)
            if hist is None:
                hist = self._hists[route] = self.metrics.histogram(
                    "http_route_latency_seconds",
                    help="end-to-end HTTP request latency by route "
                         "(exemplars carry the request_id)",
                    labels={"route": route})
            buf = self._samples.get(route)
            if buf is None:
                buf = self._samples[route] = collections.deque(
                    maxlen=self.max_samples)
            buf.append((now, latency_s))
            horizon = now - self.slow_window_s
            while buf and buf[0][0] < horizon:
                buf.popleft()
            self._observed += 1
            n = self._observed
        hist.record(latency_s, exemplar=request_id)
        if n % 16 == 0 or n <= 4:
            self._refresh_gauges(now)

    def _window_samples(self, window_s: float, now: float,
                        route: Optional[str] = None) -> List[float]:
        t0 = now - window_s
        with self._lock:
            bufs = ([self._samples.get(route) or ()]
                    if route is not None
                    else list(self._samples.values()))
            return [lat for buf in bufs for ts, lat in buf if ts >= t0]

    def percentiles(self, route: str,
                    window_s: Optional[float] = None) -> dict:
        """Sliding-window p50/p95/p99 (seconds) for one route."""
        now = self._clock()
        vals = sorted(self._window_samples(
            window_s if window_s is not None else self.slow_window_s,
            now, route))
        if not vals:
            return {"n": 0}

        def q(f):
            return vals[min(len(vals) - 1, int(f * len(vals)))]
        return {"n": len(vals), "p50": round(q(0.50), 6),
                "p95": round(q(0.95), 6), "p99": round(q(0.99), 6)}

    def burn_rates(self, now: Optional[float] = None
                   ) -> Tuple[float, float]:
        """(fast, slow) burn rates across all routes: the fraction of
        windowed requests over the objective, divided by the error
        budget. 0.0 when no objective is set or a window holds fewer
        than ``min_samples`` — a near-empty window's violation fraction
        is statistically meaningless and (at 1-2 samples) would let one
        slow request escalate the ladder to admission rejection."""
        if self.objective_p99_s is None:
            return 0.0, 0.0
        now = self._clock() if now is None else now
        out = []
        for w in (self.fast_window_s, self.slow_window_s):
            vals = self._window_samples(w, now)
            if len(vals) < max(1, self.min_samples):
                out.append(0.0)
                continue
            frac = sum(1 for v in vals if v > self.objective_p99_s) \
                / len(vals)
            out.append(frac / self.error_budget)
        return out[0], out[1]

    def _verdict(self, fast: float, slow: float) -> Tuple[bool, bool]:
        """(burning, calm) from an already-computed burn-rate pair —
        delegates to the module-level :func:`burn_verdict` (shared with
        the fleet federation) at this monitor's thresholds."""
        return burn_verdict(fast, slow, self.fast_burn, self.slow_burn)

    def pressure(self, now: Optional[float] = None) -> Tuple[bool, bool]:
        """(burning, calm) from ONE burn-rate computation — the ladder
        evaluates both every watchdog tick, and each burn_rates() call
        scans every route's sample window under the lock, so the paired
        form halves the per-tick cost versus burning()+calm()."""
        fast, slow = self.burn_rates(now)
        return self._verdict(fast, slow)

    def burning(self, now: Optional[float] = None) -> bool:
        """True when the SLO is burning hot enough to escalate."""
        return self.pressure(now)[0]

    def calm(self, now: Optional[float] = None) -> bool:
        """True when latency is inside budget on the fast window."""
        return self.pressure(now)[1]

    def _refresh_gauges(self, now: float) -> None:
        fast, slow = self.burn_rates(now)
        self._g_fast.set(fast)
        self._g_slow.set(slow)
        with self._lock:
            routes = list(self._samples)
        for route in routes:
            p = self.percentiles(route, self.fast_window_s)
            if not p.get("n"):
                continue
            g = self._g_p99.get(route)
            if g is None:
                g = self._g_p99[route] = self.metrics.gauge(
                    "slo_route_p99_ms",
                    help="fast-window p99 latency by route",
                    labels={"route": route})
            g.set(p["p99"] * 1e3)

    def brief(self) -> dict:
        """The burn-rate headline WITHOUT per-route percentiles — what
        `supervisor.status()` embeds in every `/readyz` body. One
        burn_rates() window scan, no sorting: percentiles sort each
        route's full slow-window buffer, and paying that per liveness
        probe (orchestrators poll readiness constantly) would contend
        the SLO lock against every handler's observe(). The full
        per-route picture stays on `/info` and `/debug/engine`."""
        fast, slow = self.burn_rates()
        return {
            "objective_p99_ms": (round(self.objective_p99_s * 1e3, 3)
                                 if self.objective_p99_s else None),
            "burn_rate_fast": round(fast, 4),
            "burn_rate_slow": round(slow, 4),
            "burning": self._verdict(fast, slow)[0],
        }

    def snapshot(self) -> dict:
        """The `/debug/engine` / `/info` SLO block."""
        now = self._clock()
        fast, slow = self.burn_rates(now)
        with self._lock:
            routes = list(self._samples)
        return {
            "objective_p99_ms": (round(self.objective_p99_s * 1e3, 3)
                                 if self.objective_p99_s else None),
            "burn_rate_fast": round(fast, 4),
            "burn_rate_slow": round(slow, 4),
            # reuse the pair computed above rather than re-scanning
            "burning": self._verdict(fast, slow)[0],
            "routes": {
                r: {k: (round(v * 1e3, 3) if k != "n" else v)
                    for k, v in self.percentiles(r).items()}
                for r in routes},
        }
