"""Serving-side SLO metrics: counters, gauges, streaming latency histograms —
the port's copy of deeplearning4j_tpu/inference/metrics.py.

Host-only (no torch), kept name for name and output for output with the
JAX package's module, so a reader of one package's snapshots (the fleet
aggregator, dashboards) reads the other's unchanged.

Modeled on the Prometheus client-library data model: monotonic counters,
point-in-time gauges, and fixed-bucket histograms whose percentiles are
estimated by linear interpolation inside the owning bucket (the same
estimate `histogram_quantile()` computes server-side).

Lock discipline: one small lock per instrument, held only for a couple of
scalar updates (`record` does no allocation on the hot path). Python's GIL
already serializes the increments; the locks exist so `snapshot()` never
reads a torn (count, sum) pair and so the module stays correct on GIL-free
builds.

Everything is wired through a :class:`MetricsRegistry` so the decode
engine, the serving layer and the smoke run all read ONE source of truth.

Instruments carry **HELP text** (registered at creation —
``registry.counter(name, help=...)``; first non-empty help wins) and
optional **labels** (``labels={"phase": "decode"}``): labeled series of
one family share a base name and differ by label set, the Prometheus
data model. The registry key — and the JSON-snapshot / text-exposition
key — is the canonical series string (``name{phase="decode"}``), so
unlabeled instruments are bit-compatible with the unlabeled format.

Three expositions, kept in name/value parity:
  - ``snapshot()``       -> JSON (carries a ``help`` map)
  - ``render_text()``    -> the Prometheus-FLAVORED summary text
                            (quantile labels, _min/_max)
  - ``render_prometheus()`` -> real Prometheus/OpenMetrics exposition:
                            ``# HELP``/``# TYPE`` per family, cumulative
                            ``_bucket{le=...}`` histogram series, and
                            OpenMetrics exemplars
                            (``# {request_id="r000042"} v ts``) linking
                            a bucket back into the flight recorder.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple


def _escape_label(v) -> str:
    """Prometheus/OpenMetrics label-value escaping (backslash, quote,
    newline). Internal label values are constants, but exemplar labels
    carry the CLIENT-controlled request id — one unescaped quote there
    would corrupt the whole exposition for every consumer."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def series_key(name: str, labels: Optional[dict]) -> str:
    """Canonical series string: ``name`` or ``name{k="v",...}`` (sorted
    label keys, the Prometheus exposition form — so a registry key IS a
    valid text-exposition series name)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _suffixed(key: str, name: str, suffix: str) -> str:
    """``key`` with ``suffix`` appended to the BASE name (labels keep
    their place: ``lat{route="/x"}`` + ``_max`` ->
    ``lat_max{route="/x"}``)."""
    return name + suffix + key[len(name):]


def _with_label(key: str, name: str, extra: str, suffix: str = "") -> str:
    """``key`` with ``suffix`` on the base name and one more
    ``k="v"`` label spliced in: ``lat{route="/x"}`` + ``_bucket`` +
    ``le="0.1"`` -> ``lat_bucket{route="/x",le="0.1"}``."""
    rest = key[len(name):]  # "" or "{...}"
    inner = rest[1:-1] + "," + extra if rest.startswith("{") else extra
    return f"{name}{suffix}{{{inner}}}"


class Counter:
    """Monotonic event counter (requests served, tokens emitted, ...)."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.key = series_key(name, labels)
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        # single int, GIL-atomic read: a scrape racing inc() sees the
        # count from one instant earlier — a correct counter value. The
        # lock exists for the read-modify-write in inc(), not for this.
        return self._value


class Gauge:
    """Point-in-time value (queue depth, active slots, ...). Also tracks the
    high-water mark — saturation shows up even between scrapes."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.key = series_key(name, labels)
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            if v > self._max:
                self._max = float(v)

    @property
    def value(self) -> float:
        # GIL-atomic single-float read (see Counter.value): any value
        # this returns was the gauge's value at some instant
        return self._value

    @property
    def max(self) -> float:
        # GIL-atomic; _max is monotonic within a process lifetime, so a
        # stale read only ever under-reports by the in-flight sample
        return self._max


def _log_buckets(lo: float, hi: float, per_decade: int) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


def estimate_quantile(bounds: List[float], counts: List[int], total: int,
                      vmin: float, vmax: float, q: float) -> float:
    """Quantile estimate over fixed-bucket counts (``counts`` has one
    overflow slot beyond ``bounds``): walk to the owning bucket,
    interpolate linearly inside it, clamp to [vmin, vmax] — the same
    estimate ``histogram_quantile()`` computes server-side. Module-level
    so a fleet federation path can recompute
    p50/p95/p99 from MERGED bucket counts with the exact algorithm the
    per-replica `Histogram` uses (pass ``vmin=0, vmax=math.inf`` when
    the extremes are unknown, e.g. parsed from a Prometheus scrape)."""
    if not total:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        if seen + c >= target and c:
            lo = bounds[i - 1] if i else 0.0
            hi = bounds[i] if i < len(bounds) else \
                (vmax if math.isfinite(vmax) else bounds[-1])
            frac = (target - seen) / c
            est = lo + (hi - lo) * frac
            return min(max(est, vmin), vmax)
        seen += c
    return vmax if math.isfinite(vmax) else bounds[-1]


def merge_histograms(snapshots: List[dict]) -> dict:
    """Merge N :meth:`Histogram.bucket_snapshot` dicts into one — the
    fleet-federation primitive: per-bucket counts sum, count
    and sum add, min/max recombine as min-of-mins / max-of-maxes, and
    p50/p95/p99 are re-estimated over the merged buckets. Merging two
    snapshots is EXACTLY equivalent to one histogram having observed
    the union stream (property-tested in the tests),
    because fixed canonical bucket boundaries make the bucket counts a
    sufficient statistic.

    Mismatched bucket boundaries raise ``ValueError`` — silently
    summing bucket i of two different layouts would fabricate a
    latency distribution, which is strictly worse than failing the
    scrape."""
    snaps = [s for s in snapshots if s is not None]
    if not snaps:
        return {"count": 0}
    bounds = list(snaps[0]["bounds"])
    for s in snaps[1:]:
        b = s["bounds"]
        if len(b) != len(bounds) or any(
                not math.isclose(x, y, rel_tol=1e-9)
                for x, y in zip(b, bounds)):
            raise ValueError(
                "cannot merge histograms with mismatched bucket "
                f"boundaries ({len(bounds)} bounds starting "
                f"{bounds[:2]} vs {len(b)} starting {list(b)[:2]}): "
                "summing unlike buckets would silently fabricate the "
                "distribution")
        if len(s["counts"]) != len(bounds) + 1:
            raise ValueError(
                f"histogram counts length {len(s['counts'])} != "
                f"bounds+overflow {len(bounds) + 1}")
    counts = [0] * (len(bounds) + 1)
    count, total = 0, 0.0
    vmin, vmax = math.inf, -math.inf
    for s in snaps:
        for i, c in enumerate(s["counts"]):
            counts[i] += int(c)
        count += int(s.get("count", sum(s["counts"])))
        total += float(s.get("sum", 0.0))
        vmin = min(vmin, s.get("min", math.inf))
        vmax = max(vmax, s.get("max", -math.inf))
    if not count:
        return {"bounds": bounds, "counts": counts, "count": 0,
                "sum": 0.0}
    if not math.isfinite(vmin):
        vmin = 0.0  # extremes unknown (e.g. parsed from a Prometheus
        # scrape, which carries no _min/_max): estimate clamps fall
        # back to the bucket edges
    if vmax == -math.inf:
        vmax = math.inf
    return {
        "bounds": bounds, "counts": counts, "count": count,
        "sum": round(total, 9), "min": vmin, "max": vmax,
        "p50": estimate_quantile(bounds, counts, count, vmin, vmax, .50),
        "p95": estimate_quantile(bounds, counts, count, vmin, vmax, .95),
        "p99": estimate_quantile(bounds, counts, count, vmin, vmax, .99),
    }


class Histogram:
    """Streaming histogram over fixed log-spaced buckets.

    O(1) per `record` (binary search over ~40 static bounds), O(buckets)
    per percentile query — no reservoir, no per-sample storage, so a
    million-request day costs the same memory as an idle server. Default
    bounds cover 10 microseconds .. 100 seconds, the full range a serving
    latency can plausibly land in.

    ``record(v, exemplar="r000042")`` keeps the newest exemplar per
    bucket (value, label, wall time) — the OpenMetrics bucket→trace
    link `render_prometheus` emits.
    """

    def __init__(self, name: str, lo: float = 1e-5, hi: float = 100.0,
                 per_decade: int = 6, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.key = series_key(name, labels)
        self._bounds = _log_buckets(lo, hi, per_decade)
        self._counts = [0] * (len(self._bounds) + 1)  # + overflow bucket
        self._exemplars: List[Optional[tuple]] = \
            [None] * (len(self._bounds) + 1)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        lo, hi = 0, len(self._bounds)
        while lo < hi:  # first bound >= v (bisect_left on static bounds)
            mid = (lo + hi) // 2
            if self._bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        with self._lock:
            self._counts[lo] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[lo] = (v, exemplar, time.time())

    @property
    def count(self) -> int:
        # GIL-atomic single-int read; consistent multi-field snapshots
        # go through _state() under the lock
        return self._count

    @property
    def mean(self) -> float:
        # derived from one locked copy: a lock-free (_sum, _count) pair
        # read racing record() could pair a new sum with an old count
        _, count, total, _, _ = self._state()
        return total / count if count else 0.0

    def _state(self) -> tuple:
        """ONE consistent copy of the mutable state, under ONE lock
        acquisition. Every read path (percentile, snapshot) derives from
        a single copy: reading `_min`/`_max` lock-free and re-locking per
        percentile would let a scrape racing `record()` report a (count,
        sum) pair from one instant and quantiles/extremes from another
        (e.g. a count-1 histogram whose p99 was not its only sample)."""
        with self._lock:
            return (list(self._counts), self._count, self._sum,
                    self._min, self._max)

    def buckets(self) -> tuple:
        """(upper bounds, per-bucket counts incl. overflow, exemplars,
        count, sum) — ONE consistent locked copy, the Prometheus
        renderer's input: count/sum taken under a separate acquisition
        could disagree with the ``+Inf`` cumulative when a record()
        lands between the two, and OpenMetrics validators reject a
        scrape whose ``_count`` != last bucket."""
        with self._lock:
            return (list(self._bounds), list(self._counts),
                    list(self._exemplars), self._count, self._sum)

    def _estimate(self, counts: List[int], total: int, vmin: float,
                  vmax: float, q: float) -> float:
        """Quantile over a consistent state copy: walk to the owning
        bucket, interpolate linearly inside it, clamp to min/max (the
        shared :func:`estimate_quantile`, so per-replica and merged
        fleet estimates use one algorithm)."""
        return estimate_quantile(self._bounds, counts, total, vmin,
                                 vmax, q)

    def bucket_snapshot(self) -> dict:
        """Merge-ready state (:func:`merge_histograms` input): bounds,
        NON-cumulative per-bucket counts (incl. the overflow slot),
        count/sum/min/max — one consistent locked copy."""
        counts, count, total, vmin, vmax = self._state()
        return {"bounds": list(self._bounds), "counts": counts,
                "count": count, "sum": total,
                "min": vmin if count else math.inf,
                "max": vmax if count else -math.inf}

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1])."""
        counts, count, _, vmin, vmax = self._state()
        return self._estimate(counts, count, vmin, vmax, q)

    def snapshot(self) -> dict:
        counts, count, total, vmin, vmax = self._state()
        if not count:
            return {"count": 0}
        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6),
            "min": round(vmin, 6),
            "max": round(vmax, 6),
            "p50": round(self._estimate(counts, count, vmin, vmax, 0.50), 6),
            "p95": round(self._estimate(counts, count, vmin, vmax, 0.95), 6),
            "p99": round(self._estimate(counts, count, vmin, vmax, 0.99), 6),
        }


class MetricsRegistry:
    """Named instrument registry; `get_or_create` semantics so call sites
    never race on registration. Instruments are keyed by their canonical
    series string (base name + sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # derived name -> (numerator, denominator) counters, computed at
        # snapshot time (a stored value would go stale between scrapes)
        self._ratios: Dict[str, tuple] = {}
        self._help: Dict[str, str] = {}
        self._t0 = time.monotonic()

    def _register_help(self, name: str, help: str) -> None:
        # caller holds self._lock; first non-empty help wins so every
        # series of a family documents itself once
        if help and not self._help.get(name):
            self._help[name] = help

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        key = series_key(name, labels)
        with self._lock:
            if key not in self._counters:
                self._counters[key] = Counter(name, help, labels)
            self._register_help(name, help)
            return self._counters[key]

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        key = series_key(name, labels)
        with self._lock:
            if key not in self._gauges:
                self._gauges[key] = Gauge(name, help, labels)
            self._register_help(name, help)
            return self._gauges[key]

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None, **kw) -> Histogram:
        key = series_key(name, labels)
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = Histogram(name, help=help,
                                                  labels=labels, **kw)
            self._register_help(name, help)
            return self._histograms[key]

    def ratio(self, name: str, numerator, denominator,
              help: str = "") -> None:
        """Register a derived numerator/denominator instrument — any two
        objects with a ``.value`` (Counter OR Gauge): the prefix-cache
        hit rate is hit-token / looked-up-token counters, the paged-KV
        ``kv_pool_utilization`` is live-blocks / capacity gauges.
        Evaluated fresh at every snapshot so it can never go stale
        between scrapes; an empty denominator reads as 0.0."""
        with self._lock:
            self._ratios[name] = (numerator, denominator)
            self._register_help(name, help)

    def help_text(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._help)

    def snapshot(self) -> dict:
        """One JSON-able view of everything — the `GET /metrics` body and
        the UI snapshot payload. Keys are canonical series strings
        (identical to the bare name for unlabeled instruments); the
        ``help`` map documents each base name once."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            ratios = dict(self._ratios)
            help_map = {n: h for n, h in self._help.items() if h}
        return {
            "uptime_sec": round(time.monotonic() - self._t0, 3),
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: {"value": g.value, "max": g.max}
                       for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(histograms.items())},
            "ratios": {n: round(num.value / den.value, 6)
                       if den.value else 0.0
                       for n, (num, den) in sorted(ratios.items())},
            "help": help_map,
        }

    def render_text(self) -> str:
        """Prometheus-FLAVORED text exposition (`/metrics?format=text`,
        the legacy summary form: quantile labels, ``_min``/``_max``).

        Parity with the JSON snapshot: the text form used to drop the
        saturation signals the JSON carries — gauge high-water marks,
        histogram extremes, process uptime — so a Prometheus-only
        consumer could not see that a queue ever peaked between scrapes.
        Now every gauge also exposes ``{name}_max``, every non-empty
        histogram ``{name}_min``/``{name}_max``, the process its
        ``uptime_sec`` — and every documented family its ``# HELP``
        line (once per base name, like ``# TYPE``)."""
        snap = self.snapshot()
        with self._lock:
            metas = ([(c.key, c.name, "counter")
                      for c in self._counters.values()]
                     + [(g.key, g.name, "gauge")
                        for g in self._gauges.values()]
                     + [(h.key, h.name, "summary")
                        for h in self._histograms.values()]
                     + [(n, n, "gauge") for n in self._ratios])
        base_of = {key: name for key, name, _ in metas}
        help_map = snap.get("help", {})
        lines = ["# TYPE uptime_sec gauge",
                 f"uptime_sec {snap['uptime_sec']}"]
        typed = set()

        def head(key: str, kind: str) -> None:
            name = base_of.get(key, key)
            if name not in typed:
                typed.add(name)
                if help_map.get(name):
                    lines.append(f"# HELP {name} {help_map[name]}")
                lines.append(f"# TYPE {name} {kind}")

        for k, v in snap["counters"].items():
            head(k, "counter")
            lines.append(f"{k} {v}")
        for k, g in snap["gauges"].items():
            head(k, "gauge")
            lines.append(f"{k} {g['value']}")
            name = base_of.get(k, k)
            if name + "_max" not in typed:
                typed.add(name + "_max")
                lines.append(f"# TYPE {name}_max gauge")
            lines.append(f"{_suffixed(k, name, '_max')} {g['max']}")
        for k, v in snap.get("ratios", {}).items():
            head(k, "gauge")
            lines.append(f"{k} {v}")
        for k, h in snap["histograms"].items():
            head(k, "summary")
            name = base_of.get(k, k)
            if h.get("count"):
                # Prometheus summary convention: fractional quantile
                # labels ({quantile="0.5"}), not percentile numbers
                for q, frac in (("p50", "0.5"), ("p95", "0.95"),
                                ("p99", "0.99")):
                    series = _with_label(k, name, f'quantile="{frac}"')
                    lines.append(f"{series} {h[q]}")
                lines.append(f"{_suffixed(k, name, '_sum')} {h['sum']}")
                lines.append(f"{_suffixed(k, name, '_min')} {h['min']}")
                lines.append(f"{_suffixed(k, name, '_max')} {h['max']}")
            lines.append(f"{_suffixed(k, name, '_count')} "
                         f"{h.get('count', 0)}")
        return "\n".join(lines) + "\n"

    def render_prometheus(self, openmetrics: bool = True) -> str:
        """Real Prometheus/OpenMetrics exposition
        (`/metrics?format=prometheus`, also served on Accept
        negotiation): ``# HELP``/``# TYPE`` once per family, label
        support throughout, cumulative ``_bucket{le="..."}`` histogram
        series ending in ``le="+Inf"``, and ``_sum``/``_count``.

        ``openmetrics=True`` (the default, and what
        ``?format=prometheus`` / an openmetrics Accept header serve)
        additionally emits exemplars (``# {request_id="..."} value
        ts``) on buckets whose newest sample carried one — the
        bucket→flight-recorder link — and the required ``# EOF``
        terminator; the content type must then be
        ``application/openmetrics-text``. ``openmetrics=False`` is the
        plain Prometheus 0.0.4 text form (a legacy ``text/plain``
        scraper's parser rejects the ``#`` exemplar marker after a
        value, so exemplars are omitted there)."""
        with self._lock:
            counters = sorted(self._counters.values(), key=lambda i: i.key)
            gauges = sorted(self._gauges.values(), key=lambda i: i.key)
            histograms = sorted(self._histograms.values(),
                                key=lambda i: i.key)
            ratios = sorted(self._ratios.items())
            help_map = {n: h for n, h in self._help.items() if h}
        lines = ["# TYPE uptime_sec gauge",
                 f"uptime_sec {round(time.monotonic() - self._t0, 3)}"]
        typed = set()

        def head(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                if help_map.get(name):
                    lines.append(f"# HELP {name} {help_map[name]}")
                lines.append(f"# TYPE {name} {kind}")

        for c in counters:
            # strict OpenMetrics: a counter FAMILY 'foo' exposes
            # samples 'foo_total' — families here are literally named
            # *_total, so the HELP/TYPE lines carry the stripped
            # family name (what prometheus_client's OM encoder does);
            # sample lines keep the full name. The 0.0.4 form keeps
            # the full name in TYPE too (the legacy convention).
            fam = (c.name[:-6] if openmetrics
                   and c.name.endswith("_total") else c.name)
            if fam is not c.name and help_map.get(c.name) \
                    and fam not in help_map:
                help_map[fam] = help_map[c.name]
            head(fam, "counter")
            lines.append(f"{c.key} {c.value}")
        for g in gauges:
            head(g.name, "gauge")
            lines.append(f"{g.key} {g.value}")
        for g in gauges:
            head(g.name + "_max", "gauge")
            lines.append(f"{_suffixed(g.key, g.name, '_max')} {g.max}")
        for n, (num, den) in ratios:
            head(n, "gauge")
            lines.append(f"{n} {round(num.value / den.value, 6) if den.value else 0.0}")
        for h in histograms:
            head(h.name, "histogram")
            bounds, counts, exemplars, count, total = h.buckets()
            cum = 0
            for i, (bound, c) in enumerate(
                    zip(list(bounds) + ["+Inf"], counts)):
                cum += c
                le = bound if bound == "+Inf" else f"{bound:.9g}"
                line = _with_label(h.key, h.name, f'le="{le}"',
                                   "_bucket") + f" {cum}"
                ex = exemplars[i]
                if ex is not None and openmetrics:
                    v, label, ts = ex
                    line += (f' # {{request_id="{_escape_label(label)}"'
                             f"}} {round(v, 9)} {round(ts, 3)}")
                lines.append(line)
            lines.append(f"{_suffixed(h.key, h.name, '_sum')} "
                         f"{round(total, 9)}")
            lines.append(f"{_suffixed(h.key, h.name, '_count')} {count}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide registry for components not handed an explicit one."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
