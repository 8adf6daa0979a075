"""Training-phase stats — port of deeplearning4j_tpu/parallel/stats.py.

The reference's SparkTrainingStats SPI and its TimeSource SPI
(NTPTimeSource vs SystemClockTimeSource): per-phase wall-time events
around data fetch, minibatch processing and aggregation, recorded by
`phase_timer`. `device_trace` records a `torch.profiler` trace of a
training region (the JAX package's XPlane trace) beside the phase event.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional


class TimeSource:
    """Reference spark/time/TimeSource.java."""

    def current_time_millis(self) -> float:
        raise NotImplementedError


class SystemClockTimeSource(TimeSource):
    def current_time_millis(self) -> float:
        return time.time() * 1000.0


class NTPTimeSource(TimeSource):
    """Clock-skew-corrected timestamps (reference NTPTimeSource.java): the
    system clock plus an offset a deployment sets from its NTP reading
    (`set_offset_millis`); nothing is fetched."""

    def __init__(self):
        self._offset = 0.0

    def set_offset_millis(self, offset: float):
        self._offset = offset

    def current_time_millis(self) -> float:
        return time.time() * 1000.0 + self._offset


@dataclass
class EventStats:
    """One timed phase event (reference spark/stats/EventStats)."""

    name: str
    start_millis: float
    duration_millis: float


class SparkTrainingStats:
    """Per-phase timing events (reference CommonSparkTrainingStats)."""

    def __init__(self, time_source: Optional[TimeSource] = None):
        self.time_source = time_source or SystemClockTimeSource()
        self.events: Dict[str, List[EventStats]] = defaultdict(list)

    def add_event(self, name: str, start_millis: float,
                  duration_millis: float):
        self.events[name].append(EventStats(name, start_millis,
                                            duration_millis))

    def keys(self):
        return list(self.events.keys())

    def total_millis(self, name: str) -> float:
        return sum(e.duration_millis for e in self.events.get(name, []))

    def mean_millis(self, name: str) -> float:
        evs = self.events.get(name, [])
        return sum(e.duration_millis for e in evs) / len(evs) if evs else 0.0

    def count(self, name: str) -> int:
        return len(self.events.get(name, []))

    def stats_as_string(self) -> str:
        lines = ["phase                     count   total_ms    mean_ms"]
        for name in sorted(self.events):
            lines.append(f"{name:25s} {self.count(name):5d} "
                         f"{self.total_millis(name):10.1f} "
                         f"{self.mean_millis(name):10.2f}")
        return "\n".join(lines)

    def export_json(self) -> str:
        """StatsUtils-style export (reference spark/stats/StatsUtils)."""
        return json.dumps({
            name: [{"start": e.start_millis, "duration": e.duration_millis}
                   for e in evs]
            for name, evs in self.events.items()})


@contextlib.contextmanager
def phase_timer(stats: Optional[SparkTrainingStats], name: str):
    """Time a phase (reference StatsCalculationHelper start/stop pairs)."""
    if stats is None:
        yield
        return
    start = stats.time_source.current_time_millis()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.add_event(name, start, (time.perf_counter() - t0) * 1000.0)


@contextlib.contextmanager
def device_trace(log_dir: str,
                 host_stats: Optional[SparkTrainingStats] = None,
                 phase: str = "device_trace"):
    """A `torch.profiler` trace of the region (CPU activity, and CUDA
    where a card is present), written as a Chrome trace under ``log_dir``
    (``trace.json``), with the region's wall time recorded as a phase
    event in ``host_stats``. A profiler that cannot start leaves host
    timing only."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        with phase_timer(host_stats, phase):
            yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception:
                pass
