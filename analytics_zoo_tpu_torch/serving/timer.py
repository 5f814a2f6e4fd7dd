"""Per-stage timing statistics (thin shim over the obs registry).

The analog of serving ``Timer`` (ref: zoo/.../serving/engine/Timer.scala:
24-90 -- total/avg/max/min/top-10 per stage, printed periodically) and the
``Supportive.timing`` wrapper (ref: zoo/.../serving/utils/Supportive.scala).

Since ISSUE-2 the stat math lives in one place --
:class:`analytics_zoo_tpu_torch.obs.metrics.StatCore` -- and a Timer can
*mirror* every stage duration into a labelled registry histogram family
(``mirror=``), which is how the serving worker's stage summaries appear
in ``GET /metrics`` Prometheus exposition while ``summary()`` keeps its
historical per-instance dict shape.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from analytics_zoo_tpu_torch.obs.metrics import Histogram, StatCore


class Timer:
    """``keep_samples``: per-stage raw-sample ring size; when > 0 the
    summary gains p50_s/p99_s percentiles (the reference prints only
    total/avg/max/min/top-10, Timer.scala:24-90; percentiles are what
    the serving bench needs to split worker service time from client
    latency). ``mirror``: an obs registry :class:`Histogram` family
    labelled by ``stage`` -- every duration recorded here is also
    observed there, so per-instance summaries and the process-wide
    scrape surface stay in lockstep."""

    def __init__(self, keep_samples: int = 0,
                 mirror: Optional[Histogram] = None):
        self._stats: Dict[str, StatCore] = {}
        self._gauges: Dict[str, StatCore] = {}
        self._keep = keep_samples
        self._lock = threading.Lock()
        self._mirror = mirror

    @contextmanager
    def timing(self, name: str, batch: int = 1):
        """(ref: Supportive.scala timing)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, dt: float) -> None:
        """Record an externally-measured duration (spans that cross
        function boundaries, e.g. the worker's pipelined batch
        service time)."""
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = self._stats[name] = StatCore(self._keep)
            stat.observe(dt)
        if self._mirror is not None:
            self._mirror.labels(stage=name).observe(dt)

    def gauge(self, name: str, value: float) -> None:
        """Record a sampled VALUE (queue depth, batch occupancy,
        in-flight count) rather than a duration; summarized under the
        ``gauges`` key of :meth:`summary` with unit-less stat names."""
        with self._lock:
            stat = self._gauges.get(name)
            if stat is None:
                stat = self._gauges[name] = StatCore(self._keep)
            stat.observe(float(value))

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for name, s in self._stats.items():
                if not s.count:
                    continue
                out[name] = s.summary("_s")
            gauges = {}
            for name, s in self._gauges.items():
                if not s.count:
                    continue
                g = {"count": s.count, "avg": s.avg, "max": s.max,
                     "min": s.min}
                p50 = s.percentile(0.50)
                if p50 is not None:
                    g["p50"] = p50
                    g["p99"] = s.percentile(0.99)
                gauges[name] = g
            if gauges:
                out["gauges"] = gauges
            return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._gauges.clear()
