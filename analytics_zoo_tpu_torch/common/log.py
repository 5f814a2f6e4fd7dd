"""Logging + lightweight timing instrumentation.

Timing helpers mirror the reference's ``Supportive.timing(name){...}``
(ref: zoo/.../serving/utils/Supportive.scala:22) and ``EstimateSupportive``
wrappers; per-stage stats mirror the serving ``Timer``
(ref: zoo/.../serving/engine/Timer.scala:24-90: total/avg/max/min/topN).
"""

from __future__ import annotations

import contextlib
import logging
import sys
import threading
import time
from typing import Dict, List, Optional

from analytics_zoo_tpu_torch.obs.metrics import StatCore

_LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False
_lock = threading.Lock()


def get_logger(name: str = "analytics_zoo_tpu_torch") -> logging.Logger:
    global _configured
    with _lock:
        if not _configured:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_LOG_FORMAT))
            root = logging.getLogger("analytics_zoo_tpu_torch")
            if not root.handlers:
                root.addHandler(handler)
            root.setLevel(logging.INFO)
            root.propagate = False
            _configured = True
    return logging.getLogger(name)


class TimerStat:
    """Accumulated stats for one named stage (count/total/avg/max/min/
    top-k) -- a thin shim over :class:`analytics_zoo_tpu_torch.obs.metrics.
    StatCore`, the single stat-math implementation shared with the
    serving Timer and the registry histograms (ISSUE-2 dedup)."""

    __slots__ = ("name", "_core")

    def __init__(self, name: str, k: int = 10):
        self.name = name
        self._core = StatCore(top_k=k)

    def record(self, elapsed: float) -> None:
        self._core.observe(elapsed)

    @property
    def count(self) -> int:
        return self._core.count

    @property
    def total(self) -> float:
        return self._core.total

    @property
    def max(self) -> float:
        return self._core.max

    @property
    def min(self) -> float:
        return self._core.min

    @property
    def avg(self) -> float:
        return self._core.avg

    def top(self, n: int = 10) -> List[float]:
        return self._core.top(n)

    def summary(self) -> str:
        return (
            f"[{self.name}] count={self.count} total={self.total:.4f}s "
            f"avg={self.avg * 1e3:.2f}ms max={self.max * 1e3:.2f}ms "
            f"min={(0.0 if self.min == float('inf') else self.min) * 1e3:.2f}ms"
        )


class Timer:
    """Named-stage timer registry; thread-safe. ``mirror`` (an obs
    registry histogram family labelled by ``stage``) additionally
    publishes every recorded duration process-wide -- how training
    stage timers join the same ``/metrics`` scrape as serving."""

    def __init__(self, mirror=None):
        self._stats: Dict[str, TimerStat] = {}
        self._lock = threading.Lock()
        self._mirror = mirror

    @contextlib.contextmanager
    def timing(self, name: str, log: Optional[logging.Logger] = None):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                stat = self._stats.setdefault(name, TimerStat(name))
                stat.record(elapsed)
            if self._mirror is not None:
                self._mirror.labels(stage=name).observe(elapsed)
            if log is not None:
                log.info("%s took %.2f ms", name, elapsed * 1e3)

    def stat(self, name: str) -> Optional[TimerStat]:
        with self._lock:
            return self._stats.get(name)

    def stats(self) -> Dict[str, TimerStat]:
        with self._lock:
            return dict(self._stats)

    def summaries(self) -> List[str]:
        with self._lock:
            return [s.summary() for s in self._stats.values()]

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


GLOBAL_TIMER = Timer()
timing = GLOBAL_TIMER.timing
