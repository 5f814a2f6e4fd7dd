"""Background metrics reporter: periodic rate/latency rollups to the log.

The counterpart of ``analytics_zoo_tpu/obs/reporter.py``, on the port's
registry: the same rollup line, driven off the unified registry, so it
covers counters (as rates), gauges (current value), and histograms
(interval count + interval mean) across serving AND training.

Config-gated: ``zoo.obs.report.interval`` seconds between rollups;
``0`` (the default) disables the thread entirely.
"""

from __future__ import annotations

import atexit
import logging
import threading
import time
from typing import Dict, Optional, Tuple

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.obs.metrics import (
    MetricsRegistry, get_registry, snapshot_delta)


def format_rollup(prev: Dict, cur: Dict, dt: float) -> str:
    """One log line from two registry snapshots ``dt`` seconds apart:
    counter deltas as rates, histogram interval mean latency, gauge
    current values. Families idle over the interval are omitted
    (the diff itself is :func:`obs.metrics.snapshot_delta` -- shared
    with the perf harness so the two interval views cannot drift)."""
    parts = []
    for name, fam in sorted(snapshot_delta(prev, cur).items()):
        for label, val in sorted(fam["values"].items()):
            tag = f"{name}{{{label}}}" if label else name
            if fam["type"] == "counter":
                parts.append(f"{tag}: {val / dt:.1f}/s")
            elif fam["type"] == "gauge":
                parts.append(f"{tag}: {val:g}")
            else:  # histogram: ms only for duration families;
                # occupancy/ratio report their interval mean as-is
                unit = (f"{val['avg'] * 1e3:.2f}ms"
                        if name.endswith("_seconds")
                        else f"{val['avg']:.2f}")
                parts.append(f"{tag}: n={val['count']} mean={unit}")
    return "; ".join(parts) if parts else "idle"


class Reporter:
    """Daemon thread logging registry rollups every ``interval``
    seconds (None reads ``zoo.obs.report.interval``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval: Optional[float] = None,
                 logger: Optional[logging.Logger] = None):
        if interval is None:
            interval = float(get_config().get("zoo.obs.report.interval",
                                              0.0))
        self.registry = registry if registry is not None else \
            get_registry()
        self.interval = interval
        self._log = logger or logging.getLogger(
            "analytics_zoo_tpu_torch.obs.reporter")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev = self.registry.snapshot(with_buckets=False)
        self._prev_t = time.monotonic()
        self._atexit_registered = False

    def tick(self, dt: Optional[float] = None) -> str:
        """One rollup (also the unit-testable core): snapshot, diff
        against the previous snapshot, log, and roll the baseline.
        Rates divide by the MEASURED time since the last tick (a
        delayed/overslept cycle must not overstate rates), unless an
        explicit ``dt`` is given."""
        now = time.monotonic()
        cur = self.registry.snapshot(with_buckets=False)
        line = format_rollup(self._prev, cur,
                             dt if dt else max(now - self._prev_t,
                                               1e-9))
        self._prev = cur
        self._prev_t = now
        if line != "idle":
            self._log.info("obs rollup: %s", line)
        return line

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # a reporting bug must never take down
                self._log.exception("obs reporter tick failed")

    def start(self) -> "Reporter":
        if self.interval <= 0:
            raise ValueError("reporter interval must be > 0 to start")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-reporter")
        self._thread.start()
        if not self._atexit_registered:
            # a daemon thread dies wherever the interpreter catches it
            # -- mid-interval, rollup lost. The atexit hook turns every
            # process exit into a clean stop()+final flush, so the last
            # partial interval still reaches the log (deployments read
            # it as the run's closing line). stop() unregisters.
            atexit.register(self.stop)
            self._atexit_registered = True
        return self

    def stop(self, join_timeout: float = 5.0,
             flush: bool = True) -> None:
        """Stop the rollup thread; with ``flush`` (default) log one
        final rollup covering the partial interval since the last
        tick."""
        if self._atexit_registered:
            atexit.unregister(self.stop)
            self._atexit_registered = False
        was_running = self._thread is not None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(join_timeout)
            self._thread = None
        if flush and was_running:
            try:
                line = self.tick()  # tick() logs the rollup itself
                from analytics_zoo_tpu_torch.obs.events import emit

                emit("reporter_final", "obs", rollup=line[:500])
            except Exception as e:
                # atexit path: interpreter teardown may have dismantled
                # the registry/event log under us. The logging module
                # shuts down after atexit hooks run (its own hook was
                # registered first, LIFO), so a debug line is still safe
                self._log.debug("final rollup flush failed: %s", e)


def maybe_start_reporter() -> Optional[Reporter]:
    """Start a reporter iff ``zoo.obs.report.interval`` > 0; the
    serving launcher calls this so deployments opt in by config."""
    interval = float(get_config().get("zoo.obs.report.interval", 0.0))
    if interval <= 0:
        return None
    return Reporter(interval=interval).start()
