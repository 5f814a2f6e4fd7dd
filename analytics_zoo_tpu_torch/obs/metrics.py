"""Process-wide metrics registry with Prometheus + JSON export.

The unification layer ISSUE-2 asked for: the reference platform exposes
serving ``Timer`` stats to a dashboard (ref: zoo/.../serving/engine/
Timer.scala:24-90 published via Supportive) and BigDL training exposes
``Metrics`` counters; our rebuild had three disconnected instrumentation
islands (serving/timer.py, common/log.py TimerStat, learn/profiler.py)
with no export surface. This module is the single vocabulary:

- :class:`StatCore` -- the one implementation of the per-stage stat math
  (count/total/max/min/top-10, optional raw-sample ring for percentiles,
  optional fixed histogram buckets). ``serving.timer.Timer`` and
  ``common.log.TimerStat`` are thin shims over it.
- :class:`Counter` / :class:`Gauge` / :class:`Histogram` -- registry
  instruments, optionally labelled (``family.labels(stage="decode")``).
- :class:`MetricsRegistry` -- named-family registry with idempotent
  registration, a JSON snapshot (``snapshot()``), and Prometheus text
  exposition (``prometheus_text()``, format 0.0.4) served by
  ``HttpFrontend`` at ``GET /metrics``.

Naming convention (enforced by ``tests/test_metric_names.py``):
``zoo_<subsystem>_<name>_<unit>`` with unit one of ``total`` (counters),
``seconds``, ``bytes``, ``items``, ``ratio``, ``info``.

No third-party dependencies and no jax import: the registry must be
importable from the batcher/queue layer and from client processes.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# latency-shaped default buckets (seconds); chosen to straddle the
# serving pipeline's observed range: ~0.5 ms stage times to multi-second
# first-compile stalls
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_UNITS = ("total", "seconds", "bytes", "items", "ratio", "info")
METRIC_NAME_RE = re.compile(
    r"^zoo_[a-z][a-z0-9]*_[a-z0-9_]+_(%s)$" % "|".join(_UNITS))
_LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")


def check_metric_name(name: str, kind: str = "") -> None:
    """Raise ValueError unless ``name`` follows the
    ``zoo_<subsystem>_<name>_<unit>`` convention (counters must end in
    ``_total``)."""
    if not METRIC_NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} breaks the zoo_<subsystem>_<name>_"
            f"<unit> convention (unit one of {', '.join(_UNITS)})")
    if kind == "counter" and not name.endswith("_total"):
        raise ValueError(f"counter {name!r} must end in _total")
    if kind != "counter" and name.endswith("_total"):
        raise ValueError(f"{kind or 'metric'} {name!r} must not end in "
                         "_total (reserved for counters)")


class StatCore:
    """Accumulated stats for one observed series: count/total/max/min/
    top-10, an optional raw-sample ring (percentiles), and optional
    fixed cumulative-histogram buckets. NOT thread-safe -- owners
    serialize access (registry children and both Timer shims hold their
    own locks)."""

    __slots__ = ("count", "total", "max", "min", "_top", "_top_k",
                 "_samples", "_cap", "_bounds", "_bucket_counts")

    def __init__(self, keep_samples: int = 0,
                 buckets: Optional[Sequence[float]] = None,
                 top_k: int = 10):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")
        self._top: List[float] = []  # k largest, kept sorted ascending
        self._top_k = top_k
        self._samples: Optional[List[float]] = ([] if keep_samples
                                                else None)
        self._cap = keep_samples
        self._bounds = tuple(buckets) if buckets else None
        self._bucket_counts = ([0] * (len(self._bounds) + 1)
                               if self._bounds else None)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if v < self.min:
            self.min = v
        top = self._top
        if len(top) < self._top_k:
            bisect.insort(top, v)
        elif top and v > top[0]:
            top[0] = v
            top.sort()
        if self._samples is not None:
            if len(self._samples) >= self._cap:
                self._samples[self.count % self._cap] = v
            else:
                self._samples.append(v)
        if self._bounds is not None:
            self._bucket_counts[bisect.bisect_left(self._bounds, v)] += 1

    # ------------------------------------------------------- summaries --
    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def top(self, n: int = 10) -> List[float]:
        return self._top[::-1][:n]

    def percentile(self, q: float) -> Optional[float]:
        """From the raw-sample ring; None when sampling is off/empty."""
        if not self._samples:
            return None
        ordered = sorted(self._samples)
        return ordered[min(len(ordered) - 1, int(len(ordered) * q))]

    def summary(self, suffix: str = "") -> Dict[str, float]:
        """The stat dict shape of the historical serving Timer: count,
        total/avg/max/min (+ ``suffix``, e.g. ``_s``), top-10 average,
        and p50/p99 when the sample ring is on."""
        out = {
            "count": self.count,
            "total" + suffix: self.total,
            "avg" + suffix: self.avg,
            "max" + suffix: self.max,
            "min" + suffix: self.min if self.count else 0.0,
            "top10_avg" + suffix: (sum(self._top) / len(self._top)
                                   if self._top else 0.0),
        }
        p50 = self.percentile(0.50)
        if p50 is not None:
            out["p50" + suffix] = p50
            out["p99" + suffix] = self.percentile(0.99)
        return out

    def bucket_counts(self) -> Optional[List[Tuple[float, int]]]:
        """Cumulative (le, count) pairs ending with (+inf, count)."""
        if self._bounds is None:
            return None
        out, acc = [], 0
        for le, c in zip(self._bounds, self._bucket_counts):
            acc += c
            out.append((le, acc))
        out.append((math.inf, acc + self._bucket_counts[-1]))
        return out


# ------------------------------------------------------------------ #
# instruments                                                         #
# ------------------------------------------------------------------ #
class _Family:
    """Base for labelled instrument families: ``labels(**kv)`` returns
    the child for that label combination (created on first use)."""

    kind = ""

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        check_metric_name(name, self.kind)
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:  # unlabelled: one implicit child
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv) -> Any:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _items(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    def _only_child(self):
        """The implicit child of an unlabelled family (what the
        convenience methods operate on); labelled families get a
        self-diagnosing error instead of a bare KeyError."""
        child = self._children.get(())
        if child is None:
            raise ValueError(
                f"{self.name} is labelled {self.labelnames}; use "
                ".labels(...) to pick a series")
        return child


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    # unlabelled conveniences
    def inc(self, n: float = 1.0) -> None:
        self._only_child().inc(n)

    @property
    def value(self) -> float:
        return self._only_child().value


class _GaugeChild:
    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        """Scrape-time callback (queue depths): evaluated at snapshot/
        exposition; a raising callback reads as the last set() value."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            v = self._value
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return v
        return v


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._only_child().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._only_child().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._only_child().dec(n)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        self._only_child().set_function(fn)

    @property
    def value(self) -> float:
        return self._only_child().value


class _HistogramChild:
    __slots__ = ("_core", "_lock")

    def __init__(self, buckets: Sequence[float], keep_samples: int):
        self._core = StatCore(keep_samples=keep_samples, buckets=buckets)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._core.observe(float(v))

    def time(self):
        """Context manager observing the elapsed seconds."""
        return _HistTimer(self)

    def summary(self, suffix: str = "") -> Dict[str, float]:
        with self._lock:
            return self._core.summary(suffix)

    def snapshot(self, with_buckets: bool = True) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "count": self._core.count,
                "sum": self._core.total,
                "avg": self._core.avg,
                "max": self._core.max,
                "min": self._core.min if self._core.count else 0.0,
            }
            p50 = self._core.percentile(0.50)
            if p50 is not None:
                out["p50"] = p50
                out["p99"] = self._core.percentile(0.99)
            if with_buckets:
                bc = self._core.bucket_counts()
                if bc is not None:
                    out["buckets"] = [
                        ["+Inf" if math.isinf(le) else le, c]
                        for le, c in bc]
            return out

    def _expo(self) -> Tuple[List[Tuple[float, int]], float, int]:
        with self._lock:
            return (self._core.bucket_counts() or [],
                    self._core.total, self._core.count)


class _HistTimer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)
        return False


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 keep_samples: int = 0):
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self.keep_samples = keep_samples
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets, self.keep_samples)

    def observe(self, v: float) -> None:
        self._only_child().observe(v)

    def time(self):
        return self._only_child().time()

    def snapshot(self, with_buckets: bool = True) -> Dict[str, Any]:
        return self._only_child().snapshot(with_buckets)


# ------------------------------------------------------------------ #
# registry                                                            #
# ------------------------------------------------------------------ #
def _escape_label(v: str) -> str:
    return (v.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Named instrument families. Registration is idempotent: asking for
    an existing name with the same kind + labelnames returns the
    existing family (per-instance wiring in workers/frontends re-runs
    freely); a kind or label mismatch raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # --------------------------------------------------- registration --
    def _register(self, cls, name: str, help: str, labelnames,
                  **kwargs) -> Any:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                if isinstance(fam, Histogram) and (
                        fam.buckets != tuple(sorted(
                            kwargs.get("buckets", DEFAULT_BUCKETS)))
                        or fam.keep_samples != kwargs.get(
                            "keep_samples", 0)):
                    # silently handing back a family with different
                    # buckets would put the caller's observations on
                    # boundaries it never declared
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}, keep_samples "
                        f"{fam.keep_samples}")
                return fam
            fam = cls(name, help, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  keep_samples: int = 0) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets, keep_samples=keep_samples)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # --------------------------------------------------------- export --
    def snapshot(self, with_buckets: bool = True) -> Dict[str, Any]:
        """JSON-able registry state; ``with_buckets=False`` drops the
        per-bucket arrays (the compact form bench lines embed)."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            series: Dict[str, Any] = {}
            for key, child in fam._items():
                label = ",".join(
                    f"{ln}={lv}"
                    for ln, lv in zip(fam.labelnames, key)) or ""
                if fam.kind == "histogram":
                    series[label] = child.snapshot(with_buckets)
                else:
                    series[label] = child.value
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             + fam.help.replace("\n", " "))
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam._items():
                pairs = [f'{ln}="{_escape_label(lv)}"'
                         for ln, lv in zip(fam.labelnames, key)]
                base = "{" + ",".join(pairs) + "}" if pairs else ""
                if fam.kind == "histogram":
                    buckets, total, count = child._expo()
                    for le, c in buckets:
                        lp = pairs + [f'le="{_fmt(le)}"']
                        lines.append(f"{fam.name}_bucket"
                                     "{" + ",".join(lp) + "}" + f" {c}")
                    lines.append(f"{fam.name}_sum{base} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{base} {count}")
                else:
                    lines.append(f"{fam.name}{base} "
                                 f"{_fmt(child.value)}")
        return "\n".join(lines) + "\n"


def snapshot_delta(before: Dict[str, Any], after: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """Interval view between two ``snapshot(with_buckets=False)``
    dicts: counter deltas, histogram interval ``count``/``avg``,
    gauges as last observed. Series idle over the interval (zero
    counter delta, zero new histogram observations, zero gauge) are
    dropped -- the registry is process-global and cumulative, so any
    per-window reading (the reporter's rollup, the perf harness's
    per-engine numbers) must diff snapshots rather than read
    absolutes. Cumulative fields that cannot be diffed (min/max/
    percentiles) are intentionally omitted: they would blend in
    activity from before the interval."""
    out: Dict[str, Any] = {}
    for name, fam in after.items():
        prev = before.get(name, {"values": {}})
        series: Dict[str, Any] = {}
        for label, val in fam["values"].items():
            pval = prev["values"].get(label)
            if fam["type"] == "counter":
                delta = val - (pval or 0)
                if delta:
                    series[label] = delta
            elif fam["type"] == "gauge":
                if val:
                    series[label] = val
            else:  # histogram
                dcount = val["count"] - (pval or {}).get("count", 0)
                if dcount > 0:
                    dsum = val["sum"] - (pval or {}).get("sum", 0.0)
                    series[label] = {"count": dcount,
                                     "avg": dsum / dcount}
        if series:
            out[name] = {"type": fam["type"], "values": series}
    return out


_global_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem wires into (the
    scrape surface of ``HttpFrontend``'s ``/metrics``)."""
    global _global_registry
    with _registry_lock:
        if _global_registry is None:
            _global_registry = MetricsRegistry()
        return _global_registry
