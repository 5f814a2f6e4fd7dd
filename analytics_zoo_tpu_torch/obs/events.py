"""Process-wide structured event log + recompile-storm detection.

The flight-recorder substrate ISSUE-3 asked for: metrics (obs.metrics)
answer "how much / how fast", but when a process dies or silently
degrades there is no *history* to read. This module is the black box:

- a fixed vocabulary of **typed events** (:data:`EVENT_TYPES` -- the one
  place event types are registered, linted by
  ``tests/test_metric_names.py`` the same way metric names are);
- :class:`EventLog` -- a bounded in-memory ring of
  ``{ts, seq, type, subsystem, fields}`` records, always on and
  allocation-cheap (one dict + one deque append per emit; no I/O, no
  formatting until somebody asks), rendered as JSON lines on demand;
- a **recompile-storm detector**: every instrumented compile boundary
  (``inference_model.predict_async`` bucket misses, the Estimator's
  jitted steps, graph-executor signatures) reports
  ``(fn, shapes, wall_s)`` here; >= K distinct shapes for one fn inside
  a sliding window raises a ``recompile_storm`` warning event and bumps
  ``zoo_obs_recompile_storms_total`` -- the failure mode that quietly
  dominates TPU serving cost (fixed-shape bucketing exists precisely to
  avoid it).

The tail is served at ``GET /debug/events`` (http_frontend) and the
last N events land in every crash postmortem (obs.flight).

No jax import at module level: the event log must be importable from
the batcher/queue layer and from client processes (same constraint as
obs.metrics).
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.obs.metrics import get_registry

# stdlib logger (not common.log.get_logger): common.log itself imports
# obs -- the event log must sit below every other subsystem
logger = logging.getLogger(__name__)

EVENT_TYPE_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)*$")

# ------------------------------------------------------------------ #
# vocabulary                                                          #
# ------------------------------------------------------------------ #
# THE event-type registry: every emit() anywhere in the package must
# use a type listed here (lower_snake_case; enforced at emit time and
# by the tests/test_metric_names.py collected lint). Keeping the
# vocabulary in one module is what keeps postmortems greppable -- a
# type invented inline in some subsystem would never be documented,
# dashboarded, or filtered on.
EVENT_TYPES: Dict[str, str] = {
    # compile boundaries
    "compile": "a new XLA program / shape bucket was compiled "
               "(fields: fn, shapes, wall_s)",
    "recompile_storm": ">= threshold distinct shapes for one fn inside "
                       "the sliding window (fields: fn, distinct, "
                       "window_s, shapes)",
    # serving lifecycle
    "worker_start": "serving worker thread started",
    "worker_stop": "serving worker stopped (fields: served)",
    "worker_crash": "serving worker thread died on an uncaught "
                    "exception (fields: error)",
    "pipeline_abort": "pipelined engine exited abnormally, dropping "
                      "decoded requests (fields: dropped)",
    "batch_cap_change": "adaptive batcher grew/shrank its cap "
                        "(fields: cap, prev, depth)",
    "serving_error": "a per-request error reply was pushed "
                     "(fields: uri, error)",
    # serving resilience (ISSUE-5)
    "worker_restart": "supervisor restarting a dead or wedged serving "
                      "worker (fields: reason, restarts, backoff_s, "
                      "requeued)",
    "supervisor_giveup": "supervisor hit its restart cap and stopped "
                         "supervising (fields: restarts)",
    "circuit_open": "circuit breaker opened after consecutive backend "
                    "failures (fields: failures)",
    "circuit_half_open": "circuit breaker allowing one half-open "
                         "probe dispatch",
    "circuit_closed": "circuit breaker closed again after a "
                      "successful probe",
    "request_shed": "admission control started shedding a priority "
                    "class (one per shed episode per class; fields: "
                    "depth, shed_depth, priority, cost)",
    "deadline_exceeded": "a request missed its deadline and was "
                         "rejected with a structured error "
                         "(fields: uri, error)",
    "redis_reconnect": "redis adapter result drain lost its queue "
                       "backend and is retrying with backoff "
                       "(fields: error, backoff_s)",
    "chaos_injected": "a configured fault injector fired "
                      "(fields: seam, kind)",
    "frontend_start": "HTTP frontend listening (fields: address)",
    "frontend_stop": "HTTP frontend stopped",
    "serving_launch": "launcher assembled a deployment "
                      "(fields: queue, pipelined, http, shard_mode)",
    "shard_attached": "a serving shard plan committed the model onto "
                      "a device mesh (fields: mode, axis, devices, "
                      "recipe, quantized_collectives)",
    "serving_stop": "launcher deployment stopped",
    "launch_failed": "launcher aborted mid-assembly (fields: error)",
    # serving fleet (ISSUE-9)
    "replica_start": "fleet controller spawned a replica process "
                     "(fields: name, pid)",
    "replica_healthy": "a replica's /healthz went green "
                       "(fields: name, address)",
    "replica_unhealthy": "a replica failed its health check "
                         "(fields: name, status)",
    "replica_exit": "a replica process exited (fields: name, pid, "
                    "returncode, reason)",
    "replica_killed": "the controller SIGKILLed a replica "
                      "(chaos drill or stuck drain; fields: name, "
                      "pid, reason)",
    "fleet_scale": "autoscaler (or scale_to) changed the replica "
                   "count (fields: direction, n_from, n_to, reason)",
    "rolling_restart": "rolling-restart progress (fields: phase, "
                       "name; phase=slo_blocked aborts the restart)",
    "replica_reprobe": "a targeted re-probe re-admitted an unhealthy "
                       "replica between health sweeps (ISSUE-15; "
                       "fields: name, outcome, failures)",
    "slo_breach": "the fleet sample crossed a zoo.serving.slo.* "
                  "target (edge-triggered, one per breach episode; "
                  "fields: signals, p99_ms, ttft_p99_ms, "
                  "inter_token_p99_ms)",
    "drain_begin": "deployment started draining: no new pulls, "
                   "in-flight work finishing (fields: deadline_ms)",
    "drain_complete": "drain finished or hit its deadline "
                      "(fields: ok, waited_s)",
    "stream_reclaim": "a consumer reclaimed pending stream entries "
                      "owned by a dead/stalled consumer "
                      "(fields: stream, group, n)",
    # disaggregated fleet (ISSUE-20)
    "broker_unreachable": "the stream broker failed its PING liveness "
                          "probe after capped-backoff retries "
                          "(fields: address, retries, waited_s)",
    "kv_handoff": "a prefill (or draining decode) replica exported a "
                  "stream's KV pages + replay state and published it "
                  "on the handoff stream (fields: uri, slot, "
                  "prompt_len; inline_kv=0 means the snapshot was "
                  "dropped for size and the decode side re-prefills; "
                  "moved=1 marks a drain-time re-handoff)",
    "kv_import": "a decode replica restored a handed-off stream "
                 "(fields: uri, slot, produced; regenerated=1 means "
                 "the KV snapshot was absent/unusable and the stream "
                 "was deterministically re-prefilled)",
    # generation serving (ISSUE-10)
    "generation_admit": "a generate request joined the running decode "
                        "batch: prefill done, slot + KV pages "
                        "committed (fields: uri, slot, prompt_len, "
                        "bucket)",
    "generation_complete": "a generation stream finished and released "
                           "its slot (fields: uri, slot, tokens, "
                           "reason)",
    "generation_overflow": "a generate request was refused at "
                           "admission: the paged KV cache had no free "
                           "slot/pages (fields: uri, need_pages, "
                           "free_pages, free_slots)",
    # vectorized population / automl (ISSUE-13)
    "population_cohort": "a vectorized trial cohort ran as one "
                         "population dispatch (fields: name, members, "
                         "active, epochs, continued)",
    "automl_search_start": "SearchEngine.run() entered (fields: name, "
                           "trials, executor, scheduler)",
    "automl_search_trial": "one search trial finished (fields: name, "
                           "index, ok, reward, rung)",
    "automl_search_stop": "a search ended (fields: name, reason, "
                          "trials, failed, total_epochs)",
    # learn lifecycle
    "train_start": "estimator fit() entered (fields: epochs, "
                   "batch_size)",
    "train_stop": "estimator fit() returned (fields: epochs_run)",
    "train_failure": "mid-epoch training failure being retried "
                     "(fields: error, failures)",
    # obs / process lifecycle
    "reporter_final": "rollup reporter flushed its final report at "
                      "shutdown",
    "uncaught_exception": "sys/threading excepthook fired "
                          "(fields: error, thread)",
    "fatal_signal": "fatal signal hook fired (fields: signum)",
    "postmortem_written": "a postmortem bundle was written "
                          "(fields: path, reason)",
    "flight_installed": "flight recorder hooks installed",
}

_M_EVENTS = get_registry().counter(
    "zoo_obs_events_total", "Structured events emitted, by type",
    labelnames=("type",))
_M_STORMS = get_registry().counter(
    "zoo_obs_recompile_storms_total",
    "Recompile storms detected (one fn crossing the distinct-shape "
    "threshold inside the sliding window)")


def register_event_type(name: str, description: str) -> None:
    """Extend the vocabulary (plugins/tests). Names must be
    lower_snake_case; re-registering an existing name with a different
    description raises -- one type, one meaning."""
    if not EVENT_TYPE_RE.match(name):
        raise ValueError(
            f"event type {name!r} is not lower_snake_case")
    existing = EVENT_TYPES.get(name)
    if existing is not None and existing != description:
        raise ValueError(f"event type {name!r} already registered: "
                         f"{existing!r}")
    EVENT_TYPES[name] = description


def check_event_type(name: str) -> None:
    """Raise ValueError unless ``name`` is lower_snake_case and
    registered in :data:`EVENT_TYPES` (the test_metric_names lint calls
    this for every literal ``emit("...")`` in the package)."""
    if not EVENT_TYPE_RE.match(name):
        raise ValueError(f"event type {name!r} is not lower_snake_case")
    if name not in EVENT_TYPES:
        raise ValueError(
            f"event type {name!r} is not registered in "
            "obs.events.EVENT_TYPES (the one event vocabulary module)")


def to_jsonable(v: Any) -> Any:
    """Best-effort scalar coercion for event fields (numpy scalars,
    tuples of shapes, exceptions) so JSON rendering never raises --
    shared by the jsonl renderer, the postmortem dumper, and the
    /debug/events endpoint."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): to_jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return item()
        except Exception as e:
            # non-scalar .item() (size != 1 array) or a lazy backend
            # refusing the sync: fall through to str(), but leave a
            # trace -- a coercion path that fails silently hides the
            # exact field the postmortem reader needed
            logger.debug("to_jsonable: .item() on %s failed: %s",
                         type(v).__name__, e)
    return str(v)


class EventLog:
    """Bounded ring of structured events.

    An event is ``{"ts": epoch_seconds, "seq": n, "type": ...,
    "subsystem": ...}`` plus a ``fields`` dict when the emitter passed
    any. ``max_events`` bounds memory (``zoo.obs.events.max_events``);
    older events fall off -- like the span ring, this is a flight
    recorder, not an archive. emit() is the only hot-ish operation and
    does no I/O and no string formatting."""

    def __init__(self, max_events: Optional[int] = None):
        if max_events is None:
            max_events = int(get_config().get(
                "zoo.obs.events.max_events", 2048))
        self._ring: collections.deque = collections.deque(
            maxlen=max_events)
        self._lock = threading.Lock()
        self._seq = 0

    def emit(self, type: str, subsystem: str, **fields) -> Dict[str, Any]:
        check_event_type(type)
        ev: Dict[str, Any] = {"ts": time.time(), "type": type,
                              "subsystem": subsystem}
        if fields:
            ev["fields"] = fields
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
        _M_EVENTS.labels(type=type).inc()
        return ev

    # ------------------------------------------------------------ read --
    def tail(self, n: Optional[int] = None, type: Optional[str] = None,
             subsystem: Optional[str] = None) -> List[Dict[str, Any]]:
        """The newest events, oldest-first; filter before truncation so
        ``tail(5, type="compile")`` means the last 5 compiles, not
        compiles among the last 5 events."""
        with self._lock:
            out = list(self._ring)
        if type is not None:
            out = [e for e in out if e["type"] == type]
        if subsystem is not None:
            out = [e for e in out if e["subsystem"] == subsystem]
        if n is not None:
            n = int(n)
            # guard the falsy-zero slice: out[-0:] is the WHOLE list
            out = out[-n:] if n > 0 else []
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ---------------------------------------------------------- render --
    @staticmethod
    def render_jsonl(events: List[Dict[str, Any]]) -> str:
        """One JSON object per line (the postmortem bundle format);
        unserializable field values stringify rather than raise."""
        return "\n".join(
            json.dumps(to_jsonable(e), sort_keys=True) for e in events)

    def to_jsonl(self, n: Optional[int] = None, **filters) -> str:
        return self.render_jsonl(self.tail(n, **filters))


# ------------------------------------------------------------------ #
# recompile-storm detection                                           #
# ------------------------------------------------------------------ #
_warming_state = threading.local()


@contextlib.contextmanager
def warming():
    """Mark this thread's compiles as *intentional* (warm-up walking a
    bucket ladder): ``record_compile`` still logs them (``warm: true``)
    but the storm detector ignores them. Process-level by design --
    every compile boundary the warm-up traces through (InferenceModel's
    bucket cache, a GraphFunction's feed signatures, nested jits)
    inherits the flag without each site threading its own."""
    prev = getattr(_warming_state, "active", False)
    _warming_state.active = True
    try:
        yield
    finally:
        _warming_state.active = prev


def is_warming() -> bool:
    return getattr(_warming_state, "active", False)


def shape_signature(x) -> Tuple:
    """(shape, dtype) per leaf of a pytree -- the compile key compile
    events carry."""
    from analytics_zoo_tpu_torch.utils.tree import tree_leaves

    return tuple((tuple(getattr(l, "shape", ()) or ()),
                  str(getattr(l, "dtype", "")))
                 for l in tree_leaves(x))


def _shape_str(shapes: Any) -> str:
    """Compact printable form of a shape signature for event fields:
    ``(8,224,224,3):uint8|(8,):int32``."""
    try:
        return "|".join(
            "(" + ",".join(str(d) for d in s) + "):" + (dt or "?")
            for s, dt in shapes)
    except Exception:
        return str(shapes)


class RecompileDetector:
    """Sliding-window distinct-shape tracker per compiled fn.

    Every reported compile is remembered as ``(t, shape_str)``; when one
    fn accumulates >= ``threshold`` *distinct* shapes inside
    ``window_s`` seconds, a ``recompile_storm`` warning event is
    emitted (at most once per window per fn -- the detector must not
    itself storm) and ``zoo_obs_recompile_storms_total`` increments.
    """

    def __init__(self, window_s: Optional[float] = None,
                 threshold: Optional[int] = None,
                 log: Optional["EventLog"] = None):
        cfg = get_config()
        self.window_s = float(cfg.get("zoo.obs.recompile.window_s", 60.0)
                              if window_s is None else window_s)
        self.threshold = int(cfg.get("zoo.obs.recompile.threshold", 8)
                             if threshold is None else threshold)
        self._log = log
        self._lock = threading.Lock()
        self._by_fn: Dict[str, collections.deque] = {}
        self._last_warn: Dict[str, float] = {}

    def record_compile(self, fn: str, shapes: Any = None,
                       wall_s: float = 0.0,
                       subsystem: str = "inference",
                       warm: bool = False) -> bool:
        """Log one compile event and update the storm window; returns
        True when this compile tipped fn over the threshold.

        ``warm=True`` (or an enclosing :func:`warming` context) marks
        an *intentional* compile (warm_up walking the bucket ladder
        pre-compiles every power-of-two shape in seconds): logged as a
        ``compile`` event but excluded from the storm window --
        otherwise every healthy deployment launch would cry storm and
        teach operators to ignore the signal."""
        warm = warm or is_warming()
        now = time.monotonic()
        shape_s = _shape_str(shapes) if shapes is not None else ""
        # explicit None check: an EMPTY EventLog is falsy (__len__),
        # and `or` would silently reroute a dedicated log's events to
        # the global one
        log = self._log if self._log is not None else get_event_log()
        log.emit("compile", subsystem, fn=fn, shapes=shape_s,
                 wall_s=round(float(wall_s), 6), warm=bool(warm))
        if warm:
            return False
        with self._lock:
            ring = self._by_fn.get(fn)
            if ring is None:
                ring = self._by_fn[fn] = collections.deque()
            ring.append((now, shape_s))
            cutoff = now - self.window_s
            while ring and ring[0][0] < cutoff:
                ring.popleft()
            distinct = {s for _, s in ring}
            stormy = len(distinct) >= self.threshold
            if stormy and now - self._last_warn.get(fn, -1e18) \
                    < self.window_s:
                return False  # already warned for this window
            if stormy:
                self._last_warn[fn] = now
                sample = sorted(distinct)[:8]
        if not stormy:
            return False
        _M_STORMS.inc()
        log.emit("recompile_storm", subsystem, fn=fn,
                 distinct=len(distinct), window_s=self.window_s,
                 shapes=sample)
        logger.warning(
            "recompile storm: %s compiled %d distinct shapes inside "
            "%.0fs -- requests are paying XLA compile stalls; check "
            "input bucketing (e.g. %s)", fn, len(distinct),
            self.window_s, "; ".join(sample[:3]))
        return True

    def reset(self) -> None:
        with self._lock:
            self._by_fn.clear()
            self._last_warn.clear()


def instrument_compiles(fn, name: str, subsystem: str = "learn"):
    """Wrap a jitted callable so each call that triggers a trace +
    compile is timed and reported (jax compiles lazily at first call
    per signature, so that call's wall time ~= the compile stall).

    The hot path must stay hot: a jit fn exposes its signature-cache
    size, so compile detection is one int compare per call -- no
    pytree walk over a 100M-param variables tree per training step.
    The expensive ``shape_signature`` runs only on the calls that
    actually compiled. Non-jit callables (tests, duck-typed models)
    fall back to a seen-signature set."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        seen: set = set()
        lock = threading.Lock()

        def wrapper(*args, **kwargs):
            key = shape_signature((args,
                                   tuple(sorted(kwargs.items()))))
            with lock:
                new = key not in seen
                if new:
                    seen.add(key)
            if not new:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            record_compile(name, key, time.perf_counter() - t0,
                           subsystem=subsystem)
            return out
    else:
        def wrapper(*args, **kwargs):
            try:
                before = probe()
            except Exception:
                before = -1
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if before >= 0:
                try:
                    compiled = probe() > before
                except Exception:
                    compiled = False
                if compiled:
                    record_compile(
                        name,
                        shape_signature(
                            (args, tuple(sorted(kwargs.items())))),
                        time.perf_counter() - t0,
                        subsystem=subsystem)
            return out

    wrapper.__name__ = getattr(fn, "__name__", name)
    wrapper.__wrapped__ = fn
    return wrapper


# ------------------------------------------------------------------ #
# process-wide singletons                                             #
# ------------------------------------------------------------------ #
_global_log: Optional[EventLog] = None
_global_detector: Optional[RecompileDetector] = None
_singleton_lock = threading.Lock()


def get_event_log() -> EventLog:
    """The process-wide event log every subsystem emits into (tail
    served at ``GET /debug/events``; last N land in postmortems)."""
    global _global_log
    with _singleton_lock:
        if _global_log is None:
            _global_log = EventLog()
        return _global_log


def get_recompile_detector() -> RecompileDetector:
    global _global_detector
    with _singleton_lock:
        if _global_detector is None:
            _global_detector = RecompileDetector()
        return _global_detector


def emit(type: str, subsystem: str, **fields) -> Dict[str, Any]:
    """Module-level convenience: emit into the process-wide log."""
    return get_event_log().emit(type, subsystem, **fields)


def record_compile(fn: str, shapes: Any = None, wall_s: float = 0.0,
                   subsystem: str = "inference",
                   warm: bool = False) -> bool:
    """Module-level convenience: report a compile to the process-wide
    detector (which also emits the ``compile`` event)."""
    return get_recompile_detector().record_compile(
        fn, shapes=shapes, wall_s=wall_s, subsystem=subsystem,
        warm=warm)
