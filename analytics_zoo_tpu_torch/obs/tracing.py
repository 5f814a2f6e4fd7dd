"""End-to-end request tracing for the serving pipeline.

A request that enters the data plane under an active trace context
carries its trace id through the ``AZT1`` wire blob (``__trace__`` meta
key, serving/queues.py), and each pipeline stage the request crosses --
``decode``, ``dispatch``, ``finalize`` in the worker, ``http_request``
in the frontend -- records a span against that id. Spans land in a
bounded process-wide collector and export as Chrome trace-event JSON
loadable in perfetto / chrome://tracing.

Tracing is config-gated (``zoo.obs.trace.enabled``, default **false**)
and designed so the disabled path costs nothing measurable: producers
only read a thread-local (no config lookup per request), and the worker
skips span emission entirely for requests that carry no trace id.

Usage::

    from analytics_zoo_tpu_torch.obs import tracing
    with tracing.maybe_trace("client_request") as trace_id:
        input_queue.enqueue(uri, x=tensor)   # blob carries trace_id
    ...
    tracing.get_tracer().dump_chrome_trace("trace.json")
"""

from __future__ import annotations

import collections
import json
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.common.config import get_config

_state = threading.local()


def enabled() -> bool:
    """Whether tracing is switched on (``zoo.obs.trace.enabled``). Read
    once per *request entry point* (HTTP handler, client context), not
    per queue operation -- the data plane consults only the
    thread-local."""
    return bool(get_config().get("zoo.obs.trace.enabled", False))


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> Optional[str]:
    """The trace id active on this thread (None when tracing is off or
    no context is open). A single thread-local read: cheap enough for
    the enqueue hot path."""
    return getattr(_state, "trace_id", None)


@contextmanager
def trace_context(trace_id: Optional[str]):
    """Bind ``trace_id`` to this thread for the duration of the block
    (requests enqueued inside inherit it on the wire)."""
    prev = getattr(_state, "trace_id", None)
    _state.trace_id = trace_id
    try:
        yield trace_id
    finally:
        _state.trace_id = prev


@contextmanager
def maybe_trace(name: str, trace_id: Optional[str] = None, **args):
    """Open a traced region when tracing is enabled: yields the trace id
    (fresh unless given) with the context bound to this thread, and
    records a span named ``name`` over the block. When tracing is
    disabled, yields None and touches nothing but one config read."""
    if not enabled():
        yield None
        return
    tid = trace_id or new_trace_id()
    tracer = get_tracer()
    t0 = time.perf_counter()
    with trace_context(tid):
        try:
            yield tid
        finally:
            tracer.add_span(name, tid, t0, time.perf_counter(), **args)


class Tracer:
    """Bounded collector of finished spans.

    A span is a dict: ``name``, ``trace_id``, ``t0``/``t1`` (module
    perf_counter seconds), ``thread`` (recording thread's name), plus
    free-form args. The ring holds ``max_spans`` (config
    ``zoo.obs.trace.max_spans``); older spans fall off -- tracing is a
    flight recorder, not an archive."""

    def __init__(self, max_spans: Optional[int] = None):
        if max_spans is None:
            max_spans = int(get_config().get("zoo.obs.trace.max_spans",
                                             8192))
        self._spans: collections.deque = collections.deque(
            maxlen=max_spans)
        self._lock = threading.Lock()
        # perf_counter anchor so exported timestamps start near zero
        self._epoch = time.perf_counter()

    def add_span(self, name: str, trace_id: str, t0: float, t1: float,
                 **args) -> None:
        span = {"name": name, "trace_id": trace_id, "t0": t0, "t1": t1,
                "thread": threading.current_thread().name}
        if args:
            span["args"] = args
        with self._lock:
            self._spans.append(span)

    def spans(self, trace_id: Optional[str] = None) -> List[Dict]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # --------------------------------------------------------- export --
    def chrome_trace(self, trace_id: Optional[str] = None
                     ) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}``
        object format): complete events ("ph": "X") with microsecond
        timestamps, one row per recording thread, trace ids in args.
        Load in chrome://tracing or https://ui.perfetto.dev."""
        events: List[Dict[str, Any]] = []
        threads: Dict[str, int] = {}
        for s in self.spans(trace_id):
            tid = threads.setdefault(s["thread"], len(threads) + 1)
            args = dict(s.get("args") or {})
            args["trace_id"] = s["trace_id"]
            events.append({
                "name": s["name"],
                "cat": "serving",
                "ph": "X",
                "ts": round((s["t0"] - self._epoch) * 1e6, 3),
                "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": args,
            })
        for tname, tid in threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": tname}})
        return {"traceEvents": events,
                "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str,
                          trace_id: Optional[str] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(trace_id), f)
        return path


_global_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _global_tracer
    with _tracer_lock:
        if _global_tracer is None:
            _global_tracer = Tracer()
        return _global_tracer
