"""HTTP frontend: /predict + observability routes over the serving queues.

The counterpart of ``analytics_zoo_tpu/serving/http_frontend.py``, with
byte-identical wire formats (JSON bodies, the SSE event framing of
/generate, the ``__*__`` keys); only ``/debug/vars`` reports torch, its
CUDA version and the card in place of the jax block. A stdlib
``ThreadingHTTPServer``; each /predict POST
enqueues into the InputQueue with a fresh uri, a router thread drains the
OutputQueue into per-uri mailboxes, and the handler blocks on its mailbox
with a deadline. Dependency-free wire format:

  POST /predict       {"inputs": {"x": [[...]]}}         -> {"predictions": ...}
  POST /predict       {"instances": [{"x": [...]}, ...]} -> {"predictions": [...]}
  GET  /metrics       Prometheus text exposition (process registry)
  GET  /metrics.json  JSON snapshot: registry + frontend/worker summaries
  GET  /healthz       liveness (200, or 503 when the worker thread died)
  GET  /trace         Chrome trace-event JSON of collected request spans
  GET  /debug/events  structured event-log tail (?n=&type=&subsystem=)
  GET  /debug/vars    resolved config + build/uptime/process info

Unknown paths get a 404 with a JSON error body. With
``zoo.obs.trace.enabled`` each /predict carries a fresh trace id through
the queue blobs, so its worker-side decode/dispatch/finalize spans join
the frontend's ``http_request`` span under one id (docs/observability.md).
"""

from __future__ import annotations

import json
import os
import queue as _pyqueue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs

import numpy as np

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.obs import tracing
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.events import get_event_log, to_jsonable
from analytics_zoo_tpu_torch.obs.flight import get_inflight
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.serving.protocol import (
    DEADLINE_PREFIX, DRAINING_PREFIX, ERROR_KEY, PRIORITY_CLASSES,
    PRIORITY_KEY, SHED_PREFIX, STREAM_KEY, TENANT_KEY, error_status,
    priority_index)
from analytics_zoo_tpu_torch.serving.timer import Timer

logger = get_logger(__name__)

_REG = get_registry()
_M_HTTP_STAGE = _REG.histogram(
    "zoo_http_stage_duration_seconds",
    "HTTP frontend stage latency (predict_request, ...)",
    labelnames=("stage",))
_M_HTTP_REQS = _REG.counter(
    "zoo_http_requests_total", "HTTP requests served, by route and "
    "status code", labelnames=("route", "code"))
_M_HTTP_DROPPED = _REG.counter(
    "zoo_http_dropped_results_total",
    "Results dropped for abandoned (timed-out) requests")

# label-cardinality guard: only known routes get their own label value;
# everything else (scanners probing arbitrary 404 paths) collapses to
# "other" so client-supplied URLs cannot grow the registry unboundedly
_KNOWN_ROUTES = frozenset(
    ("/predict", "/generate", "/metrics", "/metrics.json", "/healthz",
     "/trace", "/debug/events", "/debug/vars", "/"))


class _ResultRouter:
    """Drains the OutputQueue into per-uri mailboxes. Only uris
    registered as pending get a mailbox; results for abandoned uris
    (request already timed out) are dropped, so timeouts don't leak.

    Two mailbox kinds: one-shot results (predict -- one blob, then the
    waiter owns cleanup) and *stream* mailboxes (generate --
    a Queue of chunks, recognized by ``__stream__`` riding the reply
    blob; a stream stays registered until its handler unregisters it,
    so a multi-chunk reply never races its own registration)."""

    def __init__(self, output_queue):
        self._q = output_queue
        self._pending: set = set()
        self._results: Dict[str, Dict[str, np.ndarray]] = {}
        self._streams: Dict[str, _pyqueue.Queue] = {}
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, join_timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(join_timeout)
            self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            item = self._q.dequeue(timeout=0.05)
            if item is None:
                continue
            uri, tensors = item
            if STREAM_KEY in tensors:
                # generation chunk: route into the stream mailbox
                # (debug-level drop log -- an abandoned stream keeps
                # producing chunks until the worker finishes it, and a
                # warning per chunk would flood the log)
                with self._cv:
                    sq = self._streams.get(uri)
                if sq is not None:
                    sq.put(tensors)
                else:
                    _M_HTTP_DROPPED.inc()
                    logger.debug("dropping chunk for abandoned "
                                 "stream %s", uri)
                continue
            with self._cv:
                if uri in self._pending:
                    self._results[uri] = tensors
                    self._cv.notify_all()
                else:
                    _M_HTTP_DROPPED.inc()
                    logger.warning("dropping result for abandoned "
                                   "request %s", uri)

    def register(self, uri: str) -> None:
        with self._cv:
            self._pending.add(uri)

    def register_stream(self, uri: str) -> _pyqueue.Queue:
        """Open a stream mailbox; every chunk blob for ``uri`` lands
        in the returned Queue until :meth:`unregister_stream`."""
        sq: _pyqueue.Queue = _pyqueue.Queue()
        with self._cv:
            self._streams[uri] = sq
        return sq

    def unregister_stream(self, uri: str) -> None:
        with self._cv:
            self._streams.pop(uri, None)

    def unregister(self, uri: str) -> None:
        """Abandon a registered uri (request failed before/without its
        wait): drop the mailbox so late results can't accumulate."""
        with self._cv:
            self._pending.discard(uri)
            self._results.pop(uri, None)

    def wait(self, uri: str, timeout: float
             ) -> Optional[Dict[str, np.ndarray]]:
        deadline = time.monotonic() + timeout
        with self._cv:
            try:
                while uri not in self._results:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cv.wait(remaining)
                return self._results.pop(uri)
            finally:
                self._pending.discard(uri)


def _to_jsonable(tensors: Dict[str, np.ndarray]) -> Any:
    out = {}
    for k, v in tensors.items():
        a = np.asarray(v)
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            # json.dumps would emit bare NaN/Infinity tokens (invalid
            # JSON); strict clients can't parse that. Map to null.
            a = np.where(np.isfinite(a), a.astype(object), None)
        out[k] = a.item() if a.ndim == 0 else a.tolist()
    return out


class HttpFrontend:
    """Serve /predict + /metrics on ``host:port``.

    Args:
      input_queue / output_queue: the serving queues; the frontend OWNS
        the output queue (its router consumes every result).
      worker: optional ServingWorker whose metrics join /metrics.
      request_timeout: /predict deadline in seconds (ref:
        FrontEndApp timeout settings).
    """

    def __init__(self, input_queue, output_queue,
                 host: Optional[str] = None,
                 port: int = 0, worker=None,
                 request_timeout: float = 10.0,
                 timer: Optional[Timer] = None,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 gen_queue=None, gen_worker=None):
        if host is None:
            # cross-host fleets bind 0.0.0.0 via
            # zoo.serving.fleet.bind_host; loopback stays
            # the default
            host = str(get_config().get(
                "zoo.serving.fleet.bind_host", "127.0.0.1"))
        self._in = input_queue
        self.router = _ResultRouter(output_queue)
        self.worker = worker
        # generation serving: the generate-request input
        # queue and worker; None = POST /generate answers 404. Chunks
        # arrive on the SAME output queue the router drains (routed by
        # the __stream__ key), so there is still exactly one drainer.
        self._gen_in = gen_queue
        self.gen_worker = gen_worker
        self.request_timeout = request_timeout
        self.retry_after_s = float(get_config().get(
            "zoo.serving.shed.retry_after_s", 1.0))
        self.timer = timer or Timer(mirror=_M_HTTP_STAGE)
        self._tls = certfile is not None
        self._started_at = time.time()
        # drain state: a draining deployment refuses NEW
        # predicts (503 + Retry-After) and fails its health check so
        # the fleet router routes around it, while requests already
        # in flight keep their mailboxes until answered
        self._draining = False
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: chunked transfer encoding for streamed
            # /generate responses (every non-streamed reply still
            # carries Content-Length, so keep-alive stays correct)
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to our logger
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload: Any,
                       content_type: str = "application/json",
                       headers: Optional[Dict[str, str]] = None):
                # count BEFORE writing: the increment must be visible
                # by the time the client has read the response, and a
                # mid-write disconnect must still count the request
                route = self.path.split("?")[0]
                if route not in _KNOWN_ROUTES:
                    route = "other"
                _M_HTTP_REQS.labels(route=route, code=str(code)).inc()
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # dispatch ignores the query string (a scrape config's
                # params or a cache-buster must not 404 a known route)
                route = self.path.split("?")[0]
                if route == "/metrics":
                    # Prometheus text exposition of the process-wide
                    # registry (scrape target; format 0.0.4)
                    self._reply(
                        200, get_registry().prometheus_text().encode(),
                        content_type="text/plain; version=0.0.4; "
                                     "charset=utf-8")
                elif route == "/metrics.json":
                    self._reply(200, frontend.metrics())
                elif route == "/healthz":
                    code, payload = frontend.health()
                    self._reply(code, payload)
                elif route == "/trace":
                    self._reply(200, tracing.get_tracer().chrome_trace())
                elif route == "/debug/events":
                    self._reply(200, frontend.debug_events(
                        self.path.partition("?")[2]))
                elif route == "/debug/vars":
                    self._reply(200, frontend.debug_vars())
                elif route == "/":
                    # welcome route (ref: FrontEndApp.scala:40)
                    self._reply(200, {"message": "welcome to analytics "
                                                 "zoo tpu serving"})
                else:
                    self._reply(404, {"error": "not found",
                                      "path": self.path})

            def do_POST(self):
                route = self.path.split("?")[0]
                if route not in ("/predict", "/generate"):
                    self._reply(404, {"error": "not found",
                                      "path": self.path})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if route == "/generate":
                    frontend.handle_generate(self, req)
                    return
                with frontend.timer.timing("predict_request"):
                    code, payload = frontend.handle_predict(
                        req, priority=self.headers.get("X-Priority"))
                self._reply(code, payload,
                            headers=frontend._retry_headers(code))

            # ------------------------- chunked stream helpers -------
            def begin_stream(self) -> None:
                """Response head of a streamed /generate: chunked
                transfer, SSE content type. Counted here -- _reply
                never runs for a streamed response."""
                _M_HTTP_REQS.labels(route="/generate",
                                    code="200").inc()
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

            def write_event(self, obj: Any) -> bool:
                """One SSE event as one HTTP chunk; False = client
                went away (the caller stops relaying)."""
                data = b"data: " + json.dumps(obj).encode() + b"\n\n"
                try:
                    self.wfile.write(b"%X\r\n" % len(data) + data
                                     + b"\r\n")
                    self.wfile.flush()
                    return True
                except (ConnectionError, BrokenPipeError, OSError):
                    return False

            def end_stream(self) -> None:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except (ConnectionError, BrokenPipeError, OSError) as e:
                    logger.debug("stream close failed: %s", e)
                self.close_connection = True

        if self._tls:
            # HTTPS (ref: FrontEndApp.scala:40-130 supports --https-*
            # with cert+key). The handshake must run in the per-request
            # worker thread, NOT the accept loop: wrapping the listening
            # socket would let one stalled client (open connection, no
            # ClientHello) freeze accept() and starve every other
            # client. get_request only wraps (deferred handshake);
            # finish_request handshakes under the connection timeout.
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=certfile, keyfile=keyfile)

            class TLSServer(ThreadingHTTPServer):
                def get_request(self):
                    conn, addr = self.socket.accept()
                    conn.settimeout(30.0)
                    conn = ctx.wrap_socket(
                        conn, server_side=True,
                        do_handshake_on_connect=False)
                    return conn, addr

                def finish_request(self, request, client_address):
                    try:
                        request.do_handshake()
                    except (ssl.SSLError, OSError) as e:
                        logger.debug("tls handshake failed from %s: %s",
                                     client_address, e)
                        return
                    super().finish_request(request, client_address)

            self._server = TLSServer((host, port), Handler)
        else:
            self._server = ThreadingHTTPServer((host, port), Handler)
        self._server_thread: Optional[threading.Thread] = None

    # --------------------------------------------------------- requests --
    def handle_predict(self, req: Any, priority=None):
        """Predict with optional end-to-end tracing: when
        ``zoo.obs.trace.enabled``, the whole request runs under a fresh
        trace id (enqueued blobs carry it to the worker stages), an
        ``http_request`` span is recorded, and the response echoes the
        id for client-side correlation. ``priority`` is the request's
        admission class (the ``X-Priority`` header; a per-input
        ``__priority__`` JSON key overrides it)."""
        with tracing.maybe_trace("http_request") as trace_id:
            code, payload = self._handle_predict(req, priority)
            if trace_id is not None and isinstance(payload, dict):
                payload = dict(payload)
                payload["trace_id"] = trace_id
            return code, payload

    def _handle_predict(self, req: Any, priority=None):
        if self._draining:
            # structured refusal, same vocabulary as the wire errors:
            # the caller (fleet router, or a well-behaved client) sees
            # 503 + Retry-After and goes elsewhere
            return 503, {"error": DRAINING_PREFIX,
                         "detail": f"{DRAINING_PREFIX}: deployment "
                                   "is draining for restart",
                         "retry_after_s": self.retry_after_s}
        if priority is not None and priority_index(priority) is None:
            return 400, {"error": "unknown priority class "
                                  f"{priority!r}; expected one of "
                                  + ", ".join(PRIORITY_CLASSES)}
        if not isinstance(req, dict):
            return 400, {"error": "body must be a JSON object"}
        if "instances" in req:
            instances = req["instances"]
            if not isinstance(instances, list):
                return 400, {"error": "'instances' must be a list"}
            single = False
        elif "inputs" in req:
            instances, single = [req["inputs"]], True
        else:
            return 400, {"error": "body must carry 'inputs' or "
                                  "'instances'"}
        # enqueue everything first so the worker's micro-batcher can
        # stack the whole request into device batches, then await; one
        # deadline covers the whole request
        deadline = time.monotonic() + self.request_timeout
        uris: list = []
        try:
            code, payload = self._enqueue_many(instances, uris,
                                               priority)
            if code != 200:
                return code, payload
            preds = []
            for i, uri in enumerate(uris):
                code, payload = self._await(uri, deadline)
                uris[i] = None  # awaited: wait() owns the cleanup now
                if code != 200:
                    return code, payload
                preds.append(payload)
            return 200, {"predictions": preds[0] if single else preds}
        finally:
            for uri in uris:  # abandon whatever was never awaited
                if uri is not None:
                    self.router.unregister(uri)

    def _enqueue_many(self, instances, uris: list, priority=None):
        for inputs in instances:
            if not isinstance(inputs, dict) or not inputs:
                return 400, {"error": "inputs must be a non-empty object"}
            # __tenant__ / __priority__ ride the JSON inputs next to
            # the tensors and are lifted onto the wire blob's
            # out-of-band keys, never into the tensor dict (parameter
            # lanes, admission classes)
            inputs = dict(inputs)
            tenant = inputs.pop(TENANT_KEY, None)
            if tenant is not None and not isinstance(tenant, int):
                return 400, {"error": f"{TENANT_KEY} must be an "
                                      "integer lane id"}
            pri = inputs.pop(PRIORITY_KEY, priority)
            if pri is not None and priority_index(pri) is None:
                return 400, {"error": f"{PRIORITY_KEY} must name a "
                                      "priority class: "
                                      + ", ".join(PRIORITY_CLASSES)}
            if not inputs:
                return 400, {"error": "inputs must carry at least one "
                                      "tensor besides " + TENANT_KEY}
            try:
                tensors = {k: self._as_tensor(v)
                           for k, v in inputs.items()}
            except (ValueError, TypeError) as e:
                return 400, {"error": f"bad tensor: {e}"}
            for k, a in tensors.items():
                if a.dtype.kind not in "biufc":
                    return 400, {"error": f"tensor {k!r} is ragged or "
                                          "non-numeric"}
            uri = uuid.uuid4().hex
            self.router.register(uri)
            uris.append(uri)
            if not self._in.enqueue(uri, tenant=tenant, priority=pri,
                                    **tensors):
                # bounded-queue backpressure or admission-control
                # shedding -> 503 (+ Retry-After header added by the
                # handler); the reference surfaces Redis OOM as an
                # error (FrontEndApp/client.py), we tell the client
                # when to come back instead -- with a backoff that
                # scales with current shed pressure
                return 503, {"error": SHED_PREFIX,
                             "detail": f"{SHED_PREFIX}: input queue "
                                       "refused the request",
                             "retry_after_s": self._retry_after_s()}
        return 200, None

    @staticmethod
    def _as_tensor(value) -> np.ndarray:
        """JSON value -> tensor. ``{"b64": "..."}`` carries base64 bytes
        (TF-serving convention; the reference's frontend ships base64
        images the same way, FrontEndApp.scala + PreProcessing
        decodeImage) -- delivered as a uint8 byte tensor the worker's
        image sniffer decodes."""
        if isinstance(value, dict) and set(value) == {"b64"}:
            import base64

            raw = base64.b64decode(value["b64"], validate=True)
            return np.frombuffer(raw, np.uint8)
        return np.asarray(value)

    def _await(self, uri: str, deadline: float):
        result = self.router.wait(
            uri, max(0.0, deadline - time.monotonic()))
        if result is None:
            return 504, {"error": "prediction timed out"}
        if ERROR_KEY in result:
            msg = str(result[ERROR_KEY])
            status = error_status(msg)
            if status is not None:
                # structured worker rejection (protocol.ERROR_PREFIXES):
                # deadline_exceeded -> 504 (the client's budget ran
                # out, not a server fault), circuit_open -> 503 (the
                # handler adds Retry-After to every 503 so clients
                # back off while the breaker cools down)
                return status, {"error": msg.split(":", 1)[0],
                                "detail": msg}
            return 500, {"error": msg}
        return 200, _to_jsonable(result)

    def _retry_after_s(self, queue=None) -> float:
        """The backoff to advertise on a shed 503: the refusing
        queue's adaptive value (EWMA shed pressure) when it
        exposes one, never below the configured floor."""
        q = self._in if queue is None else queue
        fn = getattr(q, "retry_after_s", None)
        if callable(fn):
            try:
                return max(self.retry_after_s, float(fn()))
            except (TypeError, ValueError):
                pass
        return self.retry_after_s

    def _retry_headers(self, code: int) -> Optional[Dict[str, str]]:
        """Every 503 carries Retry-After (the load-shed / drain /
        overflow backoff contract shared by /predict and /generate).
        The advertised seconds track shed pressure: the configured
        retry_after_s is the floor, consecutive sheds raise it."""
        if code != 503:
            return None
        return {"Retry-After": str(max(1, int(self._retry_after_s())))}

    # ------------------------------------------------------ generation --
    def handle_generate(self, handler, req: Any) -> None:
        """``POST /generate``: enqueue a generate request
        and relay its chunk stream. ``stream: true`` (default) answers
        chunked SSE -- one ``data: {...}`` event per token chunk, a
        terminal event carrying ``finish_reason`` (or a structured
        ``error``); ``stream: false`` collects the whole stream into
        one JSON reply. The per-request deadline is honored across the
        stream: expiry mid-stream produces a structured
        ``deadline_exceeded`` terminal event, never a silent close."""
        with tracing.maybe_trace("http_generate") as trace_id:
            hdrs = getattr(handler, "headers", None)
            code, err, uri, stream_q, streaming = \
                self._generate_setup(
                    req, priority=(hdrs.get("X-Priority")
                                   if hdrs is not None else None))
            if uri is None:
                handler._reply(code, err,
                               headers=self._retry_headers(code))
                return
            try:
                if streaming:
                    self._stream_generate(handler, uri, stream_q,
                                          trace_id)
                else:
                    code, payload = self._collect_generate(
                        uri, stream_q, trace_id)
                    handler._reply(code, payload,
                                   headers=self._retry_headers(code))
            finally:
                self.router.unregister_stream(uri)

    def _generate_setup(self, req: Any, priority=None):
        """Validate + enqueue; returns (code, error_payload, uri,
        stream_queue, streaming) with uri None on refusal. A
        ``priority`` body field overrides the X-Priority header."""
        if self._gen_in is None:
            return 404, {"error": "generation serving is not enabled "
                                  "on this deployment"}, None, None, \
                False
        if self._draining:
            return 503, {"error": DRAINING_PREFIX,
                         "detail": f"{DRAINING_PREFIX}: deployment "
                                   "is draining for restart",
                         "retry_after_s": self.retry_after_s}, \
                None, None, False
        if not isinstance(req, dict):
            return 400, {"error": "body must be a JSON object"}, \
                None, None, False
        prompt = req.get("prompt", req.get("tokens"))
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(
                    t, bool) for t in prompt)):
            return 400, {"error": "'prompt' must be a non-empty list "
                                  "of token ids"}, None, None, False
        max_tokens = req.get("max_tokens")
        eos = req.get("eos")
        for name, v in (("max_tokens", max_tokens), ("eos", eos)):
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int)):
                return 400, {"error": f"'{name}' must be an int"}, \
                    None, None, False
        if max_tokens is not None and max_tokens < 1:
            # admission always yields the prefill's first token, so a
            # <1 budget cannot be honored -- refuse up front instead
            # of billing a prefill for a token nobody asked for
            return 400, {"error": "'max_tokens' must be >= 1"}, \
                None, None, False
        pri = req.get("priority", priority)
        if pri is not None and priority_index(pri) is None:
            return 400, {"error": "'priority' must name a class: "
                                  + ", ".join(PRIORITY_CLASSES)}, \
                None, None, False
        streaming = bool(req.get("stream", True))
        uri = uuid.uuid4().hex
        stream_q = self.router.register_stream(uri)
        if not self._gen_in.enqueue_generation(
                uri, np.asarray(prompt, np.int32),
                max_tokens=max_tokens, eos=eos, priority=pri):
            self.router.unregister_stream(uri)
            return 503, {"error": SHED_PREFIX,
                         "detail": f"{SHED_PREFIX}: generation queue "
                                   "refused the request",
                         "retry_after_s":
                             self._retry_after_s(self._gen_in)}, \
                None, None, False
        return 200, None, uri, stream_q, streaming

    @staticmethod
    def _parse_chunk(tensors: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Wire chunk -> event dict: {seq, token?, finish_reason?,
        n_tokens?} or {seq, error, detail}."""
        ev: Dict[str, Any] = {"seq": int(np.asarray(
            tensors[STREAM_KEY]).reshape(()))}
        if ERROR_KEY in tensors:
            msg = str(np.asarray(tensors[ERROR_KEY]).reshape(()))
            ev["error"] = msg.split(":", 1)[0]
            ev["detail"] = msg
            return ev
        if "token" in tensors:
            ev["token"] = [int(t) for t in
                           np.asarray(tensors["token"]).reshape(-1)]
        if "finish_reason" in tensors:
            ev["finish_reason"] = str(np.asarray(
                tensors["finish_reason"]).reshape(()))
            ev["n_tokens"] = int(np.asarray(
                tensors.get("n_tokens", 0)).reshape(()))
        return ev

    def _next_chunk(self, stream_q, deadline: float
                    ) -> Optional[Dict[str, Any]]:
        """Next parsed chunk event, or None when the request deadline
        expired first."""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                tensors = stream_q.get(timeout=min(remaining, 0.25))
            except _pyqueue.Empty:
                continue
            return self._parse_chunk(tensors)

    def _stream_generate(self, handler, uri: str, stream_q,
                         trace_id: Optional[str]) -> None:
        handler.begin_stream()
        meta: Dict[str, Any] = {"uri": uri}
        if trace_id is not None:
            meta["trace_id"] = trace_id
        alive = handler.write_event(meta)
        last_seq = -1
        while alive:
            # request_timeout here is an inter-chunk STALL detector
            # (reset per chunk): the TOTAL stream budget is the wire
            # deadline (zoo.serving.deadline_ms), which the worker
            # enforces with its own structured terminal chunk -- a
            # healthy long stream must not be killed mid-flow by the
            # frontend's (predict-sized) total timeout
            ev = self._next_chunk(
                stream_q, time.monotonic() + self.request_timeout)
            if ev is None:
                # chunks stopped arriving -> STRUCTURED terminal
                # chunk, not a silent close (the /generate contract)
                handler.write_event(
                    {"error": DEADLINE_PREFIX,
                     "detail": f"{DEADLINE_PREFIX}: stream stalled "
                               "(no chunk inside the request "
                               "timeout)"})
                break
            if "error" in ev:
                handler.write_event(ev)
                break
            if ev["seq"] <= last_seq:
                continue  # supervisor-restart replay: already relayed
            last_seq = ev["seq"]
            alive = handler.write_event(ev)
            if "finish_reason" in ev:
                break
        handler.end_stream()

    def _collect_generate(self, uri: str, stream_q,
                          trace_id: Optional[str]):
        """``stream: false``: assemble the chunk stream into one JSON
        reply (error prefixes map to HTTP statuses exactly like
        /predict error replies). Same inter-chunk STALL semantics as
        the streaming path -- a healthy long stream must not 504 just
        because its total exceeds the predict-sized request_timeout
        (the total budget is the wire deadline's job)."""
        toks: list = []
        last_seq = -1
        while True:
            ev = self._next_chunk(
                stream_q, time.monotonic() + self.request_timeout)
            if ev is None:
                return 504, {"error": "generation stalled (no chunk "
                                      "inside the request timeout)"}
            if "error" in ev:
                status = error_status(ev["detail"])
                return ((status, {"error": ev["error"],
                                  "detail": ev["detail"],
                                  "retry_after_s": self.retry_after_s})
                        if status is not None
                        else (500, {"error": ev["detail"]}))
            if ev["seq"] <= last_seq:
                continue
            last_seq = ev["seq"]
            toks.extend(ev.get("token", ()))
            if "finish_reason" in ev:
                out = {"tokens": toks,
                       "finish_reason": ev["finish_reason"],
                       "n_tokens": ev["n_tokens"]}
                if trace_id is not None:
                    out["trace_id"] = trace_id
                return 200, out

    # -------------------------------------------------------- lifecycle --
    @property
    def address(self):
        host, port = self._server.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> "HttpFrontend":
        self.router.start()
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._server_thread.start()
        logger.info("serving frontend at %s", self.address)
        emit_event("frontend_start", "serving", address=self.address)
        return self

    def stop(self) -> None:
        emit_event("frontend_stop", "serving")
        self._server.shutdown()
        if self._server_thread is not None:
            self._server_thread.join(5.0)
            self._server_thread = None
        self.router.stop()
        self._server.server_close()

    def metrics(self) -> Dict[str, Any]:
        """The JSON snapshot API (``GET /metrics.json``): historical
        frontend/worker summaries plus the full process registry."""
        out: Dict[str, Any] = {"frontend": self.timer.summary()}
        try:
            out["input_queue_depth"] = len(self._in)
        except TypeError:
            pass
        if self.worker is not None:
            out["worker"] = self.worker.metrics()
        if self.gen_worker is not None:
            out["generation"] = self.gen_worker.metrics()
        out["registry"] = get_registry().snapshot()
        return out

    def debug_events(self, query: str = "") -> Dict[str, Any]:
        """``GET /debug/events``: the structured event-log tail.
        Query params: ``n`` (default 200), ``type``, ``subsystem`` --
        filters apply before truncation, so ``?n=5&type=compile``
        means the last 5 compiles."""
        qs = parse_qs(query)

        def one(key):
            vals = qs.get(key)
            return vals[-1] if vals else None

        try:
            n = int(one("n") or 200)
        except ValueError:
            n = 200
        log = get_event_log()
        events = log.tail(n, type=one("type"),
                          subsystem=one("subsystem"))
        # scalar-coerce the fields (numpy values, exceptions): an
        # arbitrary emitter object must not 500 a debug endpoint
        return {"events": [to_jsonable(e) for e in events],
                "ring_len": len(log)}

    def debug_vars(self) -> Dict[str, Any]:
        """``GET /debug/vars``: resolved config + build/process info
        (the expvar convention) -- what you diff first when two
        deployments behave differently."""
        out: Dict[str, Any] = {
            "config": {k: v for k, v in sorted(
                get_config().as_dict().items())},
            "build": {
                "python": sys.version.split()[0],
                "platform": sys.platform,
            },
            "process": {
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "uptime_s": round(time.time() - self._started_at, 3),
                "threads": len(threading.enumerate()),
            },
            "inflight_requests": get_inflight().snapshot(),
        }
        # protocol-visible shard info: what you diff when one
        # deployment serves sharded and another doesn't (mode "off" is
        # the explicit single-chip answer, not an absent block)
        shard_plan = getattr(getattr(self.worker, "model", None),
                             "shard_plan", None)
        out["serving_shard"] = (shard_plan.describe()
                                if shard_plan is not None
                                else {"mode": "off"})
        # the framework and the card in place of the reference's jax
        # block (torch is imported with the port, so this cannot fail)
        import torch

        out["build"]["torch"] = torch.__version__
        out["build"]["cuda"] = torch.version.cuda
        out["build"]["device"] = (torch.cuda.get_device_name(0)
                                  if torch.cuda.is_available() else "cpu")
        return out

    def set_draining(self) -> None:
        """Flip the deployment into drain mode (one-way; the process
        is on its way out): health goes 503 ``draining`` so the fleet
        router stops routing here, /predict refuses new work."""
        self._draining = True

    def health(self):
        """Liveness for ``GET /healthz``: 503 once a started worker's
        serving thread has died (a stopped or inline-run worker is not
        a failure -- there is no thread to have died), or while the
        deployment is draining (in-flight work finishing; no new
        traffic wanted). A deployment hosting both data planes is
        healthy only when BOTH workers' threads live."""
        worker = self.worker
        thread = getattr(worker, "_thread", None)
        alive = thread is None or thread.is_alive()
        gen = self.gen_worker
        gen_thread = getattr(gen, "_thread", None)
        alive = alive and (gen_thread is None or gen_thread.is_alive())
        status = (DRAINING_PREFIX if self._draining
                  else "ok" if alive else "worker_dead")
        payload = {
            "status": status,
            "uptime_s": round(time.time() - self._started_at, 3),
        }
        if worker is not None:
            payload["served"] = worker.served
            payload["pipelined"] = worker.pipelined
        if gen is not None:
            payload["generation_served"] = gen.served
        return (200 if alive and not self._draining else 503), payload
