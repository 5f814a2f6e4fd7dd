"""ServingWorker: the inference engine of the serving data plane.

The analog of the Flink inference task (ref: zoo/.../serving/engine/
FlinkInference.scala:32-80 -- per-TM singleton InferenceModel fed by
micro-batches from the Redis source; batching logic in
engine/ClusterServingInference.scala:33-160). The TPU redesign runs one
worker loop per serving host, in one of two modes:

- **pipelined** (default, ``zoo.serving.pipeline.enabled``): an
  explicitly staged engine. A *decode* stage (its own thread, image
  decode fanned out over the shared thread pool) pulls micro-batches
  via :class:`AdaptiveBatcher` and feeds an *assembly* stage that
  stacks shape-compatible requests into padded, bucket-ladder device
  batches and dispatches them through the non-blocking
  ``InferenceModel.predict_async`` -- work queued on the model's CUDA
  stream keeps up to ``pipeline_depth`` batches in flight -- while a
  *finalize* stage on a
  third thread drains completed results in dispatch order. Decode of
  batch k+1 therefore overlaps device compute of batch k and result
  fetch/postprocess/push of batch k-1 (the stage overlap BigDL 2.0's
  Cluster Serving gets from the Flink dataflow, arXiv:2204.01715).
- **synchronous** (the escape hatch): one pull -> decode -> predict ->
  finalize cycle at a time on the caller's thread, still with
  ``pipeline_depth`` async dispatches in flight between cycles.

Results never reorder: the in-flight window is a FIFO and finalize is
single-threaded, so responses leave in dispatch order. Every stage is
Timer-instrumented (ref: serving/engine/Timer.scala:24-90), including
queue-depth / batch-occupancy / in-flight gauges.
"""

from __future__ import annotations

import collections
import os
import queue as _pyqueue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.flight import get_inflight
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.obs.tracing import get_tracer
from analytics_zoo_tpu_torch.serving.batcher import AdaptiveBatcher, MicroBatcher
from analytics_zoo_tpu_torch.serving.chaos import chaos_point
from analytics_zoo_tpu_torch.serving.protocol import (
    CIRCUIT_PREFIX, DEADLINE_PREFIX, ERROR_KEY, INVALID_PREFIX,
    priority_index, priority_name)
from analytics_zoo_tpu_torch.serving.queues import _decode_predict, _encode
from analytics_zoo_tpu_torch.serving.timer import Timer
from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map

logger = get_logger(__name__)

# exactly-once-reply obligation (zoolint lifecycle engine): every
# path through these stage methods must reach a reply, error-reply,
# requeue, or ownership hand-off -- the static twin of the ledger
ZOOLINT_REPLY_OBLIGATED = (
    "ServingWorker._predict_group",
    "ServingWorker._finalize_record",
)

# unified-registry wiring (obs, ISSUE-2): stage latencies as one
# labelled histogram family (every worker Timer mirrors into it),
# request/error counters, and the pipeline's operational gauges --
# the series HttpFrontend's /metrics Prometheus exposition scrapes
_REG = get_registry()
_M_STAGE = _REG.histogram(
    "zoo_serving_stage_duration_seconds",
    "Serving pipeline stage latency (decode, stack, predict_dispatch, "
    "predict_fetch, postprocess, service, ...)", labelnames=("stage",))
_M_SERVED = _REG.counter(
    "zoo_serving_requests_total", "Requests answered by the worker "
    "(successes and per-request error replies)")
_M_ERRORS = _REG.counter(
    "zoo_serving_errors_total",
    "Per-request error replies pushed by the worker")
_M_QUEUE_DEPTH = _REG.gauge(
    "zoo_serving_queue_depth_items",
    "Input-queue backlog observed behind the latest batch pull")
_M_OCCUPANCY = _REG.histogram(
    "zoo_serving_batch_occupancy_items",
    "Requests per pulled micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
_M_INFLIGHT = _REG.gauge(
    "zoo_serving_inflight_batches_items",
    "Dispatched batches awaiting finalize (pipeline window fill)")
_M_DEADLINE = _REG.counter(
    "zoo_serving_deadline_exceeded_total",
    "Requests rejected for missing their zoo.serving.deadline_ms "
    "budget (the catching stage rides the error message/event)")
_M_CLASS = _REG.counter(
    "zoo_serving_class_requests_total",
    "Requests decoded by the worker, by admission class (ISSUE-15; "
    "requests without __priority__ count as the default class)",
    labelnames=("class",))

# ERROR_KEY / DEADLINE_PREFIX / CIRCUIT_PREFIX are re-exported above
# from serving.protocol -- the wire vocabulary's one declaring module
# (zoolint's protocol family fails hand-typed copies); the error REPLY
# is a plain string on the wire, so the class of failure rides as a
# greppable prefix the frontend maps to an HTTP status
# (protocol.ERROR_PREFIXES) and _push_error picks the right
# event/counter from without a second argument threading through the
# in-flight record tuples

# compressed-image magic numbers: requests may ship JPEG/PNG bytes
# instead of raw pixel tensors (the reference decodes base64 images
# server-side, ref: zoo/.../serving/preprocessing/PreProcessing.scala:
# 83-99 decodeImage); a 224x224x3 JPEG is ~10-20x smaller on the wire
_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _is_image_bytes(a: np.ndarray) -> bool:
    if a.ndim != 1 or a.dtype != np.uint8 or a.size < 8:
        return False
    head = a[:8].tobytes()
    return head.startswith(_JPEG_MAGIC) or head == _PNG_MAGIC


def _decode_one_image(a: np.ndarray) -> np.ndarray:
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(a.tobytes()))
    return np.asarray(img.convert("RGB"), np.uint8)


_decode_pool = None
_decode_pool_lock = threading.Lock()


def _image_pool():
    """Shared decode pool: PIL releases the GIL during JPEG decode, so
    a thread pool decodes a 32-image batch ~cores-x faster than the
    serial loop (which would otherwise dominate worker service time)."""
    global _decode_pool
    with _decode_pool_lock:
        if _decode_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _decode_pool = ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 4))
        return _decode_pool


def decode_image_tensors(tensors: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """Replace any 1-D uint8 tensor holding JPEG/PNG bytes with the
    decoded [H, W, 3] uint8 pixel array (host-side PIL decode, the
    PreProcessing.decodeImage role). Non-image tensors pass through;
    undecodable image bytes raise (the batch path maps that to a
    per-request error)."""
    ok, failures = decode_image_batch([("", tensors, None)])
    if failures:
        raise ValueError(f"undecodable image bytes: {failures[0][2]}")
    return ok[0][1]


def decode_image_batch(items):
    """Decode every image tensor across a whole micro-batch through the
    shared thread pool (batch-level parallelism beats per-request).

    Items are ``(uri, tensors, reply, ...)`` tuples -- any tail beyond
    the tensors (reply-to, trace id) passes through untouched. Returns
    ``(decoded_items, failures)`` where failures are
    ``(uri, reply, message)`` for requests whose image bytes would not
    decode -- one corrupt upload must error that request, never the
    worker (same invariant as the per-blob decode guard)."""
    jobs = []
    for idx, item in enumerate(items):
        for k, v in item[1].items():
            a = np.asarray(v)
            if _is_image_bytes(a):
                jobs.append((idx, k, a))
    if not jobs:
        return items, []

    def safe_decode(job):
        try:
            return _decode_one_image(job[2])
        except Exception as e:
            return e

    pool = _image_pool()
    decoded = list(pool.map(safe_decode, jobs))
    out = [(item[0], dict(item[1])) + tuple(item[2:]) for item in items]
    bad = {}
    for (idx, k, _), img in zip(jobs, decoded):
        if isinstance(img, Exception):
            uri, _, reply = items[idx][:3]
            bad[idx] = (uri, reply, f"image decode failed for "
                                    f"{k!r}: {img}")
        else:
            out[idx][1][k] = img
    if not bad:
        return out, []
    return ([t for i, t in enumerate(out) if i not in bad],
            list(bad.values()))


def _default_input_fn(tensors: Dict[str, np.ndarray]) -> Any:
    """Map a request's named tensors to a model input pytree: a single
    tensor stays bare; several become a tuple in sorted-name order (the
    positional-args convention of the Estimator's multi-input models)."""
    if len(tensors) == 1:
        return next(iter(tensors.values()))
    return tuple(tensors[k] for k in sorted(tensors))


def _default_output_fn(pred: Any) -> Dict[str, np.ndarray]:
    """Map one request's slice of the model output back to named tensors
    (ref: PostProcessing -- the reference base64-encodes; we keep arrays)."""
    if isinstance(pred, dict):
        return {k: np.asarray(v) for k, v in pred.items()}
    if isinstance(pred, (tuple, list)):
        return {f"output_{i}": np.asarray(p) for i, p in enumerate(pred)}
    return {"output": np.asarray(pred)}


# in-flight records: either a dispatched batch awaiting finalize, or a
# bundle of per-request errors funneled through the same FIFO so
# responses keep dispatch order and one thread owns the served counter
_BATCH = "batch"    # ("batch", uris, replies, preds, n, prep_s, traces)
_ERRORS = "errors"  # ("errors", [(uri, reply, message), ...])

_SENTINEL = object()  # closes a pipeline stage


class ServingWorker:
    """Pulls, batches, predicts, pushes. Run inline (``serve_forever``),
    one bounded number of batches (``run``), or on a daemon thread
    (``start``/``stop``).

    Args:
      model: an ``InferenceModel`` (anything with ``predict(x)``;
        ``predict_async`` enables non-blocking dispatch).
      input_queue / output_queue: ``InputQueue``/``OutputQueue`` (or any
        object exposing their ``queue`` backend).
      batch_size: base micro-batch cap (ref: ClusterServingHelper
        coreNumber as batch size).
      timeout_ms: maximum linger after the first request of a batch.
      min_timeout_ms: linger floor the adaptive deadline tightens
        toward when the input queue is shallow.
      max_batch_size: cap the adaptive batcher may grow to under
        backlog (bucket-snapped); None reads config, 0 = 4x batch_size.
      input_fn / output_fn: request-tensors -> model-input pytree and
        model-output-slice -> response-tensors hooks (PreProcessing /
        PostProcessing analogs).
      top_n: if set, responses carry ``classes``/``scores`` of the top-N
        logits instead of the raw output (ref: PostProcessing topN).
      pipeline_depth: bounded in-flight window -- how many dispatched
        batches may await finalize (None reads config).
      pipelined: True runs the staged decode/assemble/finalize engine;
        False the synchronous loop; None reads
        ``zoo.serving.pipeline.enabled``.
    """

    def __init__(self, model, input_queue, output_queue,
                 batch_size: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 input_fn: Callable = _default_input_fn,
                 output_fn: Callable = _default_output_fn,
                 top_n: Optional[int] = None,
                 timer: Optional[Timer] = None,
                 pipeline_depth: Optional[int] = None,
                 pipelined: Optional[bool] = None,
                 min_timeout_ms: Optional[float] = None,
                 max_batch_size: Optional[int] = None,
                 breaker=None):
        cfg = get_config()
        if batch_size is None:
            batch_size = int(cfg.get("zoo.serving.batch_size", 8))
        if timeout_ms is None:
            timeout_ms = float(cfg.get("zoo.serving.batch_timeout_ms", 5))
        if min_timeout_ms is None:
            min_timeout_ms = float(
                cfg.get("zoo.serving.batch_timeout_min_ms", 1.0))
        if max_batch_size is None:
            max_batch_size = int(cfg.get("zoo.serving.batch_max_size", 0))
        if pipeline_depth is None:
            pipeline_depth = int(cfg.get("zoo.serving.pipeline.depth", 2))
        if pipelined is None:
            pipelined = bool(cfg.get("zoo.serving.pipeline.enabled", True))
        self.model = model
        self._in = getattr(input_queue, "queue", input_queue)
        self._out_q = output_queue
        self.pipelined = bool(pipelined)
        if self.pipelined:
            self.batcher = AdaptiveBatcher(
                self._in, batch_size=batch_size, timeout_ms=timeout_ms,
                min_timeout_ms=min_timeout_ms,
                max_batch_size=max_batch_size or None)
        else:
            # the escape hatch restores the WHOLE pre-pipeline engine,
            # fixed size/timeout batching included -- an operator
            # disabling the pipeline gets the proven old path, not a
            # half-new one
            self.batcher = MicroBatcher(self._in, batch_size=batch_size,
                                        timeout_ms=timeout_ms)
        self.input_fn = input_fn
        self.output_fn = output_fn
        self.top_n = top_n
        # default Timer mirrors every stage duration into the
        # process-wide registry histogram (Prometheus /metrics); a
        # caller-supplied timer keeps whatever mirroring it was built
        # with
        self.timer = timer or Timer(keep_samples=4096, mirror=_M_STAGE)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.served = 0
        # reply-to routing for brokered deployments: requests may name
        # the result stream of the frontend that issued them; results
        # go there instead of the default output queue. The route
        # travels WITH the request through grouping/finalize (clients
        # choose their own uris, so a uri-keyed side table would
        # cross-route same-uri requests that grouping reorders)
        self._reply_queues: Dict[str, Any] = {}
        # dispatch pipelining: keep up to pipeline_depth batches in
        # flight (predict_async), so batch n+1's host->device transfer
        # overlaps batch n's device compute + result fetch; 1 disables
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight: collections.deque = collections.deque()
        # live handle on the pipelined engine's in-flight window (for
        # metrics); set for the duration of a pipelined run
        self._inflight_q: Optional[_pyqueue.Queue] = None
        # resilience hooks (ISSUE-5) -- all None/absent-cheap when off:
        # * ledger: a Supervisor attaches a RequestLedger so the
        #   requests a dead run had pulled can be re-queued exactly
        #   once (recorded at decode, settled on reply);
        # * breaker: CircuitBreaker consulted before dispatch, fed by
        #   predict failures/successes (config-gated default);
        # * heartbeat: stamped by every stage loop iteration, read by
        #   the Supervisor's wedge detector.
        self.ledger = None
        # fleet ack seam (ISSUE-9): consumer-group input backends
        # (RedisStreamQueue) expose ack_uris -- the worker settles a
        # claim the moment it pushes the reply, so a replica SIGKILLed
        # mid-serve leaves its claims pending for another replica to
        # reclaim. None for every other backend: one getattr at
        # construction, zero per-request cost
        self._acker = getattr(self._in, "ack_uris", None)
        # tenant-lane routing (ISSUE-13): population-backed models
        # expose tenant_lanes (the member count) + resolve_lane; every
        # other model leaves it None, and a request carrying __tenant__
        # anyway is a structured 400 -- one getattr at construction,
        # zero per-request cost on the no-tenant path
        self._tenant_lanes = getattr(model, "tenant_lanes", None)
        # admission class of requests without __priority__ (ISSUE-15):
        # resolved once so the per-request counter pays one list index
        self._default_priority = priority_index(
            cfg.get("zoo.serving.priority.default_class",
                    "interactive")) or 0
        if breaker is None and bool(
                cfg.get("zoo.serving.breaker.enabled", False)):
            from analytics_zoo_tpu_torch.serving.resilience import (
                CircuitBreaker)

            breaker = CircuitBreaker()
        self.breaker = breaker
        # drain flag (ISSUE-9): set-once per run; a draining engine
        # stops pulling, finishes in-flight work, and exits cleanly
        self._drain = threading.Event()
        self.heartbeat = time.monotonic()
        # decode stage's own heartbeat: None while no decode thread is
        # running (sync engine, bounded runs after their decode loop
        # finished) -- the supervisor only reads it when set, so a
        # finished decode loop cannot read as a wedge
        self.heartbeat_decode: Optional[float] = None

    def _count_served(self, n: int) -> None:
        """Single owner of the served counters (instance total + the
        process-wide registry counter)."""
        self.served += n
        if n:
            _M_SERVED.inc(n)

    def _ack_input(self, uris) -> None:
        """Settle consumer-group claims for answered requests (no-op
        off the fleet data plane). Ack failures are survivable: the
        entries re-deliver after the idle threshold -- duplicate work,
        never lost work."""
        if self._acker is None:
            return
        try:
            self._acker(uris)
        except Exception as e:
            logger.warning("input ack for %d request(s) failed: %s",
                           len(tuple(uris)), e)

    # ------------------------------------------------- synchronous loop --
    def process_one_batch(self, wait_timeout: float = 1.0) -> int:
        """One pull->predict->push cycle (the synchronous engine);
        returns requests served."""
        self.heartbeat = time.monotonic()
        with self.timer.timing("batch_wait"):
            blobs = self.batcher.next_batch(wait_timeout=wait_timeout)
        if not blobs:
            n = 0
            while self._inflight:  # idle: drain pipelined batches
                n += self._finalize_one()
            self._count_served(n)
            return n
        items, bad_images, decode_s = self._decode_stage(blobs)
        n_failed = 0
        for uri, reply, msg in bad_images:
            logger.warning("serving: %s", msg)
            self._push_error(uri, reply, msg)
            n_failed += 1
        groups = self._group_compatible(items)
        # the decode stage is shared by every signature group of this
        # cycle: apportion it by group size so a group's "service"
        # metric neither double-counts earlier groups' decode+prep
        # time nor charges a 1-item group a 127-item group's decode
        self._decode_per_item = decode_s / max(1, len(items))
        n = n_failed
        for group in groups:
            group, expired = self._split_expired(group, "dispatch")
            for uri, reply, msg in expired:
                self._push_error(uri, reply, msg)
            n += len(expired)
            if not group:
                continue
            try:
                n += self._predict_group(group)
            except Exception as e:  # input_fn/output_fn bugs must not
                logger.exception(  # kill the serving thread
                    "serving batch failed: %s", e)
                for item in group:
                    self._push_error(item[0], item[2], str(e))
                n += len(group)
        # finalize the oldest in-flight batches beyond the pipeline
        # depth (idle cycles drain the rest -- see the early return)
        while len(self._inflight) >= self.pipeline_depth:
            n += self._finalize_one()
        self._count_served(n)
        return n

    # ------------------------------------------------------- stages -----
    def _decode_stage(self, blobs) -> Tuple[List, List, float]:
        """Wire-decode a pulled micro-batch, then image-decode through
        the shared thread pool. Returns (items, failures,
        decode_seconds); items are (uri, tensors, reply, trace,
        deadline, tenant, priority), failures are (uri, reply,
        message) -- undecodable images plus requests already past
        their deadline."""
        t0 = time.perf_counter()
        with self.timer.timing("decode", batch=len(blobs)):
            items: List[Tuple[str, Dict[str, np.ndarray],
                              Optional[str], Optional[str],
                              Optional[float], Optional[int],
                              Optional[int]]]
            try:  # fast path: no per-item try frames on clean batches
                items = [_decode_predict(b) for b in blobs]
                if self.ledger is not None:
                    for b, it in zip(blobs, items):
                        self.ledger.record(it[0], b)
            except Exception:
                items = []
                for b in blobs:
                    try:
                        items.append(_decode_predict(b))
                    except Exception as e:  # malformed blob: drop,
                        logger.exception(   # keep serving
                            "serving: undecodable request dropped: %s",
                            e)
                        continue
                    if self.ledger is not None:
                        self.ledger.record(items[-1][0], b)
            # chaos seam AFTER the ledger record: blobs are already
            # off the input queue, so a stage death here must be
            # requeue-covered or the requests would vanish replyless
            # (the only residual uncovered window is the wire-decode
            # loop itself)
            chaos_point("decode")
            for it in items:
                # per-class traffic counter (ISSUE-15): requests
                # without __priority__ count as the default class
                pri = it[6] if len(it) > 6 and it[6] is not None \
                    else self._default_priority
                _M_CLASS.labels(**{"class": priority_name(pri)}).inc()
            items, bad_images = decode_image_batch(items)
            items, expired = self._split_expired(items, "decode")
        t1 = time.perf_counter()
        self._emit_spans("decode", (it[3] for it in items), t0, t1,
                         batch=len(items))
        return items, bad_images + expired, t1 - t0

    def _split_expired(self, items, stage: str):
        """Partition a batch on its per-request deadlines: (live,
        expired-error-tuples). Requests without a deadline (the
        default wire format) always pass -- the common case is one
        ``is None`` check per request."""
        expired = []
        live = None  # copy-on-write: stays None on the no-expiry path
        now = None
        for i, it in enumerate(items):
            deadline = it[4]
            if deadline is not None:
                if now is None:
                    now = time.time()
                if now > deadline:
                    if live is None:
                        live = list(items[:i])
                    expired.append(
                        (it[0], it[2],
                         f"{DEADLINE_PREFIX}: request missed its "
                         f"deadline before {stage}"))
                    continue
            if live is not None:
                live.append(it)
        return (items if live is None else live), expired

    @staticmethod
    def _emit_spans(name, traces, t0: float, t1: float, **args) -> None:
        """One span per traced request covering this batch stage --
        a no-op loop when nothing in the batch carries a trace id (the
        tracing-disabled hot path)."""
        tracer = None
        for tr in traces:
            if tr:
                if tracer is None:
                    tracer = get_tracer()
                tracer.add_span(name, tr, t0, t1, **args)

    @staticmethod
    def _group_compatible(items):
        """Group requests whose tensors share keys+shapes+dtypes so they
        stack into one device batch (ref: batchInput groups by model
        signature implicitly -- one model, one schema). The tenant lane
        joins the signature: a device batch answers ONE lane, so
        same-shape requests for different tenants dispatch separately
        (each through the same warmed executable -- the lane is traced,
        not a shape)."""
        groups: Dict[Any, List] = {}
        for item in items:
            sig = (tuple(sorted((k, v.shape, str(v.dtype))
                                for k, v in item[1].items())),
                   item[5] if len(item) > 5 else None)
            groups.setdefault(sig, []).append(item)
        return list(groups.values())

    def _dispatch_group(self, group):
        """Assembly stage for one signature group: stack the requests
        into a device batch and dispatch it (non-blocking when the
        model exposes ``predict_async``). Returns an in-flight record
        -- (``_BATCH``, ...) awaiting finalize, or (``_ERRORS``, ...)
        when dispatch failed. Stack/input_fn exceptions propagate (the
        caller owns the per-request error mapping for those)."""
        chaos_point("dispatch")
        uris = [it[0] for it in group]
        replies = [it[2] for it in group]
        traces = [it[3] if len(it) > 3 else None for it in group]
        deadlines = [it[4] if len(it) > 4 else None for it in group]
        if self.breaker is not None and not self.breaker.allow():
            # open circuit: fast-fail the whole group instead of
            # burning a device slot on a backend that keeps dying
            self.breaker.rejected(len(group))
            return (_ERRORS,
                    [(u, r, f"{CIRCUIT_PREFIX}: backend dispatch "
                            "suspended after repeated failures")
                     for u, r in zip(uris, replies)])
        # tenant-lane resolution (ISSUE-13): grouping made the lane
        # uniform across this group. Resolution failures (lane out of
        # range, missing tenant under strict) are CLIENT errors -- they
        # reply with the structured invalid_request message before any
        # device work and never feed the breaker
        tenant = group[0][5] if len(group[0]) > 5 else None
        lane = None
        if self._tenant_lanes is not None:
            try:
                lane = self.model.resolve_lane(tenant)
            except ValueError as e:
                return (_ERRORS, [(u, r, str(e))
                                  for u, r in zip(uris, replies)])
        elif tenant is not None:
            return (_ERRORS,
                    [(u, r, f"{INVALID_PREFIX}: request names tenant "
                            f"lane {tenant} but the serving model has "
                            "no parameter lanes")
                     for u, r in zip(uris, replies)])
        t0 = time.perf_counter()  # this group's own prep starts here
        with self.timer.timing("stack", batch=len(group)):
            stacked = {
                k: np.stack([it[1][k] for it in group])
                for k in group[0][1]
            }
            x = self.input_fn(stacked)
        try:
            with self.timer.timing("predict_dispatch", batch=len(group)):
                if hasattr(self.model, "predict_async"):
                    if self._tenant_lanes is not None:
                        preds, n = self.model.predict_async(x, lane=lane)
                    else:
                        preds, n = self.model.predict_async(x)
                else:  # duck-typed models (tests): synchronous path
                    preds, n = self.model.predict(x), len(group)
        except Exception as e:  # push per-request errors, keep serving
            logger.exception("serving predict failed: %s", e)
            if self.breaker is not None:
                self.breaker.record_failure()
            return (_ERRORS, [(u, r, str(e))
                              for u, r in zip(uris, replies)])
        # start the device->host result copy NOW: by finalize time
        # (pipeline_depth batches later) the bytes are already host-
        # side, and the d2h copy overlaps the next batches' compute
        # (InferenceModel's results queue a non-blocking copy into
        # pinned memory on the model's CUDA stream)
        for leaf in tree_leaves(preds):
            if hasattr(leaf, "copy_to_host_async"):
                try:
                    leaf.copy_to_host_async()
                except Exception:  # fall back to the sync fetch path
                    break
        # prep time for THIS group: its share of the cycle's decode
        # stage + its own stack/dispatch (stored so the service metric
        # can exclude pipeline residency while other batches finalize)
        t1 = time.perf_counter()
        self._emit_spans("dispatch", traces, t0, t1, batch=len(group))
        prep_s = (getattr(self, "_decode_per_item", 0.0) * len(group)
                  + t1 - t0)
        # dispatched-but-unanswered ids into the flight recorder's
        # in-flight registry: a crash postmortem names exactly which
        # requests were lost (one set update per BATCH, not per request)
        get_inflight().add(uris)
        return (_BATCH, uris, replies, preds, n, prep_s, traces,
                deadlines)

    def _predict_group(self, group) -> int:
        rec = self._dispatch_group(group)
        if rec[0] == _ERRORS:
            for uri, reply, msg in rec[1]:
                self._push_error(uri, reply, msg)
            return len(rec[1])
        self._inflight.append(rec)
        return 0  # counted when finalized

    def _finalize_one(self) -> int:
        """Materialize the oldest in-flight batch and push its results
        (async dispatch errors surface here). The pop is race-guarded:
        after a wedge restart an abandoned run's drain can briefly
        overlap the new run on this deque (deque ops are atomic, the
        check-then-pop is not) -- losing the race must cost nothing,
        not an IndexError that kills a serving thread."""
        try:
            rec = self._inflight.popleft()
        except IndexError:
            return 0
        return self._finalize_record(rec)

    def _finalize_record(self, rec) -> int:
        """Finalize stage for one in-flight record. Never raises:
        push-path failures (broker down, spool disk full) must not kill
        the serving loop -- callers sit outside the batch guard."""
        chaos_point("finalize")
        if rec[0] == _ERRORS:
            try:
                for uri, reply, msg in rec[1]:
                    self._push_error(uri, reply, msg)
            except Exception as e:  # push path down (broker gone):
                logger.exception(   # the contract still holds
                    "serving error-push failed (%d error replies "
                    "lost): %s", len(rec[1]), e)
            return len(rec[1])
        _, uris, replies, preds, n, prep_s, traces, deadlines = rec
        t0 = time.perf_counter()
        try:
            try:
                served = self._finalize_inner(uris, replies, preds, n,
                                              deadlines)
            finally:  # answered (or accounted): off the crash manifest
                get_inflight().discard(uris)
                if self.ledger is not None:
                    # settled = this engine accounted for the request
                    # (reply pushed, or its loss logged); the
                    # supervisor must not re-queue it after a later
                    # crash -- that would duplicate the reply
                    self.ledger.settle(uris)
                # same settlement for brokered consumer-group claims
                # (a SIGKILL before this line leaves them pending ->
                # reclaimed by a surviving replica)
                self._ack_input(uris)
            t1 = time.perf_counter()
            self._emit_spans("finalize", traces, t0, t1,
                             batch=len(uris))
            # worker-side service time for this batch: its own decode/
            # stack/dispatch prep + its remaining result wait + push.
            # Residency in the in-flight window while OTHER batches
            # finalize is excluded -- which also means device compute
            # that OVERLAPPED that residency doesn't show up here; this
            # is "host work + un-overlapped device wait", the marginal
            # per-batch cost under pipelining (zero overlap = full
            # decode->predict->push)
            self.timer.record("service", prep_s + t1 - t0)
            return served
        except Exception as e:
            logger.exception("serving finalize failed (results for %d "
                             "requests lost): %s", len(uris), e)
            # intentional: if the finally block itself raised before
            # settle/ack ran, the ledger entry and broker claim stay
            # pending -- the supervisor/replica requeue redelivers the
            # request, so the contract degrades to at-least-once
            # rather than silently losing the reply
            return len(uris)  # zoolint: disable=reply-missing-on-path

    def _finalize_inner(self, uris, replies, preds, n,
                        deadlines=None) -> int:
        try:
            with self.timer.timing("predict_fetch", batch=len(uris)):
                preds = tree_map(lambda a: np.asarray(a)[:n], preds)
        except Exception as e:
            logger.exception("serving predict failed: %s", e)
            if self.breaker is not None:
                self.breaker.record_failure()
            for uri, reply in zip(uris, replies):
                self._push_error(uri, reply, str(e))
            return len(uris)
        if self.breaker is not None:
            # fetch materialized: the backend really answered -- this
            # is the success signal that closes a half-open breaker
            self.breaker.record_success()
        # finalize-time deadline check: the device slot is spent, but
        # a reply nobody is waiting for must still be the STRUCTURED
        # error the contract promises, not a late result
        late = None
        if deadlines is not None and any(
                d is not None for d in deadlines):
            now = time.time()
            late = [d is not None and now > d for d in deadlines]
            if not any(late):
                late = None
        with self.timer.timing("postprocess", batch=len(uris)):
            # hot path: the common single-ndarray output with default
            # hooks slices rows directly -- per-request tree_map
            # costs ~10 us each, which dominates postprocess at large
            # adaptive batches
            fast = (self.top_n is None
                    and self.output_fn is _default_output_fn
                    and isinstance(preds, np.ndarray))
            backend = getattr(self._out_q, "queue", self._out_q)
            if (fast and late is None and not any(replies)
                    and hasattr(backend, "put_many")):
                # one batched push: per-item lock/notify trips cost
                # more than the encode itself at adaptive batch sizes
                if chaos_point("push"):
                    return len(uris)  # injected drop-reply
                blobs = [_encode(uri, {"output": preds[i]})
                         for i, uri in enumerate(uris)]
                accepted = backend.put_many(blobs)
                if accepted < len(blobs):
                    logger.warning(
                        "output queue full: dropped %d results",
                        len(blobs) - accepted)
                return len(uris)
            for i, (uri, reply) in enumerate(zip(uris, replies)):
                try:
                    if late is not None and late[i]:
                        self._push_error(
                            uri, reply,
                            f"{DEADLINE_PREFIX}: request missed its "
                            "deadline before finalize")
                        continue
                    if fast:
                        self._push(uri, reply, {"output": preds[i]})
                        continue
                    pred_i = _tree_index(preds, i)
                    if self.top_n is not None:
                        pred_i = _top_n(np.asarray(pred_i), self.top_n)
                        self._push(uri, reply, pred_i)
                    else:
                        self._push(uri, reply, self.output_fn(pred_i))
                except Exception as e:  # output_fn bugs must not kill
                    logger.exception(  # the serving thread
                        "serving postprocess failed for %s: %s", uri, e)
                    self._push_error(uri, reply, str(e))
        return len(uris)

    # ---------------------------------------------- pipelined engine ----
    def _run_pipelined(self, max_batches: Optional[int],
                       wait_timeout: float,
                       stop_ev: threading.Event,
                       drain_ev: Optional[threading.Event] = None) -> int:
        """The staged engine: decode thread -> assembly/dispatch (this
        thread) -> finalize thread, bounded by ``pipeline_depth``
        dispatched batches in flight. A bounded run returns only after
        every request it pulled is answered. ``stop_ev`` is THIS run's
        stop event (captured, not ``self._stop``): a supervisor
        restart hands the next run a fresh event, so an abandoned
        wedged thread that wakes later sees its own set event and
        exits instead of double-serving."""
        decoded_q: _pyqueue.Queue = _pyqueue.Queue(
            maxsize=max(2, self.pipeline_depth))
        inflight_q: _pyqueue.Queue = _pyqueue.Queue(
            maxsize=self.pipeline_depth)
        abort = threading.Event()  # abnormal driver exit: unstick stages
        served_box = [0]

        def put_stage(q, item) -> bool:
            while True:
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _pyqueue.Full:
                    if abort.is_set():
                        return False

        def decode_loop():
            pulled = 0
            try:
                while not stop_ev.is_set() and not abort.is_set():
                    if drain_ev is not None and drain_ev.is_set():
                        # draining: stop pulling; the sentinel below
                        # flushes everything already in the pipeline
                        # through dispatch + finalize, then the run
                        # exits cleanly -- the same clean-exit path a
                        # bounded run takes
                        break
                    # iterates at least every wait_timeout when idle
                    # (next_batch returns empty), so staleness means
                    # STUCK (hung broker recv, chaos stall), not idle
                    self.heartbeat_decode = time.monotonic()
                    if max_batches is not None and pulled >= max_batches:
                        break
                    pulled += 1
                    with self.timer.timing("batch_wait"):
                        blobs = self.batcher.next_batch(
                            wait_timeout=wait_timeout)
                    if not blobs:
                        continue
                    # depth the batcher already observed for policy --
                    # a second len() here would cost one more broker
                    # RPC per pull on TcpQueue backends
                    depth = getattr(self.batcher, "last_depth", -1)
                    if depth >= 0:
                        self.timer.gauge("queue_depth", depth)
                        _M_QUEUE_DEPTH.set(depth)
                    self.timer.gauge("batch_occupancy", len(blobs))
                    _M_OCCUPANCY.observe(len(blobs))
                    if not put_stage(decoded_q,
                                     self._decode_stage(blobs)):
                        logger.warning(
                            "serving pipeline aborted with %d decoded "
                            "requests undispatched", len(blobs))
                        return
            except Exception as e:  # batcher/queue failures must
                logger.exception(   # still close the pipeline cleanly
                    "serving decode stage failed: %s", e)
            finally:
                self.heartbeat_decode = None  # not running != wedged
                put_stage(decoded_q, _SENTINEL)

        def finalize_loop():
            while True:
                rec = inflight_q.get()
                if rec is _SENTINEL:
                    return
                self.heartbeat = time.monotonic()
                try:
                    n = self._finalize_record(rec)
                except Exception as e:  # belt-and-braces: this thread
                    # must never die -- the driver blocks on the
                    # bounded FIFO it drains, so a dead finalizer
                    # wedges the whole engine
                    logger.exception("serving finalize stage "
                                     "failed: %s", e)
                    n = len(rec[1])
                served_box[0] += n
                self._count_served(n)

        decode_t = threading.Thread(target=decode_loop, daemon=True,
                                    name="serving-decode")
        finalize_t = threading.Thread(target=finalize_loop, daemon=True,
                                      name="serving-finalize")
        self._inflight_q = inflight_q
        decode_t.start()
        finalize_t.start()
        try:
            while True:
                with self.timer.timing("assembly_wait"):
                    # the DRIVER owns the supervision heartbeat: it is
                    # the thread that holds device work, so "driver
                    # stuck in dispatch/finalize backpressure" is
                    # exactly the wedge the Supervisor must catch --
                    # a sliced wait keeps the heartbeat fresh while
                    # verifiably idle, stale only when truly stuck
                    while True:
                        self.heartbeat = time.monotonic()
                        try:
                            item = decoded_q.get(timeout=0.5)
                            break
                        except _pyqueue.Empty:
                            continue
                if item is _SENTINEL:
                    break
                items, bad_images, decode_s = item
                if bad_images:
                    for uri, reply, msg in bad_images:
                        logger.warning("serving: %s", msg)
                    # errors ride the in-flight FIFO: responses keep
                    # arrival order and finalize owns the counters
                    inflight_q.put((_ERRORS, list(bad_images)))
                if not items:
                    continue
                self.heartbeat = time.monotonic()
                self._decode_per_item = decode_s / max(1, len(items))
                for group in self._group_compatible(items):
                    group, expired = self._split_expired(group,
                                                         "dispatch")
                    if expired:  # deadline hit while queued in-engine
                        inflight_q.put((_ERRORS, expired))
                    if not group:
                        continue
                    try:
                        rec = self._dispatch_group(group)
                    except Exception as e:  # input_fn bugs etc.
                        logger.exception("serving batch failed: %s", e)
                        rec = (_ERRORS, [(it[0], it[2], str(e))
                                         for it in group])
                    with self.timer.timing("inflight_wait"):
                        inflight_q.put(rec)  # blocks at the window cap
                    depth_now = inflight_q.qsize()
                    self.timer.gauge("inflight", depth_now)
                    _M_INFLIGHT.set(depth_now)
        finally:
            abort.set()
            dropped = 0
            while True:  # abnormal exit: unstick + account a blocked
                try:     # decode stage (normal exit finds it empty)
                    item = decoded_q.get_nowait()
                    if item is not _SENTINEL:
                        dropped += len(item[0]) + len(item[1])
                except _pyqueue.Empty:
                    break
            if dropped:
                logger.warning("serving pipeline dropped %d decoded "
                               "requests on abnormal exit", dropped)
                emit_event("pipeline_abort", "serving", dropped=dropped)
            inflight_q.put(_SENTINEL)
            finalize_t.join()
            decode_t.join(timeout=5.0)
            self._inflight_q = None
            # zero the operational gauges: a drained/stopped engine
            # must not scrape as permanently-stuck backlog
            _M_INFLIGHT.set(0)
            _M_QUEUE_DEPTH.set(0)
        return served_box[0]

    # ------------------------------------------------------- lifecycle --
    def run(self, max_batches: Optional[int] = None,
            wait_timeout: float = 0.05) -> int:
        """Serve until stopped (or ``max_batches`` pull cycles); returns
        total requests served in this call."""
        stop_ev = self._stop  # capture: this RUN's stop event -- see
        # _run_pipelined's docstring for the restart semantics
        drain_ev = self._drain  # same per-run capture
        if self.pipelined:
            return self._run_pipelined(max_batches, wait_timeout,
                                       stop_ev, drain_ev)
        total = 0
        batches = 0
        while not stop_ev.is_set() and not drain_ev.is_set():
            total += self.process_one_batch(wait_timeout=wait_timeout)
            batches += 1
            if max_batches is not None and batches >= max_batches:
                break
        # a bounded run returns only after everything it pulled is
        # answered (pipelined batches must not linger past the call).
        # Identity-gated: after a wedge restart this may be an
        # ABANDONED run waking up -- the deque now belongs to the new
        # run, whose own drain answers these records
        while self._inflight and self._stop is stop_ev:
            n = self._finalize_one()
            self._count_served(n)
            total += n
        return total

    def serve_forever(self) -> None:
        try:
            self.run()
        except BaseException as e:
            # mark the death in the event log BEFORE re-raising so the
            # flight recorder's postmortem (threading.excepthook fires
            # next) carries the crash as its final event
            emit_event("worker_crash", "serving", error=repr(e)[:500],
                       served=self.served)
            raise

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Graceful drain (ISSUE-9): stop pulling new work (the input
        backend's ``pause`` seam, where it has one), let the engine
        finish every request it already pulled, and wait up to
        ``deadline_s`` (default ``zoo.serving.drain.deadline_ms``).
        Returns True when the run fully drained inside the budget;
        False means in-flight work is still finishing when the
        deadline expired (the caller decides whether to hard-stop).
        This is the seam SIGTERM and rolling restarts share."""
        if deadline_s is None:
            deadline_s = float(get_config().get(
                "zoo.serving.drain.deadline_ms", 10000.0)) / 1000.0
        pause = getattr(self._in, "pause", None)
        if pause is not None:
            pause()  # a brokered consumer must stop CLAIMING, not
            # just stop pulling claimed work -- entries claimed after
            # this point would sit until the reclaim threshold
        self._drain.set()
        thread = self._thread
        if thread is None:
            return True
        thread.join(max(0.0, deadline_s))
        if thread.is_alive():
            return False
        self._thread = None
        while self._inflight:  # sync-engine leftovers
            self._count_served(self._finalize_one())
        return True

    def start(self) -> "ServingWorker":
        # a FRESH stop event per run (not .clear()): a previous run's
        # thread that is still draining -- or was abandoned by a
        # supervisor wedge restart -- holds the old event and must
        # keep seeing it set, or it would resume serving next to the
        # new thread
        self._stop = threading.Event()
        self._drain = threading.Event()  # same per-run freshness
        self.heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        emit_event("worker_start", "serving", pipelined=self.pipelined,
                   batch_size=self.batcher.batch_size,
                   pipeline_depth=self.pipeline_depth)
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        emit_event("worker_stop", "serving", served=self.served)
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(join_timeout)
            if thread.is_alive():
                # the worker thread is still draining (e.g. a slow
                # first compile); it owns the in-flight window --
                # draining here would race its pops. KEEP the handle so
                # a retried stop() (or start()) still sees the live
                # thread.
                logger.warning("serving worker still busy after %.1fs; "
                               "in-flight batches drain on its thread",
                               join_timeout)
                return
            self._thread = None
        while self._inflight:  # flush: accepted requests must answer
            self._count_served(self._finalize_one())

    # --------------------------------------------------------- outputs --
    def _push(self, uri: str, reply: Optional[str],
              tensors: Dict[str, np.ndarray]) -> None:
        if chaos_point("push"):
            return  # injected drop-reply
        backend = self._reply_backend(reply)
        if not backend.put(_encode(uri, tensors)):
            logger.warning("output queue full: dropping result for %s",
                           uri)

    def _reply_backend(self, reply_to: Optional[str]):
        """Default output backend, or the named stream on the same
        broker when the request carried a reply-to (several frontends
        sharing one broker each get their own results back). Brokered
        backends (TcpQueue, RedisStreamQueue) expose ``for_stream``;
        everything else ignores reply-to."""
        default = getattr(self._out_q, "queue", self._out_q)
        if not reply_to:
            return default
        maker = getattr(default, "for_stream", None)
        if maker is None:
            return default
        if reply_to not in self._reply_queues:
            self._reply_queues[reply_to] = maker(reply_to)
        return self._reply_queues[reply_to]

    def _push_error(self, uri: str, reply: Optional[str],
                    message: str) -> None:
        # reserved out-of-band key (the "__uri__" convention of
        # queues._encode) so model outputs named "error" stay usable
        _M_ERRORS.inc()
        if message.startswith(DEADLINE_PREFIX):
            _M_DEADLINE.inc()
            emit_event("deadline_exceeded", "serving", uri=uri,
                       error=message[:500])
        elif not message.startswith(CIRCUIT_PREFIX):
            # breaker rejections happen at batch scale while open; the
            # circuit_open/closed transition events carry that story,
            # a per-request event would flood the ring. Everything
            # else is rare by construction, so a structured event per
            # error is cheap and makes /debug/events the first stop
            # for "why did request X fail" instead of log spelunking
            emit_event("serving_error", "serving", uri=uri,
                       error=message[:500])
        if self.ledger is not None:
            self.ledger.settle((uri,))
        self._push(uri, reply, {ERROR_KEY: np.asarray(message)})
        # ack AFTER the push: an error reply answers the request, so
        # its stream claim settles on the same at-least-once contract
        # as a result reply
        self._ack_input((uri,))

    # --------------------------------------------------------- metrics --
    def metrics(self) -> Dict[str, Any]:
        inflight_q = self._inflight_q  # read once: the worker thread
        # clears this attribute when a pipelined run exits
        pipe: Dict[str, Any] = {
            "enabled": self.pipelined,
            "depth": self.pipeline_depth,
            "inflight": (inflight_q.qsize() if inflight_q is not None
                         else len(self._inflight)),
            "batcher": self.batcher.stats(),
        }
        try:
            pipe["queue_depth"] = len(self._in)
        except (TypeError, OSError):
            # a queue backend without __len__ (or a broker hop that
            # cannot answer right now): depth is best-effort metadata,
            # omit the field rather than fail the metrics call
            pass
        out = {"served": self.served, "stages": self.timer.summary(),
               "pipeline": pipe}
        shard_plan = getattr(self.model, "shard_plan", None)
        if shard_plan is not None:
            out["shard"] = shard_plan.describe()
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        if self.ledger is not None:
            out["ledger_outstanding"] = len(self.ledger)
        return out


def _tree_index(preds, i: int):
    return tree_map(lambda a: np.asarray(a)[i], preds)


def _top_n(logits: np.ndarray, n: int) -> Dict[str, np.ndarray]:
    """(ref: PostProcessing topN -- class indices + scores)."""
    flat = logits.reshape(-1)
    idx = np.argsort(flat)[::-1][:n]
    return {"classes": idx.astype(np.int32), "scores": flat[idx]}
