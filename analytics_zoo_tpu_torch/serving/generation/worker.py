"""GenerationWorker: the token-streaming serving loop.

The generation data plane's :class:`~..worker.ServingWorker`: pulls
generate requests, admits them into the :class:`~.engine.DecodeEngine`
slot table at step boundaries (continuous batching -- a request joins
the running batch, it never waits for a batch window), and streams
each slot's tokens back as chunked replies the moment they exist.

Reply protocol (all chunks are ordinary wire blobs on the reply/output
stream, so every queue backend and the fleet's consumer-group data
plane carry them unchanged):

- data chunk:      ``{__stream__: seq, token: [k] int32}``
- terminal chunk:  data chunk + ``finish_reason`` ("stop" | "length")
  and ``n_tokens``
- error terminal:  ``{__stream__: -1, __error__: "<prefix>: detail"}``
  -- ``generation_overflow`` for admission refusal (the frontend maps
  it to 503 + Retry-After), ``deadline_exceeded`` when a stream's
  budget ran out mid-decode (the structured mid-stream terminal chunk
  the /generate contract promises).

``seq`` increments per chunk from 0 and is the client's exactly-once
dedup key: greedy decode is deterministic, so a supervisor-restarted
stream (ledger re-queue) regenerates the same tokens and consumers
drop ``seq <= last_seen``. Error terminals ride ``seq = -1`` so a
post-restart failure is never mistaken for a stale duplicate.

Lifecycle seams match ServingWorker exactly -- per-run stop/drain
events, supervision heartbeat, ledger record/settle, consumer-group
ack-on-reply, ``pull``/``decode``/``dispatch``/``finalize``/``push``
chaos points -- so the Supervisor, the drain path, the fleet and the
chaos harness drive both workers through one contract.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.inference.kv_cache import CacheOverflow
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.flight import get_inflight
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.obs.tracing import get_tracer
from analytics_zoo_tpu_torch.serving.chaos import chaos_point
from analytics_zoo_tpu_torch.serving.generation.batcher import (
    ContinuousBatcher)
from analytics_zoo_tpu_torch.serving.protocol import (
    DEADLINE_PREFIX, ERROR_KEY, GENERATION_PREFIX, INVALID_PREFIX,
    STREAM_KEY, priority_index, priority_name)
from analytics_zoo_tpu_torch.serving.queues import (
    _decode_generation, _decode_handoff, _discard_handoff, _encode,
    _encode_handoff)
from analytics_zoo_tpu_torch.serving.timer import Timer

logger = get_logger(__name__)

# exactly-once-reply obligation (zoolint lifecycle engine): every
# path through these stage methods must reach a reply, error-reply,
# requeue, or ownership hand-off -- the static twin of the ledger
ZOOLINT_REPLY_OBLIGATED = (
    "GenerationWorker._admit_blob",
    "GenerationWorker._finish_stream",
    "GenerationWorker._abort_stream",
    "GenerationWorker._handoff_slot",
    "GenerationWorker._import_blob",
)

_REG = get_registry()
_M_REQS = _REG.counter(
    "zoo_generation_requests_total",
    "Generation streams answered (a terminal chunk was pushed: "
    "completions and error terminals)")
_M_TOKENS = _REG.counter(
    "zoo_generation_tokens_total",
    "Tokens generated across all streams (the numerator of the "
    "deployment's tokens/sec)")
_M_ERRORS = _REG.counter(
    "zoo_generation_errors_total",
    "Error terminal chunks pushed (admission refusals, mid-stream "
    "deadlines, internal failures)")
_M_OVERFLOW = _REG.counter(
    "zoo_generation_overflow_total",
    "Generate requests refused at admission because the paged KV "
    "cache had no free slot/pages (503 + Retry-After at the frontend)")
_M_LATENCY = _REG.histogram(
    "zoo_generation_latency_seconds",
    "Generation latency stages: ttft = admission to first token, "
    "inter_token = gap between consecutive tokens of one stream "
    "(the SLO autoscaler's zoo.serving.slo.ttft_ms / inter_token_ms "
    "inputs)",
    labelnames=("stage",))
_M_HANDOFF = _REG.counter(
    "zoo_generation_handoff_total",
    "Prefill->decode stream handoffs by stage: export (prefill "
    "published a stream), import (decode restored one from its KV "
    "snapshot), regen (decode re-prefilled deterministically because "
    "the snapshot was dropped), moved (a draining decode replica "
    "re-published a live stream), refused (import hit cache "
    "exhaustion -> generation_overflow)",
    labelnames=("stage",))


class _GenStream:
    """Host-side state of one live stream (one engine slot)."""

    __slots__ = ("uri", "reply", "trace", "deadline", "eos",
                 "max_tokens", "priority", "produced", "pending",
                 "seq", "admitted_at", "last_token_at", "prompt")

    def __init__(self, uri, reply, trace, deadline, eos, max_tokens,
                 priority=None, prompt=None):
        self.uri = uri
        self.reply = reply
        self.trace = trace
        self.deadline = deadline
        self.eos = eos
        self.max_tokens = max_tokens
        self.priority = priority
        self.produced = 0      # tokens generated so far
        self.pending: List[int] = []  # generated, not yet chunked
        self.seq = 0           # next chunk sequence number
        self.admitted_at = time.monotonic()
        self.last_token_at: Optional[float] = None
        # original prompt tokens -- a decode-role worker keeps them so
        # a drain-time re-handoff stays regenerable downstream even
        # when the KV snapshot must be dropped
        self.prompt = prompt


class GenerationWorker:
    """Continuous-batching generation server over the serving queues.

    Args:
      engine: a warmed :class:`~.engine.DecodeEngine`.
      input_queue / output_queue: the serving queues (request blobs
        carry ``tokens`` + the generation wire keys; chunks go to the
        reply-to stream when the request names one, else the default
        output queue -- the ServingWorker routing contract).
      max_tokens / eos: per-deployment defaults when a request omits
        ``__max_tokens__``/``__eos__`` (None reads
        ``zoo.generation.max_tokens``; eos default -1 = none).
      stream_chunk_tokens: tokens per data chunk (None reads
        ``zoo.generation.stream_chunk_tokens``; 1 = stream every
        token as it exists -- lowest TTFT-to-client, most chunks).
      role: disaggregated pool role. "unified" (default)
        admits AND decodes, the historical behavior. "prefill" admits
        + prefills, then exports the slot's KV pages and publishes the
        stream to ``handoff_queue`` (the broker's handoff stream) --
        it never decodes. "decode" consumes handoff blobs from
        ``input_queue``, imports the snapshot (or deterministically
        re-prefills when it was dropped) and streams tokens; on drain
        it re-publishes live streams to ``handoff_queue`` so a
        survivor continues them.
      handoff_queue: producer to the handoff stream (required for
        "prefill", used for drain re-handoff by "decode").
    """

    def __init__(self, engine, input_queue, output_queue,
                 max_tokens: Optional[int] = None,
                 eos: Optional[int] = None,
                 stream_chunk_tokens: Optional[int] = None,
                 role: str = "unified",
                 handoff_queue=None):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"unknown generation role {role!r}: expected "
                "unified | prefill | decode")
        cfg = get_config()
        self.engine = engine
        self.role = role
        self._in = getattr(input_queue, "queue", input_queue)
        self._out_q = output_queue
        self._handoff_out = (getattr(handoff_queue, "queue",
                                     handoff_queue)
                             if handoff_queue is not None else None)
        if role == "prefill" and self._handoff_out is None:
            raise ValueError("prefill role needs a handoff_queue")
        self.handoff_max_bytes = int(cfg.get(
            "zoo.serving.fleet.handoff_max_bytes", 8388608))
        self.batcher = ContinuousBatcher(self._in)
        self.default_max_tokens = int(
            cfg.get("zoo.generation.max_tokens", 64)
            if max_tokens is None else max_tokens)
        self.default_eos = -1 if eos is None else int(eos)
        self.stream_chunk_tokens = max(1, int(
            cfg.get("zoo.generation.stream_chunk_tokens", 1)
            if stream_chunk_tokens is None else stream_chunk_tokens))
        self.step_idle_s = float(
            cfg.get("zoo.generation.step_idle_ms", 5.0)) / 1000.0
        self._streams: Dict[int, _GenStream] = {}
        self._reply_queues: Dict[str, Any] = {}
        self.served = 0
        # SLO surfaces: TTFT and inter-token samples feed
        # the fleet's SLO-driven autoscaler via metrics()["latency"]
        self._lat = Timer(keep_samples=4096, mirror=_M_LATENCY)
        self._default_priority = priority_index(
            cfg.get("zoo.serving.priority.default_class",
                    "interactive")) or 0
        self._class_served: Dict[str, int] = {}
        self._handoff_counts: Dict[str, int] = {}
        # supervision / fleet seams (the ServingWorker contract): the
        # Supervisor reads heartbeat/_thread/_stop/_drain and clears
        # _inflight on restart; consumer-group backends expose
        # ack_uris; a Supervisor attaches the ledger
        self.ledger = None
        self._acker = getattr(self._in, "ack_uris", None)
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight: collections.deque = collections.deque()
        self.heartbeat = time.monotonic()
        self.heartbeat_decode: Optional[float] = None

    # ----------------------------------------------------------- run --
    def run(self, max_steps: Optional[int] = None,
            wait_timeout: Optional[float] = None) -> int:
        """Serve until stopped (or ``max_steps`` decode steps);
        returns terminal replies pushed in this call. A draining run
        admits nothing new, finishes every live stream, then exits
        cleanly -- the seam SIGTERM and rolling restarts share.
        ``wait_timeout`` is the idle poll patience; None reads
        ``zoo.generation.step_idle_ms`` (bounded runs/tests pass their
        own)."""
        stop_ev = self._stop  # per-run capture: a supervisor restart
        drain_ev = self._drain  # hands the next run fresh events
        idle_wait = (self.step_idle_s if wait_timeout is None
                     else wait_timeout)
        total = 0
        steps = 0
        while not stop_ev.is_set():
            self.heartbeat = time.monotonic()
            draining = drain_ev.is_set()
            if (draining and self.role == "decode" and self._streams
                    and self._handoff_out is not None):
                # drain moves in-flight decode streams:
                # re-publish each live stream's KV snapshot + replay
                # state so a surviving decode replica continues it;
                # streams the publish could not move finish here
                total += self._rehandoff_streams()
            if not draining:
                free = self.engine.free_slots()
                if free > 0:
                    idle = not self._streams
                    blobs = self.batcher.poll(
                        free, wait_timeout=idle_wait, idle=idle)
                    for blob in blobs:
                        total += (self._import_blob(blob)
                                  if self.role == "decode"
                                  else self._admit_blob(blob))
            if not self._streams:
                if draining:
                    break
                if max_steps is not None and steps >= max_steps:
                    break
                continue  # the idle poll above already waited
            chaos_point("dispatch")
            try:
                results = self.engine.step()
            except Exception as e:
                # a step failure strands every live stream: give each
                # one structured terminal error instead of a silent
                # stall (the engine's slot state stays consistent --
                # step() commits nothing on raise)
                logger.exception("generation step failed: %s", e)
                for slot in list(self._streams):
                    total += self._abort_stream(
                        slot, f"generation step failed: {e}")
                continue
            steps += 1
            total += self._finalize_results(results)
            if max_steps is not None and steps >= max_steps:
                break
        return total

    def serve_forever(self) -> None:
        try:
            self.run()
        except BaseException as e:
            emit_event("worker_crash", "generation",
                       error=repr(e)[:500], served=self.served)
            raise

    # ----------------------------------------------------- admission --
    def _admit_blob(self, blob: bytes) -> int:
        """Decode + admit one request at a step boundary; returns the
        terminal replies pushed (0 for a live admission, 1 when the
        request was refused/expired/finished instantly)."""
        chaos_point("decode")
        try:
            (uri, tensors, reply, trace, deadline, max_toks,
             eos, priority) = _decode_generation(blob)
        except Exception as e:
            logger.exception(
                "generation: undecodable request dropped: %s", e)
            # intentional drop: an undecodable blob has no uri/reply
            # channel to answer on -- logging IS the accounting here
            return 0  # zoolint: disable=reply-missing-on-path
        if self.ledger is not None:
            self.ledger.record(uri, blob)
        if deadline is not None and time.time() > deadline:
            self._push_error(
                uri, reply,
                f"{DEADLINE_PREFIX}: request missed its deadline "
                "before admission")
            return 1
        if max_toks is None:
            max_toks = self.default_max_tokens
        # admission always yields at least the prefill's first token,
        # so a <1 budget (direct-queue clients; the frontend already
        # 400s it) is served as 1, not refused
        max_toks = max(1, int(max_toks))
        if eos is None:
            eos = self.default_eos
        prompt = tensors.get("tokens")
        if prompt is None and len(tensors) == 1:
            prompt = next(iter(tensors.values()))
        if prompt is None:
            self._push_error(
                uri, reply,
                f"{INVALID_PREFIX}: generate request needs a "
                "'tokens' tensor (int prompt)")
            return 1
        t0 = time.perf_counter()
        try:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            slot, tok0 = self.engine.admit(prompt, max_toks)
        except ValueError as e:
            # malformed CLIENT content past the frontend's shape
            # checks (out-of-vocab ids, empty prompt): a structured
            # 400, a warning (no traceback -- an unauthenticated
            # client must not be able to flood exception logs or make
            # bad input read as server faults)
            logger.warning("generation: invalid request %s: %s",
                           uri, e)
            self._push_error(uri, reply, f"{INVALID_PREFIX}: {e}")
            return 1
        except CacheOverflow as e:
            _M_OVERFLOW.inc()
            stats = self.engine.cache.stats()
            emit_event("generation_overflow", "generation", uri=uri,
                       need_pages=self.engine.cache.pages_for(
                           int(np.asarray(prompt).size) + max_toks),
                       free_pages=stats["num_pages"]
                       - stats["pages_assigned"],
                       free_slots=stats["slots_free"])
            self._push_error(uri, reply, f"{GENERATION_PREFIX}: {e}")
            return 1
        except Exception as e:
            logger.exception("generation admit failed for %s: %s",
                             uri, e)
            self._push_error(uri, reply, str(e))
            return 1
        if self.role == "prefill":
            # prefill pool: this worker's part of the
            # stream ends at the handoff publish -- no stream-table
            # entry, no decode steps
            return self._handoff_slot(
                slot, uri, prompt, tok0, reply, trace, deadline,
                eos, max_toks, priority)
        try:
            if trace:
                get_tracer().add_span("gen_prefill", trace, t0,
                                      time.perf_counter())
            get_inflight().add((uri,))
            stream = _GenStream(
                uri, reply, trace, deadline, eos, max_toks,
                priority=(self._default_priority
                          if priority is None else priority),
                prompt=prompt)
            self._streams[slot] = stream
            cls = priority_name(stream.priority)
            self._class_served[cls] = (
                self._class_served.get(cls, 0) + 1)
        except BaseException:
            # nothing owns the slot until the stream table does: a
            # raise in this window (tracer, crash manifest, stream
            # allocation) would leak the KV reservation until restart
            # -- the admit-path capacity leak leak-on-path guards
            self.engine.release(slot)
            raise
        emit_event("generation_admit", "generation", uri=uri,
                   slot=slot, prompt_len=int(np.asarray(prompt).size),
                   bucket=next(b for b in self.engine.ladder
                               if b >= np.asarray(prompt).size))
        return self._accept_token(slot, stream, tok0)

    # ------------------------------------------------------- handoff --
    def _handoff_slot(self, slot: int, uri: str, prompt: np.ndarray,
                      tok0: int, reply, trace, deadline, eos,
                      max_toks: int, priority) -> int:
        """Prefill role: export the freshly prefilled slot and publish
        the stream to the decode pool; the slot frees here either way
        (on a failed publish the client gets a retryable structured
        refusal -- the stream has no owner to decode it)."""
        snap = None
        try:
            snap = self.engine.export_slot(slot)
            state = {"next_token": int(tok0),
                     "position": int(snap["position"]),
                     "produced": 0, "seq": 0, "emitted": 0}
            blob = _encode_handoff(
                uri, prompt, state, snap, reply_to=reply,
                trace_id=trace, deadline=deadline,
                max_tokens=max_toks, eos=eos, priority=priority,
                max_bytes=self.handoff_max_bytes)
        except Exception as e:
            logger.exception("handoff export failed for %s: %s",
                             uri, e)
            _discard_handoff(snap)
            self.engine.release(slot)
            self._push_error(uri, reply, str(e))
            return 1
        self.engine.release(slot)
        ok = self._handoff_out.put(blob)
        if not ok:
            self._push_error(
                uri, reply,
                f"{GENERATION_PREFIX}: handoff stream full")
            return 1
        self._count_handoff("export")
        # "ttft" on a prefill replica = admission to handoff publish
        # (prefill + export + publish): the prefill pool's
        # SLO-attainment signal -- the client-visible first token
        # lands after the decode side imports
        emit_event("kv_handoff", "generation", uri=uri, slot=slot,
                   prompt_len=int(prompt.size),
                   inline_kv=int(snap["kv"].nbytes
                                 <= self.handoff_max_bytes
                                 or not self.handoff_max_bytes))
        self._settle(uri)
        self.served += 1
        return 1

    def _import_blob(self, blob: bytes) -> int:
        """Decode role: restore one handed-off stream at a step
        boundary -- import its KV snapshot, or deterministically
        re-prefill from the prompt when the snapshot was dropped (or
        belonged to a dead pool geometry). Returns terminal replies
        pushed, exactly like :meth:`_admit_blob`."""
        chaos_point("decode")
        try:
            (uri, handoff, reply, trace, deadline, max_toks,
             eos, priority) = _decode_handoff(blob)
        except Exception as e:
            logger.exception(
                "generation: undecodable handoff dropped: %s", e)
            # intentional drop: no uri/reply channel to answer on
            return 0  # zoolint: disable=reply-missing-on-path
        if self.ledger is not None:
            self.ledger.record(uri, blob)
        if deadline is not None and time.time() > deadline:
            self._push_error(
                uri, reply,
                f"{DEADLINE_PREFIX}: stream missed its deadline "
                f"after {int(handoff['produced'])} tokens")
            return 1
        if max_toks is None:
            max_toks = self.default_max_tokens
        max_toks = max(1, int(max_toks))
        if eos is None:
            eos = self.default_eos
        prompt = handoff["prompt"]
        tok0 = int(handoff["next_token"])
        snap = handoff["snapshot"]
        if snap is not None:
            try:
                slot = self.engine.import_slot(snap)
            except CacheOverflow as e:
                self._count_handoff("refused")
                _M_OVERFLOW.inc()
                self._push_error(uri, reply,
                                 f"{GENERATION_PREFIX}: {e}")
                return 1
            except ValueError as e:
                # snapshot geometry does not match this pool (mixed
                # engine configs): fall through to deterministic
                # regeneration rather than stranding the stream
                logger.warning(
                    "handoff snapshot for %s unusable (%s); "
                    "re-prefilling", uri, e)
            else:
                try:
                    get_inflight().add((uri,))
                    stream = _GenStream(
                        uri, reply, trace, deadline, eos, max_toks,
                        priority=(self._default_priority
                                  if priority is None else priority),
                        prompt=prompt)
                    # continue mid-stream: chunk seqs resume where
                    # the previous owner stopped, so the client sees
                    # one gapless sequence
                    stream.produced = int(handoff["produced"])
                    stream.seq = int(handoff["seq"])
                    self._streams[slot] = stream
                    cls = priority_name(stream.priority)
                    self._class_served[cls] = (
                        self._class_served.get(cls, 0) + 1)
                except BaseException:
                    self.engine.release(slot)
                    raise
                self._count_handoff("import")
                emit_event("kv_import", "generation", uri=uri,
                           slot=slot, regenerated=0,
                           produced=stream.produced)
                if not int(handoff["emitted"]):
                    # the next-input token has not reached the client
                    # yet (fresh prefill handoff): emit it now
                    return self._accept_token(slot, stream, tok0)
                return 0
        # deterministic regeneration: the snapshot was size-dropped at
        # publish or unusable here -- re-prefill from the prompt and
        # replay from scratch (produced=0, seq=0): greedy decode
        # re-emits identical chunks and consumers drop
        # seq <= last_seen -- the exactly-once contract's
        # determinism leg
        try:
            slot, tok0 = self.engine.admit(prompt, max_toks)
        except ValueError as e:
            logger.warning("generation: invalid handoff %s: %s",
                           uri, e)
            self._push_error(uri, reply, f"{INVALID_PREFIX}: {e}")
            return 1
        except CacheOverflow as e:
            self._count_handoff("refused")
            _M_OVERFLOW.inc()
            self._push_error(uri, reply,
                             f"{GENERATION_PREFIX}: {e}")
            return 1
        except Exception as e:
            logger.exception(
                "handoff re-prefill failed for %s: %s", uri, e)
            self._push_error(uri, reply, str(e))
            return 1
        try:
            get_inflight().add((uri,))
            stream = _GenStream(
                uri, reply, trace, deadline, eos, max_toks,
                priority=(self._default_priority
                          if priority is None else priority),
                prompt=prompt)
            self._streams[slot] = stream
            cls = priority_name(stream.priority)
            self._class_served[cls] = (
                self._class_served.get(cls, 0) + 1)
        except BaseException:
            self.engine.release(slot)
            raise
        self._count_handoff("regen")
        emit_event("kv_import", "generation", uri=uri, slot=slot,
                   regenerated=1, produced=0)
        return self._accept_token(slot, stream, tok0)

    def _rehandoff_streams(self) -> int:
        """Decode-role drain: flush pending chunks, then re-publish
        every live stream (KV snapshot + replay state) to the handoff
        stream for a surviving decode replica. Streams whose publish
        failed stay live and finish here inside the drain budget.
        Returns the number of streams moved."""
        moved = 0
        for slot in list(self._streams):
            stream = self._streams.get(slot)
            if stream is None:
                continue
            if stream.pending:
                self._push_chunk(stream)
            snap = None
            try:
                snap = self.engine.export_slot(slot)
                state = {"next_token": int(snap["next_token"]),
                         "position": int(snap["position"]),
                         "produced": stream.produced,
                         "seq": stream.seq,
                         "emitted": 1}
                blob = _encode_handoff(
                    stream.uri,
                    stream.prompt if stream.prompt is not None
                    else np.zeros(0, np.int32),
                    state, snap, reply_to=stream.reply,
                    trace_id=stream.trace, deadline=stream.deadline,
                    max_tokens=stream.max_tokens, eos=stream.eos,
                    priority=stream.priority,
                    max_bytes=self.handoff_max_bytes)
            except Exception as e:
                logger.warning(
                    "drain re-handoff export for %s failed (%s); "
                    "finishing locally", stream.uri, e)
                _discard_handoff(snap)
                continue
            if not self._handoff_out.put(blob):
                logger.warning(
                    "handoff stream full: stream %s finishes locally",
                    stream.uri)
                continue
            self._count_handoff("moved")
            emit_event("kv_handoff", "generation", uri=stream.uri,
                       slot=slot, prompt_len=int(
                           stream.prompt.size
                           if stream.prompt is not None else 0),
                       moved=1)
            self._streams.pop(slot, None)
            self.engine.release(slot)
            self._settle(stream.uri)
            moved += 1
        return moved

    # ------------------------------------------------------ stepping --
    def _finalize_results(self, results) -> int:
        """Route one decode step's tokens into their streams: deadline
        checks, chunk flushes, terminal pushes. Returns terminal
        replies pushed."""
        chaos_point("finalize")
        n = 0
        for slot, tok in results:
            stream = self._streams.get(slot)
            if stream is None:
                continue  # lane freed earlier this same step batch
            if (stream.deadline is not None
                    and time.time() > stream.deadline):
                n += self._abort_stream(
                    slot,
                    f"{DEADLINE_PREFIX}: stream missed its deadline "
                    f"after {stream.produced} tokens")
                continue
            n += self._accept_token(slot, stream, tok)
        return n

    def _accept_token(self, slot: int, stream: _GenStream,
                      tok: int) -> int:
        """Append one generated token; flush/terminate as policy
        dictates. Returns 1 when this token finished the stream."""
        now = time.monotonic()
        if stream.produced == 0:
            self._lat.record("ttft", now - stream.admitted_at)
        elif stream.last_token_at is not None:
            self._lat.record("inter_token", now - stream.last_token_at)
        stream.last_token_at = now
        stream.pending.append(int(tok))
        stream.produced += 1
        _M_TOKENS.inc()
        if stream.eos >= 0 and int(tok) == stream.eos:
            return self._finish_stream(slot, stream, "stop")
        if stream.produced >= stream.max_tokens:
            return self._finish_stream(slot, stream, "length")
        if len(stream.pending) >= self.stream_chunk_tokens:
            self._push_chunk(stream)
        return 0

    # -------------------------------------------------------- pushes --
    def _push_chunk(self, stream: _GenStream, final: bool = False,
                    reason: Optional[str] = None) -> None:
        payload: Dict[str, np.ndarray] = {
            STREAM_KEY: np.asarray(stream.seq, np.int32)}
        if stream.pending:
            payload["token"] = np.asarray(stream.pending, np.int32)
        if final:
            payload["finish_reason"] = np.asarray(reason)
            payload["n_tokens"] = np.asarray(stream.produced, np.int32)
        stream.seq += 1
        stream.pending = []
        if chaos_point("push"):
            return  # injected drop-chunk
        backend = self._reply_backend(stream.reply)
        if not backend.put(_encode(stream.uri, payload)):
            logger.warning("output queue full: dropping chunk for %s",
                           stream.uri)

    def _finish_stream(self, slot: int, stream: _GenStream,
                       reason: str) -> int:
        """Terminal chunk + slot release + settlement: the stream
        leaves the running batch at this step boundary."""
        self._push_chunk(stream, final=True, reason=reason)
        self._settle(stream.uri)
        emit_event("generation_complete", "generation", uri=stream.uri,
                   slot=slot, tokens=stream.produced, reason=reason)
        if stream.trace:
            get_tracer().add_span(
                "gen_stream", stream.trace, stream.admitted_at,
                time.monotonic(), tokens=stream.produced)
        self.engine.release(slot)
        self._streams.pop(slot, None)
        self.served += 1
        _M_REQS.inc()
        return 1

    def _abort_stream(self, slot: int, message: str) -> int:
        """Mid-stream failure: structured error terminal, then the
        slot frees exactly like a completion."""
        stream = self._streams.pop(slot, None)
        if stream is None:
            # no stream owns the slot: nothing was admitted, so there
            # is no request to answer (abort raced a finished stream)
            return 0  # zoolint: disable=reply-missing-on-path
        self._push_error(stream.uri, stream.reply, message)
        self.engine.release(slot)
        self.served += 1
        return 1

    def _push_error(self, uri: str, reply: Optional[str],
                    message: str) -> None:
        """Error terminal chunk (``seq = -1``: never deduped away).
        Also the Supervisor's ``_reply_error`` seam -- give-up and
        double-crash replies arrive through here."""
        _M_ERRORS.inc()
        _M_REQS.inc()
        if message.startswith(DEADLINE_PREFIX):
            emit_event("deadline_exceeded", "generation", uri=uri,
                       error=message[:500])
        elif not message.startswith((GENERATION_PREFIX,
                                     INVALID_PREFIX)):
            # overflow refusals already emitted generation_overflow
            # with capacity fields, and invalid_request is client
            # noise an unauthenticated caller could use to churn the
            # event ring; everything else is rare by construction ->
            # one structured event per error
            emit_event("serving_error", "generation", uri=uri,
                       error=message[:500])
        self._settle(uri)
        payload = {STREAM_KEY: np.asarray(-1, np.int32),
                   ERROR_KEY: np.asarray(message)}
        if chaos_point("push"):
            return
        backend = self._reply_backend(reply)
        if not backend.put(_encode(uri, payload)):
            logger.warning("output queue full: dropping error for %s",
                           uri)

    def _settle(self, uri: str) -> None:
        """One settlement point: ledger + crash-manifest + stream-claim
        ack -- the request is answered, nothing may re-serve it."""
        get_inflight().discard((uri,))
        if self.ledger is not None:
            self.ledger.settle((uri,))
        if self._acker is not None:
            try:
                self._acker((uri,))
            except Exception as e:
                logger.warning("input ack for %s failed: %s", uri, e)

    def _count_handoff(self, stage: str) -> None:
        _M_HANDOFF.labels(stage=stage).inc()
        self._handoff_counts[stage] = (
            self._handoff_counts.get(stage, 0) + 1)

    def _reply_backend(self, reply_to: Optional[str]):
        default = getattr(self._out_q, "queue", self._out_q)
        if not reply_to:
            return default
        maker = getattr(default, "for_stream", None)
        if maker is None:
            return default
        if reply_to not in self._reply_queues:
            self._reply_queues[reply_to] = maker(reply_to)
        return self._reply_queues[reply_to]

    # ----------------------------------------------------- lifecycle --
    def start(self) -> "GenerationWorker":
        # fresh per-run events (the ServingWorker restart contract);
        # slots a dead run left occupied are released here -- their
        # requests are ledger-outstanding and re-arrive via the
        # supervisor's re-queue, regenerating deterministically
        self._reset_streams()
        self._stop = threading.Event()
        self._drain = threading.Event()
        self.heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="generation-worker")
        self._thread.start()
        emit_event("worker_start", "generation",
                   slots=self.engine.num_slots,
                   max_tokens=self.default_max_tokens)
        return self

    def _reset_streams(self) -> None:
        for slot in list(self._streams):
            self._streams.pop(slot, None)
            self.engine.release(slot)

    def stop(self, join_timeout: float = 5.0) -> None:
        emit_event("worker_stop", "generation", served=self.served)
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(join_timeout)
            if thread.is_alive():
                logger.warning(
                    "generation worker still busy after %.1fs",
                    join_timeout)
                return
            self._thread = None

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Stop admitting, finish every live stream, within the
        budget (default ``zoo.serving.drain.deadline_ms``). True =
        fully drained in time."""
        if deadline_s is None:
            deadline_s = float(get_config().get(
                "zoo.serving.drain.deadline_ms", 10000.0)) / 1000.0
        pause = getattr(self._in, "pause", None)
        if pause is not None:
            pause()  # brokered consumer: stop CLAIMING, not just
            # stop pulling claimed entries
        self._drain.set()
        thread = self._thread
        if thread is None:
            return True
        thread.join(max(0.0, deadline_s))
        if thread.is_alive():
            return False
        self._thread = None
        return True

    # ------------------------------------------------------- metrics --
    def metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "served": self.served,
            "role": self.role,
            "streams_active": len(self._streams),
            "engine": self.engine.stats(),
            "batcher": self.batcher.stats(),
            "defaults": {"max_tokens": self.default_max_tokens,
                         "eos": self.default_eos,
                         "chunk_tokens": self.stream_chunk_tokens},
            # latency.ttft / latency.inter_token summaries (p99_s
            # etc.) -- the fleet's SLO sampler scrapes these
            "latency": self._lat.summary(),
            "class_served": dict(self._class_served),
            # per-stage handoff counts (mirrors the labeled
            # zoo_generation_handoff_total counter, readable per
            # worker without scraping the registry)
            "handoffs": dict(self._handoff_counts),
        }
        try:
            out["queue_depth"] = len(self._in)
        except (TypeError, OSError):
            pass
        if self.ledger is not None:
            out["ledger_outstanding"] = len(self.ledger)
        return out
