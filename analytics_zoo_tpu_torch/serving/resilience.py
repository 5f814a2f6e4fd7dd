"""Serving resilience: supervised workers, request ledger, breaker.

The reference platform's Cluster Serving inherited its recovery story
from the execution engines underneath it -- Spark's driver re-schedules
a failed task, Flink restarts an operator from its checkpoint
(PAPER.md, arXiv:1804.05839). This stack owns its threads, so the
recovery machinery has to live here:

- :class:`Supervisor` -- owns a :class:`~.worker.ServingWorker`'s
  lifecycle: detects *death* (the serving thread exited while its stop
  event was never set) and *wedge* (heartbeat stale beyond
  ``zoo.serving.supervisor.heartbeat_timeout_s`` while the thread is
  still alive), then restarts the engine with capped exponential
  backoff + seeded jitter. Requests the dead run had pulled but not
  answered are re-queued from the :class:`RequestLedger` **exactly
  once** per request id; a request whose re-run also dies gets one
  structured error reply instead of a third run -- so every admitted
  request produces exactly one reply (result or error), never zero,
  and duplicates are confined to the wedge case (an abandoned thread
  that wakes mid-push cannot be un-scheduled; crash recovery is
  exactly-once because a dead thread pushes nothing).
- :class:`RequestLedger` -- uri -> wire-blob for every request decoded
  but not yet answered. The worker records at decode and settles on
  reply (both are one dict op per request); the supervisor drains it
  on restart. Bounded: beyond ``max_entries`` the oldest entries are
  dropped from requeue coverage (never from serving).
- :class:`CircuitBreaker` -- around backend dispatch: ``threshold``
  consecutive predict failures open it (dispatches fast-fail with a
  structured error instead of burning a device slot), after
  ``cooldown_s`` one half-open probe is allowed through; the probe's
  finalize-time success closes the breaker, its failure re-opens it.
  State transitions emit ``circuit_open`` / ``circuit_half_open`` /
  ``circuit_closed`` events and keep the per-state metrics current.

Everything here is opt-in at the worker level (a bare ``ServingWorker``
has ``ledger is None`` / ``breaker is None`` and pays nothing); the
launcher wires the Supervisor by default
(``zoo.serving.supervisor.enabled``).
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.metrics import get_registry

logger = get_logger(__name__)

_REG = get_registry()
_M_RESTARTS = _REG.counter(
    "zoo_serving_worker_restarts_total",
    "Supervisor restarts of the serving worker, by reason",
    labelnames=("reason",))
_M_REQUEUED = _REG.counter(
    "zoo_serving_requeued_total",
    "In-flight requests re-queued by the supervisor after a restart")
_M_BREAKER_STATE = _REG.gauge(
    "zoo_serving_breaker_state_info",
    "Circuit-breaker state (0 = closed, 1 = half-open, 2 = open)")
_M_BREAKER_TRANSITIONS = _REG.counter(
    "zoo_serving_breaker_transitions_total",
    "Circuit-breaker state transitions, by state entered",
    labelnames=("state",))
_M_BREAKER_REJECTED = _REG.counter(
    "zoo_serving_breaker_rejected_total",
    "Requests fast-failed while the circuit breaker was open")


class RequestLedger:
    """uri -> wire blob for decoded-but-unanswered requests.

    ``record`` overwrites (a re-queued request decodes again),
    ``settle`` is idempotent, and :meth:`take_for_requeue` implements
    the exactly-once policy: the first drain returns an entry for
    re-queueing and remembers it; a second drain (the re-run died too)
    returns it as *dead* -- the caller answers it with a structured
    error and it leaves the ledger for good.

    The record/settle pairing is the runtime half of the exactly-once
    contract; zoolint's lifecycle engine is the static half -- worker
    stage methods declared in ``ZOOLINT_REPLY_OBLIGATED`` are proven
    to reach exactly one of {reply, error-reply, requeue, handoff} on
    every CFG path (``reply-missing-on-path`` /
    ``reply-duplicated-on-path``, docs/zoolint.md)."""

    def __init__(self, max_entries: int = 4096):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, bytes]" = (
            collections.OrderedDict())
        self._requeued: set = set()
        self._max = int(max_entries)
        self.dropped = 0  # aged out of requeue coverage (bound)

    def record(self, uri: str, blob: bytes) -> None:
        with self._lock:
            self._entries[uri] = blob
            self._entries.move_to_end(uri)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
                self.dropped += 1

    def settle(self, uris) -> None:
        with self._lock:
            for uri in uris:
                self._entries.pop(uri, None)
                self._requeued.discard(uri)

    def take_for_requeue(self
                         ) -> Tuple[List[Tuple[str, bytes]],
                                    List[Tuple[str, bytes]]]:
        """(fresh, dead): fresh entries are marked requeued and stay
        in the ledger (they will re-decode and settle on answer); dead
        entries (already requeued once) are removed -- the caller owes
        each one an error reply."""
        with self._lock:
            fresh = [(u, b) for u, b in self._entries.items()
                     if u not in self._requeued]
            dead = [(u, b) for u, b in self._entries.items()
                    if u in self._requeued]
            for u, _ in fresh:
                self._requeued.add(u)
            for u, _ in dead:
                self._entries.pop(u, None)
                self._requeued.discard(u)
        return fresh, dead

    def outstanding(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class CircuitBreaker:
    """Consecutive-failure breaker around backend dispatch.

    The worker calls :meth:`allow` before dispatching a batch,
    :meth:`record_failure` on a predict dispatch/fetch exception and
    :meth:`record_success` on a successful finalize. ``clock`` is
    injectable for deterministic tests."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None, clock=None):
        cfg = get_config()
        self.threshold = int(cfg.get("zoo.serving.breaker.threshold", 5)
                             if threshold is None else threshold)
        self.cooldown_s = float(
            cfg.get("zoo.serving.breaker.cooldown_s", 5.0)
            if cooldown_s is None else cooldown_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        _M_BREAKER_STATE.set(0)

    # ------------------------------------------------------ transitions --
    def _enter(self, state: str) -> None:
        # under self._lock (callers hold it)
        self._state = state
        _M_BREAKER_STATE.set(self._STATE_GAUGE[state])
        _M_BREAKER_TRANSITIONS.labels(state=state).inc()

    def allow(self) -> bool:
        """May a batch dispatch right now? Open -> False (fast-fail);
        open past cooldown -> one half-open probe slips through."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if (self._clock() - self._opened_at
                        < self.cooldown_s):
                    return False
                self._enter(self.HALF_OPEN)
                self._probe_inflight = True
                self._probe_started = self._clock()
                emit_event("circuit_half_open", "serving")
                return True
            # HALF_OPEN: one probe at a time -- but a probe that never
            # reported back (its thread crashed, or it failed outside
            # the predict path, where record_* is never called) must
            # not wedge the breaker half-open forever: after another
            # cooldown the probe slot re-arms
            if (self._probe_inflight
                    and self._clock() - self._probe_started
                    < self.cooldown_s):
                return False
            self._probe_inflight = True
            self._probe_started = self._clock()
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != self.CLOSED:
                self._enter(self.CLOSED)
                emit_event("circuit_closed", "serving")
                logger.info("circuit breaker closed (probe succeeded)")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probe_inflight = False
            tripped = (self._state == self.HALF_OPEN
                       or (self._state == self.CLOSED
                           and self._failures >= self.threshold))
            if tripped and self._state != self.OPEN:
                self._enter(self.OPEN)
                self._opened_at = self._clock()
                emit_event("circuit_open", "serving",
                           failures=self._failures)
                logger.warning(
                    "circuit breaker OPEN after %d consecutive "
                    "backend failures; dispatch suspended for %.1fs",
                    self._failures, self.cooldown_s)

    def rejected(self, n: int = 1) -> None:
        """Account ``n`` requests fast-failed while open."""
        _M_BREAKER_REJECTED.inc(n)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s}


class Supervisor:
    """Watches one ServingWorker and restarts it on death or wedge.

    Death: the serving thread exited but its stop event was never set
    (an uncaught exception killed it -- ``worker_crash`` in the event
    log). Wedge: the thread is alive but ``worker.heartbeat`` has not
    moved for ``heartbeat_timeout_s`` (a stage stuck in a syscall, a
    backend hang). Either way: emit ``worker_restart``, re-queue the
    ledger's outstanding requests (exactly once each; twice-crashed
    requests get one error reply), back off with capped exponential +
    seeded jitter, and start a fresh engine run. The worker's stop
    event is per-run, so an abandoned wedged thread that later wakes
    finds *its* event set and exits instead of double-serving.

    Restart supervision only ever touches the worker between runs; a
    healthy worker pays one attribute read per poll interval."""

    def __init__(self, worker, poll_interval_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 seed: int = 0, requeue: bool = True):
        cfg = get_config()
        self.worker = worker
        self.poll_interval_s = float(
            cfg.get("zoo.serving.supervisor.poll_interval_s", 0.5)
            if poll_interval_s is None else poll_interval_s)
        self.heartbeat_timeout_s = float(
            cfg.get("zoo.serving.supervisor.heartbeat_timeout_s", 30.0)
            if heartbeat_timeout_s is None else heartbeat_timeout_s)
        self.backoff_base_s = float(
            cfg.get("zoo.serving.supervisor.backoff_base_s", 0.1)
            if backoff_base_s is None else backoff_base_s)
        self.backoff_max_s = float(
            cfg.get("zoo.serving.supervisor.backoff_max_s", 30.0)
            if backoff_max_s is None else backoff_max_s)
        self.max_restarts = int(
            cfg.get("zoo.serving.supervisor.max_restarts", 0)
            if max_restarts is None else max_restarts)
        self.ledger: Optional[RequestLedger] = None
        if requeue:
            self.ledger = RequestLedger()
            worker.ledger = self.ledger
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0

    # -------------------------------------------------------- lifecycle --
    def start(self) -> "Supervisor":
        self._stop.clear()
        self._thread = threading.Thread(target=self._monitor,
                                        daemon=True,
                                        name="serving-supervisor")
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(join_timeout)
            self._thread = None
        if self.ledger is not None and self.worker.ledger is self.ledger:
            self.worker.ledger = None

    # ---------------------------------------------------------- monitor --
    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                reason = self._diagnose()
            except Exception as e:  # a probe bug must not kill the
                logger.exception(   # supervisor itself
                    "supervisor probe failed: %s", e)
                continue
            if reason is None:
                continue
            try:
                self._restart(reason)
            except Exception as e:
                logger.exception("supervisor restart failed: %s", e)

    def _diagnose(self) -> Optional[str]:
        """"crashed" / "wedged" / None (healthy, stopped, or never
        started)."""
        worker = self.worker
        thread = getattr(worker, "_thread", None)
        if thread is None:
            return None  # not running (or operator stopped it)
        if worker._stop.is_set():
            return None  # orderly shutdown in progress
        drain = getattr(worker, "_drain", None)
        if drain is not None and drain.is_set():
            # graceful drain (ISSUE-9): the run exiting with its stop
            # event unset is the POINT, not a crash to restart
            return None
        if not thread.is_alive():
            return "crashed"
        now = time.monotonic()
        hb = getattr(worker, "heartbeat", None)
        if (hb is not None
                and now - hb > self.heartbeat_timeout_s):
            return "wedged"
        # the decode stage heartbeats separately (None = no decode
        # thread running): a pull stuck in a hung broker recv starves
        # the engine without ever staling the driver's heartbeat
        hb_decode = getattr(worker, "heartbeat_decode", None)
        if (hb_decode is not None
                and now - hb_decode > self.heartbeat_timeout_s):
            return "wedged"
        return None

    # ---------------------------------------------------------- restart --
    def _restart(self, reason: str) -> None:
        if self.max_restarts and self.restarts >= self.max_restarts:
            emit_event("supervisor_giveup", "serving",
                       restarts=self.restarts)
            logger.error("supervisor giving up after %d restarts; "
                         "worker stays down", self.restarts)
            # the final run's in-flight requests still get their one
            # structured error reply -- giving up on the WORKER must
            # not strand its CLIENTS waiting on timeouts
            self._flush_ledger_with_errors(
                "request failed: serving worker gave up after "
                f"{self.restarts} restarts")
            self._stop.set()
            return
        self.restarts += 1
        backoff = min(self.backoff_max_s,
                      self.backoff_base_s * (2 ** (self.restarts - 1)))
        backoff *= 0.5 + self._rng.random() * 0.5  # jitter: no
        # thundering herd when N hosts restart off the same outage
        _M_RESTARTS.labels(reason=reason).inc()
        # reap the old run: for a crash the thread is already dead and
        # stop() just joins + flushes; for a wedge it times out and we
        # abandon the thread -- its per-run stop event is now set, so
        # if it ever wakes it exits instead of double-serving
        self.worker.stop(join_timeout=1.0)
        self.worker._thread = None
        self.worker._inflight.clear()  # stale sync-engine records
        requeued = self._requeue()
        emit_event("worker_restart", "serving", reason=reason,
                   restarts=self.restarts,
                   backoff_s=round(backoff, 4), requeued=requeued)
        logger.warning("supervisor restarting %s serving worker "
                       "(restart #%d, backoff %.3fs, %d requests "
                       "re-queued)", reason, self.restarts, backoff,
                       requeued)
        if self._stop.wait(backoff):
            return  # supervisor stopped during backoff
        self.worker.start()

    def _requeue(self) -> int:
        """Drain the ledger: fresh entries go back on the input queue
        (once per request id), twice-crashed entries get one error
        reply. Returns the requeued count."""
        if self.ledger is None:
            return 0
        fresh, dead = self.ledger.take_for_requeue()
        # consumer-group input (the fleet data plane): the BROKER
        # still owns the dead run's claims -- they re-deliver via
        # XAUTOCLAIM after the idle threshold. A local re-put here
        # would add a second copy of each entry and race the reclaim
        # into duplicate replies, so ownership stays with the broker;
        # the ledger still marks them (a second crash during the
        # re-serve takes the one-error-reply exit as before).
        broker_owned = getattr(self.worker, "_acker", None) is not None
        requeued = 0
        for uri, blob in fresh:
            if broker_owned:
                continue
            try:
                ok = self.worker._in.put(blob)
            except Exception as e:
                logger.warning("requeue of %s failed: %s", uri, e)
                ok = False
            if ok:
                requeued += 1
            else:
                self._reply_error(uri, blob,
                                  "request lost: re-queue failed "
                                  "during worker restart")
        for uri, blob in dead:
            self._reply_error(uri, blob,
                              "request failed: worker died twice "
                              "while serving it")
        if requeued:
            _M_REQUEUED.inc(requeued)
        return requeued

    def _flush_ledger_with_errors(self, message: str) -> None:
        """Answer every outstanding ledger entry with one structured
        error (the give-up path: no further run will serve them)."""
        if self.ledger is None:
            return
        fresh, dead = self.ledger.take_for_requeue()
        for uri, blob in fresh + dead:
            self._reply_error(uri, blob, message)
        self.ledger.settle([u for u, _ in fresh])

    def _reply_error(self, uri: str, blob: bytes, message: str) -> None:
        from analytics_zoo_tpu_torch.serving.queues import _decode_request

        try:
            reply = _decode_request(blob)[2]
        except Exception:
            reply = None  # undecodable blob: default result stream
        try:
            self.worker._push_error(uri, reply, message)
        except Exception as e:
            logger.warning("error reply for %s failed: %s", uri, e)

    def stats(self) -> Dict[str, Any]:
        return {"restarts": self.restarts,
                "outstanding": (len(self.ledger)
                                if self.ledger is not None else 0),
                "max_restarts": self.max_restarts}
