"""Serving queues: the Redis-Streams role, dependency-free.

The client API mirrors the reference's ``InputQueue``/``OutputQueue``
(ref: pyzoo/zoo/serving/client.py:52-250 -- enqueue XADDs base64-encoded
tensors; dequeue reads the result stream). Backends:

- ``MemQueue``: in-process deque (single-process serving, tests);
- ``DirQueue``: a spool directory; each item is one ``.npz`` file,
  consumers claim atomically with ``os.rename`` -- cross-process safe
  with no broker, and items survive crashes (the durability Redis
  provided in the reference).
"""

from __future__ import annotations

import collections
import io
import os
import struct
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.obs import tracing as _tracing
from analytics_zoo_tpu_torch.obs.metrics import get_registry as _get_registry
from analytics_zoo_tpu_torch.serving.admission import AdmissionController
from analytics_zoo_tpu_torch.serving.protocol import (
    DEADLINE_KEY, EOS_KEY, HANDOFF_KEY, MAX_TOKENS_KEY, PRIORITY_KEY,
    REPLY_KEY, TENANT_KEY, TRACE_KEY, URI_KEY, WIRE_KEYS,
    priority_index)

# client-side data-plane counters (the queues' entry in the unified
# registry): offered load, backpressure rejections, drained results.
# The shed family (zoo_serving_shed_total) moved to admission.py when
# it grew the per-class label (ISSUE-15).
_REG = _get_registry()
_M_ENQ = _REG.counter(
    "zoo_serving_enqueue_total",
    "Requests offered to the serving input queue")
_M_ENQ_REJECTED = _REG.counter(
    "zoo_serving_enqueue_rejected_total",
    "Requests rejected by input-queue backpressure (queue full)")
_M_DEQ = _REG.counter(
    "zoo_serving_dequeue_total",
    "Results drained from the serving output queue")

# Wire format. v1 was np.savez (one zip archive per request): simple,
# but the zip machinery costs ~260 us per request round-trip -- it was
# the single largest host cost of the serving cycle (measured on the
# ISSUE-1 pipeline bench; see BENCH_NOTES.md). v2 ("AZT1") frames raw
# ndarray buffers with a dtype/shape header: ~15 us round-trip, no
# pickle surface, and decode still accepts v1 blobs (zip magic) so
# spooled items from older deployments keep draining.
_MAGIC = b"AZT1"
_ZIP_MAGIC = b"PK"  # np.savez container (legacy v1 blobs)


def _encode(uri: str, payload: Dict[str, np.ndarray],
            reply_to: Optional[str] = None,
            trace_id: Optional[str] = None,
            deadline: Optional[float] = None,
            max_tokens: Optional[int] = None,
            eos: Optional[int] = None,
            tenant: Optional[int] = None,
            priority: Optional[int] = None) -> bytes:
    items = [(URI_KEY, np.asarray(uri))]
    if reply_to:
        # reply-to stream for brokered deployments: the worker that
        # serves the request routes the result back to the REQUESTER'S
        # result stream (several frontends can share one broker)
        items.append((REPLY_KEY, np.asarray(reply_to)))
    if trace_id:
        # end-to-end tracing (obs.tracing): the id rides the blob so
        # worker stages can span against it; absent when tracing is off
        items.append((TRACE_KEY, np.asarray(trace_id)))
    if max_tokens is not None:
        # generation budget (ISSUE-10): the worker stops the stream
        # after this many new tokens (absent on predict requests)
        items.append((MAX_TOKENS_KEY,
                      np.asarray(int(max_tokens), np.int32)))
    if eos is not None:
        # generation stop token id (-1 = none)
        items.append((EOS_KEY, np.asarray(int(eos), np.int32)))
    if tenant is not None:
        # parameter-lane id (ISSUE-13): which member of a population-
        # backed model's stacked tree answers this request
        items.append((TENANT_KEY, np.asarray(int(tenant), np.int32)))
    if priority is not None:
        # admission class index (ISSUE-15): rides the blob so a
        # requeued/restarted request keeps its brownout class exactly
        # like __tenant__ keeps its lane; absent -> the
        # zoo.serving.priority.default_class at the decoder
        items.append((PRIORITY_KEY,
                      np.asarray(int(priority), np.int32)))
    if deadline is not None:
        # absolute epoch-seconds deadline (zoo.serving.deadline_ms,
        # stamped at enqueue): the worker rejects expired requests at
        # decode/dispatch/finalize with a structured deadline_exceeded
        # error. Wall-clock, not monotonic -- the blob may cross
        # processes/hosts, and skew only shifts the budget by clock
        # error, which deadline granularity (>= tens of ms) tolerates
        items.append((DEADLINE_KEY, np.asarray(float(deadline))))
    for k, v in payload.items():
        a = np.asarray(v)
        if not a.flags["C_CONTIGUOUS"]:
            # NOT np.ascontiguousarray: that promotes 0-d to (1,),
            # silently changing scalar tensors' round-tripped shape
            # (0-d arrays are already contiguous and skip this)
            a = np.ascontiguousarray(a)
        items.append((k, a))
    parts = [_MAGIC, struct.pack("<I", len(items))]
    for name, a in items:
        if a.dtype.hasobject:
            raise ValueError(
                f"tensor {name!r} has object dtype; only plain "
                "numeric/string arrays go on the serving wire")
        nb = name.encode("utf-8")
        db = a.dtype.str.encode("ascii")
        body = a.tobytes()
        parts.append(struct.pack("<HBB", len(nb), len(db), a.ndim))
        parts.append(nb)
        parts.append(db)
        parts.append(struct.pack("<%dq" % a.ndim, *a.shape))
        parts.append(struct.pack("<Q", len(body)))
        parts.append(body)
    return b"".join(parts)


_META_KEYS = WIRE_KEYS  # historical alias for the codec below


def _decode(blob: bytes) -> Tuple[str, Dict[str, np.ndarray]]:
    uri, tensors, _ = _decode_full(blob)
    return uri, tensors


def _decode_raw(blob: bytes) -> Dict[str, np.ndarray]:
    (count,) = struct.unpack_from("<I", blob, 4)
    off = 8
    out: Dict[str, np.ndarray] = {}
    for _ in range(count):
        nlen, dlen, ndim = struct.unpack_from("<HBB", blob, off)
        off += 4
        name = blob[off:off + nlen].decode("utf-8")
        off += nlen
        dtype = np.dtype(blob[off:off + dlen].decode("ascii"))
        off += dlen
        shape = struct.unpack_from("<%dq" % ndim, blob, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", blob, off)
        off += 8
        n = 1
        for s in shape:
            n *= s
        # .copy(): frombuffer views are read-only; requests keep the
        # writable-array contract the npz decoder gave user hooks
        out[name] = np.frombuffer(
            blob, dtype=dtype, count=n,
            offset=off).reshape(shape).copy()
        off += nbytes
    return out


def _decode_full(blob: bytes
                 ) -> Tuple[str, Dict[str, np.ndarray], Optional[str]]:
    uri, tensors, reply, _ = _decode_traced(blob)
    return uri, tensors, reply


def _decode_traced(blob: bytes) -> Tuple[str, Dict[str, np.ndarray],
                                         Optional[str], Optional[str]]:
    """Full decode incl. the trace id meta key (``_decode_full`` keeps
    the historical 3-tuple; the worker uses ``_decode_request``)."""
    uri, tensors, reply, trace, _ = _decode_request(blob)
    return uri, tensors, reply, trace


def _decode_to_dict(blob: bytes) -> Dict[str, np.ndarray]:
    """Framing dispatch, THE one place the blob container format is
    recognized: AZT1 raw-buffer framing, or the legacy np.savez (zip)
    container -- both -> {name: array}. Every decoder (predict,
    generation) goes through here, so a future framing change has one
    home."""
    if blob[:4] == _MAGIC:
        return _decode_raw(blob)
    if not blob.startswith(_ZIP_MAGIC):
        raise ValueError("not a serving wire blob (neither AZT1 nor "
                         "legacy npz framing)")
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:  # legacy v1
        return {k: z[k] for k in z.files}


def _request_meta(z: Dict[str, np.ndarray]
                  ) -> Tuple[str, Optional[str], Optional[str],
                             Optional[float]]:
    """(uri, reply_to, trace_id, deadline) out of a decoded blob dict
    -- the meta keys every request carries regardless of data plane."""
    uri = str(z[URI_KEY].reshape(())) if URI_KEY in z else ""
    reply = str(z[REPLY_KEY].reshape(())) if REPLY_KEY in z else None
    trace = str(z[TRACE_KEY].reshape(())) if TRACE_KEY in z else None
    deadline = (float(z[DEADLINE_KEY].reshape(()))
                if DEADLINE_KEY in z else None)
    return uri, reply, trace, deadline


def _decode_request(blob: bytes
                    ) -> Tuple[str, Dict[str, np.ndarray],
                               Optional[str], Optional[str],
                               Optional[float]]:
    """The worker's decode: (uri, tensors, reply_to, trace_id,
    deadline) with every meta key stripped from the tensor dict."""
    z = _decode_to_dict(blob)
    uri, reply, trace, deadline = _request_meta(z)
    return uri, {k: v for k, v in z.items()
                 if k not in _META_KEYS}, reply, trace, deadline


def _decode_predict(blob: bytes
                    ) -> Tuple[str, Dict[str, np.ndarray],
                               Optional[str], Optional[str],
                               Optional[float], Optional[int],
                               Optional[int]]:
    """The predict worker's decode: ``_decode_request``'s 5-tuple plus
    the ``__tenant__`` parameter-lane id and the ``__priority__``
    admission class (None when the request names neither). A separate
    function -- NOT a new arity for ``_decode_request`` -- because
    that 5-tuple is unpacked outside this module (resilience requeue,
    redis adapter, tests)."""
    z = _decode_to_dict(blob)
    uri, reply, trace, deadline = _request_meta(z)
    tenant = (int(z[TENANT_KEY].reshape(()))
              if TENANT_KEY in z else None)
    priority = (int(z[PRIORITY_KEY].reshape(()))
                if PRIORITY_KEY in z else None)
    tensors = {k: v for k, v in z.items() if k not in _META_KEYS}
    return uri, tensors, reply, trace, deadline, tenant, priority


def _decode_generation(blob: bytes
                       ) -> Tuple[str, Dict[str, np.ndarray],
                                  Optional[str], Optional[str],
                                  Optional[float], Optional[int],
                                  Optional[int], Optional[int]]:
    """The generation worker's decode: ``_decode_request``'s 5-tuple
    plus ``(max_tokens, eos, priority)`` (None when the request
    omitted them -- the worker falls back to the ``zoo.generation.*``
    / ``zoo.serving.priority.*`` defaults)."""
    z = _decode_to_dict(blob)
    uri, reply, trace, deadline = _request_meta(z)
    max_tokens = (int(z[MAX_TOKENS_KEY].reshape(()))
                  if MAX_TOKENS_KEY in z else None)
    eos = int(z[EOS_KEY].reshape(())) if EOS_KEY in z else None
    priority = (int(z[PRIORITY_KEY].reshape(()))
                if PRIORITY_KEY in z else None)
    tensors = {k: v for k, v in z.items() if k not in _META_KEYS}
    return (uri, tensors, reply, trace, deadline, max_tokens, eos,
            priority)


# ------------------------------------------------- stream handoff --
# ISSUE-20 (disaggregated prefill/decode pools): a prefill replica
# publishes one handoff blob per admitted stream on the broker's
# handoff stream; a decode replica imports it and continues the
# stream. The blob carries the full replay state -- the prompt (for
# deterministic regeneration when the KV snapshot was dropped or died
# with its host), the page-aligned KV snapshot when it fits
# ``max_bytes``, and the slot registers + chunk-seq counters that keep
# re-served chunks dedupable at the client.

def _encode_handoff(uri: str, prompt: np.ndarray,
                    state: Dict[str, int],
                    snapshot: Optional[Dict[str, Any]] = None,
                    reply_to: Optional[str] = None,
                    trace_id: Optional[str] = None,
                    deadline: Optional[float] = None,
                    max_tokens: Optional[int] = None,
                    eos: Optional[int] = None,
                    priority: Optional[int] = None,
                    max_bytes: int = 0) -> bytes:
    """Encode a prefill->decode stream handoff. ``state`` carries the
    slot registers: ``next_token`` (the token the next decode step
    consumes), ``position`` (its write position), ``produced`` (output
    tokens already delivered), ``seq`` (next chunk sequence number)
    and ``emitted`` (whether ``next_token`` already reached the
    client). A snapshot larger than ``max_bytes`` (> 0) is dropped --
    the importer then re-prefills deterministically from the prompt."""
    payload: Dict[str, np.ndarray] = {
        HANDOFF_KEY: np.asarray(1, np.int32),
        "prompt": np.asarray(prompt, np.int32).reshape(-1),
    }
    for key in ("next_token", "position", "produced", "seq",
                "emitted"):
        payload[key] = np.asarray(int(state[key]), np.int32)
    if snapshot is not None:
        kv = np.asarray(snapshot["kv"])
        if not (max_bytes and kv.nbytes > max_bytes):
            payload["kv"] = kv
            payload["kv_length"] = np.asarray(
                int(snapshot["length"]), np.int32)
            payload["kv_reserve"] = np.asarray(
                int(snapshot["reserve"]), np.int32)
    return _encode(uri, payload, reply_to=reply_to, trace_id=trace_id,
                   deadline=deadline, max_tokens=max_tokens, eos=eos,
                   priority=priority)


def _decode_handoff(blob: bytes
                    ) -> Tuple[str, Dict[str, Any], Optional[str],
                               Optional[str], Optional[float],
                               Optional[int], Optional[int],
                               Optional[int]]:
    """The decode replica's decode: ``(uri, handoff, reply, trace,
    deadline, max_tokens, eos, priority)`` where ``handoff`` holds the
    prompt, the slot-register state, and ``snapshot`` (an
    ``import_pages``-shaped dict, or None when the KV pages were
    dropped at publish time). Raises ValueError on a blob that is not
    a handoff (no ``__handoff__`` marker) -- a client request on the
    handoff stream is a routing bug, not a soft error."""
    z = _decode_to_dict(blob)
    if HANDOFF_KEY not in z:
        raise ValueError("not a handoff blob (no __handoff__ marker)")
    uri, reply, trace, deadline = _request_meta(z)
    max_tokens = (int(z[MAX_TOKENS_KEY].reshape(()))
                  if MAX_TOKENS_KEY in z else None)
    eos = int(z[EOS_KEY].reshape(())) if EOS_KEY in z else None
    priority = (int(z[PRIORITY_KEY].reshape(()))
                if PRIORITY_KEY in z else None)
    handoff: Dict[str, Any] = {
        "prompt": np.asarray(z["prompt"], np.int32).reshape(-1),
        "snapshot": None,
    }
    for key in ("next_token", "position", "produced", "seq",
                "emitted"):
        handoff[key] = int(z[key].reshape(()))
    if "kv" in z:
        handoff["snapshot"] = {
            "kv": z["kv"],
            "length": int(z["kv_length"].reshape(())),
            "reserve": int(z["kv_reserve"].reshape(())),
            "next_token": handoff["next_token"],
            "position": handoff["position"],
            "rng": None,
        }
    return (uri, handoff, reply, trace, deadline, max_tokens, eos,
            priority)


def _discard_handoff(snapshot: Optional[Dict[str, Any]]) -> None:
    """Abandon an exported KV snapshot that will never reach the wire
    (encode failed before publish). The pages themselves still live in
    the engine slot the exporter holds, so dropping the copy frees
    nothing -- this exists (and is registered as the kv-handoff
    release verb in zoolint's lifecycle registry) so an abandonment is
    a visible decision on the failure path, not a silent leak."""
    return None


class MemQueue:
    def __init__(self, maxlen: Optional[int] = None):
        self._q: collections.deque = collections.deque()
        self._maxlen = maxlen
        self._cv = threading.Condition()

    def put(self, item: bytes) -> bool:
        with self._cv:
            if self._maxlen is not None and len(self._q) >= self._maxlen:
                return False  # backpressure signal
            self._q.append(item)
            self._cv.notify()
            return True

    def get(self, timeout: Optional[float] = None) -> Optional[bytes]:
        with self._cv:
            if timeout is None:  # shared contract: None = block forever
                while not self._q:
                    self._cv.wait()
            elif not self._q:
                self._cv.wait(timeout)
            if not self._q:
                return None
            return self._q.popleft()

    def get_many(self, n: int) -> List[bytes]:
        """Drain up to ``n`` items without blocking -- one lock
        acquisition instead of ``n`` condvar round-trips (the batcher's
        deep-backlog fast path)."""
        with self._cv:
            k = min(n, len(self._q))
            return [self._q.popleft() for _ in range(k)]

    def put_many(self, items: List[bytes]) -> int:
        """Append up to capacity in one lock trip; returns how many
        were accepted (the finalize stage pushes whole batches --
        per-item lock/notify costs add up at adaptive batch sizes)."""
        with self._cv:
            if self._maxlen is None:
                self._q.extend(items)
                accepted = len(items)
            else:
                room = max(0, self._maxlen - len(self._q))
                accepted = min(room, len(items))
                self._q.extend(items[:accepted])
            if accepted:
                self._cv.notify(accepted)
            return accepted

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)


class DirQueue:
    """Spool-directory queue; items ordered by (timestamp, uuid) name."""

    def __init__(self, path: str, maxlen: Optional[int] = None):
        self.path = path
        self._maxlen = maxlen
        os.makedirs(path, exist_ok=True)

    def put(self, item: bytes) -> bool:
        if self._maxlen is not None and len(self) >= self._maxlen:
            return False
        name = f"{time.time_ns():020d}-{uuid.uuid4().hex}"
        tmp = os.path.join(self.path, f".{name}.tmp")
        with open(tmp, "wb") as f:
            f.write(item)
        os.replace(tmp, os.path.join(self.path, name + ".item"))
        return True

    def get(self, timeout: Optional[float] = None) -> Optional[bytes]:
        deadline = (None if timeout is None  # None = block forever
                    else time.time() + timeout)
        while True:
            for name in sorted(os.listdir(self.path)):
                if not name.endswith(".item"):
                    continue
                src = os.path.join(self.path, name)
                claimed = os.path.join(self.path, name + ".claimed")
                try:
                    os.rename(src, claimed)  # atomic claim
                except OSError:
                    continue  # another consumer won
                with open(claimed, "rb") as f:
                    data = f.read()
                os.unlink(claimed)
                return data
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.005)

    def get_many(self, n: int) -> List[bytes]:
        """Claim up to ``n`` items in one directory scan (non-blocking;
        losing a claim race to another consumer just skips that item)."""
        out: List[bytes] = []
        for name in sorted(os.listdir(self.path)):
            if len(out) >= n:
                break
            if not name.endswith(".item"):
                continue
            src = os.path.join(self.path, name)
            claimed = src + ".claimed"
            try:
                os.rename(src, claimed)
            except OSError:
                continue
            with open(claimed, "rb") as f:
                out.append(f.read())
            os.unlink(claimed)
        return out

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.path)
                   if n.endswith(".item"))


class TcpQueueServer:
    """A tiny stream broker: named MemQueues served over TCP.

    The cross-host data plane the reference delegated to Redis Streams
    (ref: serving/engine/FlinkRedisSource.scala XREADGROUP consumer
    groups): one broker process per serving deployment, any number of
    producer/consumer hosts. Framed request/response per connection:

      request  = op:1 (P/G/L) | name_len:2 | name | arg:4 | payload
      response = status:1 (K/E/N) | payload_len:4 | payload

    P(ut): arg = payload length, K/E(full) back. G(et): arg = timeout
    in ms, K+payload or N(othing). L(en): K + 4-byte count.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 maxlen: Optional[int] = 10000):
        import socket

        self._maxlen = maxlen
        self._queues: Dict[str, MemQueue] = {}
        self._qlock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._sock.getsockname()[:2]
        return f"tcp://{host}:{port}"

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _queue(self, name: str) -> MemQueue:
        with self._qlock:
            if name not in self._queues:
                self._queues[name] = MemQueue(self._maxlen)
            return self._queues[name]

    def start(self) -> "TcpQueueServer":
        self._stop.clear()
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self._sock.close()

    def _accept_loop(self):
        import socket

        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        import struct as _struct

        try:
            conn.settimeout(None)
            while not self._stop.is_set():
                head = _recv_exact(conn, 7)
                if head is None:
                    return
                op = chr(head[0])
                (nlen,) = _struct.unpack(">H", head[1:3])
                (arg,) = _struct.unpack(">I", head[3:7])
                name = _recv_exact(conn, nlen)
                if name is None:
                    return
                q = self._queue(name.decode())
                if op == "P":
                    payload = _recv_exact(conn, arg)
                    if payload is None:
                        return
                    ok = q.put(payload)
                    conn.sendall((b"K" if ok else b"E")
                                 + _struct.pack(">I", 0))
                elif op == "G":
                    blob = q.get(timeout=arg / 1000.0)
                    if blob is None:
                        conn.sendall(b"N" + _struct.pack(">I", 0))
                    else:
                        conn.sendall(b"K" + _struct.pack(">I", len(blob))
                                     + blob)
                elif op == "L":
                    n = _struct.pack(">I", len(q))
                    conn.sendall(b"K" + _struct.pack(">I", 4) + n)
                else:
                    return
        except OSError:
            pass
        finally:
            conn.close()


def _recv_exact(conn, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TcpQueue:
    """Client backend for :class:`TcpQueueServer`; address
    ``tcp://host:port`` plus a stream name. Reconnects per failure,
    thread-safe via one lock (a connection carries one in-flight
    request at a time)."""

    def __init__(self, address: str, name: str = "serving_stream"):
        if address.startswith("tcp://"):
            address = address[len("tcp://"):]
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._name = name.encode()
        # separate channels: a blocking G wait (up to _GET_SLICE_S)
        # must not hold up P/L callers sharing this object
        self._chan = {"main": [None, threading.Lock()],
                      "get": [None, threading.Lock()]}

    # server-side wait per G request; long client timeouts poll in
    # slices so the socket deadline always exceeds the blocking wait
    # and an abandoned request can't strand an item on a dead socket
    _GET_SLICE_S = 2.0

    def _request(self, op: bytes, arg: int, payload: bytes = b"",
                 retry: bool = True, wait_s: float = 0.0,
                 channel: str = "main"):
        import socket
        import struct as _struct

        chan = self._chan[channel]
        with chan[1]:
            for attempt in (0, 1):
                try:
                    if chan[0] is None:
                        chan[0] = socket.create_connection(
                            (self._host, self._port), timeout=30.0)
                    conn = chan[0]
                    # recv deadline must cover the server-side wait
                    conn.settimeout(30.0 + wait_s)
                    conn.sendall(op + _struct.pack(">H", len(self._name))
                                 + _struct.pack(">I", arg)
                                 + self._name + payload)
                    head = _recv_exact(conn, 5)
                    if head is None:
                        raise OSError("connection closed")
                    status = chr(head[0])
                    (plen,) = _struct.unpack(">I", head[1:5])
                    body = _recv_exact(conn, plen) if plen else b""
                    if plen and body is None:
                        raise OSError("connection closed mid-body")
                    return status, body
                except OSError:
                    chan[0] = None
                    if attempt or not retry:
                        raise
        raise OSError("unreachable")

    def put(self, item: bytes) -> bool:
        status, _ = self._request(b"P", len(item), item)
        return status == "K"

    def get(self, timeout: Optional[float] = None) -> Optional[bytes]:
        deadline = (None if timeout is None  # None = block forever
                    else time.monotonic() + max(0.0, timeout))
        while True:
            remaining = (self._GET_SLICE_S if deadline is None
                         else deadline - time.monotonic())
            wait = min(max(remaining, 0.0), self._GET_SLICE_S)
            # no blind retry on G: a re-sent request after a half-done
            # one could pop an item onto a dead connection
            status, body = self._request(b"G", int(wait * 1000),
                                         retry=False, wait_s=wait,
                                         channel="get")
            if status == "K":
                return body
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def __len__(self) -> int:
        import struct as _struct

        status, body = self._request(b"L", 0)
        return _struct.unpack(">I", body)[0] if status == "K" else 0

    def for_stream(self, name: str) -> "TcpQueue":
        """Handle on another stream of the same broker (the worker's
        reply-to routing; brokered backends share this protocol)."""
        return TcpQueue(f"tcp://{self._host}:{self._port}", name=name)


def _make_backend(backend, path: Optional[str], maxlen: Optional[int],
                  name: str = "serving_stream",
                  group: Optional[str] = None,
                  consumer: Optional[str] = None,
                  autoack: bool = False):
    if isinstance(backend, str) and backend.startswith("redis://"):
        # fleet data plane: a consumer-group stream on the RESP2
        # broker (redis_adapter) -- N workers passing the same group
        # shard the stream, claims ride the pending list until the
        # worker acks them on reply. The RESP2 broker adapter belongs
        # to the fleet item of ROADMAP queue 1 and is not ported yet
        raise NotImplementedError(
            "redis:// queues need serving/redis_adapter.py, which the "
            "PyTorch port has not ported yet (ROADMAP queue 1: fleet)")
    if isinstance(backend, str) and backend.startswith("tcp://"):
        return TcpQueue(backend, name=name)
    if backend == "tcp":
        if not path or "://" not in str(path) and ":" not in str(path):
            raise ValueError('backend "tcp" needs path "host:port"')
        return TcpQueue(str(path), name=name)
    if backend == "memory" or (backend is None and path is None):
        return MemQueue(maxlen)
    if backend == "dir" or path is not None:
        return DirQueue(path, maxlen)
    raise ValueError(f"unknown backend {backend!r}")


class InputQueue:
    """(ref: client.py InputQueue.enqueue/predict). ``backend`` may be
    a ``tcp://host:port`` broker address (cross-host data plane);
    ``name`` is the stream on that broker (ref: serving_stream)."""

    def __init__(self, backend=None, path: Optional[str] = None,
                 maxlen: Optional[int] = 10000, queue=None,
                 name: str = "serving_stream",
                 reply_stream: Optional[str] = None,
                 shed_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 group: Optional[str] = None,
                 consumer: Optional[str] = None):
        self._q = queue if queue is not None else _make_backend(
            backend, path, maxlen, name=name, group=group,
            consumer=consumer)
        # when set, every request carries this reply-to stream so the
        # serving worker routes its result back to THIS producer's
        # result stream (brokered multi-frontend deployments)
        self.reply_stream = reply_stream
        # admission control (ISSUE-5), resolved ONCE at construction
        # so the disabled path stays one int/float compare per
        # enqueue: shed_depth refuses new work above a backlog depth
        # (softer than maxlen -- the queue still absorbs in-flight
        # producers, the frontend turns the refusal into 503 +
        # Retry-After); deadline_ms stamps each blob with an absolute
        # deadline the worker enforces at every stage
        from analytics_zoo_tpu_torch.common.config import get_config

        cfg = get_config()
        self.shed_depth = int(
            cfg.get("zoo.serving.shed.queue_depth", 0)
            if shed_depth is None else shed_depth)
        self.deadline_ms = float(
            cfg.get("zoo.serving.deadline_ms", 0.0)
            if deadline_ms is None else deadline_ms)
        # brownout ladder (ISSUE-15): the controller owns per-class
        # thresholds, shed counters/events, and the adaptive
        # Retry-After; requests without an explicit class admit as
        # zoo.serving.priority.default_class
        self._admission = AdmissionController(self.shed_depth)
        self.default_priority = priority_index(
            cfg.get("zoo.serving.priority.default_class",
                    "interactive")) or 0
        # generation admission cost: one queue slot per this many
        # budgeted tokens (long streams are charged like the long
        # occupancy they are)
        self._gen_cost_tokens = int(
            cfg.get("zoo.serving.shed.gen_cost_tokens", 16))
        self._gen_default_tokens = int(
            cfg.get("zoo.generation.max_tokens", 64))

    @property
    def queue(self):
        return self._q

    def enqueue(self, uri: str, tenant: Optional[int] = None,
                priority=None, **tensors) -> bool:
        """False means the queue refused the request -- full (hard
        backpressure; the reference surfaces Redis OOM errors here,
        client.py:176-192) or shedding (the brownout ladder refused
        this request's class at the observed depth). A trace context
        open on this thread (obs.tracing) rides the blob as
        ``__trace__`` -- one thread-local read when tracing is off.
        ``tenant`` selects a parameter lane of a population-backed
        model (ISSUE-13; rides the blob as ``__tenant__``);
        ``priority`` is a class name or index (ISSUE-15; rides the
        blob as ``__priority__``, absent when the caller names none).
        """
        pri = priority_index(priority)
        if self.shed_depth and self._shed(
                self.default_priority if pri is None else pri):
            return False
        deadline = (time.time() + self.deadline_ms / 1000.0
                    if self.deadline_ms else None)
        ok = self._q.put(_encode(uri, tensors,
                                 reply_to=self.reply_stream,
                                 trace_id=_tracing.current_trace_id(),
                                 deadline=deadline, tenant=tenant,
                                 priority=pri))
        _M_ENQ.inc()
        if not ok:
            _M_ENQ_REJECTED.inc()
        return ok

    def _shed(self, priority: int, cost: int = 1) -> bool:
        """Shed-or-admit; the depth probe costs one len() per enqueue
        (a broker RPC on TcpQueue backends), which is why shedding is
        opt-in via ``zoo.serving.shed.queue_depth``."""
        try:
            depth = len(self._q)
        except (TypeError, OSError):
            return False  # depth-less backend: cannot shed on depth
        if self._admission.admit(depth, priority, cost=cost):
            return False
        _M_ENQ.inc()  # a shed request still counts as offered load
        return True

    def retry_after_s(self) -> float:
        """The adaptive Retry-After the frontend should advertise on
        shed 503s (floor = zoo.serving.shed.retry_after_s, scaled by
        current shed pressure up to retry_after_max_s)."""
        return self._admission.retry_after_s()

    @property
    def admission(self) -> AdmissionController:
        return self._admission

    def enqueue_generation(self, uri: str, tokens,
                           max_tokens: Optional[int] = None,
                           eos: Optional[int] = None,
                           priority=None) -> bool:
        """Enqueue a *generate* request (ISSUE-10): ``tokens`` is the
        1-D int prompt; ``max_tokens``/``eos`` ride the blob as
        reserved wire keys next to the deadline. Same admission
        control / shedding / False-means-refused contract as
        :meth:`enqueue`, except the admission COST is max_tokens-
        weighted (ceil(budget / zoo.serving.shed.gen_cost_tokens)) so
        one long stream cannot starve interactive traffic."""
        pri = priority_index(priority)
        budget = (self._gen_default_tokens if max_tokens is None
                  else max(1, int(max_tokens)))
        cost = max(1, -(-budget // max(1, self._gen_cost_tokens)))
        if self.shed_depth and self._shed(
                self.default_priority if pri is None else pri,
                cost=cost):
            return False
        deadline = (time.time() + self.deadline_ms / 1000.0
                    if self.deadline_ms else None)
        ok = self._q.put(_encode(
            uri, {"tokens": np.asarray(tokens, np.int32).reshape(-1)},
            reply_to=self.reply_stream,
            trace_id=_tracing.current_trace_id(),
            deadline=deadline, max_tokens=max_tokens, eos=eos,
            priority=pri))
        _M_ENQ.inc()
        if not ok:
            _M_ENQ_REJECTED.inc()
        return ok

    def enqueue_image(self, uri: str, data, key: str = "image") -> bool:
        """Enqueue a COMPRESSED image (JPEG/PNG file path or bytes);
        the serving worker decodes it host-side (the reference client's
        base64-image enqueue, ref: client.py enqueue_image +
        PreProcessing.decodeImage). ~10-20x less wire payload than the
        raw pixel tensor."""
        if isinstance(data, (bytes, bytearray)):
            raw = bytes(data)
        else:
            with open(data, "rb") as f:
                raw = f.read()
        return self.enqueue(uri, **{key: np.frombuffer(raw, np.uint8)})

    def __len__(self):
        return len(self._q)


class OutputQueue:
    """(ref: client.py OutputQueue.dequeue/query). ``backend`` may be a
    ``tcp://host:port`` broker address; ``name`` defaults to the result
    stream (ref: result XADD stream)."""

    def __init__(self, backend=None, path: Optional[str] = None,
                 maxlen: Optional[int] = None, queue=None,
                 name: str = "result_stream",
                 group: Optional[str] = None,
                 consumer: Optional[str] = None):
        # result consumers are each their stream's sole owner, so a
        # brokered group consumes destructively (autoack) -- the PEL's
        # exactly-once machinery is the REQUEST stream's concern
        self._q = queue if queue is not None else _make_backend(
            backend, path, maxlen, name=name, group=group,
            consumer=consumer, autoack=True)

    @property
    def queue(self):
        return self._q

    def dequeue(self, timeout: Optional[float] = None
                ) -> Optional[Tuple[str, Dict[str, np.ndarray]]]:
        """Pop one result. ``timeout=None`` blocks until an item
        arrives (uniform across memory/dir/tcp backends); ``timeout=0``
        polls; a positive timeout waits up to that many seconds and
        returns None on expiry."""
        blob = self._q.get(timeout)
        if blob is None:
            return None
        _M_DEQ.inc()
        return _decode(blob)

    def dequeue_all(self) -> List[Tuple[str, Dict[str, np.ndarray]]]:
        if hasattr(self._q, "get_many"):
            out = []
            while True:  # batched drain: one lock trip per chunk
                blobs = self._q.get_many(256)
                out.extend(_decode(b) for b in blobs)
                if len(blobs) < 256:
                    if out:
                        _M_DEQ.inc(len(out))
                    return out
        out = []
        while True:
            item = self.dequeue(timeout=0)
            if item is None:
                return out
            out.append(item)
