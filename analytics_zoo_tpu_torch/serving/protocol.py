"""Serving wire-protocol vocabulary: ONE declaring module.

Everything that crosses the serving wire as an out-of-band *name* --
reserved blob keys and structured error-reply prefixes -- is declared
here and imported everywhere else. A hand-typed copy elsewhere in
``serving/`` is a zoolint finding (``analysis/protocol.py``): a typo'd
key silently drops a deadline on the floor and a prefix the frontend
cannot map turns a structured rejection into a generic 500, and both
only surface under load.

Reserved wire keys (AZT1/npz blob tensor names; see
``queues._encode``):

- ``__uri__``       request id, the reply-correlation key
- ``__reply__``     reply-to stream for brokered deployments
- ``__trace__``     obs trace id riding the blob (zoo.obs.trace.*)
- ``__deadline__``  absolute epoch-seconds deadline
                    (zoo.serving.deadline_ms)
- ``__tenant__``    parameter-lane id for population-backed models
                    (ISSUE-13): selects which member of a stacked
                    parameter tree answers this request; one warmed
                    compile serves every tenant (zoo.serving.tenant.*)
- ``__priority__``  admission class index (ISSUE-15): brownout
                    shedding refuses low classes first
                    (zoo.serving.priority.*, zoo.serving.shed.*)
- ``__error__``     reply-side: the structured error message tensor

Structured error prefixes (the *class* of a failure rides the reply
message as a greppable ``<prefix>: detail`` string, so the frontend
can map it to an HTTP status without a second wire field):

- ``deadline_exceeded`` -> 504 (the client's budget ran out; not a
  server fault)
- ``circuit_open`` -> 503 (breaker fast-fail; the handler adds
  Retry-After to every 503 so clients back off)
- ``generation_overflow`` -> 503 (KV-cache admission refusal;
  transient, retryable)
- ``invalid_request`` -> 400 (malformed client content the worker,
  not the frontend, detected)
- ``overloaded`` -> 503 (priority-ordered admission refusal; the
  Retry-After adapts to shed pressure)

``ERROR_PREFIXES`` is the complete prefix -> HTTP-status contract;
zoolint's ``error-prefix-unmapped`` rule fails any declared prefix
missing from it, so a new failure class cannot ship half-wired.
"""

from __future__ import annotations

from typing import Optional

# ---------------------------------------------------------- wire keys --
URI_KEY = "__uri__"
REPLY_KEY = "__reply__"
TRACE_KEY = "__trace__"
DEADLINE_KEY = "__deadline__"
ERROR_KEY = "__error__"
# generation serving (ISSUE-10). Request side: MAX_TOKENS_KEY caps the
# new tokens a generate request may emit and EOS_KEY names its stop
# token id (-1 = none) -- both ride the request blob next to
# __deadline__. Reply side: STREAM_KEY is the monotonically increasing
# chunk sequence number of a streamed generation reply; its PRESENCE
# is what routes a blob into a stream mailbox instead of the one-shot
# result path, and its value is the client's exactly-once dedup key (a
# supervisor-restarted stream regenerates deterministically from chunk
# 0, so consumers drop seq <= last-seen and never double-count a
# token).
STREAM_KEY = "__stream__"
MAX_TOKENS_KEY = "__max_tokens__"
EOS_KEY = "__eos__"
# per-tenant parameter lanes (ISSUE-13): the lane index into a
# population-backed model's stacked parameter tree. A request carrying
# it dispatches through the SAME warmed executable as every other
# tenant -- the lane is a traced argument, not a shape -- so thousands
# of per-tenant variants serve from one compile. Absent -> the
# zoo.serving.tenant.default_lane (or a 400 invalid_request when
# zoo.serving.tenant.strict).
TENANT_KEY = "__tenant__"
# priority classes (ISSUE-15): the request's admission class rides the
# blob as a small int32 index into PRIORITY_CLASSES, so brownout
# shedding can refuse low classes first and a requeued/restarted
# request keeps its class exactly like __tenant__ keeps its lane.
# Absent -> zoo.serving.priority.default_class.
PRIORITY_KEY = "__priority__"
# disaggregated prefill/decode pools (ISSUE-20): a blob carrying
# HANDOFF_KEY is a prefill->decode stream handoff riding the broker's
# handoff stream, NOT a client request. Its value is the handoff
# format version (int32); the blob's tensors carry the prompt, the
# page-aligned KV snapshot, and the slot replay state (next token,
# position, produced count, chunk seq) so a decode replica can import
# the stream -- or deterministically regenerate it when the snapshot
# was dropped -- without breaking the chunk-seq exactly-once contract.
HANDOFF_KEY = "__handoff__"

# request-side out-of-band keys the decoder strips from tensor dicts
# (ERROR_KEY/STREAM_KEY are reply-side only: model outputs named
# "error" stay usable, and an error reply is recognised by ERROR_KEY's
# presence, a stream chunk by STREAM_KEY's)
WIRE_KEYS = (URI_KEY, REPLY_KEY, TRACE_KEY, DEADLINE_KEY,
             MAX_TOKENS_KEY, EOS_KEY, TENANT_KEY, PRIORITY_KEY,
             HANDOFF_KEY)

# ---------------------------------------------------- priority classes --
# Index 0 is the HIGHEST class: the admission ladder sheds from the
# tail of this tuple first, and the no-inversion contract is "a class
# is never refused while a strictly lower class is admitted at the
# same queue depth". Wire value = index (int32), so class ordering is
# total and comparison is integer comparison.
PRIORITY_CLASSES = ("interactive", "batch", "background")
PRIORITY_DEFAULT = PRIORITY_CLASSES[0]


def priority_index(value) -> Optional[int]:
    """Normalize a class name or index to an index into
    PRIORITY_CLASSES, or None when the value names no class."""
    if value is None:
        return None
    if isinstance(value, str):
        name = value.strip().lower()
        if name in PRIORITY_CLASSES:
            return PRIORITY_CLASSES.index(name)
        return None
    try:
        idx = int(value)
    except (TypeError, ValueError):
        return None
    if 0 <= idx < len(PRIORITY_CLASSES):
        return idx
    return None


def priority_name(index) -> str:
    """Class name for a wire index; out-of-range indexes clamp to the
    lowest class (a garbled byte must never PROMOTE a request)."""
    try:
        idx = int(index)
    except (TypeError, ValueError):
        return PRIORITY_CLASSES[-1]
    if 0 <= idx < len(PRIORITY_CLASSES):
        return PRIORITY_CLASSES[idx]
    return PRIORITY_CLASSES[-1]

# ------------------------------------------------------ error prefixes --
DEADLINE_PREFIX = "deadline_exceeded"
CIRCUIT_PREFIX = "circuit_open"
# fleet vocabulary (ISSUE-9): a draining replica refuses NEW work while
# it finishes in-flight requests (rolling restart / SIGTERM drain), and
# the front-tier router answers replica_unavailable only after its
# one-retry-on-a-dead-replica budget is spent -- both are retryable,
# so both map to 503 (every 503 carries Retry-After)
DRAINING_PREFIX = "draining"
REPLICA_PREFIX = "replica_unavailable"
# generation vocabulary (ISSUE-10): a generate request refused at
# admission because the paged KV cache has no free slot/pages left --
# transient by construction (slots free as streams finish), so 503 +
# Retry-After, never a generic 500
GENERATION_PREFIX = "generation_overflow"
# a request the worker could not honor because the CLIENT sent
# malformed content past the frontend's shape checks (out-of-vocab
# token ids, missing prompt tensor): 400, not 500 -- bad input must
# never read as a server fault on the error-rate dashboard
INVALID_PREFIX = "invalid_request"
# brownout shedding (ISSUE-15): the admission controller refused the
# request because its class's depth threshold was exceeded --
# transient by construction, so 503 with an ADAPTIVE Retry-After
# (EWMA of shed pressure, zoo.serving.shed.retry_after_s the floor)
SHED_PREFIX = "overloaded"

# prefix -> HTTP status the frontend answers with; prefixes absent
# here fall through to 500 (generic server fault), which is exactly
# what the zoolint contract rule exists to prevent for declared ones
ERROR_PREFIXES = {
    DEADLINE_PREFIX: 504,
    CIRCUIT_PREFIX: 503,
    DRAINING_PREFIX: 503,
    REPLICA_PREFIX: 503,
    GENERATION_PREFIX: 503,
    INVALID_PREFIX: 400,
    SHED_PREFIX: 503,
}


def error_status(message: str) -> Optional[int]:
    """HTTP status for a structured error reply, or None when the
    message carries no declared prefix (-> generic 500 at the
    frontend). Matches ``<prefix>`` exactly or ``<prefix>:``-led."""
    for prefix, status in ERROR_PREFIXES.items():
        if message == prefix or message.startswith(prefix + ":"):
            return status
    return None
