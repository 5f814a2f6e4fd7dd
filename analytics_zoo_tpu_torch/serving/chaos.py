"""Deterministic fault injection for the serving data plane.

The resilience layer (serving/resilience.py) is only trustworthy if it
is *exercised*: BigDL inherited fault tolerance from Spark re-running
failed tasks (arXiv:1804.05839) and could lean on that machinery's own
test surface; our TPU-native engine owns its threads, so this module is
the crash lab -- seeded injectors wired behind the exact seams the
Supervisor watches, so tier-1 tests can kill the dispatch thread
mid-batch on the Nth call and assert full recovery, every run, same
schedule.

Seams (one ``chaos_point(seam)`` call per *batch*, never per request,
so the disabled path costs one global read + ``is None`` check):

========  ====================================================
seam      where it fires
========  ====================================================
pull      top of ``AdaptiveBatcher.next_batch`` (queue stall)
decode    top of ``ServingWorker._decode_stage``
dispatch  top of ``ServingWorker._dispatch_group``
finalize  top of ``ServingWorker._finalize_record``
push      result push (returns True = drop this reply)
replica   fleet controller, once per routed/observed result
          (returns True = SIGKILL a whole replica process)
========  ====================================================

Injector kinds:

- ``crash``: raise :class:`ChaosCrash` (a ``BaseException`` -- it
  escapes the worker's per-batch ``except Exception`` guards and kills
  the stage thread, the way a real segfaulting callback or interpreter
  error would);
- ``error``: raise :class:`ChaosError` (an ``Exception`` -- exercises
  the per-request error mapping, not supervision);
- ``sleep``: block the stage for ``dur`` seconds (wedge / slow
  backend / queue stall depending on the seam);
- ``drop``: at the ``push`` seam, swallow the reply (lost-result
  path; clients observe a timeout);
- ``kill``: at the ``replica`` seam only (ISSUE-9) -- tells the fleet
  controller to SIGKILL one whole replica process mid-run, the
  process-granular fault PR 5's in-process harness could not model.

Spec grammar (``zoo.serving.chaos.spec``, entries ``;``-separated)::

    kind:seam[:key=val]*
    crash:dispatch:at=3          # the 3rd dispatch, exactly once
    sleep:decode:every=5:dur=0.2 # every 5th decode stalls 200 ms
    error:finalize:p=0.05        # 5% of finalizes, seeded RNG
    drop:push:p=0.01

Triggers: ``at=N`` fires on exactly the Nth call at that seam (once,
counters are process-lifetime so restarts don't reset the schedule);
``every=N`` fires on every Nth call; ``p=F`` fires with probability F
from the injector's seeded RNG. Gated by ``zoo.serving.chaos.enabled``
(default false) + ``zoo.serving.chaos.seed``; tests install an
injector programmatically with :func:`install`.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.metrics import get_registry

logger = get_logger(__name__)

_M_INJECTED = get_registry().counter(
    "zoo_serving_chaos_injected_total",
    "Chaos faults injected, by seam and kind",
    labelnames=("seam", "kind"))

SEAMS = ("pull", "decode", "dispatch", "finalize", "push", "replica")
KINDS = ("crash", "error", "sleep", "drop", "kill")


class ChaosError(Exception):
    """Injected *recoverable* fault: subclasses Exception so the
    worker's per-batch guards map it to per-request error replies."""


class ChaosCrash(BaseException):
    """Injected *fatal* fault: subclasses BaseException so it escapes
    every ``except Exception`` guard and kills the stage thread -- the
    seam the Supervisor exists to cover."""


class ChaosRule:
    """One parsed spec entry; see the module docstring grammar."""

    def __init__(self, kind: str, seam: str, at: Optional[int] = None,
                 every: Optional[int] = None, p: float = 0.0,
                 dur: float = 0.1):
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r} "
                             f"(one of {', '.join(KINDS)})")
        if seam not in SEAMS:
            raise ValueError(f"unknown chaos seam {seam!r} "
                             f"(one of {', '.join(SEAMS)})")
        if kind == "drop" and seam != "push":
            raise ValueError("drop rules only apply to the push seam")
        # replica-level chaos (ISSUE-9) is process-granular: only the
        # fleet controller can act on it, and in-process kinds make no
        # sense there -- the pairing is exclusive both ways
        if (kind == "kill") != (seam == "replica"):
            raise ValueError(
                "kill rules pair exclusively with the replica seam "
                "(kill:replica:at=N -- the fleet controller SIGKILLs "
                "a whole replica process)")
        self.kind = kind
        self.seam = seam
        self.at = at
        self.every = every
        self.p = float(p)
        self.dur = float(dur)

    def __repr__(self):
        return (f"ChaosRule({self.kind}:{self.seam} at={self.at} "
                f"every={self.every} p={self.p} dur={self.dur})")


def parse_spec(spec: str) -> List[ChaosRule]:
    """``"crash:dispatch:at=3;sleep:decode:p=0.1:dur=0.2"`` -> rules.
    Raises ValueError on malformed entries -- a typo'd chaos schedule
    silently injecting nothing would vacuously pass every drill."""
    rules: List[ChaosRule] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(f"chaos spec entry {entry!r} needs at "
                             "least kind:seam")
        kwargs: Dict[str, float] = {}
        for kv in parts[2:]:
            key, sep, val = kv.partition("=")
            if not sep or key not in ("at", "every", "p", "dur"):
                raise ValueError(
                    f"chaos spec entry {entry!r}: bad trigger {kv!r} "
                    "(keys: at=, every=, p=, dur=)")
            kwargs[key] = (int(val) if key in ("at", "every")
                           else float(val))
        rules.append(ChaosRule(parts[0], parts[1], **kwargs))
    return rules


class ChaosInjector:
    """Seeded rule engine behind :func:`chaos_point`.

    Counters are per-seam and process-lifetime (a supervisor restart
    must not reset the schedule -- "crash the 2nd dispatch" has to
    mean the 2nd dispatch *ever*, or a crash-loop drill would re-crash
    forever). ``fire`` is thread-safe; the RNG draw order is
    deterministic per seam because each seam is only called from its
    own stage thread."""

    def __init__(self, rules: List[ChaosRule], seed: int = 0):
        self.rules = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}

    def fire(self, seam: str) -> bool:
        """Evaluate every rule on ``seam``; returns True when a reply
        should be dropped (push seam). May raise ChaosError/ChaosCrash
        or sleep, per the matching rule."""
        drop = False
        actions = []
        with self._lock:
            n = self._calls.get(seam, 0) + 1
            self._calls[seam] = n
            for rule in self.rules:
                if rule.seam != seam:
                    continue
                hit = ((rule.at is not None and n == rule.at)
                       or (rule.every is not None
                           and n % rule.every == 0)
                       or (rule.p > 0.0
                           and self._rng.random() < rule.p))
                if hit:
                    actions.append(rule)
                    self._fired[f"{seam}:{rule.kind}"] = (
                        self._fired.get(f"{seam}:{rule.kind}", 0) + 1)
        for rule in actions:  # act OUTSIDE the lock: sleeps/raises
            _M_INJECTED.labels(seam=seam, kind=rule.kind).inc()
            emit_event("chaos_injected", "serving", seam=seam,
                       kind=rule.kind)
            logger.warning("chaos: injecting %s at %s (call %d)",
                           rule.kind, seam, n)
            if rule.kind == "sleep":
                time.sleep(rule.dur)
            elif rule.kind == "error":
                raise ChaosError(f"chaos: injected error at {seam} "
                                 f"(call {n})")
            elif rule.kind == "crash":
                raise ChaosCrash(f"chaos: injected crash at {seam} "
                                 f"(call {n})")
            elif rule.kind in ("drop", "kill"):
                # both are act-by-return-value kinds: the caller knows
                # its seam -- push drops the reply it was about to
                # send, the fleet controller SIGKILLs a replica
                drop = True
        return drop

    def counts(self) -> Dict[str, int]:
        """{"<seam>:<kind>": fired} -- what actually triggered (soak
        driver summary + test assertions)."""
        with self._lock:
            return dict(self._fired)


_injector: Optional[ChaosInjector] = None


def install(injector: ChaosInjector) -> ChaosInjector:
    """Arm the process-wide injector (tests, soak driver)."""
    global _injector
    _injector = injector
    return injector


def uninstall() -> None:
    global _injector
    _injector = None


def get_injector() -> Optional[ChaosInjector]:
    return _injector


def maybe_install_from_config() -> Optional[ChaosInjector]:
    """Arm from ``zoo.serving.chaos.*`` when enabled (the launcher
    calls this); returns the injector or None. An armed injector is
    left alone -- a test's programmatic install wins."""
    if _injector is not None:
        return _injector
    cfg = get_config()
    if not bool(cfg.get("zoo.serving.chaos.enabled", False)):
        return None
    rules = parse_spec(str(cfg.get("zoo.serving.chaos.spec", "")))
    if not rules:
        logger.warning("zoo.serving.chaos.enabled is set but the spec "
                       "is empty; nothing will be injected")
    return install(ChaosInjector(
        rules, seed=int(cfg.get("zoo.serving.chaos.seed", 0))))


def chaos_point(seam: str) -> bool:
    """The seam hook. One global read + None check when chaos is off
    (the always-on cost of being injectable); returns True when the
    caller should drop the reply it was about to push."""
    inj = _injector
    if inj is None:
        return False
    return inj.fire(seam)
