"""Flight recorder: crash hooks + postmortem bundles.

When a serving process dies -- uncaught exception on any thread, fatal
signal, SIGTERM from the orchestrator -- the dashboards of obs.metrics
go dark with it. This module writes the black box instead: on crash it
dumps a **postmortem bundle** (a directory) containing

- ``manifest.json``   reason, timestamp, pid, thread, exception +
                      traceback, python/platform info, uptime
- ``events.jsonl``    the last N structured events (obs.events)
- ``metrics.json``    a full metrics-registry snapshot
- ``spans.json``      active/collected trace spans (obs.tracing)
- ``inflight.json``   request ids dispatched but not yet answered
- ``config.json``     the resolved layered config

into ``zoo.obs.postmortem.dir``, turning "rerun and hope" into a
readable artifact. Installation is explicit (:func:`install`, done by
the serving launcher when ``zoo.obs.flight.enabled``); the hooks chain
to whatever was installed before them, and ``faulthandler`` covers the
failures Python never sees (segfault in a native lib, deadlock dump
via SIGABRT) by streaming C-level tracebacks into the same directory.

The in-flight request registry lives here too: the serving worker
registers every dispatched-but-unanswered uri, so a postmortem names
exactly which requests were lost -- the first question after a prod
crash.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.obs import events as _events
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.obs.tracing import get_tracer

# stdlib logger: same import-order constraint as obs.events
logger = logging.getLogger(__name__)


class InflightRequests:
    """Process-wide set of request ids dispatched but not yet answered.
    The worker adds a batch's uris at dispatch and discards them at
    finalize -- two lock trips per *batch*, not per request, so the
    hot path cost is negligible."""

    def __init__(self):
        self._ids: set = set()
        self._lock = threading.Lock()

    def add(self, ids) -> None:
        with self._lock:
            self._ids.update(ids)

    def discard(self, ids) -> None:
        with self._lock:
            self._ids.difference_update(ids)

    def snapshot(self) -> List[str]:
        with self._lock:
            return sorted(self._ids)

    def clear(self) -> None:
        with self._lock:
            self._ids.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)


_inflight = InflightRequests()


def get_inflight() -> InflightRequests:
    return _inflight


class FlightRecorder:
    """Installs crash hooks and writes postmortem bundles.

    Args:
      out_dir: bundle directory root (None reads
        ``zoo.obs.postmortem.dir``; ``~`` expands).
      max_events: events.jsonl length (None reads
        ``zoo.obs.postmortem.max_events``).
    """

    def __init__(self, out_dir: Optional[str] = None,
                 max_events: Optional[int] = None):
        cfg = get_config()
        if out_dir is None:
            out_dir = str(cfg.get(
                "zoo.obs.postmortem.dir",
                "~/.cache/analytics-zoo-tpu/postmortems"))
        self.out_dir = os.path.expanduser(out_dir)
        self.max_events = int(cfg.get("zoo.obs.postmortem.max_events",
                                      512)
                              if max_events is None else max_events)
        self._installed = False
        self._signals_installed = False
        self._prev_excepthook = None
        self._prev_thread_hook = None
        self._prev_sigterm = None
        self._fault_file = None
        self._fault_was_enabled = False
        self._started_at = time.time()
        # re-entrancy guard: a crash inside postmortem writing (disk
        # full, broken registry) must not recurse into another bundle
        self._writing = threading.Lock()

    # -------------------------------------------------------- bundles --
    def write_postmortem(self, reason: str,
                         exc: Optional[BaseException] = None,
                         thread: Optional[str] = None
                         ) -> Optional[str]:
        """Write one bundle; returns its path, or None when a write is
        already in progress (re-entrant crash) or the dump itself
        failed. Never raises: the recorder runs inside excepthooks
        where a second exception would mask the first."""
        if not self._writing.acquire(blocking=False):
            return None
        try:
            return self._write_bundle(reason, exc, thread)
        except Exception as e:  # pragma: no cover - last-resort path
            logger.error("postmortem write failed: %s", e)
            return None
        finally:
            self._writing.release()

    def _write_bundle(self, reason, exc, thread) -> str:
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        path = os.path.join(self.out_dir,
                            f"postmortem-{stamp}-pid{os.getpid()}")
        n = 1
        while os.path.exists(path if n == 1 else f"{path}.{n}"):
            n += 1
        if n > 1:
            path = f"{path}.{n}"
        os.makedirs(path)

        def dump(name: str, obj: Any) -> None:
            # one file failing (unserializable corner, disk hiccup)
            # must not void the rest of the bundle
            try:
                with open(os.path.join(path, name), "w") as f:
                    if name.endswith(".jsonl"):
                        f.write(obj)
                    else:
                        json.dump(_events.to_jsonable(obj), f, indent=2,
                                  sort_keys=True)
            except Exception as e:
                logger.error("postmortem: %s failed: %s", name, e)

        manifest: Dict[str, Any] = {
            "reason": reason,
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self._started_at, 3),
            "python": sys.version.split()[0],
            "platform": sys.platform,
            "argv": list(sys.argv),
            "thread": thread or threading.current_thread().name,
            "threads_alive": sorted(t.name
                                    for t in threading.enumerate()),
        }
        if exc is not None:
            manifest["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
            }
        dump("manifest.json", manifest)
        log = _events.get_event_log()
        dump("events.jsonl", log.to_jsonl(self.max_events))
        dump("metrics.json", get_registry().snapshot())
        dump("spans.json", get_tracer().spans())
        dump("inflight.json", {"request_ids": _inflight.snapshot(),
                               "count": len(_inflight)})
        dump("config.json", get_config().as_dict())
        # recorded AFTER the bundle so the bundle's own event tail
        # describes the pre-crash world, not the dump
        try:
            log.emit("postmortem_written", "obs", path=path,
                     reason=reason)
        except Exception as e:
            # the bundle on disk is already complete; only the event-
            # ring echo failed (e.g. a broken metrics backend mid-
            # crash). Log it: a crash-reporting path must not itself
            # fail without evidence
            logger.debug("postmortem_written event emit failed: %s", e)
        logger.error("postmortem bundle written: %s (%s)", path, reason)
        return path

    # ---------------------------------------------------------- hooks --
    def _on_uncaught(self, exc_type, exc, tb) -> None:
        try:
            _events.emit("uncaught_exception", "obs",
                         error=f"{exc_type.__name__}: {exc}",
                         thread=threading.current_thread().name)
            self.write_postmortem("uncaught_exception", exc=exc)
        finally:
            if self._prev_excepthook is not None:
                self._prev_excepthook(exc_type, exc, tb)

    def _on_thread_exception(self, args) -> None:
        if args.exc_type is SystemExit:  # interpreter-driven exits
            return
        try:
            tname = args.thread.name if args.thread else "?"
            _events.emit("uncaught_exception", "obs",
                         error=f"{args.exc_type.__name__}: "
                               f"{args.exc_value}",
                         thread=tname)
            self.write_postmortem("thread_exception",
                                  exc=args.exc_value, thread=tname)
        finally:
            if self._prev_thread_hook is not None:
                self._prev_thread_hook(args)

    def _on_sigterm(self, signum, frame) -> None:
        import signal as _signal

        _events.emit("fatal_signal", "obs", signum=int(signum))
        self.write_postmortem(f"signal_{int(signum)}")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == _signal.SIG_IGN:
            # the host deliberately ignored this signal; our hook must
            # only add the bundle, not turn an ignored signal fatal
            return
        else:  # SIG_DFL: restore + re-raise so the process still dies
            _signal.signal(signum, _signal.SIG_DFL)
            _signal.raise_signal(signum)

    def install(self, signals: bool = False) -> "FlightRecorder":
        """Install ``sys.excepthook`` + ``threading.excepthook`` +
        ``faulthandler`` (and, with ``signals=True``, a SIGTERM hook
        that writes a bundle then chains to the previous handler).
        Idempotent, except that a later ``signals=True`` upgrades a
        signal-less install (library code installs plain; the
        entrypoint, which owns the main thread, opts into the SIGTERM
        hook afterwards)."""
        if not self._installed:
            try:
                os.makedirs(self.out_dir, exist_ok=True)
            except OSError as e:
                # unwritable bundle root (read-only container, unset
                # HOME): the crash-observability add-on must never BE
                # the crash -- degrade to hooks-only (dumps will log
                # their own failure), same stance as the compile
                # cache's dir creation (common.context)
                logger.warning("postmortem dir %s unavailable (%s); "
                               "bundles will fail until it exists",
                               self.out_dir, e)
            # pin the bound methods: attribute access mints a fresh
            # bound-method object each time, so uninstall()'s
            # are-we-still-installed identity checks need the exact
            # objects that went into the hooks
            self._hook_uncaught = self._on_uncaught
            self._hook_thread = self._on_thread_exception
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._hook_uncaught
            self._prev_thread_hook = threading.excepthook
            threading.excepthook = self._hook_thread
            try:
                import faulthandler

                self._fault_was_enabled = faulthandler.is_enabled()
                self._fault_file = open(
                    os.path.join(
                        self.out_dir,
                        f"faulthandler-pid{os.getpid()}.log"), "w")
                faulthandler.enable(self._fault_file, all_threads=True)
            except Exception as e:
                logger.warning("faulthandler unavailable: %s", e)
                self._fault_file = None
            self._installed = True
            _events.emit("flight_installed", "obs", dir=self.out_dir,
                         signals=bool(signals))
        if signals and not self._signals_installed:
            import signal as _signal

            self._prev_sigterm = _signal.signal(_signal.SIGTERM,
                                                self._on_sigterm)
            self._signals_installed = True
        return self

    def uninstall(self) -> None:
        """Restore whatever the hooks replaced (tests; embedded use)."""
        if not self._installed:
            return
        if sys.excepthook is self._hook_uncaught:
            sys.excepthook = self._prev_excepthook
        if threading.excepthook is self._hook_thread:
            threading.excepthook = self._prev_thread_hook
        if self._signals_installed:
            import signal as _signal

            try:
                _signal.signal(_signal.SIGTERM,
                               self._prev_sigterm or _signal.SIG_DFL)
            except ValueError:  # not the main thread
                pass
            self._prev_sigterm = None
            self._signals_installed = False
        if self._fault_file is not None:
            try:
                import faulthandler

                if self._fault_was_enabled:
                    # somebody (pytest, PYTHONFAULTHANDLER) had it on
                    # before us: hand it back to stderr rather than
                    # leaving the process with no hard-crash traceback
                    faulthandler.enable(all_threads=True)
                else:
                    faulthandler.disable()
                self._fault_file.close()
            except Exception as e:
                # uninstall() must not raise (tests tear down in
                # finally blocks), but a faulthandler left half-
                # restored is worth a breadcrumb
                logger.debug("faulthandler restore failed: %s", e)
            self._fault_file = None
        self._installed = False


_global_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The installed process recorder, or None before install()."""
    return _global_recorder


def install_flight_recorder(out_dir: Optional[str] = None,
                            signals: bool = False) -> FlightRecorder:
    """Install (or return) the process-wide recorder. The serving
    launcher calls this when ``zoo.obs.flight.enabled``; entrypoints
    that own the main thread pass ``signals=True`` for the SIGTERM
    bundle."""
    global _global_recorder
    with _recorder_lock:
        if _global_recorder is None:
            _global_recorder = FlightRecorder(out_dir=out_dir)
        return _global_recorder.install(signals=signals)


def uninstall_flight_recorder() -> None:
    global _global_recorder
    with _recorder_lock:
        if _global_recorder is not None:
            _global_recorder.uninstall()
            _global_recorder = None
