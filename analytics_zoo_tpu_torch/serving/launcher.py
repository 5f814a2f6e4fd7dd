"""Config-driven serving launcher.

The counterpart of ``analytics_zoo_tpu/serving/launcher.py``: one config
dict (the reference's YAML schema) describes the model, the queue, the
batching params and the HTTP frontend; ``launch(config)`` assembles
InferenceModel + ServingWorker (+ its Supervisor) + HttpFrontend and
starts serving.

Ported so far: ``model.path``, ``data.queue: memory`` (the default),
every ``params`` key, the ``http:`` block (``enabled``, the default;
``host``, ``port``, ``certfile``, ``keyfile``), the rollup reporter
(``zoo.obs.report.interval``), and the ``generation:`` block with
``role: unified``. The ``generation:`` block's presence enables the
token-streaming plane (``enabled: false`` opts out); without a
``model:`` block the app serves generation only. It takes the
reference's keys::

    generation:
      model: {vocab: 64, dim: 32, heads: 2, head_dim: 16, layers: 2,
              max_len: 256, mlp_ratio: 2, seed: 0}   # GenModelConfig
      slots: null          # null = zoo.generation.* defaults
      page_size: null
      num_pages: null
      max_len: null
      max_tokens: null     # default new-token budget
      eos: null            # default stop token id
      stream_chunk_tokens: null
      role: unified

A stock config (no ``http:`` block) starts the frontend on
``zoo.serving.fleet.bind_host`` (loopback) at ``zoo.serving.http_port``
(0 = a free port; ``app.address`` names it): ``POST /predict``, ``POST
/generate`` (an SSE token stream), ``/metrics``, ``/healthz`` and the
debug routes. With ``http: {enabled: false}`` generate requests go to
``app.gen_input_queue`` (``enqueue_generation``) and their chunks, like
predict replies, to ``app.output_queue``, which direct queue clients
read themselves (with the frontend on, its router drains that queue).
Everything else raises ``NotImplementedError`` naming its ROADMAP
queue-1 item: encrypted models (inference runtime), the
``dir``/``tcp``/``redis`` queues, ``generation.role: prefill | decode``
(they need the ``redis://`` handoff stream) and the Redis frontend
(fleet), and ``shard:`` (parallel and sharded inference).
``redis.enabled`` beside ``http.enabled`` raises the reference's
``ValueError`` first.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.inference.inference_model import (
    InferenceModel, bucket_ladder)
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.obs.reporter import maybe_start_reporter
from analytics_zoo_tpu_torch.serving.http_frontend import HttpFrontend
from analytics_zoo_tpu_torch.serving.queues import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.worker import ServingWorker

logger = get_logger(__name__)

_M_DRAIN = get_registry().histogram(
    "zoo_serving_drain_duration_seconds",
    "Graceful-drain wait: from drain_begin until the engine finished "
    "its in-flight work (or the deadline expired)")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch port yet (ROADMAP queue 1: "
        f"{item})")


class ServingApp:
    """A running serving deployment: model + worker (+ supervisor) +
    optional HTTP frontend and rollup reporter.

    With a ``generation:`` block the deployment also (or, when
    ``model:`` is omitted, *only*) hosts a
    :class:`~analytics_zoo_tpu_torch.serving.generation.worker.
    GenerationWorker` with its own input queue and supervisor, sharing
    the output queue, one frontend serving both ``/predict`` and
    ``/generate``; ``worker`` and ``model`` are None for a
    generation-only deployment."""

    def __init__(self, model: Any, worker: Optional[ServingWorker],
                 input_queue: InputQueue, output_queue: OutputQueue,
                 frontend: Optional[HttpFrontend] = None, reporter=None,
                 supervisor=None, gen_worker=None, gen_supervisor=None,
                 gen_input_queue: Optional[InputQueue] = None):
        self.model = model
        self.worker = worker
        self.input_queue = input_queue
        self.output_queue = output_queue
        self.frontend = frontend
        self.reporter = reporter
        self.supervisor = supervisor
        self.gen_worker = gen_worker
        self.gen_supervisor = gen_supervisor
        self.gen_input_queue = gen_input_queue

    @property
    def address(self) -> Optional[str]:
        return self.frontend.address if self.frontend else None

    def drain(self, deadline_ms: Optional[float] = None) -> bool:
        """Graceful drain: refuse new work, finish what is already in
        flight (predict batches and live token streams), within
        ``zoo.serving.drain.deadline_ms``. Returns True when both
        planes drained inside the budget; ``stop()`` follows."""
        if deadline_ms is None:
            deadline_ms = float(get_config().get(
                "zoo.serving.drain.deadline_ms", 10000.0))
        emit_event("drain_begin", "serving", deadline_ms=deadline_ms)
        t0 = time.monotonic()
        # supervisors first: a draining worker's thread exits with its
        # stop event unset, which must not read as a crash to restart
        for sup in (self.supervisor, self.gen_supervisor):
            if sup is not None:
                sup.stop()
        if self.frontend is not None:
            # health goes 503 "draining"; new /predict and /generate get
            # a structured 503 + Retry-After
            self.frontend.set_draining()
        ok = True
        for worker in (self.worker, self.gen_worker):
            # each plane gets the full budget: they drain work started
            # concurrently, not a shared quantity
            if worker is not None:
                ok = worker.drain(deadline_s=deadline_ms / 1000.0) and ok
        waited = time.monotonic() - t0
        _M_DRAIN.observe(waited)
        emit_event("drain_complete", "serving", ok=ok,
                   waited_s=round(waited, 3))
        if not ok:
            logger.warning(
                "drain deadline (%.0f ms) expired with in-flight work "
                "remaining; stop() will cut it loose", deadline_ms)
        return ok

    def stop(self) -> None:
        # supervisors FIRST: they exist to restart a stopping worker
        for sup in (self.supervisor, self.gen_supervisor):
            if sup is not None:
                sup.stop()
        if self.frontend is not None:
            self.frontend.stop()
        for worker in (self.worker, self.gen_worker):
            if worker is not None:
                worker.stop()
        if self.reporter is not None:
            self.reporter.stop()
        emit_event("serving_stop", "serving")
        logger.info("serving stopped")


def _load_model(cfg: Dict[str, Any], device) -> InferenceModel:
    mcfg = cfg.get("model") or {}
    path = mcfg.get("path")
    if not path:
        raise ValueError("config needs model.path")
    if mcfg.get("encrypted"):
        raise _not_ported("model.encrypted", "inference runtime")
    return InferenceModel(device=device).load_zoo(path)


def _check_ported(config: Dict[str, Any]) -> None:
    gen = config.get("generation") or {}
    role = gen.get("role", "unified")
    if gen.get("enabled", True) and role in ("prefill", "decode"):
        # the reference takes these roles only over data.queue redis://,
        # whose broker stream carries the prefill -> decode handoff
        raise _not_ported(f"generation.role {role!r} (it needs data.queue "
                          "redis://, the handoff stream)", "fleet")
    if config.get("shard"):
        raise _not_ported("the shard: block",
                          "parallel and sharded inference")
    queue = (config.get("data") or {}).get("queue")
    if queue not in (None, "memory"):
        raise _not_ported(f"data.queue {queue!r}", "fleet")
    if (config.get("data") or {}).get("path"):
        raise _not_ported("data.path (the dir queue)", "fleet")
    if (config.get("redis") or {}).get("enabled"):
        if (config.get("http") or {}).get("enabled", True):
            # the reference's refusal (its launcher raises it once the
            # frontend is up): both frontends drain the one result queue
            raise ValueError(
                "redis.enabled requires http.enabled: false -- "
                "both frontends drain the same result queue (use "
                "two deployments on a shared tcp broker to serve "
                "both protocols)")
        raise _not_ported("the Redis frontend", "fleet")


def launch(config: Dict[str, Any], model: Any = None,
           device=None) -> ServingApp:
    """Assemble and start a deployment from a parsed config dict.

    ``model`` injects a pre-built model object (anything honoring
    ``predict_async(x) -> (outputs, n)``) instead of loading
    ``model.path``; ``device`` (None = CUDA) is where a loaded model and
    the generation engine run."""
    _check_ported(config)
    # fail fast on a bad conf file / AZT_* env var before any thread
    from analytics_zoo_tpu_torch.common.config import validate_config

    validate_config()
    # black box first: a deployment that dies during model load /
    # warm-up should already leave a postmortem bundle
    if get_config().get("zoo.obs.flight.enabled", True):
        from analytics_zoo_tpu_torch.obs.flight import (
            install_flight_recorder)

        install_flight_recorder()
    # chaos drills arm BEFORE the worker exists (no-op unless enabled)
    from analytics_zoo_tpu_torch.serving.chaos import (
        maybe_install_from_config)

    maybe_install_from_config()
    # PRESENCE of the generation block enables the plane (a bare
    # `generation:` with every sub-key defaulted is valid), `enabled:
    # false` opts out; a deployment may host generation ONLY, in which
    # case model.path is not required
    gen_cfg = dict(config.get("generation") or {})
    gen_enabled = ("generation" in config
                   and bool(gen_cfg.get("enabled", True)))
    if model is None and not (gen_enabled and not config.get("model")):
        model = _load_model(config, device)
    data = config.get("data") or {}
    params = config.get("params") or {}

    in_q = InputQueue(backend="memory", maxlen=data.get("maxlen", 10000))
    out_q = OutputQueue(backend="memory")
    http = config.get("http") or {}
    supervise = bool(
        get_config().get("zoo.serving.supervisor.enabled", True))
    worker = supervisor = None
    if model is not None:
        worker, supervisor = _start_predict(model, in_q, out_q, params,
                                            supervise)
    gen_worker = gen_supervisor = gen_in = frontend = reporter = None
    try:
        if gen_enabled:
            gen_in, gen_worker, gen_supervisor = _start_generation(
                gen_cfg, data, out_q, supervise, device)
        if http.get("enabled", True):
            port = http.get("port")
            if port is None:
                # zoo.serving.http_port (0 = a free port); the config's
                # http.port wins when present
                port = int(get_config().get("zoo.serving.http_port", 0))
            # no host -> zoo.serving.fleet.bind_host (loopback unless
            # the deployment opts into a routable bind)
            frontend = HttpFrontend(
                in_q, out_q, host=http.get("host"), port=port,
                worker=worker, certfile=http.get("certfile"),
                keyfile=http.get("keyfile"), gen_queue=gen_in,
                gen_worker=gen_worker).start()
            logger.info("serving ready at %s", frontend.address)
        # the config-gated rollup logger (zoo.obs.report.interval
        # seconds; 0 = off), inside the guard: a malformed interval
        # must not leak the running workers and frontend
        reporter = maybe_start_reporter()
    except Exception as e:
        emit_event("launch_failed", "serving", error=repr(e)[:500])
        # no ServingApp handle escapes; don't leak running pieces
        # (supervisors first, or they would restart the workers we stop)
        for sup in (supervisor, gen_supervisor):
            if sup is not None:
                sup.stop()
        if frontend is not None:
            frontend.stop()
        for w in (worker, gen_worker):
            if w is not None:
                w.stop()
        raise
    emit_event("serving_launch", "serving", queue="memory",
               pipelined=worker.pipelined if worker is not None else False,
               http=frontend is not None, shard_mode="off",
               generation=gen_worker is not None,
               address=frontend.address if frontend is not None else None)
    return ServingApp(model, worker, in_q, out_q, frontend, reporter,
                      supervisor=supervisor, gen_worker=gen_worker,
                      gen_supervisor=gen_supervisor,
                      gen_input_queue=gen_in)


def _start_predict(model: Any, in_q: InputQueue, out_q: OutputQueue,
                   params: Dict[str, Any], supervise: bool):
    """The predict plane: a started ServingWorker (every bucket the
    batcher can emit warmed first) and its Supervisor (or None)."""
    worker = ServingWorker(
        model, in_q, out_q, batch_size=params.get("batch_size"),
        timeout_ms=params.get("timeout_ms"),
        top_n=params.get("top_n"),
        pipeline_depth=params.get("pipeline_depth"),
        pipelined=params.get("pipelined"),
        min_timeout_ms=params.get("min_timeout_ms"),
        max_batch_size=params.get("max_batch_size"))
    # default: every power-of-two bucket the batcher can emit, up to
    # its backlog growth cap, so no request pays a first-use stall
    warm_cap = getattr(worker.batcher, "max_batch_size",
                       worker.batcher.batch_size)
    warm = params.get("warm_batch_sizes", bucket_ladder(warm_cap))
    if warm:
        warm_example = params.get(
            "warm_example", getattr(model, "example_input", None))
        if warm_example is not None:
            model.warm_up(warm_example, batch_sizes=tuple(warm))
        else:
            logger.warning(
                "warm_batch_sizes set but no example input is "
                "available; skipping warm-up")
    worker.start()
    supervisor = None
    if supervise:
        # restart a dead/wedged worker with backoff, re-queue its
        # in-flight requests exactly once
        from analytics_zoo_tpu_torch.serving.resilience import Supervisor

        try:
            supervisor = Supervisor(worker).start()
        except Exception as e:
            emit_event("launch_failed", "serving", error=repr(e)[:500])
            worker.stop()
            raise
    return worker, supervisor


def _start_generation(gen_cfg: Dict[str, Any], data: Dict[str, Any],
                      out_q: OutputQueue, supervise: bool, device):
    """The generation plane (role unified): its own memory request
    queue, the shared output queue, a warmed engine (the whole prefill
    ladder and the decode step run before traffic), a started
    GenerationWorker and its Supervisor (or None)."""
    from analytics_zoo_tpu_torch.serving.generation.engine import (
        engine_from_config)
    from analytics_zoo_tpu_torch.serving.generation.worker import (
        GenerationWorker)

    gen_in = InputQueue(backend="memory", maxlen=data.get("maxlen", 10000))
    engine = engine_from_config(gen_cfg, device=device).warm_up()
    gen_worker = GenerationWorker(
        engine, gen_in, out_q, max_tokens=gen_cfg.get("max_tokens"),
        eos=gen_cfg.get("eos"),
        stream_chunk_tokens=gen_cfg.get("stream_chunk_tokens"),
        role=str(gen_cfg.get("role", "unified"))).start()
    gen_supervisor = None
    if supervise:
        from analytics_zoo_tpu_torch.serving.resilience import Supervisor

        try:
            gen_supervisor = Supervisor(gen_worker).start()
        except Exception:
            gen_worker.stop()
            raise
    return gen_in, gen_worker, gen_supervisor
