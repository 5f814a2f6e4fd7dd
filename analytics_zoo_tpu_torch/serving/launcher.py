"""Config-driven serving launcher.

The counterpart of ``analytics_zoo_tpu/serving/launcher.py``: one config
dict (the reference's YAML schema) describes the model, the queue and
the batching params; ``launch(config)`` assembles InferenceModel +
ServingWorker (+ its Supervisor) and starts serving.

Ported so far: ``model.path``, ``data.queue: memory`` (the default),
every ``params`` key, ``http.enabled: false``, and the ``generation:``
block with ``role: unified``. Its presence enables the token-streaming
plane (``enabled: false`` opts out); without a ``model:`` block the app
serves generation only. It takes the reference's keys::

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

Generate requests go to ``app.gen_input_queue`` (``enqueue_generation``)
and their chunks to ``app.output_queue``. Everything else raises
``NotImplementedError`` naming its ROADMAP queue-1 item: encrypted
models (inference runtime), the ``dir``/``tcp``/``redis`` queues and
``generation.role: prefill | decode``, which needs the ``redis://``
handoff stream (fleet), the HTTP frontend and the Redis frontend (HTTP
frontend), and ``shard:`` (parallel and sharded inference). The
periodic rollup reporter (``zoo.obs.report.interval``) comes with the
HTTP frontend. Direct queue clients read ``app.output_queue``
themselves.
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
    """A running serving deployment: model + worker (+ supervisor).

    With a ``generation:`` block the deployment also (or, when
    ``model:`` is omitted, *only*) hosts a
    :class:`~analytics_zoo_tpu_torch.serving.generation.worker.
    GenerationWorker` with its own input queue and supervisor, sharing
    the output queue; ``worker`` and ``model`` are None for a
    generation-only deployment."""

    def __init__(self, model: Any, worker: Optional[ServingWorker],
                 input_queue: InputQueue, output_queue: OutputQueue,
                 supervisor=None, gen_worker=None, gen_supervisor=None,
                 gen_input_queue: Optional[InputQueue] = None):
        self.model = model
        self.worker = worker
        self.input_queue = input_queue
        self.output_queue = output_queue
        self.supervisor = supervisor
        self.gen_worker = gen_worker
        self.gen_supervisor = gen_supervisor
        self.gen_input_queue = gen_input_queue

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
        for worker in (self.worker, self.gen_worker):
            if worker is not None:
                worker.stop()
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
    if (config.get("http") or {}).get("enabled", True):
        raise _not_ported("the HTTP frontend (http.enabled: true)",
                          "HTTP frontend")
    if (config.get("redis") or {}).get("enabled"):
        raise _not_ported("the Redis frontend", "HTTP frontend")


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
    supervise = bool(
        get_config().get("zoo.serving.supervisor.enabled", True))
    worker = supervisor = None
    if model is not None:
        worker, supervisor = _start_predict(model, in_q, out_q, params,
                                            supervise)
    gen_worker = gen_supervisor = gen_in = None
    if gen_enabled:
        try:
            gen_in, gen_worker, gen_supervisor = _start_generation(
                gen_cfg, data, out_q, supervise, device)
        except Exception as e:
            emit_event("launch_failed", "serving", error=repr(e)[:500])
            # no ServingApp handle escapes; don't leak the running
            # predict plane (supervisor first, or it would restart the
            # worker we stop)
            if supervisor is not None:
                supervisor.stop()
            if worker is not None:
                worker.stop()
            raise
    emit_event("serving_launch", "serving", queue="memory",
               pipelined=worker.pipelined if worker is not None else False,
               http=False, shard_mode="off",
               generation=gen_worker is not None, address=None)
    return ServingApp(model, worker, in_q, out_q, supervisor=supervisor,
                      gen_worker=gen_worker, gen_supervisor=gen_supervisor,
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
