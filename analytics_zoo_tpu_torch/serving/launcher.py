"""Config-driven serving launcher.

The counterpart of ``analytics_zoo_tpu/serving/launcher.py``: one config
dict (the reference's YAML schema) describes the model, the queue and
the batching params; ``launch(config)`` assembles InferenceModel +
ServingWorker (+ its Supervisor) and starts serving.

Ported so far: ``model.path``, ``data.queue: memory`` (the default),
every ``params`` key, ``http.enabled: false``. Everything else raises
``NotImplementedError`` naming its ROADMAP queue-1 item: encrypted
models (inference runtime), the ``dir``/``tcp``/``redis`` queues
(fleet), the HTTP frontend and the Redis frontend (HTTP frontend),
``generation:`` (generation plane) and ``shard:`` (parallel and sharded
inference). The periodic rollup reporter (``zoo.obs.report.interval``)
comes with the HTTP frontend. Direct queue clients read
``app.output_queue`` themselves.
"""

from __future__ import annotations

from typing import Any, Dict

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.inference.inference_model import (
    InferenceModel, bucket_ladder)
from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.serving.queues import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.worker import ServingWorker

logger = get_logger(__name__)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch port yet (ROADMAP queue 1: "
        f"{item})")


class ServingApp:
    """A running serving deployment: model + worker (+ supervisor).
    The graceful ``drain`` of the reference arrives with the fleet
    item, whose rolling restarts use it."""

    def __init__(self, model: Any, worker: ServingWorker,
                 input_queue: InputQueue, output_queue: OutputQueue,
                 supervisor=None):
        self.model = model
        self.worker = worker
        self.input_queue = input_queue
        self.output_queue = output_queue
        self.supervisor = supervisor

    def stop(self) -> None:
        # supervisor FIRST: it exists to restart a stopping worker
        if self.supervisor is not None:
            self.supervisor.stop()
        self.worker.stop()
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
    if "generation" in config and bool(
            (config.get("generation") or {}).get("enabled", True)):
        raise _not_ported("the generation: block", "generation plane")
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
    ``model.path``; ``device`` (None = CUDA) is where a loaded model
    runs."""
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
    if model is None:
        model = _load_model(config, device)
    data = config.get("data") or {}
    params = config.get("params") or {}

    in_q = InputQueue(backend="memory", maxlen=data.get("maxlen", 10000))
    out_q = OutputQueue(backend="memory")
    supervise = bool(
        get_config().get("zoo.serving.supervisor.enabled", True))
    supervisor = None
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
    emit_event("serving_launch", "serving", queue="memory",
               pipelined=worker.pipelined, http=False, shard_mode="off",
               generation=False, address=None)
    return ServingApp(model, worker, in_q, out_q, supervisor=supervisor)
