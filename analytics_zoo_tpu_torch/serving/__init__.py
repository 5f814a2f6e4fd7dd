"""Streaming model serving: the reference's serving data plane on the
port's ``InferenceModel``. Ported so far: the memory/dir/tcp queues, the
batchers, the pipelined and synchronous ``ServingWorker``, the
supervisor, chaos seams, the generation plane (``serving.generation``),
the HTTP frontend (``/predict``, ``/generate``, ``/metrics``) and
``launch()`` for in-process queue deployments. The Redis adapter and
the fleet are still to be ported (ROADMAP queue 1)."""

from analytics_zoo_tpu_torch.serving.queues import (  # noqa: F401
    InputQueue,
    OutputQueue,
    DirQueue,
    MemQueue,
)
from analytics_zoo_tpu_torch.serving.batcher import (  # noqa: F401
    AdaptiveBatcher,
    MicroBatcher,
)
from analytics_zoo_tpu_torch.serving.worker import ServingWorker  # noqa: F401
from analytics_zoo_tpu_torch.serving.http_frontend import (  # noqa: F401
    HttpFrontend,
)
from analytics_zoo_tpu_torch.serving.launcher import (  # noqa: F401
    ServingApp,
    launch,
)
from analytics_zoo_tpu_torch.serving.timer import Timer  # noqa: F401
from analytics_zoo_tpu_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker,
    RequestLedger,
    Supervisor,
)
from analytics_zoo_tpu_torch.serving.chaos import (  # noqa: F401
    ChaosInjector,
    parse_spec,
)
from analytics_zoo_tpu_torch.serving.protocol import (  # noqa: F401
    ERROR_PREFIXES,
    WIRE_KEYS,
    error_status,
)
