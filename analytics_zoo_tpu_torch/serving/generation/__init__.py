"""Autoregressive generation serving: the counterpart of
``analytics_zoo_tpu/serving/generation``.

The token-streaming data plane the predict path cannot express: a
``generate`` request has a *lifetime* (prefill, then one token per
decode step until eos/max_tokens/deadline), so batching is not "stack
N requests into one tensor" but "keep a fixed-shape decode step full
of whichever streams are alive right now". The package splits that
into:

- :mod:`model` -- a self-contained causal-transformer LM
  (:class:`TinyGenLM`) with explicit prefill and single-position
  decode math (the two phases the engine runs separately);
- :mod:`engine` -- :class:`DecodeEngine`: bucketed prefill ladder (its
  own shape ladder, same recompile-storm discipline as the predict
  bucket cache; on the card a bucket of 128 tokens or more launches
  K5b) + ONE fixed-shape decode step over the slot table, backed by
  :class:`~analytics_zoo_tpu_torch.inference.kv_cache.PagedKVCache`;
- :mod:`batcher` -- :class:`ContinuousBatcher`: AdaptiveBatcher's role
  evolved into slot *admission* -- requests join and leave the running
  batch at step boundaries instead of waiting for a batch window;
- :mod:`worker` -- :class:`GenerationWorker`: the serving loop
  (queues in, streamed chunks out) with the same drain / chaos /
  supervisor / fleet seams as :class:`~..worker.ServingWorker`.

Wire vocabulary (``serving/protocol.py``): requests ride
``__max_tokens__``/``__eos__``; streamed reply chunks carry
``__stream__`` (the chunk sequence number -- also the client's
exactly-once dedup key) and the terminal chunk a ``finish_reason``
(or ``__error__`` with a structured prefix, e.g.
``generation_overflow`` -> 503, ``deadline_exceeded`` -> mid-stream
structured terminal chunk).
"""

from analytics_zoo_tpu_torch.serving.generation.model import (  # noqa: F401
    GenModelConfig,
    TinyGenLM,
)
from analytics_zoo_tpu_torch.serving.generation.engine import (  # noqa: F401
    DecodeEngine,
    prefill_ladder,
)
from analytics_zoo_tpu_torch.serving.generation.batcher import (  # noqa: F401
    ContinuousBatcher,
)
from analytics_zoo_tpu_torch.serving.generation.worker import (  # noqa: F401
    GenerationWorker,
)
