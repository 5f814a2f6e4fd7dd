"""Layered configuration system.

The reference layers Spark properties (packaged defaults file +
``spark.analytics.zoo.*`` overrides), JVM system properties, and env vars
(ref: zoo/.../common/NNContext.scala:189-247, SURVEY.md section 5 "Config").
Here the layers are, lowest to highest precedence:

1. built-in defaults (``_DEFAULTS``)
2. an optional config file (``analytics-zoo-tpu.conf``, ``key value`` lines,
   the analog of ``spark-analytics-zoo.conf``)
3. environment variables ``AZT_<KEY>`` (dots -> underscores, uppercased)
4. programmatic ``set()`` calls
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

_DEFAULTS: Dict[str, Any] = {
    # training
    "zoo.train.failure.retry_times": 5,          # ref: bigdl.failure.retryTimes (Topology.scala:1256)
    "zoo.train.failure.retry_interval_s": 120,   # ref: bigdl.failure.retryTimeInterval
    "zoo.train.log_every_n_steps": 50,
    "zoo.train.donate_buffers": True,
    # training PRNG stream (dropout masks, epoch shuffles): "auto" uses
    # the hardware RBG generator on TPU -- threefry2x32 dropout costs
    # ~23 ms/step on BERT-base b32/L384 v5e (MFU 0.35 -> 0.42 measured)
    # -- and threefry elsewhere; set explicitly to pin an impl
    "zoo.train.prng_impl": "auto",
    # mesh / parallelism axis names -- read through
    # parallel.mesh.config_axis("<role>") (a prefix-built key, so
    # grep for the wrapper, not the literal)
    "zoo.mesh.axis.data": "data",
    "zoo.mesh.axis.model": "model",
    "zoo.mesh.axis.sequence": "seq",
    "zoo.mesh.axis.pipeline": "pipe",
    "zoo.mesh.axis.expert": "expert",
    # ops
    # attention kernel dispatch: "auto" (flash on TPU when shapes
    # allow, einsum otherwise), "flash", or "einsum". At short seqs
    # (<=512) the materialized einsum path is often faster on TPU than
    # a flash kernel at head_dim 64; auto picks per shape.
    "zoo.ops.attention_impl": "auto",
    # seq length at/below which auto prefers the einsum path (scores
    # fit HBM comfortably and XLA's batched matmuls beat the blockwise
    # kernel's VPU overhead at these sizes)
    "zoo.ops.attention_flash_min_seq": 512,
    # causal ring-attention schedule: "zigzag" balances causal load
    # over the ring (~2x less compute), "contiguous" is the classic
    # layout; "auto" picks zigzag for causal when shapes divide
    "zoo.ops.ring_schedule": "auto",
    # data layer
    # image-backbone BN statistics rows: 0 = exact full-batch stats;
    # K > 0 computes train-time BN stats over the first K batch rows
    # (the stat reduce is a pure HBM-bandwidth pass -- 31% of the r4
    # ResNet-50 step; see SampledBatchNorm)
    "zoo.models.bn_stat_rows": 0,

    "zoo.data.prefetch_buffer": 2,
    "zoo.data.check_batch_divisible": True,      # ref: tf_dataset.py:142-147 batch % cores == 0
    # serving
    "zoo.serving.batch_size": 8,
    "zoo.serving.batch_timeout_ms": 5,
    # adaptive micro-batching (AdaptiveBatcher): the linger floor the
    # deadline tightens toward when the input queue is shallow, and the
    # cap the batch may grow to under backlog (0 = auto: the power-of-
    # two bucket of 4x batch_size). Growth is snapped to the bucket
    # ladder so it never introduces a new XLA shape.
    "zoo.serving.batch_timeout_min_ms": 1.0,
    "zoo.serving.batch_max_size": 0,
    # pipelined serving engine: decode -> assemble/dispatch -> finalize
    # run as overlapped stages with up to pipeline.depth dispatched
    # batches in flight; false restores the synchronous per-batch loop
    "zoo.serving.pipeline.enabled": True,
    "zoo.serving.pipeline.depth": 2,
    # launcher default when the YAML omits http.port; 0 = pick a free
    # port (the reference FrontEndApp pinned 10020 -- set that here to
    # reproduce its behavior)
    "zoo.serving.http_port": 0,
    # resilience (serving/resilience.py): the launcher wraps the
    # worker in a Supervisor that restarts it on death (thread crash)
    # or wedge (stale heartbeat), with capped exponential backoff +
    # jitter, re-queuing that run's in-flight requests exactly once
    "zoo.serving.supervisor.enabled": True,
    "zoo.serving.supervisor.poll_interval_s": 0.5,
    "zoo.serving.supervisor.heartbeat_timeout_s": 30.0,
    "zoo.serving.supervisor.backoff_base_s": 0.1,
    "zoo.serving.supervisor.backoff_max_s": 30.0,
    "zoo.serving.supervisor.max_restarts": 0,    # 0 = unlimited
    # circuit breaker around backend dispatch: open after `threshold`
    # consecutive predict failures, half-open probe after cooldown_s
    "zoo.serving.breaker.enabled": False,
    "zoo.serving.breaker.threshold": 5,
    "zoo.serving.breaker.cooldown_s": 5.0,
    # per-request deadline budget stamped at enqueue (0 = off): the
    # worker rejects expired requests with a structured
    # deadline_exceeded error at decode/dispatch/finalize instead of
    # burning a device slot on an answer nobody is waiting for
    "zoo.serving.deadline_ms": 0.0,
    # load shedding (0 = off): InputQueue.enqueue refuses new work
    # once queue depth reaches this, and the HTTP frontend turns the
    # refusal into 503 + Retry-After instead of letting p99 explode.
    # ISSUE-15 turns the single threshold into a brownout LADDER:
    # queue_depth is the interactive (highest-class) threshold, and
    # batch/background admit only below batch_fraction/
    # background_fraction of it -- lowest class sheds first, and a
    # class is never refused while a lower one is admitted.
    # retry_after_s stays the Retry-After FLOOR; the advertised value
    # scales with an EWMA of the shed rate (ewma_alpha per-second
    # smoothing) up to retry_after_max_s. gen_cost_tokens converts a
    # generate request's max_tokens budget into admission cost
    # (ceil(max_tokens / gen_cost_tokens) queue slots) so one long
    # stream can't starve interactive traffic.
    "zoo.serving.shed.queue_depth": 0,
    "zoo.serving.shed.retry_after_s": 1.0,
    "zoo.serving.shed.batch_fraction": 0.6,
    "zoo.serving.shed.background_fraction": 0.3,
    "zoo.serving.shed.retry_after_max_s": 30.0,
    "zoo.serving.shed.ewma_alpha": 0.2,
    "zoo.serving.shed.gen_cost_tokens": 16,
    # priority classes (ISSUE-15): the admission class a request
    # without __priority__ is treated as (interactive outranks batch
    # outranks background)
    "zoo.serving.priority.default_class": "interactive",
    # sharded serving (inference/sharded.py): route predict_async
    # through a device mesh. mode: off (single-chip, byte-identical to
    # the pre-mesh engine incl. compile-cache keys) | tp (params
    # sharded by the recipe over zoo.mesh.axis.model, batch
    # replicated) | dp (params replicated, batch sharded) | auto
    # (tp when param bytes exceed auto_hbm_fraction of one chip's HBM,
    # else dp). quantized_collectives opts the tp engine into the
    # EQuARX-idiom int8 shard re-assembly (approximate; exact GSPMD is
    # the default). devices: 0 = the whole backend, N = first N.
    # auto_hbm_bytes: 0 = probe device memory_stats.
    "zoo.serving.shard.mode": "off",
    "zoo.serving.shard.recipe": "transformer_tp",
    "zoo.serving.shard.quantized_collectives": False,
    "zoo.serving.shard.devices": 0,
    "zoo.serving.shard.auto_hbm_bytes": 0,
    "zoo.serving.shard.auto_hbm_fraction": 0.6,
    # chaos harness (serving/chaos.py): seeded, deterministic fault
    # injection behind the same seams the Supervisor watches; spec
    # grammar "kind:seam[:k=v]*;..." (see docs/serving.md)
    "zoo.serving.chaos.enabled": False,
    "zoo.serving.chaos.seed": 0,
    "zoo.serving.chaos.spec": "",
    # graceful drain (ISSUE-9): on SIGTERM (and each rolling-restart
    # step) the deployment stops pulling new work and finishes its
    # in-flight requests for up to this budget before exiting
    # (0 = the old stop-immediately behavior)
    "zoo.serving.drain.deadline_ms": 10000.0,
    # serving fleet (serving/fleet.py): N replica launcher processes
    # sharing one consumer-group stream, front-tier HTTP router, and
    # an optional metrics-driven autoscaler within
    # [min_replicas, max_replicas]
    "zoo.serving.fleet.replicas": 2,
    "zoo.serving.fleet.min_replicas": 1,
    "zoo.serving.fleet.max_replicas": 8,
    "zoo.serving.fleet.poll_interval_s": 0.5,
    "zoo.serving.fleet.health_interval_s": 1.0,
    # pending stream entries idle beyond this are reclaimable by any
    # surviving consumer (XAUTOCLAIM semantics): how long a SIGKILLed
    # replica's claimed-but-unanswered requests wait before another
    # replica re-serves them
    "zoo.serving.fleet.reclaim_idle_ms": 5000.0,
    "zoo.serving.fleet.router_retries": 1,
    "zoo.serving.fleet.autoscale.enabled": False,
    "zoo.serving.fleet.autoscale.backlog_high": 64,
    "zoo.serving.fleet.autoscale.backlog_low": 4,
    "zoo.serving.fleet.autoscale.p99_high_ms": 500.0,
    "zoo.serving.fleet.autoscale.up_consecutive": 3,
    "zoo.serving.fleet.autoscale.down_consecutive": 10,
    "zoo.serving.fleet.autoscale.cooldown_s": 10.0,
    # SLO-driven control (ISSUE-15): latency targets in ms (0 = that
    # target off). With slo.enabled the autoscaler scales on SLO
    # attainment -- worst observed service p99 vs p99_ms, generation
    # time-to-first-token p99 vs ttft_ms, inter-token gap p99 vs
    # inter_token_ms -- instead of raw backlog, and rolling_restart
    # refuses to take a replica down while the interactive class is
    # out of SLO
    "zoo.serving.slo.enabled": False,
    "zoo.serving.slo.p99_ms": 500.0,
    "zoo.serving.slo.ttft_ms": 0.0,
    "zoo.serving.slo.inter_token_ms": 0.0,
    # router unhealthy-replica re-probe (ISSUE-15): capped-exponential
    # + jittered schedule on which the controller re-probes a replica
    # the router marked unhealthy, so a recovered replica rejoins
    # rotation without waiting a full health sweep
    "zoo.serving.fleet.reprobe_base_s": 0.05,
    "zoo.serving.fleet.reprobe_max_s": 2.0,
    # replica spawn backend (ISSUE-15): local = subprocess.Popen on
    # this host (the historical behavior); manifest = no processes,
    # the controller records per-replica configs and emits
    # docker-compose / k8s YAML -- the multi-host seam; remote =
    # launch through a command-runner prefix (ssh/exec style, ISSUE-20)
    # so replicas run as separate containers/hosts
    "zoo.serving.fleet.spawn_backend": "local",
    # command-runner prefix for the remote spawn backend, e.g.
    # "ssh worker-3" or "docker exec zoo-fleet". Tokens are
    # whitespace-split and prepended to the replica argv; empty = run
    # the argv directly on this host (the degenerate remote target)
    "zoo.serving.fleet.remote_runner": "",
    # cross-host addressing (ISSUE-20): bind_host is the interface the
    # broker / router / replica HTTP frontends listen on (loopback by
    # default so single-host behavior is unchanged; 0.0.0.0 for
    # multi-host). advertise_host is the address OTHER hosts should
    # use to reach services bound on this host -- it rides the ready
    # file and broker_address instead of the bind address; empty =
    # advertise the bind address
    "zoo.serving.fleet.bind_host": "127.0.0.1",
    "zoo.serving.fleet.advertise_host": "",
    # broker liveness probe (ISSUE-20): a PING round trip replicas and
    # the router use for readiness, retried with capped exponential
    # backoff before a broker_unreachable event is emitted
    "zoo.serving.fleet.broker_probe_retries": 6,
    "zoo.serving.fleet.broker_probe_base_s": 0.05,
    "zoo.serving.fleet.broker_probe_max_s": 2.0,
    # disaggregated prefill/decode pools (ISSUE-20): when both are
    # > 0 the controller spawns role-typed replicas instead of
    # `replicas` unified ones -- prefill replicas admit + prefill and
    # hand streams (KV pages + slot state) to the decode pool over the
    # broker's handoff stream; each pool autoscales independently
    # within its [min, max]
    "zoo.serving.fleet.prefill_replicas": 0,
    "zoo.serving.fleet.decode_replicas": 0,
    "zoo.serving.fleet.prefill_min_replicas": 1,
    "zoo.serving.fleet.prefill_max_replicas": 8,
    "zoo.serving.fleet.decode_min_replicas": 1,
    "zoo.serving.fleet.decode_max_replicas": 8,
    # KV snapshots larger than this many bytes are dropped from the
    # handoff blob (the decode side then re-prefills
    # deterministically); 0 = always inline the snapshot
    "zoo.serving.fleet.handoff_max_bytes": 8388608,
    # generation serving (serving/generation, ISSUE-10): the decode
    # slot table size (concurrent streams per worker; ALSO the fixed
    # device batch of every decode step), the paged KV cache geometry
    # (page_size tokens per page; num_pages 0 = auto-size so every
    # slot can reach max_len), the per-request length bounds
    # (max_len = prompt + generated tokens a slot may span;
    # max_tokens = default new-token budget when the request omits
    # __max_tokens__), the idle poll interval of a decode loop with no
    # active slots, and how many tokens ride each streamed reply chunk
    "zoo.generation.slots": 8,
    "zoo.generation.page_size": 16,
    "zoo.generation.num_pages": 0,
    "zoo.generation.max_len": 256,
    "zoo.generation.max_tokens": 64,
    "zoo.generation.step_idle_ms": 5.0,
    "zoo.generation.stream_chunk_tokens": 1,
    # observability (analytics_zoo_tpu_torch.obs): per-request tracing gate
    # (spans ride queue blobs as __trace__ and export as Chrome trace
    # JSON; off by default -- the disabled path must cost nothing),
    # span ring size, and the background rollup reporter cadence in
    # seconds (0 disables the thread)
    "zoo.obs.trace.enabled": False,
    "zoo.obs.trace.max_spans": 8192,
    "zoo.obs.report.interval": 0.0,
    # flight recorder (analytics_zoo_tpu_torch.obs.flight / events): the
    # always-on structured event ring, the crash postmortem bundle
    # directory, and the recompile-storm detector (>= threshold
    # distinct shapes for one jitted fn inside window_s seconds ->
    # recompile_storm warning + zoo_obs_recompile_storms_total)
    "zoo.obs.events.max_events": 2048,
    "zoo.obs.flight.enabled": True,
    "zoo.obs.postmortem.dir": "~/.cache/analytics-zoo-tpu/postmortems",
    "zoo.obs.postmortem.max_events": 512,
    "zoo.obs.recompile.window_s": 60.0,
    "zoo.obs.recompile.threshold": 8,
    # vectorized population engine (learn/population.py, ISSUE-13):
    # hard cap on stacked member lanes in one PopulationEstimator (the
    # whole population is ONE executable; too many lanes silently
    # multiplies every buffer by N)
    "zoo.population.max_members": 1024,
    # vectorized AutoML executor (automl/vectorized.py): max lanes per
    # cohort (a larger sampled wave splits into several populations),
    # and whether a failed cohort falls back to answering its trials
    # through the sequential in-process path (False = surface the
    # cohort error on every member trial)
    "zoo.automl.vectorized.max_cohort": 64,
    "zoo.automl.vectorized.fallback": True,
    # per-tenant serving lanes (inference/population.py): the lane a
    # request without __tenant__ uses, unless strict, in which case
    # tenant-less requests to a population model are rejected with a
    # structured invalid-request error
    "zoo.serving.tenant.default_lane": 0,
    "zoo.serving.tenant.strict": False,
    # inference
    "zoo.inference.default_dtype": "bfloat16",
    # XLA persistent compilation cache (see common.context.
    # enable_compilation_cache); "" disables
    "zoo.compile_cache.dir": "~/.cache/analytics-zoo-tpu/xla-cache",
    "zoo.compile_cache.min_compile_secs": 2.0,
}

# Per-key type/range metadata (the glossary's machine-readable half,
# docs/runtime.md "Config-key glossary"). Shapes:
#
#   ("int", lo, hi)      integer; lo/hi are inclusive bounds, None =
#                        unbounded on that side
#   ("float", lo, hi)    float (an int literal is acceptable)
#   ("bool",)            strict boolean
#   ("str",)             free-form string
#   ("enum", a, b, ...)  one of the listed strings
#
# Consumed two ways: ``validate_config_value`` at runtime (opt-in;
# ``set()`` stays permissive so tests can probe edge values) and the
# zoolint ``config-type`` rule statically -- a ``get``/``set`` call
# site whose cast or literal default contradicts the declared
# type/range is a finding before it ships.
_SPECS: Dict[str, tuple] = {
    "zoo.train.failure.retry_times": ("int", 0, None),
    "zoo.train.failure.retry_interval_s": ("float", 0, None),
    "zoo.train.log_every_n_steps": ("int", 1, None),
    "zoo.train.donate_buffers": ("bool",),
    "zoo.train.prng_impl": ("str",),   # "auto"/"rbg"/"threefry2x32"/
                                       # any jax.random.key impl name
    "zoo.mesh.axis.data": ("str",),
    "zoo.mesh.axis.model": ("str",),
    "zoo.mesh.axis.sequence": ("str",),
    "zoo.mesh.axis.pipeline": ("str",),
    "zoo.mesh.axis.expert": ("str",),
    "zoo.ops.attention_impl": ("enum", "auto", "flash", "einsum"),
    "zoo.ops.attention_flash_min_seq": ("int", 0, None),
    "zoo.ops.ring_schedule": ("enum", "auto", "zigzag", "contiguous"),
    "zoo.models.bn_stat_rows": ("int", 0, None),
    "zoo.data.prefetch_buffer": ("int", 0, None),
    "zoo.data.check_batch_divisible": ("bool",),
    "zoo.serving.batch_size": ("int", 1, None),
    "zoo.serving.batch_timeout_ms": ("float", 0, None),
    "zoo.serving.batch_timeout_min_ms": ("float", 0, None),
    "zoo.serving.batch_max_size": ("int", 0, None),
    "zoo.serving.pipeline.enabled": ("bool",),
    "zoo.serving.pipeline.depth": ("int", 1, None),
    "zoo.serving.http_port": ("int", 0, 65535),
    "zoo.serving.supervisor.enabled": ("bool",),
    "zoo.serving.supervisor.poll_interval_s": ("float", 0, None),
    "zoo.serving.supervisor.heartbeat_timeout_s": ("float", 0, None),
    "zoo.serving.supervisor.backoff_base_s": ("float", 0, None),
    "zoo.serving.supervisor.backoff_max_s": ("float", 0, None),
    "zoo.serving.supervisor.max_restarts": ("int", 0, None),
    "zoo.serving.breaker.enabled": ("bool",),
    "zoo.serving.breaker.threshold": ("int", 1, None),
    "zoo.serving.breaker.cooldown_s": ("float", 0, None),
    "zoo.serving.deadline_ms": ("float", 0, None),
    "zoo.serving.shed.queue_depth": ("int", 0, None),
    "zoo.serving.shed.retry_after_s": ("float", 0, None),
    "zoo.serving.shed.batch_fraction": ("float", 0, 1),
    "zoo.serving.shed.background_fraction": ("float", 0, 1),
    "zoo.serving.shed.retry_after_max_s": ("float", 0, None),
    "zoo.serving.shed.ewma_alpha": ("float", 0, 1),
    "zoo.serving.shed.gen_cost_tokens": ("int", 1, None),
    "zoo.serving.priority.default_class": ("enum", "interactive",
                                           "batch", "background"),
    "zoo.serving.shard.mode": ("enum", "off", "tp", "dp", "auto"),
    "zoo.serving.shard.recipe": ("enum", "transformer_tp",
                                 "embedding_tp"),
    "zoo.serving.shard.quantized_collectives": ("bool",),
    "zoo.serving.shard.devices": ("int", 0, None),
    "zoo.serving.shard.auto_hbm_bytes": ("int", 0, None),
    "zoo.serving.shard.auto_hbm_fraction": ("float", 0, 1),
    "zoo.serving.chaos.enabled": ("bool",),
    "zoo.serving.chaos.seed": ("int", None, None),
    "zoo.serving.chaos.spec": ("str",),
    "zoo.serving.drain.deadline_ms": ("float", 0, None),
    "zoo.serving.fleet.replicas": ("int", 1, None),
    "zoo.serving.fleet.min_replicas": ("int", 1, None),
    "zoo.serving.fleet.max_replicas": ("int", 1, None),
    "zoo.serving.fleet.poll_interval_s": ("float", 0, None),
    "zoo.serving.fleet.health_interval_s": ("float", 0, None),
    "zoo.serving.fleet.reclaim_idle_ms": ("float", 0, None),
    "zoo.serving.fleet.router_retries": ("int", 0, None),
    "zoo.serving.fleet.autoscale.enabled": ("bool",),
    "zoo.serving.fleet.autoscale.backlog_high": ("int", 1, None),
    "zoo.serving.fleet.autoscale.backlog_low": ("int", 0, None),
    "zoo.serving.fleet.autoscale.p99_high_ms": ("float", 0, None),
    "zoo.serving.fleet.autoscale.up_consecutive": ("int", 1, None),
    "zoo.serving.fleet.autoscale.down_consecutive": ("int", 1, None),
    "zoo.serving.fleet.autoscale.cooldown_s": ("float", 0, None),
    "zoo.serving.slo.enabled": ("bool",),
    "zoo.serving.slo.p99_ms": ("float", 0, None),
    "zoo.serving.slo.ttft_ms": ("float", 0, None),
    "zoo.serving.slo.inter_token_ms": ("float", 0, None),
    "zoo.serving.fleet.reprobe_base_s": ("float", 0, None),
    "zoo.serving.fleet.reprobe_max_s": ("float", 0, None),
    "zoo.serving.fleet.spawn_backend": ("enum", "local", "manifest",
                                        "remote"),
    "zoo.serving.fleet.remote_runner": ("str",),
    "zoo.serving.fleet.bind_host": ("str",),
    "zoo.serving.fleet.advertise_host": ("str",),
    "zoo.serving.fleet.broker_probe_retries": ("int", 0, None),
    "zoo.serving.fleet.broker_probe_base_s": ("float", 0, None),
    "zoo.serving.fleet.broker_probe_max_s": ("float", 0, None),
    "zoo.serving.fleet.prefill_replicas": ("int", 0, None),
    "zoo.serving.fleet.decode_replicas": ("int", 0, None),
    "zoo.serving.fleet.prefill_min_replicas": ("int", 1, None),
    "zoo.serving.fleet.prefill_max_replicas": ("int", 1, None),
    "zoo.serving.fleet.decode_min_replicas": ("int", 1, None),
    "zoo.serving.fleet.decode_max_replicas": ("int", 1, None),
    "zoo.serving.fleet.handoff_max_bytes": ("int", 0, None),
    "zoo.generation.slots": ("int", 1, None),
    "zoo.generation.page_size": ("int", 1, None),
    "zoo.generation.num_pages": ("int", 0, None),
    "zoo.generation.max_len": ("int", 2, None),
    "zoo.generation.max_tokens": ("int", 1, None),
    "zoo.generation.step_idle_ms": ("float", 0, None),
    "zoo.generation.stream_chunk_tokens": ("int", 1, None),
    "zoo.population.max_members": ("int", 1, None),
    "zoo.automl.vectorized.max_cohort": ("int", 1, None),
    "zoo.automl.vectorized.fallback": ("bool",),
    "zoo.serving.tenant.default_lane": ("int", 0, None),
    "zoo.serving.tenant.strict": ("bool",),
    "zoo.obs.trace.enabled": ("bool",),
    "zoo.obs.trace.max_spans": ("int", 1, None),
    "zoo.obs.report.interval": ("float", 0, None),
    "zoo.obs.events.max_events": ("int", 1, None),
    "zoo.obs.flight.enabled": ("bool",),
    "zoo.obs.postmortem.dir": ("str",),
    "zoo.obs.postmortem.max_events": ("int", 1, None),
    "zoo.obs.recompile.window_s": ("float", 0, None),
    "zoo.obs.recompile.threshold": ("int", 1, None),
    "zoo.inference.default_dtype": ("str",),
    "zoo.compile_cache.dir": ("str",),
    "zoo.compile_cache.min_compile_secs": ("float", 0, None),
}


def config_spec(key: str) -> Optional[tuple]:
    """The declared (type, *constraints) spec for ``key``, or None."""
    return _SPECS.get(key)


def spec_violation(spec: tuple, value: Any) -> Optional[str]:
    """Why ``value`` violates ``spec``, or None when it satisfies it.

    THE single implementation of the spec semantics: the runtime
    validators below and zoolint's ``config-type`` rule both call
    this, so lint and launch-time validation cannot drift apart."""
    kind = spec[0]
    if kind == "bool":
        if not isinstance(value, bool):
            return f"wants bool, got {value!r}"
    elif kind in ("int", "float"):
        ok_types = (int,) if kind == "int" else (int, float)
        if isinstance(value, bool) or not isinstance(value, ok_types):
            return f"wants {kind}, got {value!r}"
        lo = spec[1] if len(spec) > 1 else None
        hi = spec[2] if len(spec) > 2 else None
        if lo is not None and value < lo:
            return f"wants >= {lo}, got {value!r}"
        if hi is not None and value > hi:
            return f"wants <= {hi}, got {value!r}"
    elif kind == "str":
        if not isinstance(value, str):
            return f"wants str, got {value!r}"
    elif kind == "enum":
        if value not in spec[1:]:
            return f"wants one of {spec[1:]}, got {value!r}"
    return None


def validate_config_value(key: str, value: Any) -> Any:
    """Check ``value`` against the key's declared spec; returns the
    value unchanged, raising ValueError on a violation. Keys without
    a spec pass through (unknown keys are ``config-undeclared``'s
    business, not this helper's)."""
    spec = _SPECS.get(key)
    if spec is not None:
        why = spec_violation(spec, value)
        if why:
            raise ValueError(f"{key} {why}")
    return value


def validate_config(config: Optional["ZooConfig"] = None) -> None:
    """Validate every spec'd key's *resolved* value (defaults + file +
    env + overrides). Call at launch to fail fast on a bad conf file
    or AZT_* env var instead of mid-serve."""
    cfg = config if config is not None else get_config()
    for key in _SPECS:
        validate_config_value(key, cfg.get(key))


_ENV_PREFIX = "AZT_"


def _coerce(value: str) -> Any:
    low = value.strip()
    if low.lower() in ("true", "false"):
        return low.lower() == "true"
    for conv in (int, float):
        try:
            return conv(low)
        except ValueError:
            pass
    return low


class ZooConfig:
    """Thread-safe layered key/value config."""

    def __init__(self, conf_file: Optional[str] = None):
        self._lock = threading.Lock()
        self._overrides: Dict[str, Any] = {}
        self._file_layer: Dict[str, Any] = {}
        if conf_file is None:
            conf_file = os.environ.get("AZT_CONF_FILE", "analytics-zoo-tpu.conf")
        if conf_file and os.path.isfile(conf_file):
            self._file_layer = self._parse_conf_file(conf_file)

    @staticmethod
    def _parse_conf_file(path: str) -> Dict[str, Any]:
        layer: Dict[str, Any] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(None, 1)
                if len(parts) == 2:
                    layer[parts[0]] = _coerce(parts[1])
        return layer

    def _env_lookup(self, key: str) -> Optional[str]:
        env_key = _ENV_PREFIX + key.replace(".", "_").upper()
        return os.environ.get(env_key)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
        env_val = self._env_lookup(key)
        if env_val is not None:
            return _coerce(env_val)
        if key in self._file_layer:
            return self._file_layer[key]
        return _DEFAULTS.get(key, default)

    def set(self, key: str, value: Any) -> "ZooConfig":
        with self._lock:
            self._overrides[key] = value
        return self

    def unset(self, key: str) -> "ZooConfig":
        with self._lock:
            self._overrides.pop(key, None)
        return self

    def as_dict(self) -> Dict[str, Any]:
        merged = dict(_DEFAULTS)
        merged.update(self._file_layer)
        # env-only keys: AZT_FOO_BAR -> foo.bar (lossy for keys whose
        # canonical form contains underscores; get() remains authoritative)
        for env_key, env_val in os.environ.items():
            if env_key.startswith(_ENV_PREFIX) and env_key != "AZT_CONF_FILE":
                key = env_key[len(_ENV_PREFIX):].lower().replace("_", ".")
                if key not in merged:
                    merged[key] = _coerce(env_val)
        for key in list(merged):
            env_val = self._env_lookup(key)
            if env_val is not None:
                merged[key] = _coerce(env_val)
        with self._lock:
            merged.update(self._overrides)
        return merged


_global_config: Optional[ZooConfig] = None
_config_lock = threading.Lock()


def get_config() -> ZooConfig:
    global _global_config
    with _config_lock:
        if _global_config is None:
            _global_config = ZooConfig()
        return _global_config


def reset_config() -> None:
    global _global_config
    with _config_lock:
        _global_config = None
