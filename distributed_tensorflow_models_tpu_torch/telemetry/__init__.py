"""Telemetry of the port: the metrics registry and the event tracer.

The port's own copies of ``distributed_tensorflow_models_tpu/telemetry/``'s
``registry.py`` and ``trace.py`` (stdlib only):

- :mod:`registry` — counters, gauges, timers (p50/p95/max over a bounded
  reservoir), ``span(name)`` and the canonical metric names.
- :mod:`trace` — the bounded ring of span/instant events attached to each
  registry as ``registry.trace``, its flight-recorder dump and
  Chrome-trace export.

``data/pipeline.py`` records queue depth, producer wait, worker busy,
reassembly wait and prefetch fill stalls into an injectable registry
(default: the process-global one).  The goodput report, SLO monitor and
time-series writer of the JAX package are not ported yet.
"""

from distributed_tensorflow_models_tpu_torch.telemetry.registry import (  # noqa: F401
    CHAOS_ARMED_UNFIRED,
    CKPT_FENCE,
    CKPT_RESIZE_RESTORES,
    CKPT_RESTORE,
    CKPT_SAVE,
    CKPT_SIDECAR_FALLBACKS,
    CKPT_WAIT,
    COMPILE,
    CONSENSUS_OVERRIDES,
    DATA_WAIT,
    DISPATCH,
    FLEET_HEARTBEAT_AGE,
    FLEET_PEERS_ALIVE,
    FLEET_STEP_LAG,
    FLOPS_PER_STEP,
    FLOPS_TOTAL,
    HOOK_WALKS,
    HOST_QUEUE_DEPTH,
    PREFETCH_DEPTH,
    PREFETCH_FILL,
    PRODUCER_WAIT,
    REASSEMBLY_WAIT,
    RESTARTS,
    ROLLBACKS,
    SKIPPED_BATCHES,
    STARTUP_AOT_COMPILE,
    STARTUP_FIRST_STEP,
    STARTUP_RESTORE,
    STEP_TIME,
    TRACE_DROPPED,
    TRACE_EVENTS,
    WATCHDOG_LAST_PROGRESS,
    WORKER_BUSY,
    Counter,
    Gauge,
    MetricsRegistry,
    Timer,
    get_registry,
)
from distributed_tensorflow_models_tpu_torch.telemetry.trace import (  # noqa: F401
    NULL_TRACER,
    FlightWatcher,
    Tracer,
    chrome_trace_path,
    flight_record_path,
)
