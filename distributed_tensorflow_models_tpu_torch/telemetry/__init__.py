"""Telemetry of the port: the metrics registry, the event tracer, the
goodput report, the SLO monitor and the metric time series.

The port's own copies of ``distributed_tensorflow_models_tpu/telemetry/``:

- :mod:`registry` — counters, gauges, timers (p50/p95/max over a bounded
  reservoir), ``span(name)`` and the canonical metric names.
- :mod:`trace` — the bounded ring of span/instant events attached to each
  registry as ``registry.trace``, its flight-recorder dump and
  Chrome-trace export.
- :mod:`goodput` — ``telemetry.json``: the run's wall time split into
  compute, data stall, checkpoint and compile, and MFU against the card's
  peak (``peak_flops``: the H100's dense bf16 rate, or ``DTM_PEAK_FLOPS``).
- :mod:`slo` — declarative rolling-window SLO specs evaluated with
  hysteresis into ``serve/slo_breach/<name>`` counters,
  ``serve/slo_margin/<name>`` gauges and breach/recovery trace instants.
- :mod:`timeseries` — the periodic append-only ``timeseries.jsonl``
  writer (registry snapshot + offered/served request counts).

``data/pipeline.py`` records queue depth, producer wait, worker busy,
reassembly wait and prefetch fill stalls into an injectable registry
(default: the process-global one); ``fit`` gives each run a registry of
its own, with a tracer, and writes its goodput report; the serving server
(``serving/server.py``) attaches the SLO monitor and the time-series
writer.  Only :mod:`goodput` imports torch, and its names below are
resolved on first use, so the torch-free serving front half and the
launcher's autoscaler can import the registry without loading torch.
"""

from distributed_tensorflow_models_tpu_torch.telemetry.registry import (  # noqa: F401
    CHAOS_ARMED_UNFIRED,
    CKPT_FENCE,
    CKPT_RESIZE_RESTORES,
    CKPT_RESTORE,
    CKPT_SAVE,
    CKPT_SIDECAR_FALLBACKS,
    CKPT_WAIT,
    COLLECTIVE_BYTES,
    COLLECTIVES,
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

_LAZY = ("device_count", "device_kind", "goodput_report", "peak_flops",
         "write_report")


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from distributed_tensorflow_models_tpu_torch.telemetry import goodput

    value = getattr(goodput, name)
    globals()[name] = value
    return value
