"""repro_torch.obs — metrics and tracing (port of ``repro.obs``'s core).

* ``metrics`` — process-local registry of counters/gauges/fixed-bucket
  histograms with labels, a Prometheus-text exporter, a JSONL event sink
  with monotonic timestamps, and an optional stdlib ``/metrics`` HTTP
  endpoint. stdlib only; recording is host-side and adds no device sync.
* ``trace``   — ``span()`` stamping the JSONL stream and bracketing phases
  with ``torch.profiler.record_function``; ``profile_trace()`` captures a
  ``torch.profiler`` Chrome trace (the ``--profile-dir`` knob routes
  here); ``timed_call()``.
* ``dump``    — ``python -m repro_torch.obs.dump``: replay a recorded
  JSONL stream and render it as text/JSON/Prometheus.

The reference's ``flops`` (per-junction accounting gauges) and its wiring
into the engine, scheduler, ``ops`` and ``block_pattern`` are not ported
yet; the trainer and the fault-tolerance loop record through this core.
"""
from . import metrics, trace  # noqa: F401
from .metrics import (  # noqa: F401
    Registry, disabled_registry, get_registry, serve_http,
)
from .trace import profile_trace, span, timed_call  # noqa: F401

__all__ = ["metrics", "trace", "Registry", "get_registry",
           "disabled_registry", "serve_http", "span", "profile_trace",
           "timed_call"]
