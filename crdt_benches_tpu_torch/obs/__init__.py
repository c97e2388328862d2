"""Observability for the serve stack (the JAX package's ``obs/``), all
zero-cost when disarmed:

- :mod:`.metrics` — a typed metric registry (Counter / Gauge /
  fixed-bucket mergeable Histogram) that backs ``ServeStats``: per-round
  latency, occupancy and queue depth live in O(buckets) histograms, and
  the serve report carries the whole registry as a versioned ``metrics``
  block;
- :mod:`.trace` — a phase-span tracer for the macro-round lifecycle
  (``with span("serve.plan"):`` is one shared no-op unless
  ``--serve-trace PATH`` arms it; armed, Chrome trace-event JSON loadable
  in Perfetto) and its validator CLI;
- :mod:`.timeseries` — a ring-buffered windowed recorder of per-round
  samples and the ``ServeTelemetry`` facade the scheduler threads through
  a drain;
- :mod:`.shard` — per-shard series (their sums equal the fleet totals)
  and the replicated fleet's per-class merge series;
- :mod:`.status` — a stdlib HTTP status server on loopback (``/healthz``,
  ``/status.json``, ``/metrics`` in Prometheus text) and a ``--watch`` CLI;
- :mod:`.anomaly` — the soak detectors (throughput degradation, RSS and
  journal leak growth, a stuck-round watchdog);
- :mod:`.reqtrace` — request-scoped tracing (admission-to-drain episodes
  with per-phase segments and histogram exemplars);
- :mod:`.slo` — per-class latency objectives, burn rates and compliance;
- :mod:`.flight` — a bounded flight recorder dumped atomically on an
  anomaly, an unrecovered fault or a crash, and its validator CLI.

Nothing here imports torch: the modules are host bookkeeping.
"""
