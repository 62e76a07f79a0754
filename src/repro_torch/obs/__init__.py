"""Observability (port): in-kernel allocator telemetry, a metrics
registry with Prometheus/JSON exposition, and Chrome-trace spans.

The package imports nothing of the serving stack, which imports it.

- :mod:`repro_torch.obs.telemetry`: the update math of the ctl
  telemetry region (the CUDA kernels advance the same words) and its
  host decoder;
- :mod:`repro_torch.obs.metrics`: counters/gauges/histograms with
  labels, Prometheus text exposition and JSON;
- :mod:`repro_torch.obs.trace`: ``trace_event`` spans of the engine's
  phases, viewable in Perfetto / chrome://tracing.
"""
