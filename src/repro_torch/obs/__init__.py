"""Observability (port): allocator telemetry so far; the metrics
registry and trace spans come with ROADMAP item A14."""
