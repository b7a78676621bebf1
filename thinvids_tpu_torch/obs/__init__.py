"""Observability: metrics registry and distributed tracing (copies of the
reference package's modules).

Torch- and jax-free by contract: every piece runs on control-plane
threads and the executors' host loops, never inside a device program.

- :mod:`.metrics` — typed counters/gauges/histograms with label support
  and Prometheus text exposition. The encoders' process-cumulative stage
  clocks (parallel/dispatch._TOTALS) and the split-frame per-frame
  latency histogram land here.
- :mod:`.trace` — per-job span rings exported as Chrome trace-event
  JSON; an encoder's StageProfile records a span for every timed stage
  once a recorder is bound (``stages.set_tracer``).

The reference's flight recorder (postmortem dumps on job failure) is not
ported yet: only the job executor uses it.
"""

from __future__ import annotations

from . import metrics, trace  # noqa: F401

__all__ = ["metrics", "trace"]
