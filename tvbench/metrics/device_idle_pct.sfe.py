"""Share of the traced GOPs' encodes (their live_encode_batch spans,
from a GOP's hand-over to its segments' return) in which no device
operation ran (union of kernel, copy and fill intervals). The schedule's
waits for frames between GOPs lie outside the spans and do not count."""

from tvbench.readers import idle_in_spans_pct


def read(rec):
    return idle_in_spans_pct(rec, "live_encode_batch")
