"""Share of the traced jobs' sub-window with no device operation
running (union of kernel, copy and fill intervals)."""

from tvbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
