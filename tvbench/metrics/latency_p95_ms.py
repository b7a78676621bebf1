"""95th percentile, over every frame due in the window, of the time
from its due time to its GOP's segments returned to the caller."""

from tvbench.readers import percentile


def read(rec):
    return percentile(rec, 95)
