"""Origin serving subsystem (torch- and jax-free).

The HLS routes stopped being "read a file per request" here: an
in-memory hot-segment cache with strong ETags (`cache.py`), RFC 7233
range / HEAD / conditional-GET planning plus the bounded LL-HLS
blocking-reload machinery (`serve.py`), and per-job concurrent-session
gauges — the pieces a CDN-fronted origin needs to survive concurrent
viewers while the farm keeps encoding. Everything here runs on the
coordinator's API threads: no torch, no device state.
"""

from .cache import HotSegmentCache
from .serve import Origin, ServePlan, plan_file

__all__ = ["HotSegmentCache", "Origin", "ServePlan", "plan_file"]
