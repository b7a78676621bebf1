"""Jittered-backoff retry for idempotent HTTP calls.

One implementation of the farm's transport-retry policy, shared by the
worker's /work client (cluster/remote.WorkerClient) and the agent's
heartbeat submitter (cluster/agent.http_submitter) so the two can
never drift: transient transport failures — connection refused/reset
while a restarted coordinator replays its journal, timeouts, HTTP
5xx — retry with full-jitter exponential backoff; 4xx raises
immediately (that is OUR bug, retrying will not help). Knobs:
`remote_http_retries` × `remote_http_backoff_s`.

Dependency-free stdlib module: imported by torch- and jax-free control-plane
processes (worker daemons, metrics-only agents).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable

#: ceiling on a single backoff sleep: a deep retry ladder must keep
#: probing, not disappear for minutes
MAX_DELAY_S = 10.0


def sleep_backoff(attempt: int, backoff_s: float) -> None:
    """Sleep the `attempt`-th (0-based) backoff with full jitter in
    [delay/2, delay] — a farm of workers bounced by one coordinator
    restart must not retry in lockstep."""
    delay = min(MAX_DELAY_S, backoff_s * (2 ** attempt))
    time.sleep(delay * (0.5 + 0.5 * random.random()))


def call_with_backoff(send: Callable[[], Any], retries: int,
                      backoff_s: float) -> Any:
    """Run `send()` (one idempotent HTTP request) retrying transient
    transport failures up to `retries` times. Returns send()'s value;
    re-raises the last failure when the budget burns out."""
    import urllib.error

    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            return send()
        except urllib.error.HTTPError as exc:
            if exc.code < 500:
                raise               # 4xx: OUR bug, retrying won't help
            last = exc              # 5xx incl. chaos partition: retry
        except (urllib.error.URLError, ConnectionError, OSError) as exc:
            last = exc              # refused/reset/timeout: retry
        if attempt < retries:
            sleep_backoff(attempt, backoff_s)
    assert last is not None
    raise last
