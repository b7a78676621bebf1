"""Provider seam: how the capacity controller actually wakes and
suspends worker hosts.

The reference pair was WoL magic packets (manager side) + agent
self-suspend (node side); a cloud farm substitutes a cloud API call;
tests and the autoscale bench substitute real ``cli.py worker``
subprocesses. The controller only ever sees two callables:

    wake(host) -> bool      bring the host's worker daemon up
    suspend(host) -> bool   take it down (after the controller drained it)

Both are best-effort booleans — a False/raise leaves the lifecycle
where it was so the controller retries on a later tick. Providers run
OUTSIDE the controller's lock (they may block on subprocess spawn or a
cloud API round-trip).

torch- and jax-free by contract.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
from typing import Callable, Mapping

from ..core.log import get_logging

_LOG = get_logging(__name__)


class CallableProvider:
    """Wrap two injected callables — the deployment seam (wire a cloud
    scale API, a WoL sender + agent-suspend POST, an IPMI call...)."""

    def __init__(self, wake: Callable[[str], bool] | None = None,
                 suspend: Callable[[str], bool] | None = None) -> None:
        self._wake = wake
        self._suspend = suspend

    def wake(self, host: str) -> bool:
        if self._wake is None:
            return False
        return bool(self._wake(host))

    def suspend(self, host: str) -> bool:
        if self._suspend is None:
            return False
        return bool(self._suspend(host))


class NullProvider(CallableProvider):
    """Default provider: logs the intent and reports failure, so the
    controller keeps lifecycle bookkeeping honest (a host it cannot
    actually suspend stays DRAINING→ACTIVE rather than lying
    SUSPENDED). Deployments replace this (deploy/README.md)."""

    def wake(self, host: str) -> bool:
        _LOG.info("no farm provider wired: cannot wake %s", host)
        return False

    def suspend(self, host: str) -> bool:
        _LOG.info("no farm provider wired: cannot suspend %s", host)
        return False


class SubprocessProvider:
    """Spawn/kill real ``python -m thinvids_tpu_torch.cli worker``
    daemons on this host — the hermetic analog of the reference's WoL
    wake + agent-suspend pair, used by tests and the autoscale bench.
    Each daemon encodes on `device` (``--device``: the card by default,
    ``"cpu"`` when asked). ``suspend`` SIGTERMs the daemon (graceful:
    the controller already drained its leases); ``kill`` SIGKILLs it
    without ceremony — the chaos harness's worker-crash primitive."""

    def __init__(self, coordinator_url: str,
                 env: Mapping[str, str] | None = None,
                 heartbeat_s: float = 0.3, poll_s: float = 0.2,
                 device: str = "cuda") -> None:
        self.coordinator_url = coordinator_url
        self.device = device
        self.env = dict(env if env is not None else os.environ)
        self.heartbeat_s = heartbeat_s
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}

    def wake(self, host: str) -> bool:
        with self._lock:
            proc = self._procs.get(host)
            if proc is not None and proc.poll() is None:
                return True            # already up (re-wake is idempotent)
        # spawn OUTSIDE the lock (Popen blocks on fork/exec); the
        # re-check below resolves a racing double-wake in favor of
        # whoever registered first
        spawned = subprocess.Popen(
            [sys.executable, "-m", "thinvids_tpu_torch.cli", "worker",
             "--coordinator", self.coordinator_url,
             "--node-name", host,
             "--interval", str(self.heartbeat_s),
             "--poll", str(self.poll_s),
             "--device", self.device],
            env=self.env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        duplicate = None
        with self._lock:
            proc = self._procs.get(host)
            if proc is not None and proc.poll() is None:
                duplicate = spawned    # lost the race: theirs wins
            else:
                self._procs[host] = spawned
        if duplicate is not None:
            duplicate.kill()
            duplicate.wait(timeout=10)
        return True

    def _stop(self, host: str, sig: int) -> bool:
        with self._lock:
            proc = self._procs.pop(host, None)
        if proc is None:
            return False
        if proc.poll() is None:
            try:
                proc.send_signal(sig)
            except OSError:
                pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        return True

    def suspend(self, host: str) -> bool:
        return self._stop(host, signal.SIGTERM)

    def kill(self, host: str) -> bool:
        """SIGKILL, no goodbye — the chaos harness's crashed-worker
        primitive (the daemon's leases strand until the board's
        heartbeat-TTL sweep requeues them)."""
        return self._stop(host, signal.SIGKILL)

    def hosts(self) -> list[str]:
        """Hosts with a live daemon process right now."""
        with self._lock:
            return [h for h, p in self._procs.items() if p.poll() is None]

    def stop_all(self) -> None:
        with self._lock:
            hosts = list(self._procs)
        for host in hosts:
            self._stop(host, signal.SIGKILL)
