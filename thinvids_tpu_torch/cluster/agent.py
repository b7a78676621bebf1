"""Node agent: device-health metrics, heartbeats, role sync, idle hook
(a copy of the reference package's, reporting the node's CUDA cards).

Port of the reference's per-node agent (agent/agent.py: 355-496): instead
of `intel_gpu_top` GPU busyness it samples each card's memory occupancy
(`torch.cuda.mem_get_info`), plus host cpu/mem/disk/net read from
``/proc`` and ``shutil.disk_usage`` (the fields the reference reads
through psutil, which a card's host may lack). Metrics flow into the
coordinator's WorkerRegistry — in-process via a direct submitter, or
cross-host via ``POST /node_heartbeat`` on the HTTP API — where the 15 s
TTL makes them the liveness signal (the reference's `metrics:node:<host>`
hash with EXPIRE 15, agent.py:417-436).

Idle suspend (agent.py:445-496) keeps the same gate structure — cpu
below threshold AND all jobs idle for `suspend_idle_s` — but the
suspend action is an injected callable: a cloud GPU host has no WOL to
wake a suspended node, so the default action only emits an activity
event; deployments wire in their own (e.g. scale-down API call).
"""

from __future__ import annotations

import shutil
import socket
import threading
import time
from typing import Any, Callable, Mapping


def sample_device_metrics(device="cuda") -> dict[str, Any]:
    """Accelerator health for the device the node encodes on. For the
    cards (`device` "cuda"): their count, the first card's name, and
    memory occupancy summed over cards (used = total − free, as the
    CUDA runtime reports it: every process's allocations). Degrades to
    ``{"devices": 0}`` where torch sees no card. For ``"cpu"`` (a node
    encoding on its CPU, as the tests run it): one device of kind
    "cpu", as the reference's CPU backend reports it."""
    import torch

    if torch.device(device).type == "cpu":
        return {"devices": 1, "device_kind": "cpu"}
    try:
        count = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
    except Exception:                    # noqa: BLE001 - no CUDA runtime
        return {"devices": 0}
    out: dict[str, Any] = {"devices": count}
    out["device_kind"] = torch.cuda.get_device_name(0) if count else ""
    used = limit = 0
    for i in range(count):
        try:
            free, total = torch.cuda.mem_get_info(i)
        except Exception:                # noqa: BLE001
            continue
        used += int(total) - int(free)
        limit += int(total)
    if limit > 0:
        out["hbm_used_bytes"] = used
        out["hbm_total_bytes"] = limit
        out["hbm_pct"] = round(100.0 * used / limit, 1)
    return out


class _CpuMeter:
    """Busy share of all CPUs since the previous call (the contract of
    psutil's ``cpu_percent(interval=None)``: the first call has no
    window and returns 0.0), from the aggregate line of /proc/stat."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last: tuple[int, int] | None = None

    def percent(self) -> float:
        with open("/proc/stat", encoding="ascii") as fp:
            fields = [int(v) for v in fp.readline().split()[1:]]
        # user nice system idle iowait irq softirq steal (guest time is
        # already inside user/nice)
        busy_idle = (sum(fields[:8]), fields[3] + fields[4])
        with self._lock:
            last, self._last = self._last, busy_idle
        if last is None:
            return 0.0
        total = busy_idle[0] - last[0]
        idle = busy_idle[1] - last[1]
        if total <= 0:
            return 0.0
        return round(min(100.0, max(0.0, 100.0 * (total - idle) / total)),
                     1)


_CPU = _CpuMeter()


def _meminfo() -> dict[str, int]:
    """/proc/meminfo in bytes."""
    out = {}
    with open("/proc/meminfo", encoding="ascii") as fp:
        for line in fp:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[key] = int(parts[0]) * 1024
    return out


def _net_bytes() -> tuple[int, int]:
    """(received, sent) bytes summed over every interface, loopback
    included, from /proc/net/dev."""
    rx = tx = 0
    with open("/proc/net/dev", encoding="ascii") as fp:
        for line in fp.readlines()[2:]:
            _name, _, data = line.partition(":")
            cols = data.split()
            rx += int(cols[0])
            tx += int(cols[8])
    return rx, tx


def sample_host_metrics() -> dict[str, Any]:
    """Host health: cpu/mem/disk/net — the fields the reference agent
    published at 1 Hz (agent.py:396-415), computed as psutil computes
    them on Linux: mem used = total − MemAvailable (MemFree where
    MemAvailable is missing or exceeds the total, as inside some
    containers), disk percent of the space a user may fill."""
    mem = _meminfo()
    total = mem["MemTotal"]
    avail = mem.get("MemAvailable", mem["MemFree"])
    if not 0 <= avail <= total:
        avail = mem["MemFree"]
    used = total - avail
    disk = shutil.disk_usage("/")
    rx, tx = _net_bytes()
    return {
        "cpu": _CPU.percent(),
        "mem": round(100.0 * used / total, 1),
        "mem_used": used,
        "mem_total": total,
        "disk": round(100.0 * disk.used / (disk.used + disk.free), 1)
        if disk.used + disk.free else 0.0,
        "net_rx_bytes": rx,
        "net_tx_bytes": tx,
    }


def coordinator_submitter(coordinator) -> Callable[[str, Mapping], None]:
    """In-process heartbeat sink: registry.heartbeat directly."""
    def submit(host: str, metrics: Mapping[str, Any]) -> None:
        coordinator.registry.heartbeat(host, metrics=dict(metrics))
    return submit


def http_submitter(base_url: str, timeout_s: float = 5.0
                   ) -> Callable[[str, Mapping], None]:
    """Cross-host heartbeat sink: POST /node_heartbeat on the API.

    Transient transport failures (connection refused while a restarted
    coordinator replays its journal, 5xx) retry with the same
    jittered-backoff policy as the worker's /work client
    (`remote_http_retries` / `remote_http_backoff_s`) — one short
    restart window must not let heartbeat TTLs lapse and sweep healthy
    workers' leases. A heartbeat is trivially idempotent."""
    import json
    import urllib.request

    from ..core.config import get_settings
    from ..core.retry import call_with_backoff

    def submit(host: str, metrics: Mapping[str, Any]) -> None:
        snap = get_settings()
        body = json.dumps({"host": host, "metrics": dict(metrics)}).encode()

        def send() -> None:
            req = urllib.request.Request(
                base_url.rstrip("/") + "/node_heartbeat", data=body,
                method="POST",
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=timeout_s).read()

        call_with_backoff(send, int(snap.get("remote_http_retries", 4)),
                          float(snap.get("remote_http_backoff_s", 0.5)))
    return submit


class NodeAgent:
    """Periodic metrics heartbeat + idle detection.

    `submit(host, metrics)` is the injection point (see the two
    submitters above). `idle_probe()` must answer "is the whole cluster
    idle?" (the reference's all_jobs_are_idle); `suspend_action()` runs
    once per idle episode after the gates hold for `suspend_idle_s`.
    """

    def __init__(self, submit: Callable[[str, Mapping], None],
                 host: str | None = None, interval_s: float = 1.0,
                 settings_fn=None, idle_probe: Callable[[], bool] = None,
                 suspend_action: Callable[[], None] | None = None,
                 resume_action: Callable[[], None] | None = None,
                 extra_metrics: Callable[[], Mapping[str, Any]] | None = None,
                 clock: Callable[[], float] = time.time,
                 device="cuda") -> None:
        from ..core.config import get_settings

        self.host = host or socket.gethostname()
        self.submit = submit
        self.interval_s = interval_s
        #: the device this node encodes on: the cards ("cuda") or, for
        #: a node run on its CPU, "cpu" (sample_device_metrics)
        self.device = device
        #: optional per-process gauge source merged into every
        #: heartbeat — the worker daemon reports its shard counters
        #: (busy/done/failed) through this seam (cluster/remote.py)
        self._extra_metrics = extra_metrics
        self._settings_fn = settings_fn or get_settings
        self._idle_probe = idle_probe or (lambda: False)
        self._suspend_action = suspend_action
        #: inverse of suspend_action (the reference's WoL wake from
        #: the node's own point of view): fires ONCE when a suspended
        #: episode ends — work arrived, the operator toggled
        #: suspend_enabled off mid-episode, or resume() was called
        #: explicitly (the capacity controller's wake path)
        self._resume_action = resume_action
        self._clock = clock
        self._idle_since: float | None = None
        self._suspended_this_episode = False
        #: guards the idle-episode state: tick() is public (tests and
        #: embedding code call it directly) while _loop ticks on the
        #: agent thread — without this the check-and-set on
        #: _suspended_this_episode can fire suspend_action twice per
        #: episode (`cli.py check` TVT-T001)
        self._gate_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.role = "encode"

    # -- one tick ------------------------------------------------------

    def tick(self) -> dict[str, Any]:
        """Sample + submit one heartbeat; run the idle gate. Returns the
        metrics submitted (tests introspect it). Sampling errors degrade
        to a minimal heartbeat — a failed /proc read must never kill
        the liveness signal."""
        metrics: dict[str, Any] = {"role": self.role, "ts": self._clock()}
        samplers = [sample_host_metrics,
                    lambda: sample_device_metrics(self.device)]
        if self._extra_metrics is not None:
            samplers.append(self._extra_metrics)
        for sampler in samplers:
            try:
                metrics.update(sampler())
            except Exception:            # noqa: BLE001 - degrade, don't die
                pass
        try:
            self.submit(self.host, metrics)
        except Exception:                # noqa: BLE001 - keep sampling;
            pass                         # the TTL marks us dead anyway
        self._idle_gate(metrics)
        return metrics

    def _idle_gate(self, metrics: Mapping[str, Any]) -> None:
        snap = self._settings_fn()
        idle = False
        if bool(snap.get("suspend_enabled", False)):
            cpu_ok = float(metrics.get("cpu", 100.0)) \
                <= float(snap.get("suspend_cpu_pct", 20.0))
            idle = cpu_ok and self._idle_probe()
        now = self._clock()
        fire = False
        resume = False
        with self._gate_lock:
            if not idle:
                # episode over — work arrived OR suspend_enabled was
                # toggled off mid-episode. Either way the gate RE-ARMS
                # (fresh idle window next time), and a suspended
                # episode ends CLEANLY: resume_action fires once, the
                # inverse the idle gate never had.
                resume = self._suspended_this_episode \
                    and self._resume_action is not None
                self._idle_since = None
                self._suspended_this_episode = False
            elif self._idle_since is None:
                self._idle_since = now
            elif (now - self._idle_since
                    >= float(snap.get("suspend_idle_s", 300))
                    and not self._suspended_this_episode
                    and self._suspend_action is not None):
                self._suspended_this_episode = True
                fire = True
        if fire:
            # outside the lock: the action may suspend the host —
            # holding the gate across it would stall a concurrent tick
            self._suspend_action()
        if resume:
            self._resume_action()

    # -- episode state (the capacity controller's poll seam) -----------

    def episode_state(self) -> dict[str, Any]:
        """Point-in-time idle-episode facts: whether this agent's
        suspend_action has fired for the current episode, and since
        when the node has been idle. The capacity controller (or any
        manager) polls this instead of guessing from metrics."""
        with self._gate_lock:
            return {"suspended": self._suspended_this_episode,
                    "idle_since": self._idle_since}

    def resume(self) -> bool:
        """Explicitly end a suspended episode (the controller's wake
        path, or an operator kick): fires resume_action once and
        re-arms the idle gate. Returns True when an episode actually
        ended; False when nothing was suspended."""
        with self._gate_lock:
            if not self._suspended_this_episode:
                return False
            self._suspended_this_episode = False
            self._idle_since = None
            action = self._resume_action
        if action is not None:
            action()
        return True

    # -- loop ----------------------------------------------------------

    def start(self) -> "NodeAgent":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"tvt-agent-{self.host}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:            # noqa: BLE001 - the loop IS the
                pass                     # liveness signal; never die

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
