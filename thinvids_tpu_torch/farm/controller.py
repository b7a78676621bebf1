"""CapacityController: the farm's breathing loop.

Watches demand — queue depth on the remote shard board weighted by QoS
class, plus WAITING jobs the scheduler has not dispatched yet — and
drives worker hosts through the explicit lifecycle
(farm/lifecycle.py: ACTIVE → DRAINING → SUSPENDED → WAKING → ACTIVE)
via the pluggable provider seam (farm/provider.py): the board's
lease/requeue, preemption without attempt burn, per-label metrics and
the lease protocol composed into operations.

Policy (one tick, everything on the injected clock, autoscale gated by
``autoscale_enabled``):

- **demand**: ``ceil(Σ pending-shard class-weights / 2 +
  Σ waiting-job class-weights)`` workers, clamped to
  [``farm_min_workers``, ``farm_max_workers``] (live=4 > ladder=2 >
  batch=1 — a live backlog wakes the farm harder than a batch one).
- **scale up**: un-drain DRAINING hosts first (cheapest — they are
  still hot), then wake SUSPENDED ones, then provision new hosts up to
  ``farm_max_workers`` (``wake()`` on a fresh ``<prefix>N`` name — the
  subprocess provider spawns a daemon; a cloud provider creates a VM).
- **scale down / graceful drain**: surplus ACTIVE hosts (idlest first,
  by lease count) move to DRAINING — ``ShardBoard.claim`` refuses them
  from that instant — and SUSPEND only once their lease set is empty.
  A drain stuck past ``drain_grace_s`` requeues the host's leases
  (``ShardBoard.requeue_host`` — QoS-preemption semantics: NO attempt
  burn, no backoff, the late part still wins) and then suspends.
- **wake convergence**: a WAKING host becomes ACTIVE on its first
  heartbeat (or its first claim — ``claim_allowed`` promotes it); a
  wake that produces no heartbeat within ``drain_grace_s`` falls back
  to SUSPENDED so the next tick retries.
- **crash absorption**: an ACTIVE host whose heartbeat goes stale
  (chaos kill, power loss) is drained; a dark host's drain completes
  without provider confirmation — there is nothing left to power off —
  so demand re-wakes a replacement on the next tick.

``farm_active_worker_s`` (worker-seconds of non-SUSPENDED lifetime) is
accumulated here — the energy-proportionality figure the autoscale
bench reports against the always-on baseline.

Lock order: the board's lock may nest THIS controller's lock
(``claim`` → ``claim_allowed``); therefore tick() never touches the
board while holding its own lock (observe first, decide under the
lock, act through the provider outside it).

torch- and jax-free by contract.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

from ..core.status import Status
from ..obs import metrics as obs_metrics
from .lifecycle import WorkerState
from .provider import CallableProvider, NullProvider

if TYPE_CHECKING:    # pragma: no cover - typing only
    from ..cluster.coordinator import Coordinator
    from ..cluster.remote import ShardBoard

#: QoS class weight in the demand formula (rank → weight): a live
#: shard asks for capacity 4x as loudly as a batch one
CLASS_WEIGHT = {0: 4.0, 1: 2.0, 2: 1.0}

#: target steady-state shards per ACTIVE worker (matches the remote
#: planner's ~2-shards-per-worker auto split)
SHARDS_PER_WORKER = 2.0


@dataclasses.dataclass
class _Rec:
    """Per-host lifecycle record (guarded by the controller lock)."""

    host: str
    lifecycle: WorkerState = WorkerState.ACTIVE
    since: float = 0.0            # entered current lifecycle state at
    wake_at: float = 0.0          # last wake() fired at (WAKING budget)


class CapacityController:
    """Coordinator-side capacity controller over the worker farm."""

    def __init__(self, coordinator: "Coordinator",
                 provider: CallableProvider | None = None,
                 board: "ShardBoard | None" = None,
                 clock: Callable[[], float] = time.time,
                 host_prefix: str = "farm-w") -> None:
        self.coordinator = coordinator
        self.provider = provider if provider is not None else NullProvider()
        self.board = board
        self.host_prefix = host_prefix
        self._clock = clock
        self._lock = threading.Lock()
        self._recs: dict[str, _Rec] = {}
        self._active_worker_s = 0.0
        self._last_tick: float | None = None
        self._last_want = 0
        self._minted = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- board-facing gate (called UNDER the board lock) ---------------

    def claim_allowed(self, host: str) -> bool:
        """May this host take a shard right now? DRAINING/SUSPENDED
        hosts never claim (the model-checked invariant); a WAKING
        host's claim is proof it is up, so the claim itself promotes
        it. Hosts the controller does not manage claim freely."""
        with self._lock:
            rec = self._recs.get(host)
            if rec is None:
                return True
            if rec.lifecycle is WorkerState.WAKING:
                rec.lifecycle = WorkerState.ACTIVE
                rec.since = self._clock()
            return rec.lifecycle.may_claim

    # -- one tick ------------------------------------------------------

    def tick(self) -> dict[str, Any]:
        """One control-loop pass; returns the decision snapshot (tests
        and /metrics_snapshot introspect it)."""
        now = self._clock()
        snap = self.coordinator._settings_fn()
        enabled = bool(snap.get("autoscale_enabled", False))
        ttl = float(snap.metrics_ttl_s)
        grace = float(snap.get("drain_grace_s", 30.0))
        lo = max(0, int(snap.get("farm_min_workers", 0)))
        hi = int(snap.get("farm_max_workers", 0))

        # ---- observe (no controller lock): registry + board facts ----
        live: set[str] = set()
        seen: dict[str, float] = {}
        for w in self.coordinator.registry.all():
            if w.disabled or not w.metrics.get("worker"):
                continue
            seen[w.host] = w.last_seen
            if now - w.last_seen <= ttl:
                live.add(w.host)
        demand = self._demand(now)
        want = min(hi, max(lo, demand)) if hi > 0 else max(lo, demand)
        # one locked pass over the board — per-host polls would take
        # the board lock once per worker per tick
        leases = self.board.host_lease_counts() \
            if self.board is not None else {}

        # ---- bookkeeping + decisions (controller lock) ---------------
        to_wake: list[str] = []
        to_suspend: list[str] = []
        to_requeue: list[str] = []
        with self._lock:
            dt = max(0.0, now - self._last_tick) \
                if self._last_tick is not None else 0.0
            self._last_tick = now
            for host in live:
                if host not in self._recs:
                    self._recs[host] = _Rec(host=host, since=now)
            for rec in self._recs.values():
                # a promotion needs a heartbeat RECEIVED AFTER the
                # state was entered: the registry row stays TTL-fresh
                # for a while after a suspend, and that stale echo
                # must not resurrect the host
                hb_after = rec.host in live and \
                    seen.get(rec.host, 0.0) > rec.since
                if rec.lifecycle is WorkerState.WAKING and hb_after:
                    rec.lifecycle = WorkerState.ACTIVE
                    rec.since = now
                elif rec.lifecycle is WorkerState.SUSPENDED and hb_after:
                    # operator-started host rejoining on its own
                    rec.lifecycle = WorkerState.ACTIVE
                    rec.since = now
                elif rec.lifecycle is WorkerState.WAKING and \
                        now - rec.wake_at > grace:
                    # wake never landed: back to SUSPENDED, retry later
                    rec.lifecycle = WorkerState.SUSPENDED
                    rec.since = now
            on = sum(1 for r in self._recs.values()
                     if r.lifecycle.is_on and
                     (r.host in live or r.lifecycle is WorkerState.WAKING))
            self._active_worker_s += on * dt
            obs_metrics.FARM_WORKER_SECONDS.inc(on * dt)
            self._last_want = want

            if enabled:
                self._plan_locked(now, live, leases, want, grace,
                                  to_wake, to_suspend, to_requeue)
            counts = self._counts_locked()

        # ---- act (provider calls outside every lock) -----------------
        for host in to_requeue:
            if self.board is not None:
                n = self.board.requeue_host(host)
                if n:
                    self.coordinator.activity.emit(
                        "farm", f"drain grace expired on {host}: "
                        f"{n} leases requeued (no attempt burned)",
                        host=host)
        for host in to_suspend:
            if self.board is not None and host not in to_requeue and \
                    self.board.host_leases(host) > 0:
                # the plan's lease snapshot predates the DRAINING
                # transition — a claim granted in that window would be
                # stranded by this suspend (the model's
                # drain-strands-lease invariant). DRAINING refuses new
                # claims, so this re-read is race-free; the next tick
                # suspends once the late lease drains.
                continue
            ok = self.provider.suspend(host)
            if not ok and host in live:
                continue        # still up and provider refused: retry
            with self._lock:
                rec = self._recs.get(host)
                if rec is not None and \
                        rec.lifecycle is WorkerState.DRAINING:
                    rec.lifecycle = WorkerState.SUSPENDED
                    # fresh clock read: the provider call above blocks
                    # (SIGTERM + wait), and the dying daemon's final
                    # heartbeats land AFTER tick-start `now` — stamping
                    # `now` would let that echo pass the seen>since
                    # guard and resurrect a dead host
                    rec.since = self._clock()
            self.coordinator.activity.emit(
                "farm", f"worker {host} suspended (drained)", host=host)
        for host in to_wake:
            try:
                ok = self.provider.wake(host)
            except Exception:   # noqa: BLE001 - a broken provider must
                ok = False      # not kill the control loop
            if not ok:
                continue
            # same rationale as the suspend stamp: wake() may block,
            # and the WAKING budget must start when the wake LANDED
            woke_at = self._clock()
            with self._lock:
                rec = self._recs.get(host)
                if rec is None:
                    # freshly provisioned host: its record is born
                    # WAKING (a declared construction-time state)
                    self._recs[host] = _Rec(
                        host=host, lifecycle=WorkerState.WAKING,
                        since=woke_at, wake_at=woke_at)
                elif rec.lifecycle is WorkerState.SUSPENDED:
                    rec.lifecycle = WorkerState.WAKING
                    rec.since = woke_at
                    rec.wake_at = woke_at
            self.coordinator.activity.emit(
                "farm", f"waking worker {host} (demand {demand}, "
                f"want {want})", host=host)
        return {"enabled": enabled, "demand": demand, "want": want,
                "counts": counts, "woke": to_wake,
                "suspended": to_suspend}

    def _plan_locked(self, now: float, live: set[str],
                     leases: dict[str, int], want: int, grace: float,
                     to_wake: list[str], to_suspend: list[str],
                     to_requeue: list[str]) -> None:
        """Decide transitions toward `want` ACTIVE workers. Writes the
        cheap edges (drain / un-drain) directly; wake/suspend are
        provider-confirmed, so those land in the action lists and
        commit after the call succeeds."""
        active = [r for r in self._recs.values()
                  if r.lifecycle is WorkerState.ACTIVE]
        waking = [r for r in self._recs.values()
                  if r.lifecycle is WorkerState.WAKING]
        draining = [r for r in self._recs.values()
                    if r.lifecycle is WorkerState.DRAINING]
        suspended = [r for r in self._recs.values()
                     if r.lifecycle is WorkerState.SUSPENDED]

        # crash absorption: an ACTIVE host gone dark cannot encode;
        # drain it (its leases are already being swept by the board's
        # heartbeat-TTL requeue) so the capacity math stops counting it
        for rec in list(active):
            if rec.host not in live:
                if rec.lifecycle is WorkerState.ACTIVE:
                    rec.lifecycle = WorkerState.DRAINING
                    rec.since = now
                active.remove(rec)
                draining.append(rec)

        up = len(active) + len(waking)
        if up < want:
            # cheapest capacity first: cancel drains, then wake, then
            # provision new hosts up to the cap
            for rec in sorted(draining, key=lambda r: r.host):
                if up >= want:
                    break
                if rec.host in live and \
                        rec.lifecycle is WorkerState.DRAINING:
                    rec.lifecycle = WorkerState.ACTIVE
                    rec.since = now
                    up += 1
            for rec in sorted(suspended, key=lambda r: r.host):
                if up >= want:
                    break
                to_wake.append(rec.host)
                up += 1
            while up < want:
                self._minted += 1
                to_wake.append(f"{self.host_prefix}{self._minted}")
                up += 1
        elif len(active) > want:
            # drain the idlest surplus (fewest leases; stable by host)
            surplus = sorted(
                active, key=lambda r: (leases.get(r.host, 0), r.host))
            for rec in surplus[:len(active) - want]:
                if rec.lifecycle is WorkerState.ACTIVE:
                    rec.lifecycle = WorkerState.DRAINING
                    rec.since = now

        # drain completion: suspend once the lease set is empty; a
        # drain stuck past its grace requeues the leases first (QoS
        # preemption semantics — no attempt burned)
        for rec in self._recs.values():
            if rec.lifecycle is not WorkerState.DRAINING:
                continue
            held = leases.get(rec.host, 0)
            if held == 0:
                to_suspend.append(rec.host)
            elif now - rec.since > grace:
                to_requeue.append(rec.host)
                to_suspend.append(rec.host)

    # -- demand --------------------------------------------------------

    def _demand(self, now: float) -> int:
        """Workers demanded by the current queue: pending shards on
        the board (class-weighted, ~2 per worker) plus class-weighted
        WAITING jobs not yet sharded."""
        weighted = 0.0
        if self.board is not None:
            for rank, n in self.board.queue_depth(now).items():
                weighted += n * CLASS_WEIGHT.get(rank, 1.0) \
                    / SHARDS_PER_WORKER
        snap = self.coordinator._settings_fn()
        for job in self.coordinator.store.list(Status.WAITING):
            rank = self.coordinator._job_rank(job, snap)
            weighted += CLASS_WEIGHT.get(rank, 1.0)
        return int(math.ceil(weighted))

    # -- introspection -------------------------------------------------

    def _hosts(self) -> list[str]:
        with self._lock:
            return list(self._recs)

    def _counts_locked(self) -> dict[str, int]:
        counts = {s.value: 0 for s in WorkerState}
        for rec in self._recs.values():
            counts[rec.lifecycle.value] += 1
        return counts

    def lifecycle_of(self, host: str) -> WorkerState | None:
        with self._lock:
            rec = self._recs.get(host)
            return rec.lifecycle if rec is not None else None

    def active_worker_seconds(self) -> float:
        """Cumulative non-SUSPENDED worker-seconds — the
        ``farm_active_worker_s`` energy figure (vs. always-on =
        farm size × wall clock)."""
        with self._lock:
            return self._active_worker_s

    def snapshot(self) -> dict[str, Any]:
        """Farm panel / /metrics_snapshot view."""
        with self._lock:
            return {
                "workers": {h: r.lifecycle.value
                            for h, r in sorted(self._recs.items())},
                "counts": self._counts_locked(),
                "want": self._last_want,
                "active_worker_s": round(self._active_worker_s, 3),
            }

    # -- background loop -----------------------------------------------

    def start(self, poll_s: float = 1.0) -> "CapacityController":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(poll_s,), daemon=True,
            name="tvt-farm")
        self._thread.start()
        return self

    def _loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 - the control loop IS
                pass            # the farm's liveness; never die

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
