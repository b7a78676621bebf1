"""Job QoS: priority classes and deadline-driven batch preemption.

The reference's capacity gate (SURVEY §2.3) admits every job as an
equal; a live origin cannot — a live stream that misses its part
deadline has VIEWERS buffering, while a batch backfill only gets done
later. Two mechanisms, both owned by the coordinator:

- **Priority classes** (live > ladder > batch): the dispatch pass picks
  the highest class first, live-class jobs bypass the politeness gates
  (shareability / idle headroom) that exist to protect batch throughput,
  and the remote ShardBoard hands out claims best-class-first.
- **Deadline preemption**: the live executor reports each part's
  encode+package latency against its budget (`live_part_budget_s`;
  0 = 2x the stream's segment duration). On a breach the controller
  closes the batch gate — ShardBoard requeues ASSIGNED batch shards
  (the remote backend's lease/requeue machinery makes that safe: a
  preempted worker's late part is still accepted, and the encode is
  deterministic so any completed attempt is THE answer) and local
  batch wave loops pause between waves — until `live_recover_parts`
  consecutive parts land back inside budget.
"""

from __future__ import annotations

import threading
from typing import Callable

from ..obs import metrics as obs_metrics

#: priority classes, best first; `auto` derives from the job type
PRIORITY_CLASSES = ("live", "ladder", "batch")
_RANK = {"live": 0, "ladder": 1, "batch": 2}
_TYPE_CLASS = {"live": "live", "ladder": "ladder", "transcode": "batch"}

#: the rank at or below which a job is preemptible batch work
BATCH_RANK = _RANK["batch"]


def job_class(job_type: str, override: str = "auto") -> str:
    """Resolve a job's priority class: the `job_priority` setting when
    it names a class explicitly, else the job type's natural class."""
    if override in _RANK:
        return override
    return _TYPE_CLASS.get(job_type, "batch")


def class_rank(cls: str) -> int:
    """Numeric rank (lower = more urgent); unknown classes are batch."""
    return _RANK.get(cls, BATCH_RANK)


def job_rank(job_type: str, override: str = "auto") -> int:
    return class_rank(job_class(job_type, override))


class QosController:
    """Tracks live-job deadline health and gates batch work.

    `note_live_part` is the executor's per-part report; a breach
    closes the batch gate and fires the registered preempt callbacks
    (the ShardBoard's requeue) ONCE per breach episode. Recovery —
    `recover_parts` consecutive within-budget parts, or the live job
    reaching a terminal state (`clear_live`) — reopens the gate.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._batch_ok = threading.Event()
        self._batch_ok.set()
        self._breached: set[str] = set()
        self._good_parts: dict[str, int] = {}
        self._preempt_cbs: list[Callable[[], int]] = []
        # counters for /metrics_snapshot + tests
        self._breaches = 0
        self._recoveries = 0
        self._preempted_shards = 0

    def on_preempt(self, cb: Callable[[], int]) -> None:
        """Register a preemption hook (returns how many work units it
        requeued). Fired outside the controller's lock."""
        with self._lock:
            self._preempt_cbs.append(cb)

    def note_live_part(self, job_id: str, latency_s: float,
                       budget_s: float, recover_parts: int = 2
                       ) -> str | None:
        """One live part's latency vs its budget. Returns "breach" on
        a new breach episode, "recovered" when the gate reopens, else
        None. budget_s <= 0 disables deadline tracking for the part."""
        if budget_s <= 0:
            return None
        fire = False
        event: str | None = None
        with self._lock:
            if latency_s > budget_s:
                self._good_parts[job_id] = 0
                if job_id not in self._breached:
                    self._breached.add(job_id)
                    self._breaches += 1
                    fire = True
                    event = "breach"
                self._batch_ok.clear()
            elif job_id in self._breached:
                n = self._good_parts.get(job_id, 0) + 1
                self._good_parts[job_id] = n
                if n >= max(1, int(recover_parts)):
                    self._breached.discard(job_id)
                    self._good_parts.pop(job_id, None)
                    self._recoveries += 1
                    event = "recovered"
                    if not self._breached:
                        self._batch_ok.set()
            # gauge published UNDER the lock (the metric child's own
            # leaf lock nests safely): racing events must not publish
            # a stale value last
            if event == "breach":
                obs_metrics.QOS_BREACHES.inc()
            elif event == "recovered":
                obs_metrics.QOS_RECOVERIES.inc()
            if event is not None:
                obs_metrics.QOS_PREEMPTING.set(
                    1 if self._breached else 0)
            cbs = list(self._preempt_cbs) if fire else []
        for cb in cbs:
            try:
                n = int(cb() or 0)
            except Exception:   # noqa: BLE001 - a broken hook must not
                continue        # take down the live encode loop
            if n:
                with self._lock:
                    self._preempted_shards += n
                obs_metrics.QOS_PREEMPTED_SHARDS.inc(n)
        return event

    def clear_live(self, job_id: str) -> None:
        """A live job reached a terminal state: drop its breach (a
        dead stream must not pin the batch gate shut forever)."""
        with self._lock:
            self._breached.discard(job_id)
            self._good_parts.pop(job_id, None)
            if not self._breached:
                self._batch_ok.set()
            # published under the lock — same rationale as
            # note_live_part's gauge write
            obs_metrics.QOS_PREEMPTING.set(1 if self._breached else 0)

    def batch_allowed(self) -> bool:
        return self._batch_ok.is_set()

    def wait_batch_allowed(self, timeout: float | None = None) -> bool:
        return self._batch_ok.wait(timeout)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "preempting": bool(self._breached),
                "breached_jobs": sorted(self._breached),
                "breaches": self._breaches,
                "recoveries": self._recoveries,
                "preempted_shards": self._preempted_shards,
            }
