"""Coordinator: worker liveness, capacity-gated scheduling, watchdog.

Semantics ported from the reference manager's background threads:

- **Liveness**: workers (executor processes owning a device mesh — the
  analog of thin-client nodes) heartbeat into a registry; active =
  heartbeat within the metrics TTL. Roles mirror the reference's
  pipeline/encode split.
- **Admission**: a WAITING job is dispatched only when every active job
  is "shareable" (RUNNING, segmentation done, encode drain >= ratio),
  slot accounting leaves headroom (STARTING or segmenting jobs hold 2
  slots = master+stitcher analog, draining jobs hold 1), and enough
  idle workers remain.
- **Fencing**: each dispatch mints a run token; executor callbacks that
  present a stale token are ignored.
- **Watchdog**: active jobs whose heartbeat goes stale past the
  per-stage budget are failed with stage/host attribution and the next
  job is dispatched.

The scheduler lock is an in-process RLock (the reference needed a Redis
SET NX EX lock because several gunicorn workers raced; a single
coordinator process needs only mutual exclusion between its threads).
Time is injected (`clock`) so every budget is testable with a fake
clock.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Callable, Mapping

from ..core.config import Settings, get_settings, overlay_job_settings
from ..core.events import ActivityLog
from ..core.status import Status
from ..core.types import VideoMeta
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .jobs import Job, JobStore, new_run_token
from .policy import evaluate_job_policy
from .qos import QosController, job_rank


def natural_key(host: str) -> tuple:
    """Numeric-aware host sort (the reference's natural_key,
    common.py:163-166)."""
    return tuple(int(p) if p.isdigit() else p
                 for p in re.split(r"(\d+)", host))


@dataclasses.dataclass
class WorkerInfo:
    host: str
    role: str = "encode"            # pipeline | encode
    last_seen: float = 0.0
    disabled: bool = False
    quarantine_reason: str = ""
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    # remote-shard accounting (cluster/remote.py): lifetime counters
    # plus the consecutive-failure streak the quarantine gate reads
    shards_done: int = 0
    shards_failed: int = 0
    consecutive_failures: int = 0


class WorkerRegistry:
    """Executor liveness registry (the analog of `nodes:mac` +
    `metrics:node:*` TTL liveness, agent/agent.py:417-436
    and manager/app.py:42-102)."""

    def __init__(self, clock: Callable[[], float] = time.time) -> None:
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerInfo] = {}
        self._clock = clock

    def heartbeat(self, host: str, metrics: Mapping[str, Any] | None = None,
                  now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            info = self._workers.setdefault(host, WorkerInfo(host=host))
            info.last_seen = now
            if metrics:
                info.metrics = dict(metrics)

    def assign_roles(self, pipeline_count: int) -> dict[str, str]:
        """First `pipeline_count` enabled hosts (natural sort) take the
        pipeline role, the rest encode."""
        with self._lock:
            hosts = sorted(
                (h for h, w in self._workers.items() if not w.disabled),
                key=natural_key)
            roles = {}
            for i, host in enumerate(hosts):
                role = "pipeline" if i < pipeline_count else "encode"
                self._workers[host].role = role
                roles[host] = role
            return roles

    def active(self, ttl_s: float, now: float | None = None
               ) -> list[WorkerInfo]:
        now = self._clock() if now is None else now
        with self._lock:
            return [dataclasses.replace(w) for w in self._workers.values()
                    if not w.disabled and now - w.last_seen <= ttl_s]

    def all(self) -> list[WorkerInfo]:
        with self._lock:
            return [dataclasses.replace(w) for w in self._workers.values()]

    def record_shard_result(self, host: str, ok: bool) -> int:
        """Update a worker's remote-shard counters; returns the
        consecutive-failure streak (the quarantine gate's input). A
        success resets the streak — only an unbroken run of failures
        marks a worker bad (transient hiccups heal themselves)."""
        with self._lock:
            info = self._workers.setdefault(host, WorkerInfo(host=host))
            if ok:
                info.shards_done += 1
                info.consecutive_failures = 0
            else:
                info.shards_failed += 1
                info.consecutive_failures += 1
            return info.consecutive_failures

    def set_disabled(self, host: str, disabled: bool,
                     reason: str = "") -> None:
        with self._lock:
            info = self._workers.setdefault(host, WorkerInfo(host=host))
            info.disabled = disabled
            info.quarantine_reason = reason if disabled else ""

    def delete(self, host: str) -> bool:
        with self._lock:
            return self._workers.pop(host, None) is not None


# Jobs in these states occupy scheduler slots.
_SLOTS_SEGMENTING = 2      # master + stitcher analog
_SLOTS_DRAINING = 1        # stitcher only


class Coordinator:
    """Single-process control plane over a JobStore + WorkerRegistry."""

    def __init__(self, store: JobStore | None = None,
                 registry: WorkerRegistry | None = None,
                 launcher: Callable[[Job], None] | None = None,
                 activity: ActivityLog | None = None,
                 clock: Callable[[], float] = time.time,
                 settings_fn: Callable[[], Settings] = get_settings,
                 state_dir: str | None = None) -> None:
        if state_dir is not None:
            import os

            os.makedirs(state_dir, exist_ok=True)
            if store is None:
                store = JobStore(os.path.join(state_dir, "jobs.jsonl"))
            if activity is None:
                activity = ActivityLog(
                    path=os.path.join(state_dir, "activity.jsonl"))
        self.store = store if store is not None else JobStore()
        self.registry = registry if registry is not None else WorkerRegistry(
            clock=clock)
        self.activity = activity if activity is not None else ActivityLog()
        self._launcher = launcher
        self._clock = clock
        self._settings_fn = settings_fn
        self._sched_lock = threading.RLock()
        self._active_ids: set[str] = set()
        #: QoS state: priority classes + live deadline preemption
        #: (cluster/qos.py). Executors report live part latency here;
        #: the ShardBoard and local wave loops read the batch gate.
        self.qos = QosController()
        #: elastic-farm capacity controller (farm/controller.py),
        #: attached by cli.py when the remote backend runs: the
        #: ShardBoard consults it so DRAINING/SUSPENDED workers never
        #: claim. None = fixed-size farm (every worker claims).
        self.farm = None

    # ---- job registration / lifecycle --------------------------------

    def add_job(self, input_path: str, meta: VideoMeta,
                settings: Mapping[str, Any] | None = None,
                auto_start: bool | None = None,
                job_type: str | None = None) -> Job:
        """Register a job: admission policy → READY/REJECTED; optionally
        queue + dispatch (the reference's POST /add_job,
        manager/app.py:2222-2400).

        `job_type` resolution: explicit argument > the ``name.ladder.ext``
        / ``name.live.ext`` filename conventions (the stem must END with
        the suffix, so a watch-folder drop can opt into the ABR ladder
        or live ingest per file without derived names like
        ``clip.ladder.stamped.y4m`` inheriting it) > the ``job_type``
        setting."""
        import os as _os

        snap = self._settings_fn()
        if job_type is None:
            stem = _os.path.splitext(
                _os.path.basename(input_path))[0].lower()
            if stem.endswith(".ladder"):
                job_type = "ladder"
            elif stem.endswith(".live"):
                job_type = "live"
            else:
                job_type = str(snap.get("job_type", "transcode")
                               or "transcode")
        if job_type not in ("transcode", "ladder", "live"):
            raise ValueError(f"unknown job_type {job_type!r}")
        # tenant namespace (farm/tenancy.py): per-job setting > the
        # <tenant>__name filename prefix > the cluster default
        from ..farm.tenancy import tenant_of

        tenant = tenant_of(
            input_path,
            (settings or {}).get("tenant") or snap.get("tenant", ""))
        decision = evaluate_job_policy(meta, snap)
        job = self.store.create(input_path, meta=meta, settings=settings,
                                job_type=job_type, tenant=tenant)
        if not decision.accepted:
            def reject(j: Job) -> None:
                # freshly created above, so READY is the only possible
                # source — asserted so the READY→REJECTED edge is
                # locally provable (TVT-M001)
                if j.status is not Status.READY:
                    raise ValueError(
                        f"job {j.id} is {j.status.value}, not READY")
                j.status = Status.REJECTED
                j.reject_reason = decision.reason
            job = self.store.update(job.id, reject)
            self.activity.emit("reject", f"rejected: {decision.reason}",
                               job_id=job.id)
            return job

        def apply(j: Job) -> None:
            j.processing_mode = decision.processing_mode
        job = self.store.update(job.id, apply)
        self.activity.emit("start", f"registered {input_path}",
                           job_id=job.id)
        if auto_start if auto_start is not None else snap.auto_start_jobs:
            self.queue_job(job.id)
            self.dispatch_next_waiting_job()
        return self.store.get(job.id)

    def queue_job(self, job_id: str) -> Job:
        now = self._clock()

        def apply(j: Job) -> None:
            if j.status.is_active:
                raise ValueError(f"job {j.id} is {j.status.value}")
            if j.status is Status.REJECTED:
                # admission said no; re-queueing would bypass policy —
                # a rejected job must be re-added to be re-evaluated
                raise ValueError(
                    f"job {j.id} was rejected by admission policy; "
                    f"re-add it to re-evaluate")
            j.status = Status.WAITING
            j.queued_at = now
        job = self.store.update(job_id, apply)
        self.activity.emit("queue", "queued for dispatch", job_id=job_id)
        return job

    def stop_job(self, job_id: str) -> Job:
        changed: list[bool] = []

        def apply(j: Job) -> None:
            if j.status.is_terminal:
                # terminal absorbs: stopping a DONE/FAILED/REJECTED job
                # must not erase its result or failure attribution
                return
            j.status = Status.STOPPED
            j.run_token = ""            # fences out in-flight executors
            changed.append(True)
        job = self.store.update(job_id, apply)
        if not changed:
            return job
        with self._sched_lock:
            self._active_ids.discard(job_id)
        self.qos.clear_live(job_id)
        self.activity.emit("stop", "stopped by operator", job_id=job_id)
        return job

    def restart_job(self, job_id: str) -> Job:
        """Wipe run state and requeue (the reference's /restart_job,
        manager/app.py:2501-2666)."""
        def apply(j: Job) -> None:
            if j.status is Status.REJECTED:
                # restart re-runs the pipeline, not admission — a
                # rejected job must be re-added to be re-evaluated
                raise ValueError(
                    f"job {j.id} was rejected by admission policy; "
                    f"re-add it to re-evaluate")
            j.run_token = ""
            j.segment_progress = 0.0
            j.encode_progress = 0.0
            j.combine_progress = 0.0
            j.parts_total = 0
            j.parts_done = 0
            j.heartbeat_at = 0.0
            j.heartbeat_stage = ""
            j.heartbeat_host = ""
            j.heartbeat_note = ""
            j.failure_stage = ""
            j.failure_host = ""
            j.failure_reason = ""
            j.output_path = ""
            j.output_bytes = 0
            j.started_at = 0.0
            j.finished_at = 0.0
            j.status = Status.READY
        self.store.update(job_id, apply)
        with self._sched_lock:
            self._active_ids.discard(job_id)
        job = self.queue_job(job_id)
        self.dispatch_next_waiting_job()
        return self.store.get(job_id)

    def recover_jobs(self) -> list[str]:
        """Post-restart adoption: any job the journal shows mid-flight
        (STARTING/RUNNING/STAMPING) has no live executor — requeue it,
        exactly as the reference recovered via scheduler adoption +
        watchdog + restart_job wipe. Call once
        after constructing a persistent coordinator. Returns requeued
        job ids.

        With `resume_enabled` (the default) this is the RESUME path,
        not a restart-from-scratch: the requeue keeps the progress
        counters visible (`_requeue_for_recovery`) and the new run's
        executor re-plans deterministically from the durable board
        checkpoint, rehydrating every shard whose spooled part still
        verifies (cluster/partstore.py) — a crashed coordinator costs
        the farm only its in-flight shards, not the finished ones."""
        resume = bool(self._settings_fn().get("resume_enabled", True))
        requeued = []
        for job in self.store.list():
            if job.status.is_active:
                if resume:
                    self.activity.emit(
                        "restart", "requeued for crash-resume after "
                        f"coordinator restart (was {job.status.value})",
                        job_id=job.id)
                    self._requeue_for_recovery(job.id)
                else:
                    self.activity.emit(
                        "restart", "requeued after coordinator restart "
                        f"(was {job.status.value})", job_id=job.id)
                    self.restart_job(job.id)
                requeued.append(job.id)
        # Jobs persisted while merely WAITING also lost their dispatch
        # trigger in the crash — kick the scheduler regardless.
        self.dispatch_next_waiting_job()
        return requeued

    def _requeue_for_recovery(self, job_id: str) -> None:
        """Crash-resume requeue: wipe only the run/fencing state and
        failure attribution; KEEP the progress counters — the resumed
        run's executor rehydrates completed shards from the part spool
        and re-reports progress from there, so zeroing parts_done
        would just flap the dashboard through every recovery."""
        def apply(j: Job) -> None:
            if j.status is Status.REJECTED:
                # same contract as restart_job: recovery re-runs the
                # pipeline, never admission
                raise ValueError(
                    f"job {j.id} was rejected by admission policy; "
                    f"re-add it to re-evaluate")
            j.run_token = ""
            j.heartbeat_at = 0.0
            j.heartbeat_stage = ""
            j.heartbeat_host = ""
            j.heartbeat_note = ""
            j.failure_stage = ""
            j.failure_host = ""
            j.failure_reason = ""
            j.started_at = 0.0
            j.finished_at = 0.0
            j.status = Status.READY
        self.store.update(job_id, apply)
        with self._sched_lock:
            self._active_ids.discard(job_id)
        self.queue_job(job_id)

    def close(self) -> None:
        """Release persistent-state file handles/locks (journal +
        activity). A closed coordinator must not be used further."""
        self.store.close()
        self.activity.close()

    def delete_job(self, job_id: str) -> bool:
        with self._sched_lock:
            self._active_ids.discard(job_id)
        self.qos.clear_live(job_id)
        self.activity.drop_job(job_id)
        return self.store.delete(job_id)

    # ---- executor-facing callbacks (token-fenced) --------------------

    def token_is_current(self, job_id: str, token: str) -> bool:
        job = self.store.try_get(job_id)
        return job is not None and bool(token) and job.run_token == token

    def heartbeat_job(self, job_id: str, token: str, stage: str,
                      host: str = "", note: str = "") -> bool:
        """Throttled heartbeat write (the reference's _job_heartbeat,
        worker/tasks.py:88-123). Returns False when
        fenced out (stale token)."""
        if not self.token_is_current(job_id, token):
            return False
        now = self._clock()
        throttle = float(self._settings_fn().heartbeat_throttle_s)

        def apply(j: Job) -> None:
            if now - j.heartbeat_at < throttle and j.heartbeat_stage == stage:
                return
            j.heartbeat_at = now
            j.heartbeat_stage = stage
            j.heartbeat_host = host
            j.heartbeat_note = note
        self.store.update(job_id, apply)
        return True

    def update_progress(self, job_id: str, token: str, **fields: Any) -> bool:
        """Progress fields from executors; stale tokens are ignored."""
        if not self.token_is_current(job_id, token):
            return False
        allowed = {"segment_progress", "encode_progress", "combine_progress",
                   "parts_total", "parts_done", "parts_retried"}
        bad = set(fields) - allowed
        if bad:
            raise ValueError(f"unknown progress fields {sorted(bad)}")

        def apply(j: Job) -> None:
            for k, v in fields.items():
                # progress is monotonic per run (reference kept monotonic
                # encode_progress, worker/tasks.py:1704-1719)
                if k.endswith("_progress"):
                    v = max(float(v), getattr(j, k))
                setattr(j, k, v)
        self.store.update(job_id, apply)
        return True

    def mark_running(self, job_id: str, token: str) -> bool:
        if not self.token_is_current(job_id, token):
            return False

        def apply(j: Job) -> None:
            # token-fenced already; the status guard makes the edge
            # locally provable (idempotent within a run — a second
            # mark_running while RUNNING is a no-op write)
            if j.status not in (Status.STARTING, Status.RUNNING):
                return
            j.status = Status.RUNNING
        self.store.update(job_id, apply)
        return True

    def note_live_part(self, job_id: str, token: str, latency_s: float,
                       budget_s: float) -> bool:
        """Live executor's per-part deadline report (token-fenced like
        every executor callback): latency over budget preempts batch
        work via the QoS controller; recovery reopens the gate after
        `live_recover_parts` consecutive good parts."""
        if not self.token_is_current(job_id, token):
            return False
        # the latency DISTRIBUTION the bench only spot-samples: every
        # live part observes the fixed-bucket histogram
        obs_metrics.LIVE_PART_SECONDS.observe(latency_s)
        recover = int(self._settings_fn().get("live_recover_parts", 2))
        event = self.qos.note_live_part(job_id, latency_s, budget_s,
                                        recover_parts=recover)
        if event == "breach":
            self.activity.emit(
                "qos", f"live part {latency_s:.2f}s over its "
                f"{budget_s:.2f}s budget — preempting batch work",
                job_id=job_id)
            # postmortem artifact while the evidence is fresh: the
            # breached job's spans + errors + settings
            obs_trace.TRACE.record_error(
                job_id, f"qos breach: live part {latency_s:.2f}s over "
                        f"{budget_s:.2f}s budget")
            breached = self.store.try_get(job_id)
            obs_flight.record(
                job_id, reason=f"qos preemption: live part "
                               f"{latency_s:.2f}s over {budget_s:.2f}s "
                               f"budget",
                settings=self._settings_fn(),
                tenant=getattr(breached, "tenant", ""))
        elif event == "recovered":
            self.activity.emit(
                "qos", "live edge recovered — batch work resumes",
                job_id=job_id)
        return True

    def publish_output(self, job_id: str, token: str,
                       output_path: str) -> bool:
        """Announce a job's output location while it is STILL RUNNING —
        the live pipeline's decoupling of output availability from job
        completion: /hls starts serving the playlist tree the moment
        the packager writes it, not when the stream ends. Token-fenced
        like every executor callback."""
        if not self.token_is_current(job_id, token):
            return False
        self.store.update(job_id, lambda j: setattr(
            j, "output_path", output_path))
        self.activity.emit("publish", f"serving live → {output_path}",
                           job_id=job_id)
        return True

    def complete_job(self, job_id: str, token: str, output_path: str,
                     output_bytes: int) -> bool:
        if not self.token_is_current(job_id, token):
            return False
        now = self._clock()
        changed: list[bool] = []

        def apply(j: Job) -> None:
            if not j.status.is_active:
                # the run's token is still current but the job already
                # left the active set — completion must not resurrect
                # a non-active job
                return
            j.status = Status.DONE
            j.finished_at = now
            j.elapsed_s = now - j.started_at if j.started_at else 0.0
            j.output_path = output_path
            j.output_bytes = output_bytes
            j.combine_progress = 100.0
            changed.append(True)
        self.store.update(job_id, apply)
        if not changed:
            return False
        with self._sched_lock:
            self._active_ids.discard(job_id)
        self.qos.clear_live(job_id)
        self.activity.emit("finish", f"done → {output_path}", job_id=job_id)
        self.dispatch_next_waiting_job()
        return True

    def fail_job(self, job_id: str, token: str, stage: str, host: str,
                 reason: str) -> bool:
        """Executor-reported failure (retry budget exhausted)."""
        if token and not self.token_is_current(job_id, token):
            return False
        self._fail(job_id, stage, host, reason)
        self.dispatch_next_waiting_job()
        return True

    def _fail(self, job_id: str, stage: str, host: str, reason: str) -> None:
        now = self._clock()
        changed: list[bool] = []

        def apply(j: Job) -> None:
            if not j.status.is_active:
                # the watchdog reads the active set as a snapshot: a
                # job that completes (or is stopped) between that read
                # and this write must keep its terminal state — a
                # stale stall verdict must not flip DONE to FAILED
                return
            j.status = Status.FAILED
            j.finished_at = now
            j.run_token = ""            # revoke: fence out stragglers
            j.failure_stage = stage
            j.failure_host = host
            j.failure_reason = reason
            changed.append(True)
        self.store.update(job_id, apply)
        if not changed:
            return
        with self._sched_lock:
            self._active_ids.discard(job_id)
        self.qos.clear_live(job_id)
        self.activity.emit("error", f"failed in {stage}: {reason}",
                           job_id=job_id, host=host)
        # flight recorder: the failed job's recent spans + errors +
        # settings dump beside the output tree so the postmortem does
        # not depend on scraping logs (obs/flight.py; best-effort)
        obs_trace.TRACE.record_error(job_id, f"{stage}: {reason}")
        failed = self.store.try_get(job_id)
        obs_flight.record(job_id,
                          reason=f"job failed in {stage}: {reason}",
                          settings=self._settings_fn(),
                          tenant=getattr(failed, "tenant", ""))

    # ---- scheduler (capacity-gated dispatch) -------------------------

    def job_settings(self, job: Job) -> Settings:
        return overlay_job_settings(self._settings_fn(), job.settings)

    def _active_jobs_locked(self) -> list[Job]:
        """Resolve the active set, adopting orphaned active-status jobs
        and dropping finished ones (the reference's adoption pass,
        manager/app.py:1014-1041)."""
        active: list[Job] = []
        seen: set[str] = set()
        for job in self.store.list():
            if job.status.is_active:
                self._active_ids.add(job.id)
                seen.add(job.id)
                active.append(job)
        self._active_ids &= seen
        return active

    def _job_slots(self, job: Job) -> int:
        if job.status is Status.STARTING or job.segment_progress < 100.0:
            return _SLOTS_SEGMENTING
        return _SLOTS_DRAINING

    def _job_is_shareable(self, job: Job, drain_ratio: float) -> bool:
        """A job tolerates a new neighbor once it is RUNNING, fully
        segmented, and mostly drained."""
        return (job.status is Status.RUNNING
                and job.segment_progress >= 100.0
                and job.done_ratio >= drain_ratio)

    @staticmethod
    def _worker_slots(worker: WorkerInfo) -> int:
        """Scheduler slots one registry row contributes: the host
        itself plus one per accelerator device it reports. Devices
        used to be faked as per-device `{host}-devN` pseudo-nodes in
        the registry (VERDICT Weak #7) — now the device count rides the
        real node's heartbeat metrics and is weighted here instead."""
        try:
            devices = int(worker.metrics.get("devices", 0) or 0)
        except (TypeError, ValueError):
            devices = 0
        return 1 + max(0, devices)

    def _job_rank(self, job: Job, snap: Settings | None = None) -> int:
        """Priority rank (live=0 > ladder=1 > batch=2) from the job's
        type, overridable per job / cluster via `job_priority`."""
        snap = self._settings_fn() if snap is None else snap
        override = str(job.settings.get(
            "job_priority", snap.get("job_priority", "auto")) or "auto")
        return job_rank(getattr(job, "job_type", "transcode"), override)

    def _can_dispatch_locked(self, active: list[Job], snap: Settings,
                             now: float, rank: int = 2
                             ) -> tuple[bool, str]:
        """The per-class admission gate (the reference's capacity gate
        generalized: SURVEY §2.3). `rank` is the candidate's priority
        class — live-class candidates (rank 0) skip the politeness
        checks (neighbor shareability, pipeline-slot and idle-worker
        headroom) that exist to protect batch throughput: a live
        stream's viewers are waiting NOW, and the deadline-preemption
        path reclaims capacity from batch work if admission oversells.
        The hard max_active_jobs cap binds every class."""
        if len(active) >= snap.effective_max_active_jobs():
            return False, "max active jobs reached"
        if rank <= 0:
            return True, ""
        drain = float(snap.drain_ratio)
        for job in active:
            if not self._job_is_shareable(job, drain):
                return False, f"job {job.id[:8]} not shareable yet"
        self.registry.assign_roles(int(snap.pipeline_worker_count))
        workers = self.registry.active(float(snap.metrics_ttl_s), now=now)
        pipeline_slots = sum(self._worker_slots(w) for w in workers
                             if w.role == "pipeline")
        used = sum(self._job_slots(j) for j in active)
        if pipeline_slots < used + _SLOTS_SEGMENTING:
            return False, "no free pipeline slots"
        idle_estimate = sum(self._worker_slots(w) for w in workers) - used
        if idle_estimate < int(snap.min_idle_workers):
            return False, "not enough idle workers"
        return True, ""

    def dispatch_next_waiting_job(self) -> Job | None:
        """One scheduler pass: reserve the best WAITING job — highest
        priority class first (live > ladder > batch, cluster/qos.py),
        most-underserved tenant next (weighted fair share,
        farm/tenancy.py: active-job count ÷ the tenant's
        `tenant_shares` weight — one tenant's backlog cannot starve
        another's first job), oldest within that — when its class's
        admission gate passes, then launch it outside the lock."""
        from ..farm.tenancy import fair_usage, parse_tenant_shares

        now = self._clock()
        snap = self._settings_fn()
        shares = parse_tenant_shares(snap.get("tenant_shares", ""))
        with self._sched_lock:
            active = self._active_jobs_locked()
            waiting = self.store.list(Status.WAITING)
            usage: dict[str, float] = {}
            for j in active:
                t = getattr(j, "tenant", "default") or "default"
                usage[t] = usage.get(t, 0.0) + 1.0
            job = None
            while waiting:
                chosen = min(waiting, key=lambda j: (
                    self._job_rank(j, snap),
                    fair_usage(shares, usage,
                               getattr(j, "tenant", "default")
                               or "default"),
                    j.queued_at or j.created_at))
                ok, _why = self._can_dispatch_locked(
                    active, snap, now, rank=self._job_rank(chosen, snap))
                if not ok:
                    return None
                token = new_run_token()

                def reserve(j: Job) -> None:
                    if j.status is not Status.WAITING:
                        # `waiting` is a snapshot: an operator stop
                        # landing between the list() and this write
                        # must win — a stopped job must not be revived
                        # into STARTING
                        raise ValueError(
                            f"job {j.id} left WAITING before reserve "
                            f"({j.status.value})")
                    j.status = Status.STARTING
                    j.run_token = token
                    j.started_at = now
                    j.heartbeat_at = now
                    j.heartbeat_stage = "reserve"
                try:
                    job = self.store.update(chosen.id, reserve)
                except (ValueError, KeyError):
                    # the chosen job raced out of WAITING (stopped or
                    # deleted): drop it and consider the next candidate
                    waiting = [j for j in waiting if j.id != chosen.id]
                    continue
                break
            if job is None:
                return None
            self._active_ids.add(job.id)
        # fresh distributed trace per dispatch (a restart must not
        # interleave spans with the old run); sampling decided here
        # (trace_sample) — an unsampled job records nothing
        obs_trace.TRACE.start(job.id)
        self.activity.emit("dispatch", "reserved for launch", job_id=job.id)
        if self._launcher is not None:
            self._launcher(job)
        return job

    # ---- watchdog ----------------------------------------------------

    _STALL_BUDGETS = {
        Status.STARTING: "stall_starting_s",
        Status.RUNNING: "stall_running_s",
        Status.STAMPING: "stall_stamping_s",
    }

    def check_stalled_jobs(self) -> list[Job]:
        """Fail active jobs whose heartbeat exceeded the per-stage budget.
        Returns failed jobs."""
        now = self._clock()
        snap = self._settings_fn()
        failed: list[Job] = []
        with self._sched_lock:
            active = self._active_jobs_locked()
        for job in active:
            budget_key = self._STALL_BUDGETS.get(job.status)
            if budget_key is None:
                continue
            budget = float(snap.get(budget_key))
            last = max(job.heartbeat_at, job.started_at)
            if last and now - last > budget:
                self._fail(
                    job.id, stage=job.heartbeat_stage or job.status.value,
                    host=job.heartbeat_host,
                    reason=(f"no heartbeat for {now - last:.0f}s "
                            f"(budget {budget:.0f}s)"))
                failed.append(self.store.get(job.id))
        if failed:
            self.dispatch_next_waiting_job()
        return failed

    # ---- background loops (threads; logic above stays tick-testable) --

    def start_background(self) -> list[threading.Thread]:
        """Spawn the scheduler + watchdog poll loops (the reference's
        daemon threads, manager/app.py:1474-1516)."""
        snap = self._settings_fn()
        self._stop = threading.Event()

        def scheduler_loop() -> None:
            while not self._stop.wait(float(snap.scheduler_poll_s)):
                try:
                    self.dispatch_next_waiting_job()
                except Exception:   # pragma: no cover - keep loop alive
                    pass

        def watchdog_loop() -> None:
            while not self._stop.wait(float(snap.watchdog_poll_s)):
                try:
                    self.check_stalled_jobs()
                except Exception:   # pragma: no cover - keep loop alive
                    pass

        threads = [
            threading.Thread(target=scheduler_loop, daemon=True,
                             name="tvt-scheduler"),
            threading.Thread(target=watchdog_loop, daemon=True,
                             name="tvt-watchdog"),
        ]
        for t in threads:
            t.start()
        return threads

    def stop_background(self) -> None:
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
