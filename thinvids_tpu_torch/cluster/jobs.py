"""Typed job records + thread-safe store.

The reference kept each job as a ~60-field Redis hash (`job:<uuid>`,
manager/app.py:2367-2370) indexed by a `jobs:all` set;
this is the typed in-process
equivalent with the same lifecycle fields: status, per-stage progress,
run-token fence, heartbeat triple, and failure attribution.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Iterator, Mapping

from ..core.status import Status
from ..core.types import ChromaFormat, VideoMeta


def new_run_token() -> str:
    """Fencing token minted per dispatch; stale executors no-op when
    their token no longer matches (the reference's pipeline_run_token,
    worker/tasks.py:396-424)."""
    return uuid.uuid4().hex


@dataclasses.dataclass
class Job:
    """One transcode job. Mutate only through JobStore.update()."""

    id: str
    input_path: str
    meta: VideoMeta | None = None
    status: Status = Status.READY
    # what the job produces: "transcode" = single-rendition MP4,
    # "ladder" = the ABR rendition set packaged as HLS (abr/),
    # "live" = LL-HLS ladder tailed from a GROWING source — output
    # (the served playlist tree) becomes available DURING the run,
    # not at completion (live/)
    job_type: str = "transcode"
    # settings overlay (core.config.JOB_SETTING_KEYS subset)
    settings: dict[str, Any] = dataclasses.field(default_factory=dict)
    # tenant namespace (farm/tenancy.py): resolved at registration
    # from the per-job `tenant` setting, the `<tenant>__name` filename
    # prefix, or the cluster default — the fair-share admission key
    # and the per-tenant metrics label
    tenant: str = "default"
    # admission decision (policy.py): the remote backend encodes
    # "direct" jobs whole on the coordinator mesh instead of farming
    # split shards (cluster/remote.py)
    processing_mode: str = "split"       # split | direct
    reject_reason: str = ""
    # scheduling / fencing
    run_token: str = ""
    queued_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    created_at: float = dataclasses.field(default_factory=time.time)
    # progress (percent 0-100, parts = GOP segments)
    segment_progress: float = 0.0
    encode_progress: float = 0.0
    combine_progress: float = 0.0
    parts_total: int = 0
    parts_done: int = 0
    # parts re-dispatched after a worker failure/timeout (remote
    # backend) or wave retry — the farm-health signal the dashboard
    # surfaces next to parts_done
    parts_retried: int = 0
    # heartbeat (throttled writes; watchdog liveness source)
    heartbeat_at: float = 0.0
    heartbeat_stage: str = ""
    heartbeat_host: str = ""
    heartbeat_note: str = ""
    # failure attribution
    failure_stage: str = ""
    failure_host: str = ""
    failure_reason: str = ""
    # result
    output_path: str = ""
    output_bytes: int = 0
    elapsed_s: float = 0.0

    @property
    def done_ratio(self) -> float:
        if self.parts_total <= 0:
            return 0.0
        return self.parts_done / self.parts_total

    def to_dict(self) -> dict[str, Any]:
        """JSON-clean view (enums → names) for the API/store layers."""
        d = dataclasses.asdict(self)
        d["status"] = self.status.value
        if self.meta is not None:
            meta = dataclasses.asdict(self.meta)
            meta["chroma"] = self.meta.chroma.name
            d["meta"] = meta
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Job":
        """Inverse of to_dict (the journal restore path). Unknown keys
        are dropped so old journals survive field additions."""
        data = dict(d)
        raw_status = data.get("status")
        try:
            data["status"] = Status.parse(raw_status)
        except ValueError:
            # A corrupted persisted status must never silently become
            # schedulable again (core/status.py contract) — surface it
            # as a failed job with attribution instead.
            data["status"] = Status.FAILED
            data.setdefault("failure_stage", "restore")
            data["failure_reason"] = (
                f"corrupt persisted status {raw_status!r}")
        meta = data.get("meta")
        if meta is not None:
            meta = dict(meta)
            meta["chroma"] = ChromaFormat[meta.get("chroma", "YUV420")]
            known_m = {f.name for f in dataclasses.fields(VideoMeta)}
            data["meta"] = VideoMeta(
                **{k: v for k, v in meta.items() if k in known_m})
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


class JobStore:
    """Thread-safe job index, optionally journal-backed.

    The update() path takes the store lock and hands the caller the live
    record — the analog of the reference's HSET read-modify-write under
    its scheduler lock. Snapshots returned by get()/list() are copies.

    With `path` set, every mutation appends a JSON line
    (``{"op": "put"|"del", ...}``) to the journal, and construction
    replays it — the durable-state role Redis played for the reference
    (SURVEY.md §5.4: the job hash IS the job's checkpoint). The journal
    is compacted to one line per live job on open and whenever it grows
    past ~10x the live set.
    """

    def __init__(self, path: str | None = None) -> None:
        self._lock = threading.RLock()
        self._jobs: dict[str, Job] = {}
        self._path = path
        self._journal: Any = None
        self._lockfile: Any = None
        self._journal_lines = 0
        self._closed = False
        if path:
            self._acquire_lockfile()
            try:
                # construction is single-threaded, but `_jobs` is
                # lock-guarded state (TVT-T004): hold the lock so the
                # replay/compact sites follow the same discipline as
                # every other access
                with self._lock:
                    self._replay_locked()
                    self._compact_locked()
            except BaseException:
                self.close()           # don't leak the flock on failure
                raise

    def _acquire_lockfile(self) -> None:
        """Exclusive-own the journal via flock on a sidecar lock file
        (never replaced, so compaction can't orphan the lock). A second
        store over the same path would otherwise os.replace the journal
        out from under the first one's append handle — both would then
        'durably' write divergent state."""
        import fcntl

        self._lockfile = open(self._path + ".lock", "w")
        try:
            fcntl.flock(self._lockfile, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lockfile.close()
            self._lockfile = None
            raise RuntimeError(
                f"job journal {self._path} is owned by another store "
                "(close() it first)")

    def close(self) -> None:
        """Release the journal handle and ownership lock. Further
        mutations raise — a closed store must never silently reopen the
        journal without the lock."""
        with self._lock:
            self._closed = True
            if self._journal is not None:
                self._journal.close()
                self._journal = None
            if self._lockfile is not None:
                import fcntl

                fcntl.flock(self._lockfile, fcntl.LOCK_UN)
                self._lockfile.close()
                self._lockfile = None

    # -- journal -------------------------------------------------------

    def _replay_locked(self) -> None:
        """Replay the journal into `_jobs`. A coordinator SIGKILLed
        mid-append leaves a torn final line (any byte prefix of the
        record): the intact prefix replays and the torn tail is
        physically TRUNCATED — appending after a torn, newline-less
        tail would weld the next record onto it and lose BOTH. Bad
        lines in the middle of the file (bit rot) are skipped, never
        truncated: the records after them are still good."""
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as fh:
            data = fh.read()
        pos = 0
        good_end = 0                  # byte offset after the last
        while pos < len(data):        # cleanly replayed line
            nl = data.find(b"\n", pos)
            end = len(data) if nl < 0 else nl + 1
            line = data[pos:end].strip()
            pos = end
            if not line:
                good_end = end
                continue
            try:
                rec = json.loads(line)
                if rec.get("op") == "put":
                    job = Job.from_dict(rec["job"])
                    self._jobs[job.id] = job
                elif rec.get("op") == "del":
                    self._jobs.pop(rec.get("id"), None)
            except Exception:         # noqa: BLE001 - skip the one bad
                continue              # record (torn write / bit rot),
                                      # never abort the whole replay
            # an unterminated final line that still parses is a record
            # whose newline alone was lost — accept it, but leave
            # good_end behind it so the rewrite below re-terminates
            if nl >= 0:
                good_end = end
        if good_end < len(data):
            # torn tail (or a parsed-but-unterminated last record):
            # truncate to the last clean boundary; the compaction that
            # follows construction rewrites live state anyway
            with open(self._path, "r+b") as fh:
                fh.truncate(good_end)

    def _compact_locked(self) -> None:
        """Rewrite the journal as one put per live job (atomic rename)."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for job in self._jobs.values():
                fh.write(json.dumps({"op": "put", "job": job.to_dict()})
                         + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path)
        self._journal = open(self._path, "a", encoding="utf-8")
        self._journal_lines = len(self._jobs)

    def _log_locked(self, rec: dict[str, Any]) -> None:
        if not self._path:
            return
        if self._closed:
            raise RuntimeError(
                "JobStore is closed; mutation after close() would write "
                "the journal without the ownership lock")
        if self._journal is None:
            self._journal = open(self._path, "a", encoding="utf-8")
        self._journal.write(json.dumps(rec) + "\n")
        self._journal.flush()
        self._journal_lines += 1
        if self._journal_lines > max(1000, 10 * len(self._jobs)):
            self._compact_locked()

    def _log_put_locked(self, job: Job) -> None:
        self._log_locked({"op": "put", "job": job.to_dict()})

    def create(self, input_path: str, meta: VideoMeta | None = None,
               settings: Mapping[str, Any] | None = None,
               job_id: str | None = None,
               job_type: str = "transcode",
               tenant: str = "default") -> Job:
        job = Job(id=job_id or uuid.uuid4().hex, input_path=input_path,
                  meta=meta, settings=dict(settings or {}),
                  job_type=job_type, tenant=tenant)
        with self._lock:
            if job.id in self._jobs:
                raise ValueError(f"duplicate job id {job.id}")
            self._jobs[job.id] = job
            self._log_put_locked(job)
        return self.get(job.id)

    def get(self, job_id: str) -> Job:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"no such job {job_id}")
            return dataclasses.replace(job)

    def try_get(self, job_id: str) -> Job | None:
        try:
            return self.get(job_id)
        except KeyError:
            return None

    def update(self, job_id: str, fn: Callable[[Job], None]) -> Job:
        """Apply `fn` to the live record under the store lock; returns a
        snapshot of the result."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"no such job {job_id}")
            fn(job)
            self._log_put_locked(job)
            return dataclasses.replace(job)

    def delete(self, job_id: str) -> bool:
        with self._lock:
            gone = self._jobs.pop(job_id, None) is not None
            if gone:
                self._log_locked({"op": "del", "id": job_id})
            return gone

    def list(self, status: Status | None = None) -> list[Job]:
        with self._lock:
            jobs = [dataclasses.replace(j) for j in self._jobs.values()]
        if status is not None:
            jobs = [j for j in jobs if j.status is status]
        return sorted(jobs, key=lambda j: j.created_at)

    def __iter__(self) -> Iterator[Job]:
        return iter(self.list())

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)

    def all_idle(self) -> bool:
        """True iff no job is WAITING or active (the reference's
        all_jobs_are_idle, common.py:231-274)."""
        with self._lock:
            return not any(
                j.status is Status.WAITING or j.status.is_active
                for j in self._jobs.values())
