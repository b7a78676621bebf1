"""Activity / event log.

Port of the reference's tracing substrate:
JSON events pushed to a capped global deque plus compact per-job lines, with a
stage→label classifier. The reference kept these in Redis lists
(``activity:log`` cap 2000, ``joblog:<id>`` cap 50000); here they are
in-process ring buffers owned by the coordinator and served over its API.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Iterable

_STAGE_LABELS = [
    ("error", "ERROR"),
    ("fail", "ERROR"),
    ("quarantine", "ERROR"),
    ("segment", "SEGMENT"),
    ("shard", "ENCODE"),
    ("claim", "ENCODE"),
    ("split", "SEGMENT"),
    ("encode", "ENCODE"),
    ("stitch", "STITCH"),
    ("concat", "STITCH"),
    ("finish", "FINISH"),
    ("done", "FINISH"),
    ("start", "START"),
    ("stamp", "STAMP"),
]


def activity_label(stage: str) -> str:
    s = (stage or "").lower()
    for needle, label in _STAGE_LABELS:
        if needle in s:
            return label
    return "INFO"


class ActivityLog:
    """Thread-safe capped event log with per-job sublogs.

    With `path` set, events append as JSON lines and construction
    replays the last `cap` of them (rebuilding per-job sublogs), so a
    coordinator restart keeps its activity history — the role the Redis
    ``activity:log`` list played for the reference. The file is
    truncated back to `cap` events on open and rotated back to `cap`
    whenever it reaches 4x that, so it never grows unbounded.
    Persistence caveat vs the reference: per-job sublogs (`job_cap`) are
    durable only as far as their events fall inside the global file
    window — the reference kept each ``joblog:<id>`` independently in
    Redis; here older per-job lines survive a restart only in memory.
    """

    def __init__(self, cap: int = 2000, job_cap: int = 50000,
                 path: str | None = None) -> None:
        self._lock = threading.Lock()
        self._events: collections.deque[dict[str, Any]] = collections.deque(maxlen=cap)
        self._job_logs: dict[str, collections.deque[str]] = {}
        self._job_cap = job_cap
        self._cap = cap
        self._path = path
        self._file: Any = None
        self._lockfile: Any = None
        self._file_lines = 0
        if path:
            self._replay(cap)

    def _replay(self, cap: int) -> None:
        import fcntl
        import json
        import os

        # Exclusive-own the backing file (sidecar lock, same rationale
        # as JobStore's journal lock): a second log on this path would
        # rotate the file out from under this one's append handle.
        self._lockfile = open(self._path + ".lock", "w")
        try:
            fcntl.flock(self._lockfile, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lockfile.close()
            self._lockfile = None
            raise RuntimeError(
                f"activity log {self._path} is owned by another log "
                "(close() it first)")

        events: list[dict[str, Any]] = []
        if os.path.exists(self._path):
            with open(self._path, encoding="utf-8") as fh:
                for line in fh:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        continue              # torn tail write
        events = events[-cap:]
        for event in events:                  # oldest → newest
            self._events.appendleft(event)
            job_id = event.get("job_id")
            if job_id is not None:
                self._job_logs.setdefault(
                    job_id, collections.deque(maxlen=self._job_cap)
                ).append(self._format_line(event))
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for event in events:
                fh.write(json.dumps(event, default=str) + "\n")
        os.replace(tmp, self._path)
        self._file = open(self._path, "a", encoding="utf-8")
        self._file_lines = len(events)

    def emit(
        self,
        stage: str,
        message: str,
        job_id: str | None = None,
        host: str | None = None,
        **fields: Any,
    ) -> dict[str, Any]:
        event = {
            "ts": time.time(),
            "stage": stage,
            "label": activity_label(stage),
            "message": message,
            "job_id": job_id,
            "host": host,
        }
        event.update(fields)
        with self._lock:
            self._events.appendleft(event)
            if job_id is not None:
                log = self._job_logs.setdefault(
                    job_id, collections.deque(maxlen=self._job_cap)
                )
                log.append(self._format_line(event))
            if self._file is not None:
                import json

                self._file.write(json.dumps(event, default=str) + "\n")
                self._file.flush()
                self._file_lines += 1
                if self._file_lines >= 4 * self._cap:
                    self._rotate_locked()
        return event

    def _rotate_locked(self) -> None:
        """Rewrite the file with just the in-memory (capped) events."""
        import json
        import os

        self._file.close()
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for event in reversed(self._events):       # oldest first
                fh.write(json.dumps(event, default=str) + "\n")
        os.replace(tmp, self._path)
        self._file = open(self._path, "a", encoding="utf-8")
        self._file_lines = len(self._events)

    def close(self) -> None:
        """Release the backing file handle + lock (persistent logs
        only)."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if self._lockfile is not None:
                import fcntl

                fcntl.flock(self._lockfile, fcntl.LOCK_UN)
                self._lockfile.close()
                self._lockfile = None

    @staticmethod
    def _format_line(event: dict[str, Any]) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(event["ts"]))
        host = event.get("host") or "-"
        extra = ""
        if "part" in event:
            extra += f" part={event['part']}"
        if "elapsed_ms" in event:
            extra += f" {event['elapsed_ms']:.0f}ms"
        return f"{ts} {event['label']:<8} {host} {event['message']}{extra}"

    def fetch(self, limit: int = 100) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)[:limit]

    def fetch_job(self, job_id: str, limit: int = 500) -> list[str]:
        with self._lock:
            log = self._job_logs.get(job_id)
            if not log:
                return []
            return list(log)[-limit:]

    def drop_job(self, job_id: str) -> None:
        with self._lock:
            self._job_logs.pop(job_id, None)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._job_logs.clear()


def merge_events(logs: Iterable[ActivityLog], limit: int = 100) -> list[dict[str, Any]]:
    merged: list[dict[str, Any]] = []
    for log in logs:
        merged.extend(log.fetch(limit))
    merged.sort(key=lambda e: e["ts"], reverse=True)
    return merged[:limit]
