"""Durable shard-part spool + per-job board checkpoint.

The reference survives manager restarts because *everything* lives in
Redis — "the job hash IS the job's checkpoint" (SURVEY §5.4) — and the
encoded part payloads live on the stitcher's disk, not in a process
heap. Until this module, the repro journaled only the Job records:
every completed shard's encoded bytes sat solely in coordinator RAM
(``shard.segments``), so a coordinator crash threw away hours of farm
work and ``recover_jobs`` could only restart from scratch.

Two durable pieces, both torch- and jax-free (this module runs on coordinator
control-plane threads only):

- **Part spool** — ``spool()`` + ``commit()`` stream one accepted
  part's payload to ``<root>/<job>/<key>.part`` (the `pack_parts` wire
  framing, digests included) via temp file + fsync + atomic rename, so
  a crash can never leave a torn part that later verifies. The board
  then holds a :class:`PartRef` (path + per-segment sha256 + size)
  instead of the bytes — DONE shards stop pinning payload in RAM.

- **Board checkpoint** — a per-job append journal
  (``<root>/<job>.board.jsonl``) with the same flock / append /
  compact discipline as ``JobStore``: one ``plan`` record (the full
  deterministic shard plan + a plan signature over the inputs that
  change encoded bytes) followed by one ``done`` record per accepted
  part. ``load_job`` replays it; ``begin_job`` re-anchors it — keeping
  the done map when the signature still matches (crash-resume) and
  resetting it when it doesn't (settings/input changed: stale parts
  must never rehydrate).

Integrity is end-to-end: refs carry the digests recorded at ACCEPT
time (the sidecar manifest), and ``read_part`` re-hashes the spooled
payloads against them before any byte reaches the stitcher — a flipped
bit on disk surfaces as :class:`PartIntegrityError`, never as corrupt
output. The same digests ride the ``/work`` wire framing so transfer
corruption is rejected at ingest (cluster/remote.py `unpack_parts`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Iterable, Mapping

from ..obs import metrics as obs_metrics


class PartIntegrityError(ValueError):
    """A part's payload no longer matches its recorded sha256 — a
    transfer or storage fault, never a worker fault (rejections must
    not burn shard attempts or quarantine accounting)."""


def segment_sha256(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


@dataclasses.dataclass(frozen=True)
class PartRef:
    """Durable reference to one spooled part: what the board holds
    instead of the encoded bytes."""

    job_id: str
    key: str                      # run-stable shard plan key
    path: str
    digests: tuple[str, ...]      # per-segment payload sha256
    nbytes: int

    def to_dict(self) -> dict[str, Any]:
        return {"key": self.key, "path": self.path,
                "digests": list(self.digests), "nbytes": self.nbytes}


@dataclasses.dataclass
class JobCheckpoint:
    """Replayed view of one job's board journal."""

    plan: dict[str, Any]          # the deterministic shard plan record
    done: dict[str, PartRef]      # plan key → accepted part


class PartStore:
    """Thread-safe spool + checkpoint store rooted at one directory.

    Exclusive-owned via flock on a sidecar lock file (the JobStore
    discipline): two coordinators spooling into the same root would
    both "durably" record divergent state. The lock releases on
    process death, so a SIGKILLed coordinator's successor opens the
    same root cleanly.
    """

    def __init__(self, root: str,
                 clock: Callable[[], float] = time.time) -> None:
        self.root = root
        self._clock = clock
        self._lock = threading.Lock()
        #: job_id → open append handle for the job's board journal
        self._journals: dict[str, Any] = {}
        self._spool_bytes = 0
        self._closed = False
        os.makedirs(root, exist_ok=True)
        self._acquire_lockfile()
        # restart: the gauge must reflect what already sits on disk
        with self._lock:
            self._spool_bytes = self._scan_spool_bytes()
            self._set_gauge_locked()

    # -- ownership -----------------------------------------------------

    def _acquire_lockfile(self) -> None:
        import fcntl

        self._lockfile = open(os.path.join(self.root, ".lock"), "w")
        try:
            fcntl.flock(self._lockfile, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lockfile.close()
            self._lockfile = None
            raise RuntimeError(
                f"part spool {self.root} is owned by another store "
                "(close() it first)")

    def close(self) -> None:
        """Release journal handles + the ownership flock. Spooled
        parts and journals stay on disk — they ARE the checkpoint a
        successor store resumes from."""
        import fcntl

        with self._lock:
            self._closed = True
            for fh in self._journals.values():
                fh.close()
            self._journals.clear()
            if self._lockfile is not None:
                fcntl.flock(self._lockfile, fcntl.LOCK_UN)
                self._lockfile.close()
                self._lockfile = None

    # -- paths ---------------------------------------------------------

    def _journal_path(self, job_id: str) -> str:
        return os.path.join(self.root, f"{job_id}.board.jsonl")

    def _spool_dir(self, job_id: str) -> str:
        return os.path.join(self.root, job_id)

    def _scan_spool_bytes(self) -> int:
        total = 0
        try:
            with os.scandir(self.root) as it:
                dirs = [e.path for e in it if e.is_dir()]
        except OSError:
            return 0
        for d in dirs:
            try:
                with os.scandir(d) as it:
                    total += sum(e.stat().st_size for e in it
                                 if e.name.endswith(".part"))
            except OSError:
                continue
        return total

    def _set_gauge_locked(self) -> None:
        obs_metrics.PART_SPOOL_BYTES.set(self._spool_bytes)

    def spool_bytes(self) -> int:
        with self._lock:
            return self._spool_bytes

    # -- journal (flock/append/compact, per job) -----------------------

    def _append_locked(self, job_id: str, rec: Mapping[str, Any]) -> None:
        if self._closed:
            raise RuntimeError(
                "PartStore is closed; a write now would journal "
                "without the ownership lock")
        fh = self._journals.get(job_id)
        if fh is None:
            fh = self._journals[job_id] = open(
                self._journal_path(job_id), "a", encoding="utf-8")
        fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

    def _rewrite_locked(self, job_id: str, plan: Mapping[str, Any],
                        done: Iterable[PartRef]) -> None:
        """Compact: one plan line + the retained done lines, committed
        by atomic rename (a crash mid-compact keeps the old journal)."""
        fh = self._journals.pop(job_id, None)
        if fh is not None:
            fh.close()
        path = self._journal_path(job_id)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as out:
            out.write(json.dumps({"op": "plan", "plan": dict(plan)},
                                 separators=(",", ":")) + "\n")
            for ref in done:
                out.write(json.dumps({"op": "done", **ref.to_dict()},
                                     separators=(",", ":")) + "\n")
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)

    def load_job(self, job_id: str) -> JobCheckpoint | None:
        """Replay one job's board journal: the latest plan record plus
        the done map recorded under it. Torn tails (a coordinator
        killed mid-append) replay as the intact prefix — one bad line
        never discards the checkpoint. None when no journal exists or
        no plan record survives."""
        path = self._journal_path(job_id)
        if not os.path.exists(path):
            return None
        plan: dict[str, Any] | None = None
        done: dict[str, PartRef] = {}
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue          # torn/rotted line: skip, keep prefix
                if rec.get("op") == "plan":
                    plan = rec.get("plan") or {}
                    done = {}         # a plan line re-anchors the job
                elif rec.get("op") == "drop":
                    done.pop(str(rec.get("key")), None)
                elif rec.get("op") == "done" and plan is not None:
                    try:
                        done[str(rec["key"])] = PartRef(
                            job_id=job_id, key=str(rec["key"]),
                            path=str(rec["path"]),
                            digests=tuple(str(d)
                                          for d in rec["digests"]),
                            nbytes=int(rec["nbytes"]))
                    except (KeyError, TypeError, ValueError):
                        continue      # malformed record: worth nothing
        if plan is None:
            return None
        return JobCheckpoint(plan=plan, done=done)

    def begin_job(self, job_id: str,
                  plan: Mapping[str, Any]) -> dict[str, PartRef]:
        """(Re-)anchor a job's checkpoint at `plan`. When the existing
        journal's plan signature matches ``plan["sig"]``, the done
        records for keys still in the plan are RETAINED and returned —
        the crash-resume path rehydrates from them (after verifying
        the spooled bytes). Any other case (no journal, signature
        drift, keys that left the plan) resets: stale parts encoded
        under different settings must never rehydrate, so their spool
        files are dropped with the records."""
        ck = self.load_job(job_id)
        keys = {str(s["key"]) for s in plan.get("shards", ())}
        retained: dict[str, PartRef] = {}
        dropped: list[PartRef] = []
        if ck is not None and ck.plan.get("sig") == plan.get("sig"):
            for key, ref in ck.done.items():
                if key in keys and os.path.exists(ref.path):
                    retained[key] = ref
                else:
                    dropped.append(ref)
        elif ck is not None:
            dropped.extend(ck.done.values())
        with self._lock:
            self._rewrite_locked(job_id, plan, retained.values())
            for ref in dropped:
                self._unlink_part_locked(ref.path)
            # sweep spool files no retained record names (orphans from
            # a crash between rename and journal append, or a stale
            # plan's leftovers)
            keep = {os.path.realpath(r.path) for r in retained.values()}
            sdir = self._spool_dir(job_id)
            try:
                with os.scandir(sdir) as it:
                    orphans = [e.path for e in it
                               if e.name.endswith(".part")
                               and os.path.realpath(e.path) not in keep]
            except OSError:
                orphans = []
            for p in orphans:
                self._unlink_part_locked(p)
            self._set_gauge_locked()
        return retained

    # -- spool ---------------------------------------------------------

    @staticmethod
    def _frame_digests(data: bytes, segments) -> tuple[str, ...]:
        """Per-segment digests lifted from the `pack_parts` header —
        already computed by the sender and (on the ingest path)
        already VERIFIED by unpack_parts, so spooling never re-hashes
        the payloads. Records without a digest (pre-digest workers)
        hash their payload here as the fallback."""
        hlen = int.from_bytes(data[:4], "big")
        header = json.loads(data[4:4 + hlen])
        out = []
        for rec, seg in zip(header["segments"], segments):
            d = rec.get("sha256")
            out.append(str(d) if d else segment_sha256(seg.payload))
        return tuple(out)

    def spool(self, job_id: str, key: str, segments,
              data: bytes | None = None) -> tuple[PartRef, str]:
        """Stream one part to a job-scoped temp file (the `pack_parts`
        framing, digests embedded), fsync'd. `data` — when the caller
        already holds the exact wire bytes (the /work ingest path) —
        is spooled verbatim instead of re-serializing the segments.
        Returns the (ref, temp path); the caller either
        :meth:`commit`\\ s it under its own acceptance lock or
        :meth:`discard`\\ s it. The final path is keyed by the
        run-STABLE plan key, so a resumed run finds the part
        regardless of the run token."""
        if data is None:
            from .remote import pack_parts

            data = pack_parts(segments)
        digests = self._frame_digests(data, segments)
        sdir = self._spool_dir(job_id)
        os.makedirs(sdir, exist_ok=True)
        path = os.path.join(sdir, f"{key}.part")
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as fp:
            fp.write(data)
            fp.flush()
            os.fsync(fp.fileno())
        return PartRef(job_id=job_id, key=key, path=path,
                       digests=digests, nbytes=len(data)), tmp

    def commit(self, ref: PartRef, tmp: str) -> None:
        """Atomically publish a spooled temp into place and journal the
        done record. Rename-before-journal: a crash between the two
        leaves an orphan part file (reaped by the next begin_job), a
        journal record can never point at missing bytes."""
        with self._lock:
            had = 0
            try:
                had = os.stat(ref.path).st_size
            except OSError:
                pass
            os.replace(tmp, ref.path)
            self._spool_bytes += ref.nbytes - had
            self._append_locked(ref.job_id, {"op": "done",
                                             **ref.to_dict()})
            self._set_gauge_locked()

    def discard(self, tmp: str) -> None:
        """Drop an uncommitted spool temp (the board refused the part:
        duplicate after DONE, superseded entry)."""
        try:
            os.unlink(tmp)
        except OSError:
            pass

    def _unlink_part_locked(self, path: str) -> None:
        try:
            size = os.stat(path).st_size
            os.unlink(path)
            self._spool_bytes -= size
        except OSError:
            pass

    # -- read-back + verification --------------------------------------

    def read_part(self, ref: PartRef, verify: bool = True):
        """Load one spooled part back into EncodedSegments. With
        `verify` (the default), every payload is re-hashed against the
        digests recorded at accept time — the stitcher's last gate, so
        a bit that flipped on disk raises :class:`PartIntegrityError`
        instead of landing in the output tree."""
        from .remote import unpack_parts

        try:
            with open(ref.path, "rb") as fp:
                data = fp.read()
        except OSError as exc:
            raise PartIntegrityError(
                f"spooled part {ref.path} unreadable: {exc}")
        try:
            # the wire framing's own digest check runs here too when
            # verifying (defense in depth: header rot raises, not
            # mis-parses)
            segments = unpack_parts(data, verify=verify)
        except PartIntegrityError:
            raise
        except ValueError as exc:
            raise PartIntegrityError(
                f"spooled part {ref.path} is torn: {exc}")
        if verify:
            got = tuple(segment_sha256(s.payload) for s in segments)
            if got != ref.digests:
                raise PartIntegrityError(
                    f"spooled part {ref.path} does not match its "
                    f"recorded digests (storage corruption)")
        return segments

    def verify_part(self, ref: PartRef) -> bool:
        """True iff the spooled part still matches its manifest — the
        resume path's gate before rehydrating a shard as DONE."""
        try:
            self.read_part(ref, verify=True)
            return True
        except PartIntegrityError:
            return False

    def drop_done(self, job_id: str, key: str, ref: PartRef) -> None:
        """Forget one done record (resume verification failed): unlink
        the corrupt part and journal the retraction so a second
        restart does not trust it either."""
        with self._lock:
            self._unlink_part_locked(ref.path)
            self._append_locked(job_id, {"op": "drop", "key": key})
            self._set_gauge_locked()

    def clear_job(self, job_id: str) -> None:
        """Drop a finished job's journal + spool tree (the output is
        committed; the checkpoint has nothing left to protect)."""
        with self._lock:
            fh = self._journals.pop(job_id, None)
            if fh is not None:
                fh.close()
            try:
                os.unlink(self._journal_path(job_id))
            except OSError:
                pass
            sdir = self._spool_dir(job_id)
            freed = 0
            try:
                with os.scandir(sdir) as it:
                    freed = sum(e.stat().st_size for e in it
                                if e.name.endswith(".part"))
            except OSError:
                pass
            shutil.rmtree(sdir, ignore_errors=True)
            self._spool_bytes -= freed
            self._set_gauge_locked()
