"""Watch-folder ingest: processed ledger, size stabilization, discovery.

Port of the reference watcher's semantics:

- `FileLedger` ≙ FileProcessedStore (watcher.py:73-266): a durable
  rel_path → "size:mtime_ns" map as JSON lines, flock-serialized
  appends + fsync, mtime-triggered external-change reload, legacy
  path-only lines adopted lazily.
- `WatchIngester` ≙ periodic_scanner + submit_job_if_stable
  (watcher.py:351-452, 586-673): a file is submitted only after its
  signature has been identical for `stable_checks` consecutive scans
  (the reference polled size 5x at 10 s; here stability is measured in
  scan ticks, which makes tests deterministic),
  deduped through the ledger (marked synchronously on accept).
- `bootstrap_if_first_run` ≙ bootstrap_processed_if_first_run
  (watcher.py:482-503): an empty ledger adopts every existing file
  without submitting, so a fresh deployment doesn't re-transcode the
  whole library.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Iterable

from .decode import supported_exts as decode_supported_exts
from .tail import is_live_name

try:
    import fcntl
except ImportError:                      # non-POSIX: best-effort locking
    fcntl = None


def file_signature(path: str) -> str:
    st = os.stat(path)
    return f"{st.st_size}:{st.st_mtime_ns}"


class FileLedger:
    """Durable processed-file ledger (rel_path → signature)."""

    LEGACY_SIG = ""

    def __init__(self, path: str) -> None:
        self.path = path
        self._entries: dict[str, str] = {}
        self._loaded_mtime_ns: int | None = None
        self._lock = threading.Lock()
        self.reload_if_changed()

    # -- reading -------------------------------------------------------

    def _load(self) -> None:
        entries: dict[str, str] = {}
        try:
            with open(self.path, "r", encoding="utf-8") as fp:
                for line in fp:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        # legacy path-only line (reference
                        # watcher.py:155-170): known, signature unknown
                        entries[line] = self.LEGACY_SIG
                        continue
                    if isinstance(rec, dict) and "path" in rec:
                        entries[str(rec["path"])] = str(rec.get("sig", ""))
                    else:
                        entries[line] = self.LEGACY_SIG
            self._loaded_mtime_ns = os.stat(self.path).st_mtime_ns
        except FileNotFoundError:
            self._loaded_mtime_ns = None
        self._entries = entries

    def reload_if_changed(self) -> bool:
        """Re-read the ledger if another writer changed it on disk."""
        with self._lock:
            try:
                mtime = os.stat(self.path).st_mtime_ns
            except FileNotFoundError:
                mtime = None
            if mtime != self._loaded_mtime_ns:
                self._load()
                return True
            return False

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> dict[str, str]:
        return dict(self._entries)

    def state(self, rel_path: str, sig: str) -> str:
        """'missing' | 'legacy' | 'matched' | 'changed' for a file."""
        have = self._entries.get(rel_path)
        if have is None:
            return "missing"
        if have == self.LEGACY_SIG:
            return "legacy"
        return "matched" if have == sig else "changed"

    # -- writing -------------------------------------------------------

    def mark(self, rel_path: str, sig: str) -> None:
        self.mark_many([(rel_path, sig)])

    def mark_many(self, items) -> None:
        """Append {path, sig} lines under ONE flock + fsync (reference
        watcher.py:113-124; manager/app.py:859-870 uses the same
        protocol for manual submissions). Batching matters for
        bootstrap over a large library — one fsync, not one per file."""
        items = list(items)
        if not items:
            return
        payload = "".join(
            json.dumps({"path": rel, "sig": sig},
                       separators=(",", ":")) + "\n"
            for rel, sig in items)
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fp:
                if fcntl is not None:
                    fcntl.flock(fp.fileno(), fcntl.LOCK_EX)
                try:
                    fp.write(payload)
                    fp.flush()
                    os.fsync(fp.fileno())
                finally:
                    if fcntl is not None:
                        fcntl.flock(fp.fileno(), fcntl.LOCK_UN)
            for rel, sig in items:
                self._entries[rel] = sig
            try:
                self._loaded_mtime_ns = os.stat(self.path).st_mtime_ns
            except FileNotFoundError:
                pass


class WatchIngester:
    """Scans a watch root and submits stabilized, unprocessed files.

    `submit(abs_path, state) -> bool` is the injection point — in
    production :func:`coordinator_submitter`; in tests a recording
    stub. `state` is the ledger verdict for the file ('missing' or
    'changed'), so the submitter can distinguish a first sighting from
    a re-drop with new content. A True return marks the file processed
    in the ledger.
    """

    # Watch exactly what the decode stage can ingest — submitting a
    # file the probe/decoder rejects would never mark the ledger and
    # retry forever. Derived, not hand-synced: widening decode._READERS
    # widens the watch set automatically.
    DEFAULT_EXTS = decode_supported_exts()

    def __init__(self, watch_dir: str, ledger: FileLedger,
                 submit: Callable[[str], bool],
                 exts: Iterable[str] = DEFAULT_EXTS,
                 stable_checks: int = 3) -> None:
        self.watch_dir = os.path.abspath(watch_dir)
        self.ledger = ledger
        self.submit = submit
        self.exts = tuple(e.lower() for e in exts)
        self.stable_checks = max(1, int(stable_checks))
        #: rel_path → (last signature, consecutive identical scans)
        self._stability: dict[str, tuple[str, int]] = {}
        #: serializes whole scans: run() loops on a watcher thread
        #: while scan_once() is public API — two interleaved scans
        #: would double-submit a just-stabilized file between its
        #: submit and its ledger mark (`cli.py check` TVT-T001)
        self._scan_lock = threading.Lock()

    # -- discovery -----------------------------------------------------

    def _discover(self) -> dict[str, str]:
        """rel_path → signature for every candidate file on disk."""
        found: dict[str, str] = {}
        for root, _dirs, files in os.walk(self.watch_dir):
            for name in files:
                if not name.lower().endswith(self.exts):
                    continue
                if name.startswith("."):
                    continue
                abs_path = os.path.join(root, name)
                try:
                    sig = file_signature(abs_path)
                except OSError:
                    continue                     # vanished mid-scan
                found[os.path.relpath(abs_path, self.watch_dir)] = sig
        return found

    def bootstrap_if_first_run(self) -> int:
        """Empty ledger → adopt every existing file without submitting
        (reference watcher.py:482-503). Returns files adopted."""
        self.ledger.reload_if_changed()
        if len(self.ledger):
            return 0
        found = self._discover()
        self.ledger.mark_many(sorted(found.items()))
        return len(found)

    # -- scanning ------------------------------------------------------

    def scan_once(self) -> list[str]:
        """One discovery pass. Returns the rel paths submitted.
        Serialized: concurrent calls run one after the other."""
        with self._scan_lock:
            return self._scan_once_locked()

    def _scan_once_locked(self) -> list[str]:
        self.ledger.reload_if_changed()
        found = self._discover()
        submitted: list[str] = []

        # drop stability state for files that disappeared
        for rel in list(self._stability):
            if rel not in found:
                del self._stability[rel]

        for rel, sig in sorted(found.items()):
            state = self.ledger.state(rel, sig)
            if state == "matched":
                continue
            if state == "legacy":
                # adopt the current signature without re-transcoding
                # (lazy legacy adoption, reference watcher.py:155-170)
                self.ledger.mark(rel, sig)
                continue

            # live-named drops are INGEST STREAMS, not settled files: a
            # growing source never passes the stability gate (its size
            # changes every scan by design), so `.live.` names submit
            # on first sighting and the tail source follows the growth
            # (ingest/tail.py — the watch-folder-as-ingest model
            # generalized to a file that never settles)
            if not is_live_name(rel):
                prev_sig, streak = self._stability.get(rel, (None, 0))
                streak = streak + 1 if sig == prev_sig else 1
                self._stability[rel] = (sig, streak)
                if streak < self.stable_checks:
                    continue                     # still stabilizing

            abs_path = os.path.join(self.watch_dir, rel)
            try:
                accepted = self.submit(abs_path, state)
            except Exception:                    # noqa: BLE001 - keep scanning
                accepted = False
            if accepted:
                # Mark the signature that was OBSERVED stable: if the
                # file changed while the submit ran, the next scan sees
                # 'changed' and requeues the final content.
                self.ledger.mark(rel, sig)
                self._stability.pop(rel, None)   # live names never
                                                 # entered stabilization
                submitted.append(rel)
        return submitted

    def run(self, interval_s: float = 60.0,
            stop: threading.Event | None = None) -> None:
        """Blocking scan loop (the reference scanned every 60 s,
        watcher.py:586-614)."""
        stop = stop or threading.Event()
        while not stop.is_set():
            self.scan_once()
            stop.wait(interval_s)


def coordinator_submitter(coordinator, activity_host: str = "watcher"):
    """submit() implementation targeting an in-process Coordinator:
    probe → add_job (the reference POSTed to /add_job,
    watcher.py:415-428). Unprobeable files are recorded in the activity
    feed and MARKED processed (True) — the reference likewise ledgered
    files whose /add_job came back REJECTED; returning False would
    retry a corrupt file on every scan forever."""
    from .probe import ProbeError, probe_video

    def submit(abs_path: str, state: str = "missing") -> bool:
        # A growing live source keeps changing its ledger signature on
        # every scan; once its live job is registered and not terminal,
        # each new sighting is EXPECTED GROWTH, not a re-drop — ledger
        # the new signature (True) and leave the running tail alone.
        if is_live_name(abs_path) and any(
                j.input_path == abs_path and not j.status.is_terminal
                for j in coordinator.store):
            return True
        try:
            meta = probe_video(abs_path)
        except ProbeError as exc:
            if is_live_name(abs_path):
                # live drop whose header isn't on disk yet: retry on a
                # later scan rather than blacklisting the stream
                return False
            if isinstance(exc.__cause__, OSError):
                # transient I/O (NFS hiccup, EACCES-until-chmod): retry
                # on a later scan — ledgering now would blacklist the
                # file forever since its signature won't change
                return False
            coordinator.activity.emit(
                "reject", f"unprobeable, skipped: {exc}",
                host=activity_host)
            return True
        # A job already registered for this path (manual /add_job, stamp
        # copies written into the watch tree) must not re-queue:
        # returning True ledgers it, the analog of the reference manager
        # writing the watcher ledger for manual submissions
        # (_mark_watcher_processed, app.py:828-870). BUT a re-drop the
        # ledger flags as 'changed' is NEW CONTENT and always
        # re-registers — a path-only dedup swallowed it forever
        # (round-4 open finding), and even probe meta can't tell a
        # same-length re-edit apart; only the ledger's size+mtime
        # signature can. The meta check still guards the 'missing'
        # path: a job for the same path with different probe meta means
        # the ledger lost track of a change.
        if state != "changed" and any(
                j.input_path == abs_path and j.meta == meta
                for j in coordinator.store):
            return True
        # Re-registering: supersede ANY non-terminal job on this path
        # (whether the ledger said 'changed' or the meta mismatch on a
        # 'missing' re-probe revealed it) — a run already encoding this
        # path holds the OLD content in memory and would commit a stale
        # output file over the new cut's (both derive
        # library/<basename>.mp4); stopping it fences its run token.
        for j in coordinator.store:
            if j.input_path == abs_path and not j.status.is_terminal:
                coordinator.stop_job(j.id)
                coordinator.activity.emit(
                    "stop", "superseded by re-dropped file with "
                    "changed content", job_id=j.id, host=activity_host)
        job = coordinator.add_job(abs_path, meta)
        return job is not None

    return submit
