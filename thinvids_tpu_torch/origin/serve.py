"""Origin response planning + LL-HLS blocking-reload machinery.

`plan_file` turns one request (method, Range, If-None-Match) against
one on-disk resource into a :class:`ServePlan` — status, headers, and
either an in-memory body (hot-cache hit) or a (offset, length) disk
window the HTTP layer streams in chunks. It implements the origin
contract a fronting CDN keys on: strong ETags on everything,
`If-None-Match` → 304, single-range RFC 7233 requests → 206 with
`Content-Range` (multi-range falls back to a full 200, which the RFC
permits), unsatisfiable ranges → 416, and HEAD everywhere so players
and CDNs can probe sizes without downloading.

The LL-HLS half bounds the blocking-reload path: `ReloadGate` caps the
waiters one job may pin (beyond the cap the API answers 503 +
`Retry-After` instead of eating a server thread), and
`PlaylistEdgeWatcher` replaces per-request disk polling with ONE
poller per watched playlist — N waiters on a hot live stream cost one
20 ms file read, not N.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable

from ..obs import metrics as obs_metrics
from .cache import HotSegmentCache, stat_etag


class RangeError(ValueError):
    """Requested range cannot be satisfied (HTTP 416)."""


def parse_range(header: str | None, size: int) -> tuple[int, int] | None:
    """RFC 7233 single byte-range → (offset, length), or None to serve
    the full body (no/foreign/multi range — a multi-range response
    would need multipart/byteranges framing; serving 200 instead is
    spec-legal). Raises :class:`RangeError` when the range is
    syntactically valid but unsatisfiable against `size`."""
    if not header:
        return None
    unit, _, spec = header.partition("=")
    if unit.strip().lower() != "bytes" or "," in spec:
        return None
    start_s, dash, end_s = spec.strip().partition("-")
    if not dash:
        return None
    start_s, end_s = start_s.strip(), end_s.strip()
    try:
        if not start_s:
            # suffix form: last N bytes
            n = int(end_s)
            if n <= 0 or size == 0:
                raise RangeError(header)
            n = min(n, size)
            return size - n, n
        start = int(start_s)
        if start >= size:
            raise RangeError(header)
        end = size - 1 if not end_s else min(int(end_s), size - 1)
        if end < start:
            raise RangeError(header)
        return start, end - start + 1
    except ValueError as exc:
        if isinstance(exc, RangeError):
            raise
        return None


@dataclasses.dataclass
class ServePlan:
    """Resolved response for one file request. `body` set = send those
    bytes (cache hit / empty 304/416); `body` None = stream
    `length` bytes from the file starting at `offset`."""

    status: int
    headers: dict[str, str]
    size: int                       # full representation size
    body: bytes | None = None
    offset: int = 0
    length: int = 0


def _etag_matches(header: str, etag: str) -> bool:
    if header.strip() == "*":
        return True
    # weak-compare per RFC 7232 §3.2: If-None-Match uses weak
    # comparison, so W/ prefixes are stripped on both sides
    candidates = [c.strip() for c in header.split(",")]
    strip = lambda t: t[2:] if t.startswith("W/") else t    # noqa: E731
    return strip(etag) in (strip(c) for c in candidates)


def plan_file(path: str, *, method: str = "GET",
              req_headers=None, headers: dict[str, str] | None = None,
              cache: HotSegmentCache | None = None,
              stats: "OriginStats | None" = None) -> ServePlan:
    """Plan the response for `path`. `headers` are the route's extra
    response headers (Cache-Control); `req_headers` is any mapping with
    .get (the live http.client headers object or a plain dict). Pass
    `cache` only for content-immutable resources (segments / init
    boxes) — playlists must come through with cache=None so every
    request re-reads the rewritten file. Raises OSError when the file
    is unreadable (the API maps that to 404)."""
    req_headers = req_headers or {}
    st = os.stat(path)
    size = st.st_size
    entry = None
    if cache is not None:
        entry = cache.get((path, st.st_mtime_ns, size), path, size)
    etag = entry.etag if entry is not None \
        else stat_etag(st.st_mtime_ns, size)
    out = dict(headers or {})
    out["ETag"] = etag
    out["Accept-Ranges"] = "bytes"
    if stats is not None:
        stats.bump("origin_requests")

    inm = req_headers.get("If-None-Match")
    if inm and _etag_matches(inm, etag):
        if stats is not None:
            stats.bump("origin_304s")
        return ServePlan(status=304, headers=out, size=size, body=b"")

    try:
        rng = parse_range(req_headers.get("Range"), size)
    except RangeError:
        out["Content-Range"] = f"bytes */{size}"
        return ServePlan(status=416, headers=out, size=size, body=b"")

    status, offset, length = 200, 0, size
    if rng is not None:
        offset, length = rng
        status = 206
        out["Content-Range"] = \
            f"bytes {offset}-{offset + length - 1}/{size}"
    if stats is not None and method != "HEAD":
        stats.bump("origin_bytes", length)
    body = entry.data[offset:offset + length] if entry is not None \
        else None
    return ServePlan(status=status, headers=out, size=size, body=body,
                     offset=offset, length=length)


class OriginStats:
    """Monotonic origin counters (stage_ms-style, exported through
    /metrics_snapshot)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = {"origin_requests": 0, "origin_bytes": 0,
                        "origin_304s": 0, "origin_503s": 0}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
        metric = obs_metrics.ORIGIN_COUNTERS.get(key)
        if metric is not None:
            metric.inc(n)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


class SessionGauge:
    """Concurrent player sessions per job: a session is any distinct
    (job, session-key) with activity inside the sliding window. The
    key is the client's `X-Tvt-Session` header when it sends one (the
    loadgen does), else its socket address."""

    def __init__(self, window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        self._seen: dict[str, dict[str, float]] = {}

    def record(self, job_id: str, session_key: str) -> None:
        now = self._clock()
        with self._lock:
            sessions = self._seen.setdefault(job_id, {})
            sessions[session_key] = now
            # amortized prune keeps an abandoned job's map bounded
            if len(sessions) % 512 == 0:
                self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        for job_id in list(self._seen):
            sessions = self._seen[job_id]
            for key in [k for k, t in sessions.items() if t < horizon]:
                del sessions[key]
            if not sessions:
                del self._seen[job_id]

    def concurrent(self) -> dict[str, int]:
        with self._lock:
            self._prune_locked(self._clock())
            return {job: len(s) for job, s in self._seen.items()}


class ReloadGate:
    """Per-job cap on concurrent LL-HLS blocking-reload waiters.

    Each blocked reload pins one server thread for up to the hold
    budget; unbounded, a few hundred players on a dead stream exhaust
    the process. `try_enter` refuses past the cap (`limit_fn`, the
    live `origin_max_waiters` setting) and the API answers 503 +
    Retry-After — a spec-legal signal players back off on."""

    def __init__(self, limit_fn: Callable[[], int]) -> None:
        self._limit_fn = limit_fn
        self._lock = threading.Lock()
        self._waiters: dict[str, int] = {}

    def try_enter(self, job_id: str) -> bool:
        limit = max(1, int(self._limit_fn()))
        with self._lock:
            n = self._waiters.get(job_id, 0)
            if n >= limit:
                return False
            self._waiters[job_id] = n + 1
            return True

    def leave(self, job_id: str) -> None:
        with self._lock:
            n = self._waiters.get(job_id, 0) - 1
            if n <= 0:
                self._waiters.pop(job_id, None)
            else:
                self._waiters[job_id] = n

    def waiters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._waiters)

    def total(self) -> int:
        with self._lock:
            return sum(self._waiters.values())


class _Watch:
    """Shared state for one watched playlist path."""

    __slots__ = ("cond", "state", "waiters", "closed")

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.state: dict | None = None
        self.waiters = 0
        self.closed = False


class PlaylistEdgeWatcher:
    """One disk poller per watched playlist, shared by every waiter.

    The old blocking-reload loop re-opened and re-parsed the playlist
    every 20 ms **per request**; with hundreds of players blocked on
    the same live edge that is hundreds of redundant reads per tick.
    Here the first waiter spawns a poller thread for the path, later
    waiters ride the same parsed state via a condition variable, and
    the poller exits when the last waiter leaves."""

    POLL_S = 0.02

    def __init__(self, parse: Callable[[str], dict] | None = None) -> None:
        if parse is None:
            from ..abr.hls import live_playlist_state as parse
        self._parse = parse
        self._lock = threading.Lock()
        self._watches: dict[str, _Watch] = {}

    @staticmethod
    def satisfied(st: dict | None, want_msn: int,
                  want_part: int | None) -> bool:
        """The RFC 8216bis §6.2.5.2 release condition: the edge reached
        (msn, part), or the stream ended."""
        if st is None:
            return False
        if st["ended"] or want_msn < st["next_msn"]:
            return True
        return (want_part is not None and want_msn == st["next_msn"]
                and want_part < st["next_part"])

    def _read_state(self, path: str) -> dict | None:
        try:
            with open(path, encoding="utf-8") as fp:
                return self._parse(fp.read())
        except (OSError, ValueError):
            return None

    def _enter(self, path: str) -> _Watch:
        with self._lock:
            watch = self._watches.get(path)
            spawn = watch is None
            if spawn:
                watch = self._watches[path] = _Watch()
            watch.waiters += 1
        if spawn:
            threading.Thread(target=self._poll_loop, args=(path, watch),
                             daemon=True, name="tvt-edge-watch").start()
        return watch

    def _leave(self, path: str, watch: _Watch) -> None:
        with self._lock:
            watch.waiters -= 1

    def _poll_done(self, path: str, watch: _Watch) -> bool:
        """Atomically retire the watch when its last waiter left (the
        check and the removal must be one step, or a waiter arriving
        in between would hold a watch nobody polls)."""
        with self._lock:
            if watch.waiters <= 0:
                self._watches.pop(path, None)
                watch.closed = True
                return True
            return False

    def _poll_loop(self, path: str, watch: _Watch) -> None:
        while True:
            st = self._read_state(path)
            with watch.cond:
                watch.state = st
                watch.cond.notify_all()
            if self._poll_done(path, watch):
                return
            time.sleep(self.POLL_S)

    def wait_edge(self, path: str, want_msn: int, want_part: int | None,
                  timeout_s: float) -> bool:
        """Block until the playlist at `path` satisfies (msn, part),
        the stream ends, or `timeout_s` expires. Returns whether the
        release condition was met (timeout → False)."""
        # fast path: already satisfied — no watch, no poller
        if self.satisfied(self._read_state(path), want_msn, want_part):
            return True
        deadline = time.monotonic() + timeout_s
        watch = self._enter(path)
        try:
            with watch.cond:
                while True:
                    if self.satisfied(watch.state, want_msn, want_part):
                        return True
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or watch.closed:
                        return False
                    watch.cond.wait(min(remaining, 0.25))
        finally:
            self._leave(path, watch)


class Origin:
    """The API server's origin bundle: hot-segment cache, request
    counters, per-job session gauges, and the bounded blocking-reload
    machinery — one instance per :class:`~..api.server.ApiServer`,
    reading its knobs live from the coordinator's settings."""

    def __init__(self, settings_fn) -> None:
        self._settings_fn = settings_fn
        self.cache = HotSegmentCache(
            lambda: int(settings_fn().get("origin_cache_bytes", 0) or 0))
        self.stats = OriginStats()
        self.sessions = SessionGauge()
        self.gate = ReloadGate(
            lambda: int(settings_fn().get("origin_max_waiters", 64) or 64))
        self.watcher = PlaylistEdgeWatcher()

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        out.update(self.cache.snapshot())
        out["blocked_reload_waiters"] = self.gate.total()
        out["sessions"] = self.sessions.concurrent()
        return out
