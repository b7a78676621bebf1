"""In-memory hot-segment cache: bounded bytes, LRU, single-flight fill.

The origin's working set is tiny and hot — the live edge's last few
parts and whatever VOD segments the fronting CDN is currently missing —
so a byte-bounded LRU over whole segment bodies removes the disk from
the common path entirely. The cache is **immutable-aware by contract**:
callers only put content-immutable resources through it (fMP4 segments
and init boxes, which always get a NEW uri when content changes;
playlists rewrite in place every part and must never come through
here). Keys carry the file's identity (path, mtime_ns, size) so a
rewritten tree — a restarted live job re-encoding under the same
names — can never serve stale bytes: changed identity is a different
key, and the old entry ages out of the LRU.

Fills are single-flight: when a fresh live part lands and a thundering
herd of players asks for it at once, exactly one request reads the
disk; the rest wait on its fill event and serve from memory.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable

from ..obs import metrics as obs_metrics


def strong_etag(data: bytes) -> str:
    """Strong ETag for an in-memory body (content-addressed, so it is
    stable across processes and restarts for identical bytes)."""
    return '"' + hashlib.sha1(data).hexdigest()[:20] + '"'


def stat_etag(mtime_ns: int, size: int) -> str:
    """Strong-in-practice ETag for a streamed-from-disk body, derived
    from the file's identity the way nginx/apache do: any rewrite
    bumps mtime_ns, and our segment outputs commit via atomic rename."""
    return f'"{mtime_ns:x}-{size:x}"'


class CacheEntry:
    """One cached immutable body."""

    __slots__ = ("data", "etag")

    def __init__(self, data: bytes, etag: str) -> None:
        self.data = data
        self.etag = etag


class HotSegmentCache:
    """Byte-bounded LRU of immutable segment bodies.

    `limit_fn` is read per lookup so the `origin_cache_bytes` setting
    stays live-tunable (0 disables caching entirely). Counters are the
    stage_ms-style monotonic tallies /metrics_snapshot exports.
    """

    def __init__(self, limit_fn: Callable[[], int]) -> None:
        self._limit_fn = limit_fn
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._filling: dict[tuple, threading.Event] = {}
        self._bytes = 0
        # counters (read via snapshot(); guarded by _lock)
        self._hits = 0
        self._fills = 0
        self._coalesced = 0
        self._evictions = 0

    @staticmethod
    def _read_file(path: str) -> bytes:
        """Disk read seam — tests count calls to prove single-flight."""
        with open(path, "rb") as fp:
            return fp.read()

    def get(self, key: tuple, path: str, size: int) -> CacheEntry | None:
        """Body + ETag for the immutable file at `path`, filled from
        disk at most once per key no matter how many threads ask.
        Returns None when caching is off or the file alone exceeds the
        whole budget (the caller streams from disk instead). Raises
        OSError if the fill's disk read fails."""
        limit = max(0, int(self._limit_fn()))
        if limit <= 0 or size > limit:
            # live-tuned down (or off): release anything the old,
            # larger budget admitted — eviction otherwise only runs on
            # the fill path, which a limit of 0 never reaches
            if self._entries:
                evicted = 0
                with self._lock:
                    while self._bytes > limit and self._entries:
                        _, old = self._entries.popitem(last=False)
                        self._bytes -= len(old.data)
                        self._evictions += 1
                        evicted += 1
                if evicted:
                    obs_metrics.ORIGIN_COUNTERS[
                        "origin_evictions"].inc(evicted)
            return None
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    self._hits += 1
                    obs_metrics.ORIGIN_COUNTERS["origin_hits"].inc()
                    return ent
                ev = self._filling.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._filling[key] = ev
                    filling = True
                else:
                    self._coalesced += 1
                    obs_metrics.ORIGIN_COUNTERS[
                        "origin_coalesced_fills"].inc()
                    filling = False
            if not filling:
                # herd member: wait for the filler, then re-check (the
                # loop also covers a failed fill — the event is set and
                # the key vacated, so one waiter becomes the new filler)
                ev.wait(5.0)
                continue
            try:
                data = self._read_file(path)
            except OSError:
                with self._lock:
                    self._filling.pop(key, None)
                ev.set()
                raise
            ent = CacheEntry(data, strong_etag(data))
            evicted = 0
            with self._lock:
                self._filling.pop(key, None)
                self._fills += 1
                if len(data) <= limit:
                    self._entries[key] = ent
                    self._bytes += len(data)
                    while self._bytes > limit and self._entries:
                        _, old = self._entries.popitem(last=False)
                        self._bytes -= len(old.data)
                        self._evictions += 1
                        evicted += 1
            obs_metrics.ORIGIN_COUNTERS["origin_fills"].inc()
            if evicted:
                obs_metrics.ORIGIN_COUNTERS[
                    "origin_evictions"].inc(evicted)
            ev.set()
            return ent

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "origin_cache_bytes_used": self._bytes,
                "origin_cache_entries": len(self._entries),
                "origin_hits": self._hits,
                "origin_fills": self._fills,
                "origin_coalesced_fills": self._coalesced,
                "origin_evictions": self._evictions,
            }
