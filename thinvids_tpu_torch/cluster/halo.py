"""Cross-host halo exchange for farm split-frame encoding (SFE).

The one-card SfeShardEncoder cuts ONE frame into bands held as one
stack; the bands' halo rows, global-motion probe and temporal-median
histogram are slices and sums over that stack. This module carries the
same three flows BETWEEN HOSTS when the band layout spans the farm
(cluster/remote.py band shards, parallel/sfefarm.py):

- per-frame neighbor reference rows (the pixel halo each band slice
  needs for its motion search);
- per-frame probe partial costs and histogram partials (tiny integer
  vectors whose cross-host sums are bit-identical to the one-stack
  sums).

Transport is a coordinator-RELAYED rendezvous, not worker-to-worker
sockets: band workers already hold a connection to the coordinator API
(NAT-safe, no farm-internal reachability requirement), so blobs POST to
``/work/halo`` and peers long-poll the same route. Every blob rides the
part spool's digest framing (length-prefixed JSON directory + raw
payload with per-array sha256) and every request retries through transient transport
failures with the shared jittered backoff (core/retry.py).

Staleness is generation-fenced: whenever a band shard of a job leaves
its lease abnormally, the ShardBoard restarts the WHOLE band group
(siblings requeue with no attempt burned — the exchange is lockstep, a
lost peer strands everyone) and bumps the job's halo generation. Posts
and fetches carrying an older generation answer ``stale`` and the
worker abandons the shard silently (its lease was already requeued).
All halo payloads are DETERMINISTIC (same inputs → same bytes), so a
duplicate post from a retried attempt is harmless by construction.

torch- and jax-free: runs on coordinator API threads and inside worker control
flow; the card math lives in parallel/sfefarm.py.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np


class HaloStaleError(RuntimeError):
    """The job's halo generation moved on (a band peer was requeued and
    the group restarted): abandon this shard attempt silently — the
    board already took the lease back."""


class HaloTimeoutError(RuntimeError):
    """A peer's blob never arrived within `halo_timeout_s` (peer died
    or is partitioned): fail the shard so the lease machinery requeues
    the whole band group."""


# ---------------------------------------------------------------------------
# blob framing (the part wire's digest framing, generalized to named
# arrays)
# ---------------------------------------------------------------------------


def pack_arrays(arrays: Mapping[str, np.ndarray]) -> bytes:
    """Named-array blob: 4-byte BE header length + JSON directory +
    concatenated C-order buffers; each array record carries its
    payload's sha256 so a flipped bit on the wire is rejected at
    unpack, never fed into a motion search."""
    names = sorted(arrays)
    bufs = [np.ascontiguousarray(arrays[k]).tobytes() for k in names]
    header = json.dumps({"arrays": [{
        "name": k,
        "dtype": str(np.asarray(arrays[k]).dtype),
        "shape": list(np.asarray(arrays[k]).shape),
        "size": len(buf),
        "sha256": hashlib.sha256(buf).hexdigest(),
    } for k, buf in zip(names, bufs)]}, separators=(",", ":")).encode()
    return b"".join([struct.pack(">I", len(header)), header] + bufs)


def unpack_arrays(data: bytes) -> dict[str, np.ndarray]:
    """Inverse of :func:`pack_arrays`; raises ValueError on torn or
    digest-mismatched frames."""
    if len(data) < 4:
        raise ValueError("halo blob too short")
    hlen = struct.unpack(">I", data[:4])[0]
    if 4 + hlen > len(data):
        raise ValueError("halo blob header exceeds frame")
    header = json.loads(data[4:4 + hlen])
    out: dict[str, np.ndarray] = {}
    off = 4 + hlen
    for rec in header["arrays"]:
        size = int(rec["size"])
        buf = data[off:off + size]
        if len(buf) != size:
            raise ValueError("halo blob payload truncated")
        off += size
        if hashlib.sha256(buf).hexdigest() != str(rec["sha256"]):
            raise ValueError(
                f"halo array {rec['name']} does not match its sha256")
        out[str(rec["name"])] = np.frombuffer(
            buf, dtype=np.dtype(str(rec["dtype"]))).reshape(
                [int(x) for x in rec["shape"]]).copy()
    if off != len(data):
        raise ValueError("trailing bytes after halo blob")
    return out


# ---------------------------------------------------------------------------
# coordinator-side relay
# ---------------------------------------------------------------------------


class HaloRelay:
    """Generation-fenced rendezvous buffer the coordinator API exposes
    at /work/halo. Blobs key on (seq, band, kind) where `seq` is the
    GLOBAL frame index — monotonic across the job, so a bounded ring
    per (band, kind) stream suffices: lockstep peers never trail by
    more than a frame, and a restarted group runs under a fresh
    generation (which clears the store outright)."""

    #: retained frames per (band, kind) stream — peers are lockstep
    #: (skew ≤ 1 frame); the margin absorbs scheduling jitter only
    RING = 8

    def __init__(self) -> None:
        self._cond = threading.Condition()
        #: job id → {"gen", "blobs" {(seq, band, kind): bytes},
        #:           "hi" {(band, kind): max seq}, "bytes"}
        self._jobs: dict[str, dict[str, Any]] = {}

    def _entry_locked(self, job_id: str) -> dict[str, Any]:
        ent = self._jobs.get(job_id)
        if ent is None:
            ent = {"gen": 0, "blobs": {}, "hi": {}, "bytes": 0}
            self._jobs[job_id] = ent
        return ent

    def set_gen(self, job_id: str, gen: int) -> None:
        """Adopt a new halo generation for the job (ShardBoard band-
        group restart): all buffered blobs drop and every parked
        long-poll wakes to answer `stale`."""
        with self._cond:
            ent = self._entry_locked(job_id)
            if gen > ent["gen"]:
                ent["gen"] = gen
                ent["blobs"].clear()
                ent["hi"].clear()
                ent["bytes"] = 0
                self._cond.notify_all()

    def clear_job(self, job_id: str) -> None:
        with self._cond:
            self._jobs.pop(job_id, None)
            self._cond.notify_all()

    def post(self, job_id: str, gen: int, seq: int, band: int,
             kind: str, data: bytes) -> bool:
        """Store one blob. Returns False when `gen` is stale (the
        poster's band group restarted under a newer generation) or the
        job is unknown — the board seeds every band job's entry at
        add_job and clears it at collect/cancel, so a straggler's post
        after the job closed must answer `stale`, never resurrect a
        dead entry (the coordinator would leak its blobs forever)."""
        with self._cond:
            ent = self._jobs.get(job_id)
            if ent is None or gen < ent["gen"]:
                return False
            if gen > ent["gen"]:
                # first post of a fresh generation adopts it (the board
                # set it at requeue time; this covers claim-before-sync)
                ent["gen"] = gen
                ent["blobs"].clear()
                ent["hi"].clear()
                ent["bytes"] = 0
            key = (int(seq), int(band), str(kind))
            prior = ent["blobs"].get(key)
            if prior is None:
                ent["bytes"] += len(data)
                ent["blobs"][key] = bytes(data)
            stream = (key[1], key[2])
            hi = max(int(seq), ent["hi"].get(stream, -1))
            ent["hi"][stream] = hi
            for k in [k for k in ent["blobs"]
                      if (k[1], k[2]) == stream and k[0] < hi - self.RING]:
                ent["bytes"] -= len(ent["blobs"].pop(k))
            self._cond.notify_all()
        return True

    def wait(self, job_id: str, gen: int, seq: int, band: int,
             kind: str, timeout_s: float) -> bytes | None:
        """Blocking fetch: the parked long-poll behind GET /work/halo.
        Returns the blob, None on timeout (caller re-polls), or raises
        HaloStaleError when the generation moved on."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        key = (int(seq), int(band), str(kind))
        with self._cond:
            while True:
                ent = self._jobs.get(job_id)
                if ent is None:
                    raise HaloStaleError(
                        f"job {job_id} has no live halo entry "
                        f"(collected, cancelled, or never banded)")
                if gen < ent["gen"]:
                    raise HaloStaleError(
                        f"halo generation {gen} superseded by "
                        f"{ent['gen']}")
                blob = ent["blobs"].get(key)
                if blob is not None:
                    return blob
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cond.wait(min(left, 1.0))

    def snapshot(self) -> dict[str, Any]:
        with self._cond:
            return {
                "jobs": len(self._jobs),
                "blobs": sum(len(e["blobs"]) for e in self._jobs.values()),
                "bytes": sum(e["bytes"] for e in self._jobs.values()),
            }


# ---------------------------------------------------------------------------
# worker-side transports
# ---------------------------------------------------------------------------


class HaloClient:
    """Worker-side /work/halo transport: digest-framed blobs over the
    coordinator relay, with the shared jittered-backoff retry policy
    (core/retry.py) under every request and a generous bounded wait
    for peers (`halo_timeout_s` — peers legitimately lag by a device
    step plus scheduling jitter, not more)."""

    def __init__(self, base_url: str, job_id: str, gen: int,
                 timeout_s: float | None = None,
                 retries: int | None = None,
                 backoff_s: float | None = None) -> None:
        from ..core.config import get_settings

        snap = get_settings()
        self.base = base_url.rstrip("/")
        self.job_id = job_id
        self.gen = int(gen)
        self.timeout_s = float(snap.get("halo_timeout_s", 60.0)) \
            if timeout_s is None else max(0.1, float(timeout_s))
        self.retries = int(snap.get("remote_http_retries", 4)) \
            if retries is None else max(0, int(retries))
        self.backoff_s = float(snap.get("remote_http_backoff_s", 0.5)) \
            if backoff_s is None else max(0.0, float(backoff_s))

    def _url(self, seq: int, band: int, kind: str,
             wait: float | None = None) -> str:
        q = (f"job={self.job_id}&gen={self.gen}&seq={int(seq)}"
             f"&band={int(band)}&kind={kind}")
        if wait is not None:
            q += f"&wait={wait:.1f}"
        return f"{self.base}/work/halo?{q}"

    def _request(self, url: str, data: bytes | None,
                 timeout_s: float) -> tuple[bytes, str]:
        import urllib.request

        from ..core.retry import call_with_backoff

        def send() -> tuple[bytes, str]:
            req = urllib.request.Request(
                url, data=data, method="POST" if data is not None
                else "GET",
                headers={"Content-Type": "application/octet-stream"}
                if data is not None else {})
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return resp.read(), str(
                    resp.headers.get("Content-Type") or "")

        return call_with_backoff(send, self.retries, self.backoff_s)

    def post_blob(self, seq: int, band: int, kind: str,
                  data: bytes) -> None:
        body, ctype = self._request(self._url(seq, band, kind), data,
                                    timeout_s=30.0)
        out = json.loads(body) if "json" in ctype else {}
        if out.get("stale"):
            raise HaloStaleError(
                f"halo post {seq}/{band}/{kind} rejected: generation "
                f"{self.gen} superseded")

    def fetch_blob(self, seq: int, band: int, kind: str) -> bytes:
        deadline = time.monotonic() + self.timeout_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise HaloTimeoutError(
                    f"halo blob {seq}/{band}/{kind} not published "
                    f"within {self.timeout_s:.0f}s (peer dead or "
                    f"partitioned)")
            wait = min(2.0, max(0.1, left))
            body, ctype = self._request(
                self._url(seq, band, kind, wait=wait), None,
                timeout_s=wait + 30.0)
            if "octet-stream" in ctype:
                return body
            out = json.loads(body)
            if out.get("stale"):
                raise HaloStaleError(
                    f"halo fetch {seq}/{band}/{kind}: generation "
                    f"{self.gen} superseded")
            # pending: the server-side park expired; re-poll


class LocalHaloHub:
    """In-process transport over a HaloRelay instance — the unit-test /
    single-process form of the same protocol (every code path but the
    HTTP hop)."""

    def __init__(self, relay: HaloRelay, job_id: str, gen: int,
                 timeout_s: float = 30.0) -> None:
        self.relay = relay
        self.job_id = job_id
        self.gen = int(gen)
        self.timeout_s = float(timeout_s)

    def post_blob(self, seq: int, band: int, kind: str,
                  data: bytes) -> None:
        if not self.relay.post(self.job_id, self.gen, seq, band, kind,
                               data):
            raise HaloStaleError(
                f"halo post {seq}/{band}/{kind}: generation {self.gen} "
                f"superseded")

    def fetch_blob(self, seq: int, band: int, kind: str) -> bytes:
        deadline = time.monotonic() + self.timeout_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise HaloTimeoutError(
                    f"halo blob {seq}/{band}/{kind} not published "
                    f"within {self.timeout_s:.0f}s")
            blob = self.relay.wait(self.job_id, self.gen, seq, band,
                                   kind, min(left, 2.0))
            if blob is not None:
                return blob


# ---------------------------------------------------------------------------
# per-shard session (what the farm encoder talks to)
# ---------------------------------------------------------------------------


class HaloSession:
    """One band shard's view of the exchange: publishes this slice's
    edge rows / histogram partials and gathers the peers', keyed by
    the GLOBAL frame index. Pure numpy — the device math (and the
    host-side argmin/median tails) live in parallel/sfefarm.py."""

    def __init__(self, transport, *, band_lo: int, band_hi: int,
                 groups, on_wait: Callable[[float], None] | None = None
                 ) -> None:
        self.t = transport
        self.lo = int(band_lo)
        self.hi = int(band_hi)
        self.groups = [(int(lo), int(hi)) for lo, hi in groups]
        self.total = max((hi for _lo, hi in self.groups),
                         default=self.hi)
        self.peers = [g for g in self.groups if g != (self.lo, self.hi)]
        #: optional wall-clock sink (the encoder's "halo" stage timer)
        self.on_wait = on_wait

    def _fetch(self, seq: int, band: int, kind: str
               ) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        try:
            return unpack_arrays(self.t.fetch_blob(seq, band, kind))
        finally:
            if self.on_wait is not None:
                self.on_wait(time.perf_counter() - t0)

    def _fetch_many(self, reqs: list[tuple[int, int, str]]
                    ) -> list[dict[str, np.ndarray]]:
        """Independent long-polls fan out concurrently (one
        short-lived thread per extra request): a multi-group farm must
        not pay (groups - 1) SERIAL relay round-trips per frame for
        payloads that don't depend on each other."""
        if len(reqs) <= 1:
            return [self._fetch(*r) for r in reqs]
        out: list = [None] * len(reqs)
        errs: list[BaseException] = []

        def get(k: int, r: tuple[int, int, str]) -> None:
            try:
                out[k] = self._fetch(*r)
            except BaseException as exc:    # noqa: BLE001 - re-raised
                errs.append(exc)

        threads = [threading.Thread(target=get, args=(k, r),
                                    daemon=True,
                                    name="tvt-halo-fetch")
                   for k, r in enumerate(reqs[1:], 1)]
        for t in threads:
            t.start()
        get(0, reqs[0])
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out

    # -- round A: recon edges + histogram partials ---------------------

    def publish_state(self, seq: int,
                      top: Mapping[str, np.ndarray] | None = None,
                      bot: Mapping[str, np.ndarray] | None = None,
                      hist: Mapping[str, np.ndarray] | None = None
                      ) -> None:
        """After frame `seq`'s step: ship this slice's boundary recon
        rows to the adjacent groups and (for P frames) its histogram
        partial to every peer."""
        if self.lo > 0 and top is not None:
            self.t.post_blob(seq, self.lo, "top", pack_arrays(top))
        if self.hi < self.total and bot is not None:
            self.t.post_blob(seq, self.hi - 1, "bot", pack_arrays(bot))
        if hist is not None and self.peers:
            self.t.post_blob(seq, self.lo, "hist", pack_arrays(hist))

    def gather_edges(self, seq: int) -> tuple[
            dict[str, np.ndarray] | None, dict[str, np.ndarray] | None]:
        """Neighbor recon rows of frame `seq` (the reference for frame
        seq+1's search): (top_ext, bot_ext), None at true frame
        edges."""
        reqs = []
        if self.lo > 0:
            reqs.append((seq, self.lo - 1, "bot"))
        if self.hi < self.total:
            reqs.append((seq, self.hi, "top"))
        got = dict(zip([r[2] for r in reqs], self._fetch_many(reqs)))
        return got.get("bot"), got.get("top")

    def gather_hists(self, seq: int) -> list[dict[str, np.ndarray]]:
        """Every peer's histogram partial for frame `seq`."""
        return self._fetch_many([(seq, lo, "hist")
                                 for lo, _hi in self.peers])

    # -- round B: probe partial reduction ------------------------------

    def sum_probe(self, seq: int, cost: np.ndarray) -> np.ndarray:
        """Cross-host sum of the probe's per-window partial costs for
        frame `seq`. int32 like the card's sum (order-independent,
        and wrapping semantics match torch's int32 sum, so the argmin can
        never diverge from the one-stack program's)."""
        total = np.asarray(cost, np.int32)
        if self.peers:
            self.t.post_blob(seq, self.lo, "probe",
                             pack_arrays({"cost": np.asarray(cost)}))
            for peer in self._fetch_many([(seq, lo, "probe")
                                          for lo, _hi in self.peers]):
                total = (total + np.asarray(peer["cost"],
                                            np.int32)).astype(np.int32)
        return total
