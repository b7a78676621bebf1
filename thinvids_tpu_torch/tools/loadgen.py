"""HLS player-session load harness (torch- and jax-free).

Replays N concurrent player sessions against the origin so scale
claims are measured, not asserted (the NVENC longitudinal study's
methodology — PAPERS.md arXiv:2605.01187 — applied to serving): each
session fetches the master playlist, picks a rendition, then follows
the media playlist at its cadence — init box once, new segments/parts
as they are announced, LL-HLS blocking reloads (`_HLS_msn`/`_HLS_part`)
on live streams, a `Retry-After` back-off when the origin sheds
blocking-reload load with a 503. VOD sessions loop the program so a
fixed-duration run keeps every session busy for the whole window.

Each session holds ONE keep-alive connection and identifies itself
with an `X-Tvt-Session` header, which is what the origin's per-job
concurrent-session gauge counts. The aggregate result pins
`sessions_sustained` (sessions that ran the whole window with zero
errors) and per-segment fetch latency percentiles — the
`origin_sessions_sustained` / `origin_p99_segment_ms` BENCH lines.

    python -m thinvids_tpu_torch.tools.loadgen --url http://host:port \
        --job <job_id> [--sessions 500] [--duration 10] [--live]
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import threading
import time
from urllib.parse import urlsplit


def parse_playlist_uris(text: str) -> dict:
    """Minimal media-playlist facts for a player: segment URIs in
    order, already-announced part URIs, the init-box URI, and
    whether the stream ended. (The live-edge numbers come from
    abr.hls.live_playlist_state — this parser only collects what a
    player must FETCH.)"""
    uris: list[str] = []
    parts: list[str] = []
    map_uri = None
    ended = False
    variant = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#EXT-X-MAP:"):
            for attr in line.split(":", 1)[1].split(","):
                k, _, v = attr.partition("=")
                if k.strip() == "URI":
                    map_uri = v.strip().strip('"')
        elif line.startswith("#EXT-X-PART:"):
            for attr in line.split(":", 1)[1].split(","):
                k, _, v = attr.partition("=")
                if k.strip() == "URI":
                    parts.append(v.strip().strip('"'))
        elif line == "#EXT-X-ENDLIST":
            ended = True
        elif line.startswith("#EXT-X-STREAM-INF"):
            variant = True
        elif not line.startswith("#"):
            uris.append(line)
    return {"uris": uris, "parts": parts, "map_uri": map_uri,
            "ended": ended, "variant": variant}


@dataclasses.dataclass
class SessionResult:
    ok: bool = False
    requests: int = 0
    bytes: int = 0
    errors: int = 0
    retry_afters: int = 0
    segment_ms: list = dataclasses.field(default_factory=list)


class _Backoff(Exception):
    """Origin asked this session to retry later (503 + Retry-After)."""

    def __init__(self, delay_s: float) -> None:
        super().__init__(f"retry after {delay_s}s")
        self.delay_s = delay_s


class PlayerSession:
    """One simulated player: master → media → segments at cadence."""

    def __init__(self, host: str, port: int, job_id: str, sid: str,
                 stop_at: float, live: bool = False,
                 timeout_s: float = 10.0) -> None:
        self.host, self.port = host, port
        self.job_id, self.sid = job_id, sid
        self.stop_at = stop_at
        self.live = live
        self.timeout_s = timeout_s
        self.result = SessionResult()
        self._conn: http.client.HTTPConnection | None = None

    # -- transport -----------------------------------------------------

    def _get(self, path: str) -> bytes:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        try:
            self._conn.request("GET", path,
                               headers={"X-Tvt-Session": self.sid})
            resp = self._conn.getresponse()
            data = resp.read()
        except Exception:
            # keep-alive connection died (server restart, timeout):
            # one transparent reconnect, then let the error count
            self._close()
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
            self._conn.request("GET", path,
                               headers={"X-Tvt-Session": self.sid})
            resp = self._conn.getresponse()
            data = resp.read()
        self.result.requests += 1
        self.result.bytes += len(data)
        if resp.status == 503:
            delay = float(resp.getheader("Retry-After") or 1.0)
            raise _Backoff(delay)
        if resp.status >= 400:
            raise RuntimeError(f"GET {path} -> {resp.status}")
        return data

    def _get_timed(self, path: str) -> bytes:
        t0 = time.monotonic()
        data = self._get(path)
        self.result.segment_ms.append(
            (time.monotonic() - t0) * 1000.0)
        return data

    def _close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:   # noqa: BLE001 - teardown best-effort
                pass
            self._conn = None

    # -- playback ------------------------------------------------------

    def run(self) -> SessionResult:
        try:
            self._play()
            self.result.ok = self.result.errors == 0
        except Exception:       # noqa: BLE001 - a dead session is data
            self.result.errors += 1
            self.result.ok = False
        finally:
            self._close()
        return self.result

    def _pick_variant(self) -> str:
        master = self._get(f"/hls/{self.job_id}/master.m3u8").decode(
            "utf-8", "replace")
        variants = [u for u in parse_playlist_uris(master)["uris"]
                    if u.endswith(".m3u8")]
        if not variants:
            raise RuntimeError("master playlist lists no variants")
        # deterministic spread across the rendition set
        return variants[hash(self.sid) % len(variants)]

    def _play(self) -> None:
        from ..abr.hls import live_playlist_state

        media_rel = self._pick_variant()
        base = media_rel.rsplit("/", 1)[0]
        base = base + "/" if base != media_rel else ""
        media_path = f"/hls/{self.job_id}/{media_rel}"
        fetched: set[str] = set()
        have_map = False
        reload_path = media_path
        while time.monotonic() < self.stop_at:
            try:
                text = self._get(reload_path).decode("utf-8", "replace")
            except _Backoff as exc:
                self.result.retry_afters += 1
                time.sleep(min(exc.delay_s,
                               max(0.0, self.stop_at - time.monotonic())))
                reload_path = media_path
                continue
            pl = parse_playlist_uris(text)
            if pl["map_uri"] and not have_map:
                self._get_timed(
                    f"/hls/{self.job_id}/{base}{pl['map_uri']}")
                have_map = True
            fresh = [u for u in pl["uris"] + pl["parts"]
                     if u not in fetched]
            # a joining player fetches a couple of segments per reload
            # cycle, not the whole backlog at once
            for uri in fresh[:3]:
                self._get_timed(f"/hls/{self.job_id}/{base}{uri}")
                fetched.add(uri)
            if pl["ended"] and not fresh:
                if self.live:
                    return              # stream over: session complete
                fetched.clear()         # VOD: loop the program so the
                have_map = False        # session stays busy all window
                time.sleep(0.05)
                reload_path = media_path
                continue
            if self.live and not pl["ended"]:
                st = live_playlist_state(text)
                reload_path = (f"{media_path}?_HLS_msn={st['next_msn']}"
                               f"&_HLS_part={st['next_part']}")
            else:
                reload_path = media_path
                time.sleep(0.1)


# ---------------------------------------------------------------------------
# chaos mode (--chaos): diurnal encode demand + injected failures
# ---------------------------------------------------------------------------


def chaos_defaults(snap=None) -> dict:
    """The chaos knobs' settings tier (TVT_CHAOS_*): mean seconds
    between worker kills (0 = none), /work partition length (0 =
    none), and the diurnal curve period. One reader for every harness
    (this CLI's --chaos mode and bench.py's _run_autoscale)."""
    from ..core.config import get_settings

    snap = snap if snap is not None else get_settings()
    return {
        "kill_interval_s": float(snap.get("chaos_kill_interval_s",
                                          0.0)),
        "partition_s": float(snap.get("chaos_partition_s", 0.0)),
        "period_s": float(snap.get("chaos_period_s", 60.0)),
    }


def flip_part_bit(path: str) -> int:
    """Bit-flip injection for the crash/corruption chaos tier: flip
    one bit inside a spooled ``.part`` file's PAYLOAD region (past the
    4-byte length + JSON header framing, so the flip corrupts encoded
    bytes rather than tearing the frame). The next digest gate —
    resume rehydration or the pre-stitch check — must reject the part.
    Returns the flipped byte offset."""
    with open(path, "r+b") as fp:
        data = fp.read()
        if len(data) < 5:
            raise ValueError(f"{path}: too short to be a part frame")
        hlen = int.from_bytes(data[:4], "big")
        off = min(len(data) - 1, 4 + hlen + max(1, (len(data)
                                                    - 4 - hlen) // 2))
        fp.seek(off)
        fp.write(bytes([data[off] ^ 0x01]))
    return off


def corrupt_spooled_part(spool_root: str, job_id: str) -> str | None:
    """Corrupt ONE spooled part of `job_id` under `spool_root` (the
    coordinator's part-spool directory) — the
    while-the-coordinator-is-down storage rot the crash bench injects.
    Returns the corrupted path, or None when the job has no spooled
    parts."""
    import os

    sdir = os.path.join(spool_root, job_id)
    try:
        victims = sorted(f for f in os.listdir(sdir)
                         if f.endswith(".part"))
    except OSError:
        return None
    if not victims:
        return None
    path = os.path.join(sdir, victims[0])
    flip_part_bit(path)
    return path


def diurnal_rate(t_s: float, period_s: float, lo_rps: float,
                 hi_rps: float) -> float:
    """Sinusoidal day curve: submission rate at time `t_s` into the
    run, peaking at hi_rps mid-period and bottoming at lo_rps at the
    start/end — one compressed diurnal cycle per `period_s`. The
    autoscale bench drives job arrivals with this so the farm has a
    real trough to scale down into."""
    import math

    phase = (t_s % max(1e-9, period_s)) / max(1e-9, period_s)
    # -cos: starts at the trough, peaks at phase 0.5, returns
    return lo_rps + (hi_rps - lo_rps) * 0.5 * (
        1.0 - math.cos(2.0 * math.pi * phase))


def run_chaos_load(submit, duration_s: float, *, period_s: float = 60.0,
                   lo_rps: float = 0.0, hi_rps: float = 1.0,
                   kill=None, kill_interval_s: float = 0.0,
                   partition=None, partition_s: float = 0.0,
                   clock=None, sleep=None) -> dict:
    """Drive a diurnal submission curve with chaos injected (the farm
    proving ground the ROADMAP item asks for): `submit(i)` registers
    the i-th job; `kill()` (fired every `kill_interval_s`, when given)
    SIGKILLs a worker; `partition(seconds)` (fired once, mid-run at
    the curve's peak, when given) black-holes the /work routes.
    `clock`/`sleep` are injectable for deterministic tests. Returns
    submission/chaos-event counts plus the curve parameters so the
    bench pins its context."""
    import time as _time

    clock = clock or _time.monotonic
    sleep = sleep or _time.sleep
    t0 = clock()
    submitted = kills = partitions = 0
    next_kill = kill_interval_s if kill_interval_s > 0 else None
    partition_at = 0.5 * period_s if partition is not None \
        and partition_s > 0 else None
    credit = 0.0
    last = t0
    while True:
        now = clock()
        t = now - t0
        if t >= duration_s:
            break
        # integrate the rate curve into whole submissions
        credit += diurnal_rate(t, period_s, lo_rps, hi_rps) * (now - last)
        last = now
        while credit >= 1.0:
            credit -= 1.0
            submit(submitted)
            submitted += 1
        if next_kill is not None and t >= next_kill and kill is not None:
            if kill():
                kills += 1
            next_kill += kill_interval_s
        if partition_at is not None and t >= partition_at:
            partition(partition_s)
            partitions += 1
            partition_at = None
        sleep(0.05)
    return {"submitted": submitted, "kills": kills,
            "partitions": partitions, "duration_s": duration_s,
            "period_s": period_s, "lo_rps": lo_rps, "hi_rps": hi_rps}


def run_load(base_url: str, job_id: str, *, sessions: int,
             duration_s: float, live: bool = False,
             timeout_s: float = 10.0) -> dict:
    """Run `sessions` concurrent player sessions for `duration_s`
    seconds and aggregate: sessions_sustained (full window, zero
    errors), pooled per-segment latency percentiles, request/byte/
    error totals."""
    parts = urlsplit(base_url)
    host, port = parts.hostname or "127.0.0.1", parts.port or 80
    stop_at = time.monotonic() + duration_s
    players = [PlayerSession(host, port, job_id, f"s{i:05d}",
                             stop_at, live=live, timeout_s=timeout_s)
               for i in range(sessions)]
    threads = [threading.Thread(target=p.run, daemon=True,
                                name=f"tvt-loadgen-{p.sid}")
               for p in players]
    # player threads are mostly parked in sleeps/reads — a small stack
    # keeps 500+ of them cheap (the size is consumed at start(), so the
    # override must span the starts, not the Thread construction)
    prev_stack = threading.stack_size(512 * 1024)
    try:
        for t in threads:
            t.start()
    finally:
        threading.stack_size(prev_stack)
    for t in threads:
        t.join(duration_s + 10 * timeout_s)
    samples = sorted(ms for p in players for ms in p.result.segment_ms)

    def pct(q: float) -> float:
        if not samples:
            return 0.0
        return samples[min(len(samples) - 1, int(q * len(samples)))]

    return {
        "sessions": sessions,
        "sessions_sustained": sum(1 for p in players if p.result.ok),
        "requests": sum(p.result.requests for p in players),
        "bytes": sum(p.result.bytes for p in players),
        "errors": sum(p.result.errors for p in players),
        "retry_afters": sum(p.result.retry_afters for p in players),
        "segment_samples": len(samples),
        "segment_ms_p50": round(pct(0.50), 3),
        "segment_ms_p99": round(pct(0.99), 3),
    }


def _http_submit(base_url: str, input_path: str):
    """Chaos-mode job submitter: copy the clip to a fresh path (the
    watcher-style dedup keys on path) and POST /add_job."""
    import os
    import shutil
    import urllib.request

    base, ext = os.path.splitext(input_path)

    def submit(i: int) -> None:
        path = f"{base}.chaos{i:04d}{ext}"
        if not os.path.exists(path):
            shutil.copyfile(input_path, path)
        body = json.dumps({"input_path": path}).encode()
        req = urllib.request.Request(
            base_url.rstrip("/") + "/add_job", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).read()

    return submit


def main(argv: list[str] | None = None) -> int:
    from ..core.config import get_settings

    snap = get_settings()
    p = argparse.ArgumentParser(
        prog="thinvids_tpu_torch loadgen",
        description="replay concurrent HLS player sessions against "
                    "the origin, or (--chaos) drive a diurnal encode "
                    "demand curve at the coordinator")
    p.add_argument("--url", required=True, help="origin base URL")
    p.add_argument("--job", help="job id to play (player-load mode)")
    p.add_argument("--sessions", type=int,
                   default=int(snap.get("loadgen_sessions", 500)))
    p.add_argument("--duration", type=float,
                   default=float(snap.get("loadgen_duration_s", 10.0)))
    p.add_argument("--live", action="store_true",
                   help="use LL-HLS blocking reloads at the live edge")
    p.add_argument("--chaos", action="store_true",
                   help="diurnal job-submission curve against the "
                        "coordinator's /add_job (worker kills and "
                        "/work partitions need the in-process bench "
                        "harness — bench.py _run_autoscale)")
    p.add_argument("--input", help="clip to submit repeatedly "
                                   "(--chaos mode)")
    p.add_argument("--hi-rps", type=float, default=1.0,
                   help="peak submissions/s of the diurnal curve")
    args = p.parse_args(argv)
    if args.chaos:
        if not args.input:
            p.error("--chaos requires --input")
        out = run_chaos_load(
            _http_submit(args.url, args.input), args.duration,
            period_s=chaos_defaults(snap)["period_s"],
            hi_rps=args.hi_rps)
        print(json.dumps(out))
        return 0
    if not args.job:
        p.error("--job is required (unless --chaos)")
    out = run_load(args.url, args.job, sessions=args.sessions,
                   duration_s=args.duration, live=args.live)
    print(json.dumps(out))
    return 0 if out["errors"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
