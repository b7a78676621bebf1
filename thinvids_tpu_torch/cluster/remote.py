"""Remote worker execution backend: encode shards over HTTP.

The capability VERDICT C10/A8 called out as missing: registered remote
agents could heartbeat but "never receive work". This module is the
paper's farm made real — a job's GOP ranges are sharded across worker
daemons on other hosts, each worker encodes its shard on its own card
and streams the encoded part back, and the coordinator
concat-stitches the parts through the same stamp/seam-safe path the
local executor uses (closed GOPs + idr_pic_id offsets keep the stitched
bitstream bit-identical to a single-process encode).

Control flow is PULL-based, like the reference's Huey consumers popping
a Redis queue (worker/tasks.py:1167-1281): workers POST
``/work/claim`` on the coordinator API, encode, then stream the part to
``/work/part/<shard>``; a failed shard is reported on ``/work/status``.
Pull keeps the coordinator passive — no reverse connections into NATed
workers — and makes worker death purely a lease problem.

Robustness is lease-based:

- every ASSIGNED shard carries a deadline; `requeue_expired` returns it
  to PENDING (with exponential backoff) when the lease runs out or the
  worker's registry heartbeat goes stale (SIGKILL mid-shard);
- a worker accumulating `remote_worker_max_failures` CONSECUTIVE
  failures is quarantined via `WorkerRegistry.set_disabled`, exactly
  like the operator's /nodes/disable;
- a shard burning `part_failure_max_retries` attempts fails the job
  with host attribution;
- no live eligible worker for `remote_no_worker_grace_s` while shards
  are open fails the job instead of hanging.

`assign_roles`' pipeline/encode split governs placement: encode-role
workers always claim; pipeline-role workers are held back for the
pipeline stages unless the farm has no encode-role workers at all (a
two-node farm must not deadlock).

A copy of the reference package's remote backend: the worker side
builds the port's encoders on the worker's ``device`` (the card by
default; ``"cpu"`` when asked), and the coordinator side subclasses the
port's LocalExecutor, whose local encodes (vbr2pass, direct mode, the
live edge) run on the coordinator's device. Torch- and jax-free at
module scope: the encoders import lazily inside the worker calls.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import struct
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping

from ..core.status import ShardState, Status
from ..core.types import (ChromaFormat, EncodedSegment, GopSpec, SegmentPlan,
                          VideoMeta)
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .executor import HaltedError, LocalExecutor
from .jobs import Job
from .partstore import PartIntegrityError, PartRef, PartStore

if TYPE_CHECKING:
    from .coordinator import Coordinator

# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------


def meta_to_dict(meta: VideoMeta) -> dict[str, Any]:
    d = dataclasses.asdict(meta)
    d["chroma"] = meta.chroma.name
    return d


def meta_from_dict(d: Mapping[str, Any]) -> VideoMeta:
    data = dict(d)
    data["chroma"] = ChromaFormat[data.get("chroma", "YUV420")]
    known = {f.name for f in dataclasses.fields(VideoMeta)}
    return VideoMeta(**{k: v for k, v in data.items() if k in known})


def pack_parts(segments: Iterable[EncodedSegment]) -> bytes:
    """Binary part framing: 4-byte BE header length + JSON segment
    directory + concatenated Annex-B payloads. The payload bytes ship
    raw (no base64 inflation) — the part stream IS the scarce resource
    on a farm's uplink, the reason the reference PUT raw chunks at its
    stitcher (worker/tasks.py:1667-1674). Every
    segment record carries its payload's sha256 so a flipped bit on
    the wire (or later on the spool disk) is rejected at unpack, never
    stitched silently."""
    from .partstore import segment_sha256

    segments = list(segments)
    header = json.dumps({
        "segments": [{
            "index": s.gop.index,
            "start_frame": s.gop.start_frame,
            "num_frames": s.gop.num_frames,
            "idr": s.gop.idr,
            "frame_sizes": list(s.frame_sizes),
            "size": len(s.payload),
            "sha256": segment_sha256(s.payload),
        } for s in segments],
    }, separators=(",", ":")).encode()
    return b"".join([struct.pack(">I", len(header)), header]
                    + [s.payload for s in segments])


def unpack_parts(data: bytes, verify: bool = True) -> list[EncodedSegment]:
    """Inverse of :func:`pack_parts`; raises ValueError on torn frames
    (a truncated upload must not stitch silently) and — with `verify`,
    the default — PartIntegrityError when a payload's sha256 no longer
    matches its header record (pre-digest frames verify trivially;
    `part_integrity=False` turns the digest check off)."""
    from .partstore import PartIntegrityError, segment_sha256

    if len(data) < 4:
        raise ValueError("part frame too short")
    hlen = struct.unpack(">I", data[:4])[0]
    if 4 + hlen > len(data):
        raise ValueError("part header exceeds frame")
    header = json.loads(data[4:4 + hlen])
    segments: list[EncodedSegment] = []
    off = 4 + hlen
    for rec in header["segments"]:
        size = int(rec["size"])
        payload = data[off:off + size]
        if len(payload) != size:
            raise ValueError("part payload truncated")
        off += size
        want = rec.get("sha256")
        if verify and want and segment_sha256(payload) != str(want):
            raise PartIntegrityError(
                f"segment {rec.get('index')} payload does not match "
                f"its sha256 (corrupt in transfer or storage)")
        segments.append(EncodedSegment(
            gop=GopSpec(index=int(rec["index"]),
                        start_frame=int(rec["start_frame"]),
                        num_frames=int(rec["num_frames"]),
                        idr=bool(rec.get("idr", True))),
            payload=payload,
            frame_sizes=tuple(int(x) for x in rec["frame_sizes"])))
    if off != len(data):
        raise ValueError("trailing bytes after last part payload")
    return segments


# ---------------------------------------------------------------------------
# coordinator side: shards + board
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Shard:
    """One leased unit of a job's encode — either a contiguous GOP
    *range* (the classic farm shape: whole GOPs on one worker) or a
    frame *band* (farm SFE: a contiguous slice of the job's global
    band layout, every GOP, with per-frame halo exchange against the
    sibling band shards — parallel/sfefarm.py). One worker holds the
    lease at a time (the analog of a reference 'part' task on the
    encode queue)."""

    id: str
    job_id: str
    input_path: str
    meta: VideoMeta                 # SOURCE meta (what the worker decodes)
    gops: tuple[GopSpec, ...]       # GLOBAL indices / frame ranges
    qp: int
    gop_frames: int
    timeout_s: float
    #: shard shape: "gop" (GOP range — today's wire form, absent on
    #: the wire for rolling-upgrade compat) or "band" (frame-band
    #: slice). Workers that don't recognize a shape reject it as
    #: UNSUPPORTED: the board requeues with NO attempt burned and
    #: stops offering the shard to that host.
    shape: str = "gop"
    #: band shape only: this shard's [band_start, band_start +
    #: band_count) slice of the job's `total_bands`-band layout, plus
    #: the pinned halo depth every sibling agrees on
    band_start: int = 0
    band_count: int = 0
    total_bands: int = 0
    halo_rows: int = 0
    #: hosts that rejected this shard's shape (old workers): the claim
    #: never offers it to them again, so an unsupported rejection
    #: cannot ping-pong
    no_hosts: tuple[str, ...] = ()
    # ABR ladder (abr/ladder.py): which rendition this shard encodes;
    # empty = plain single-rendition shard. Scaled rungs carry their
    # target dims — the worker derives them on ITS card from the
    # source-resolution frames it decodes anyway.
    rung: str = ""
    rung_width: int = 0
    rung_height: int = 0
    # QoS class rank (cluster/qos.py: live=0 > ladder=1 > batch=2):
    # claims hand out the best class first, and batch-rank shards are
    # requeued/eligibility-gated while a live job is over deadline
    priority: int = 2
    # tenant namespace (farm/tenancy.py): within a priority class the
    # claim picks the most-underserved tenant first (weighted fair
    # share over currently-ASSIGNED shards), so one tenant's backlog
    # cannot monopolize the farm
    tenant: str = "default"
    # distributed-trace context (obs/trace): the job's trace id rides
    # the claim descriptor to the worker, which echoes it back in the
    # X-Tvt-Trace header on its /work uploads — a farm job's worker
    # spans land in the SAME coordinator-side trace. "" = unsampled.
    trace_id: str = ""
    # run-STABLE plan key ("<rung->NNNN"): the durable checkpoint and
    # spool are keyed by this, not by the run-scoped id, so a resumed
    # run's fresh token still finds the crashed run's accepted parts
    # (cluster/partstore.py)
    key: str = ""
    state: ShardState = ShardState.PENDING
    attempt: int = 0                # completed (failed) attempts so far
    not_before: float = 0.0         # backoff gate for re-claims
    assigned_host: str = ""
    assigned_at: float = 0.0
    deadline_at: float = 0.0
    finished_host: str = ""
    elapsed_s: float = 0.0
    fail_reason: str = ""
    #: rehydrated DONE from the verified spool on crash-resume (never
    #: re-encoded this run)
    resumed: bool = False
    #: lifetime digest rejections against this shard: transient flips
    #: requeue free, but past ShardBoard.INTEGRITY_FREE_REJECTS the
    #: rejection escalates into the normal failure path so a
    #: deterministic corruption source cannot livelock the job
    rejects: int = 0
    #: durable part reference once DONE (partstore.PartRef fields):
    #: the payload itself lives on the spool disk, not in this record
    part_path: str = ""
    part_digests: tuple[str, ...] = ()
    part_bytes: int = 0
    #: transient: populated from the spool by take_shards for the
    #: stitcher; empty while the shard sits DONE on the board
    segments: list[EncodedSegment] = dataclasses.field(default_factory=list)

    @property
    def start_frame(self) -> int:
        return self.gops[0].start_frame

    @property
    def num_frames(self) -> int:
        return self.gops[-1].end_frame - self.gops[0].start_frame

    def descriptor(self) -> dict[str, Any]:
        """Wire form handed to a claiming worker. GOP indices and frame
        ranges are SHARD-LOCAL; the worker re-bases via the encoder's
        gop_index_offset / frame_offset so emitted segments (and their
        idr_pic_id) are globally consistent — the same continuation
        mechanism the elastic replan uses (cluster/executor.py)."""
        g0, f0 = self.gops[0].index, self.gops[0].start_frame
        desc = {
            "id": self.id,
            "job_id": self.job_id,
            "input_path": self.input_path,
            "meta": meta_to_dict(self.meta),
            "start_frame": f0,
            "num_frames": self.num_frames,
            "gop_index_offset": g0,
            "gops": [[g.index - g0, g.start_frame - f0, g.num_frames]
                     for g in self.gops],
            "qp": self.qp,
            "gop_frames": self.gop_frames,
            "attempt": self.attempt,
            "timeout_s": self.timeout_s,
        }
        if self.rung:
            desc["rung"] = {"name": self.rung, "width": self.rung_width,
                            "height": self.rung_height}
        if self.shape != "gop":
            # explicit shape tag ONLY for new shapes: a GOP-range
            # shard's wire form is unchanged, so a rolling upgrade
            # keeps old workers serving GOP shards while band shards
            # flow to new ones (unknown shape → unsupported-requeue)
            desc["shape"] = self.shape
        if self.shape == "band":
            desc["band"] = {
                "start": self.band_start, "count": self.band_count,
                "total": self.total_bands, "halo_rows": self.halo_rows,
                # groups + halo generation are board state (the full
                # sibling partition and the current exchange epoch):
                # ShardBoard.claim fills them in at grant time
            }
        if self.trace_id:
            desc["trace"] = {"trace_id": self.trace_id,
                             "job_id": self.job_id}
        return desc


@dataclasses.dataclass
class _JobEntry:
    shards: dict[str, Shard]
    max_attempts: int
    backoff_s: float
    quarantine_after: int
    #: run token of the executor run that installed this entry: a
    #: superseded run's cleanup must not cancel its successor's shards
    owner_token: str = ""
    failed_reason: str = ""
    failed_host: str = ""
    retried_parts: int = 0
    #: halo-exchange generation for band shards (cluster/halo.py):
    #: bumped whenever a band shard leaves its lease abnormally — the
    #: sibling group restarts together (the exchange is lockstep) and
    #: stale workers' halo traffic answers `stale`
    halo_gen: int = 1


class ShardBoard:
    """Thread-safe work queue the coordinator API exposes to workers.

    One board serves every job the RemoteExecutor runs; claims hand out
    the oldest eligible PENDING shard across jobs (FIFO keeps the drain
    scheduler's admission assumptions intact)."""

    def __init__(self, coordinator: "Coordinator",
                 clock: Callable[[], float] = time.time,
                 spool_dir: str | None = None) -> None:
        self.coordinator = coordinator
        self._clock = clock
        self._lock = threading.Lock()
        self._jobs: dict[str, _JobEntry] = {}
        self._order: list[str] = []     # shard ids in dispatch order
        #: ring of recent shard completions for the dashboard
        self._recent: list[dict[str, Any]] = []
        #: lifetime QoS preemptions (ASSIGNED batch shards requeued)
        self._preempted = 0
        #: lifetime digest rejections (transfer/storage corruption —
        #: requeued with NO attempt burned) and crash-resume reuses
        self._integrity_rejects = 0
        self._resumed = 0
        #: durable part spool + board checkpoint (partstore.PartStore),
        #: created lazily so claim-only boards never touch disk. The
        #: RemoteExecutor passes a STABLE dir (part_spool_dir setting,
        #: else under its output dir) so a restarted coordinator finds
        #: the crashed run's parts; unanchored boards (unit tests)
        #: spool into a private temp dir.
        self._spool_dir = spool_dir
        self._parts: PartStore | None = None
        #: cross-host halo rendezvous for band shards (cluster/halo.py;
        #: served at /work/halo). Generation-fenced by the entries'
        #: halo_gen.
        from .halo import HaloRelay

        self.halo = HaloRelay()
        #: claim affinity: host → {input_path: last claimed END frame}
        #: — the claim prefers shards whose source range continues what
        #: the worker's source cache already covers (a neighboring
        #: range re-claims decode the prefix otherwise). Bounded per
        #: host; purely a scoring hint, no protocol change.
        self._affinity: dict[str, dict[str, int]] = {}

    @property
    def parts(self) -> PartStore:
        with self._lock:
            if self._parts is None:
                root = self._spool_dir
                if not root:
                    root = str(self.coordinator._settings_fn().get(
                        "part_spool_dir", "") or "")
                if not root:
                    import tempfile

                    root = tempfile.mkdtemp(prefix="tvt-part-spool-")
                self._parts = PartStore(root, clock=self._clock)
            return self._parts

    # -- job lifecycle (RemoteExecutor) --------------------------------

    def add_job(self, job_id: str, shards: list[Shard], max_attempts: int,
                backoff_s: float, quarantine_after: int,
                token: str = "") -> None:
        with self._lock:
            stale = self._jobs.pop(job_id, None)
            if stale is not None:
                # restart raced the old run's cleanup: the new entry
                # supersedes it outright
                self._order = [sid for sid in self._order
                               if sid not in stale.shards]
            entry = _JobEntry(
                shards={s.id: s for s in shards},
                max_attempts=max_attempts, backoff_s=backoff_s,
                quarantine_after=quarantine_after, owner_token=token,
                # the halo generation CONTINUES across a superseding
                # re-add: the stale entry's in-flight workers carry its
                # gen and must see `stale`, not adopt the new group
                halo_gen=(stale.halo_gen + 1 if stale is not None
                          else 1))
            self._jobs[job_id] = entry
            self._order.extend(s.id for s in shards)
            banded = any(s.shape == "band" for s in shards)
            gen = entry.halo_gen
        if banded:
            # seed the halo relay: only SEEDED jobs may rendezvous
            # (posts/waits against an unknown job answer `stale`
            # instead of resurrecting a cleared entry — halo.py)
            self.halo.set_gen(job_id, gen)

    def rehydrate_done(self, shard: Shard, ref: PartRef) -> None:
        """Crash-resume: mark one freshly planned shard DONE from a
        VERIFIED spooled part (cluster/partstore.py) before the plan
        posts to the board — the work is NOT re-encoded and the new
        run's board entry starts with the crashed run's progress. The
        PENDING guard makes the edge locally provable (PENDING→DONE is
        the declared late-part edge: a durable part IS a part that
        arrived before any lease)."""
        with self._lock:
            if shard.state is not ShardState.PENDING:
                return
            shard.state = ShardState.DONE
            shard.segments = []
            shard.part_path = ref.path
            shard.part_digests = ref.digests
            shard.part_bytes = ref.nbytes
            shard.finished_host = "resume"
            shard.resumed = True
            self._resumed += 1
        obs_metrics.RESUME_SHARDS_REUSED.inc()

    def note_spool_corruption(self, job_id: str, key: str,
                              reason: str) -> None:
        """Resume verification found a spooled part that no longer
        matches its manifest: counted like an ingest digest rejection
        (the shard simply re-encodes — no attempt burned, the record
        is retracted by the caller)."""
        with self._lock:
            self._integrity_rejects += 1
        obs_metrics.PART_INTEGRITY_FAILURES.inc()
        self.coordinator.activity.emit(
            "integrity",
            f"spooled part {key} failed its resume digest check; "
            f"shard will re-encode: {reason}", job_id=job_id)

    def cancel_job(self, job_id: str, token: str | None = None) -> None:
        """Drop a job's board state. With `token` set, only the entry
        that run installed is removed — a halted run waking after a
        restart must not cancel the new run's shards (the board analog
        of the coordinator's run-token fence)."""
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is None:
                return
            if token is not None and entry.owner_token != token:
                return
            del self._jobs[job_id]
            self._order = [sid for sid in self._order
                           if sid not in entry.shards]
        self.halo.clear_job(job_id)

    def job_progress(self, job_id: str) -> tuple[int, int, int, str, str]:
        """(gops_done, gops_total, parts_retried, failed_reason,
        failed_host) for one job."""
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is None:
                return 0, 0, 0, "cancelled", ""
            done = sum(len(s.gops) for s in entry.shards.values()
                       if s.state is ShardState.DONE)
            total = sum(len(s.gops) for s in entry.shards.values())
            return (done, total, entry.retried_parts, entry.failed_reason,
                    entry.failed_host)

    def take_shards(self, job_id: str,
                    token: str | None = None) -> list[Shard]:
        """Collect a fully-DONE job's shard records (segments + rung
        tags) and drop its board state. Token-fenced like cancel_job: a
        stale run must not pop the entry a restarted run installed.
        Raises HaltedError when fenced out, RuntimeError if any shard
        is not DONE (caller raced).

        Segments load back from the durable spool here — OUTSIDE the
        board lock — and every payload re-verifies against the digests
        recorded at accept time (`part_integrity`): a bit that flipped
        on the spool disk fails the collect (the job fails with
        attribution and its checkpoint survives for a verified resume)
        instead of reaching the stitcher."""
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is None or (token is not None
                                 and entry.owner_token != token):
                raise HaltedError(
                    f"job {job_id} board entry superseded before "
                    f"collection")
            del self._jobs[job_id]
            self._order = [sid for sid in self._order
                           if sid not in entry.shards]
            for shard in entry.shards.values():
                if shard.state is not ShardState.DONE:
                    raise RuntimeError(
                        f"collected shard {shard.id} in state "
                        f"{shard.state.value}")
            shards = list(entry.shards.values())
        self.halo.clear_job(job_id)
        verify = bool(self.coordinator._settings_fn().get(
            "part_integrity", True))
        parts = self.parts
        for shard in shards:
            if shard.segments or not shard.part_path:
                continue            # legacy/in-memory record
            ref = PartRef(job_id=job_id, key=shard.key or shard.id,
                          path=shard.part_path,
                          digests=shard.part_digests,
                          nbytes=shard.part_bytes)
            try:
                shard.segments = parts.read_part(ref, verify=verify)
            except PartIntegrityError as exc:
                with self._lock:
                    # keep the snapshot counter in step with the
                    # Prometheus total: the dashboard/bench read both
                    self._integrity_rejects += 1
                obs_metrics.PART_INTEGRITY_FAILURES.inc()
                raise RuntimeError(
                    f"shard {shard.id}: spooled part failed its "
                    f"pre-stitch digest check ({exc}); refusing to "
                    f"stitch corrupt bytes") from exc
        return shards

    def take_segments(self, job_id: str,
                      token: str | None = None) -> list[EncodedSegment]:
        """Flattened-segment view of :meth:`take_shards` (the
        single-rendition path)."""
        return [seg for shard in self.take_shards(job_id, token=token)
                for seg in shard.segments]

    # -- worker-facing API (via api/server.py /work/* routes) ----------

    def _worker_eligible_locked(self, host: str, now: float) -> bool:
        """Placement gate: quarantined AND stale workers never claim
        (liveness is re-checked HERE, under the lock, from the
        registry's current state — a worker whose heartbeat TTL lapsed
        used to be able to win a shard in a race against
        ``requeue_expired``'s pre-lock active-set snapshot, which then
        immediately swept the fresh lease and burned an attempt); the
        elastic-farm lifecycle gate refuses DRAINING/SUSPENDED workers
        outright (farm/controller.py — the model-checked invariant);
        then the pipeline/encode role split governs who encodes — an
        encode-role worker always claims, a pipeline-role worker is
        held in reserve for the pipeline stages and claims only
        OVERFLOW: when no live encode-role host is a claim-capable
        worker, or when more shards are pending than live encode
        workers can start on (reserving it would just idle the farm).
        Daemons self-identify with ``worker: true`` in their heartbeat
        metrics; metrics-only agents and the coordinator's device
        pseudo-hosts can hold the encode role but can't take work, and
        must not starve the farm."""
        reg = self.coordinator.registry
        snap = self.coordinator._settings_fn()
        ttl = float(snap.metrics_ttl_s)
        reg.assign_roles(int(snap.pipeline_worker_count))
        workers = {w.host: w for w in reg.all()}
        me = workers.get(host)
        if me is None or me.disabled or now - me.last_seen > ttl:
            return False
        farm = getattr(self.coordinator, "farm", None)
        if farm is not None and not farm.claim_allowed(host):
            return False
        if me.role == "encode":
            return True
        active = reg.active(ttl, now=now)
        encode_workers = sum(1 for w in active
                             if w.role == "encode" and w.metrics.get("worker"))
        if encode_workers == 0:
            return True
        pending = sum(
            1 for entry in self._jobs.values()
            for s in entry.shards.values()
            if s.state is ShardState.PENDING and now >= s.not_before)
        return pending > encode_workers

    def _batch_gated_locked(self) -> bool:
        """True while the QoS controller has batch work preempted for
        a live job over its part deadline (cluster/qos.py)."""
        from .qos import QosController

        qos: QosController | None = getattr(self.coordinator, "qos", None)
        return qos is not None and not qos.batch_allowed()

    def claim(self, host: str) -> dict[str, Any] | None:
        """Lease the best eligible PENDING shard to `host` — highest
        QoS class first (live > ladder > batch), most-underserved
        tenant within a class (weighted fair share over the tenants'
        currently-ASSIGNED shards, farm/tenancy.py), oldest within
        that; batch-rank shards are withheld entirely while a live
        job is over its deadline. None when no work (or the host may
        not take any). A GRANTED claim doubles as a liveness
        heartbeat — a worker that demonstrably encoded its way here is
        alive — but an idle poll does not: a worker whose agent
        heartbeat lapsed cannot win work merely by asking (the
        eligibility gate re-checks the TTL under the lock)."""
        from ..farm.tenancy import fair_usage, parse_tenant_shares
        from .qos import BATCH_RANK

        host = (host or "").strip()
        if not host:
            return None
        now = self._clock()
        granted: dict[str, Any] | None = None
        with self._lock:
            if not self._worker_eligible_locked(host, now):
                return None
            batch_gated = self._batch_gated_locked()
            shares = parse_tenant_shares(
                self.coordinator._settings_fn().get("tenant_shares", ""))
            usage: dict[str, float] = {}
            for entry in self._jobs.values():
                for s in entry.shards.values():
                    if s.state is ShardState.ASSIGNED:
                        usage[s.tenant] = usage.get(s.tenant, 0.0) + 1.0
            seen = self._affinity.get(host, {})
            host_devices = 1
            for wk in self.coordinator.registry.all():
                if wk.host == host:
                    host_devices = max(1, int((wk.metrics or {}).get(
                        "worker_devices", 1) or 1))
                    break
            best: Shard | None = None
            best_key: tuple[int, float, int, int] | None = None
            for pos, sid in enumerate(self._order):
                shard = self._find_locked(sid)
                if (shard is None or shard.state is not ShardState.PENDING
                        or now < shard.not_before):
                    continue
                if batch_gated and shard.priority >= BATCH_RANK:
                    continue
                if host in shard.no_hosts:
                    continue        # this host rejected the shape
                if shard.shape == "band" \
                        and shard.band_count > host_devices:
                    # a band slice never fits a smaller mesh than it
                    # was planned for: granting would fail the encode,
                    # burn an attempt AND restart the lockstep group —
                    # an under-provisioned late joiner must simply
                    # never see the shard
                    continue
                # affinity score (0 best): the worker's source cache
                # already covers this input and the shard CONTINUES
                # its last range (the cached demux state decodes
                # forward, no prefix re-walk) > same input (open
                # source reused) > cold open. Strictly below priority
                # and tenant fairness — a hint, never a policy.
                if shard.input_path in seen:
                    affinity = 0 if seen[shard.input_path] \
                        == shard.start_frame else 1
                else:
                    affinity = 2
                key = (shard.priority,
                       fair_usage(shares, usage, shard.tenant),
                       affinity, pos)
                if best_key is None or key < best_key:
                    best, best_key = shard, key
            if best is not None and best.state is ShardState.PENDING:
                # the re-assert is free under the lock and makes the
                # lease edge locally provable: only PENDING→ASSIGNED
                # exists (TVT-M001 audits this site against the
                # declared shard table)
                best.state = ShardState.ASSIGNED
                best.assigned_host = host
                best.assigned_at = now
                best.deadline_at = now + best.timeout_s
                granted = best.descriptor()
                if best.shape == "band":
                    entry = self._jobs[best.job_id]
                    granted["band"]["gen"] = entry.halo_gen
                    granted["band"]["groups"] = sorted(
                        [s.band_start, s.band_start + s.band_count]
                        for s in entry.shards.values()
                        if s.shape == "band")
                # affinity record: remember where this host's source
                # cursor for the input will END (bounded per host)
                rec = self._affinity.setdefault(host, {})
                rec[best.input_path] = best.gops[-1].end_frame
                while len(rec) > 4:
                    rec.pop(next(iter(rec)))
                # grant-heartbeat INSIDE the lock: the lease and the
                # liveness refresh commit atomically w.r.t. the sweep
                # (which reads the registry under this same lock), so
                # a fresh lease can never look orphaned
                self.coordinator.registry.heartbeat(host, now=now)
        return granted

    def submit_part(self, shard_id: str, host: str,
                    segments: list[EncodedSegment],
                    raw: bytes | None = None) -> bool:
        """Accept one encoded part. First result wins: a part from a
        worker whose lease already expired is still accepted while the
        shard is open (the encode is deterministic, so any completed
        attempt is THE answer); a duplicate after DONE is dropped.

        The payload is streamed to the durable part spool (temp +
        fsync + atomic rename, digests journaled — partstore.py)
        BEFORE the shard flips DONE, and the board keeps only the
        PartRef: a DONE shard pins no payload in coordinator RAM, and
        a coordinator crash after this call resumes the shard from
        disk instead of re-encoding it."""
        now = self._clock()
        with self._lock:
            shard = self._find_locked(shard_id)
            if shard is None or not shard.state.is_open:
                return False
            want = sorted(g.index for g in shard.gops)
            got = sorted(s.gop.index for s in segments)
            if want != got:
                raise ValueError(
                    f"part for shard {shard_id} covers GOPs {got}, "
                    f"expected {want}")
            job_id, key = shard.job_id, shard.key or shard.id
        # spool AND commit (rename + journal fsync) OUTSIDE the board
        # lock — disk syncs must not stall concurrent claims/sweeps.
        # Committing before the accept re-check is safe: a done record
        # the board then refuses is harmless — a same-key duplicate
        # carries identical bytes (deterministic encode, gop-validated
        # above), and an orphan from a cancelled entry is reaped by
        # the next begin_job; on a FAILED shard the record even lets a
        # later resume rehydrate the finished work.
        parts = self.parts
        ref, tmp = parts.spool(job_id, key, segments,
                               data=bytes(raw) if raw is not None
                               else None)
        parts.commit(ref, tmp)
        with self._lock:
            shard = self._find_locked(shard_id)
            if shard is None or not shard.state.is_open \
                    or shard.job_id != job_id:
                return False
            shard.state = ShardState.DONE
            shard.segments = []           # the spool holds the bytes
            shard.part_path = ref.path
            shard.part_digests = ref.digests
            shard.part_bytes = ref.nbytes
            shard.finished_host = host
            shard.elapsed_s = now - shard.assigned_at if shard.assigned_at \
                else 0.0
            self._recent.append({
                "shard": shard_id, "job_id": shard.job_id, "host": host,
                "gops": len(shard.gops), "elapsed_s": round(shard.elapsed_s, 3),
                "bytes": ref.nbytes,
                "attempt": shard.attempt + 1, "ts": now,
            })
            del self._recent[:-50]
            job_id, elapsed = shard.job_id, shard.elapsed_s
            assigned_at, gops = shard.assigned_at, len(shard.gops)
        # coordinator-side shard span (lease → accepted part): the
        # farm-level skeleton of the job's trace, which the worker's
        # own uploaded spans then fill in. Board clocks are epoch
        # (time.time) in production, matching the span timebase.
        obs_metrics.SHARD_CLAIM_SECONDS.observe(max(0.0, elapsed))
        obs_trace.TRACE.record_span(
            job_id, "shard", t0=assigned_at or now, dur_s=elapsed,
            host=host, tags={"shard": shard_id, "gops": gops})
        self.coordinator.registry.record_shard_result(host, ok=True)
        return True

    #: digest rejections one shard absorbs for free (requeue, no
    #: attempt burned) before escalating into the normal failure path:
    #: a deterministically corrupting link would otherwise
    #: claim/encode/reject hot-loop forever — the lease never expires
    #: (each cycle is fast) and the job heartbeat never stalls, so
    #: nothing else bounds it
    INTEGRITY_FREE_REJECTS = 4

    def reject_part(self, shard_id: str, host: str, reason: str) -> None:
        """Digest-mismatch rejection at ingest: a TRANSFER fault, not a
        worker fault — the lease (when this host still holds it) is
        handed straight back with NO attempt burned, no backoff and no
        quarantine accounting (the same semantics as QoS preemption),
        and the event counts in `tvt_part_integrity_failures_total`.
        The worker retries the idempotent upload; a re-encode by
        whoever claims next is the fallback. A shard rejected more
        than INTEGRITY_FREE_REJECTS times is no longer a transient
        flip: it escalates through report_failure (attempt burned,
        backoff, quarantine accounting) so the job eventually FAILS
        with attribution instead of livelocking."""
        requeued = False
        escalate = False
        band_job = ""
        with self._lock:
            self._integrity_rejects += 1
            shard = self._find_locked(shard_id)
            if shard is not None and shard.state is ShardState.ASSIGNED \
                    and shard.assigned_host == host:
                shard.rejects += 1
                if shard.rejects > self.INTEGRITY_FREE_REJECTS:
                    escalate = True     # leave ASSIGNED: the failure
                                        # path below owns the requeue
                else:
                    shard.state = ShardState.PENDING
                    shard.assigned_host = ""
                    shard.not_before = 0.0
                    requeued = True
                    if shard.shape == "band":
                        band_job = shard.job_id
        obs_metrics.PART_INTEGRITY_FAILURES.inc()
        self.coordinator.activity.emit(
            "integrity",
            f"part for shard {shard_id} from {host or 'unknown'} "
            f"rejected on digest mismatch"
            + (" (lease requeued, no attempt burned)" if requeued
               else "") + f": {reason}",
            host=host)
        if band_job:
            self._restart_band_group(band_job)
        if escalate:
            self.report_failure(
                shard_id, host,
                f"persistent part corruption: digest rejected "
                f"{self.INTEGRITY_FREE_REJECTS + 1}+ times: {reason}")

    def report_unsupported(self, shard_id: str, host: str,
                           reason: str) -> None:
        """A worker rejected the shard's SHAPE (an old daemon that
        predates frame-band shards): a capability gap, not a fault —
        the lease goes straight back with NO attempt burned, no
        backoff and no quarantine accounting, and the shard stops
        being offered to that host (`no_hosts`) so the rejection
        cannot ping-pong between the same pair forever."""
        requeued = False
        with self._lock:
            shard = self._find_locked(shard_id)
            if shard is not None and shard.state is ShardState.ASSIGNED \
                    and shard.assigned_host == host:
                shard.state = ShardState.PENDING
                shard.assigned_host = ""
                shard.not_before = 0.0
                if host not in shard.no_hosts:
                    shard.no_hosts = shard.no_hosts + (host,)
                job_id = shard.job_id
                requeued = True
        self.coordinator.activity.emit(
            "shard-requeue",
            f"shard {shard_id} shape rejected by {host or 'unknown'} "
            f"(worker too old?): requeued with no attempt burned: "
            f"{reason}", host=host)
        if requeued:
            self._restart_band_group(job_id)

    def _restart_band_group(self, job_id: str) -> None:
        """Band shards exchange halo rows in LOCKSTEP: when one of a
        job's band shards falls back to PENDING (failure, expiry,
        integrity reject, preemption, unsupported shape), its siblings
        are blocked on exchanges that will never complete — requeue
        them too. ASSIGNED siblings requeue with preemption semantics
        (NO attempt burned, their late parts still land); DONE
        siblings requeue with their spooled part RETRACTED (a finished
        slice is useless without live peers to feed the re-encoder's
        halo — the model-checked DONE→PENDING edge; the re-encode
        deterministically re-submits identical bytes). The halo
        generation bumps so in-flight workers of the old epoch see
        `stale` and abandon cleanly (cluster/halo.py). A FAILED band
        shard only bumps the generation: the job is failing, and
        retracting its siblings' finished parts would just cost the
        next resume."""
        bumped = 0
        requeued: list[tuple[str, str, str]] = []
        retract: list[PartRef] = []
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is None:
                return
            band = [s for s in entry.shards.values()
                    if s.shape == "band"]
            if not band:
                return
            restart = any(s.state is ShardState.PENDING for s in band)
            if not restart:
                if any(s.state is ShardState.FAILED for s in band):
                    entry.halo_gen += 1
                    bumped = entry.halo_gen
                else:
                    return
            else:
                for shard in band:
                    if shard.state not in (ShardState.ASSIGNED,
                                           ShardState.DONE):
                        continue
                    was = shard.state
                    if was is ShardState.DONE and shard.part_path:
                        retract.append(PartRef(
                            job_id=job_id, key=shard.key or shard.id,
                            path=shard.part_path,
                            digests=shard.part_digests,
                            nbytes=shard.part_bytes))
                    shard.state = ShardState.PENDING
                    host = shard.assigned_host or shard.finished_host
                    shard.assigned_host = ""
                    shard.not_before = 0.0
                    shard.segments = []
                    shard.part_path = ""
                    shard.part_digests = ()
                    shard.part_bytes = 0
                    shard.finished_host = ""
                    shard.resumed = False
                    requeued.append((shard.id, host, was.value))
                    if was is ShardState.ASSIGNED:
                        self._preempted += 1
                entry.halo_gen += 1
                bumped = entry.halo_gen
        self.halo.set_gen(job_id, bumped)
        if retract:
            # spool hygiene OUTSIDE the board lock (journal fsync):
            # best-effort — an undropped record is re-verified (and
            # dropped all-or-nothing) by any later resume anyway
            parts = self.parts
            for ref in retract:
                try:
                    parts.drop_done(job_id, ref.key, ref)
                except Exception:   # noqa: BLE001 - hygiene only
                    pass
        for sid, host, was in requeued:
            self.coordinator.activity.emit(
                "shard-requeue",
                f"band shard {sid} ({was}) requeued off "
                f"{host or 'unknown'}: sibling band restarted the "
                f"halo group (gen {bumped})",
                job_id=job_id, host=host)

    def report_failure(self, shard_id: str, host: str, error: str) -> None:
        """Worker-reported failure OR lease expiry: requeue with backoff
        until the attempt budget burns out, then fail the job; count the
        failure against the worker and quarantine a repeat offender.
        A failed BAND shard additionally restarts its sibling band
        group (lockstep halo exchange — see _restart_band_group)."""
        now = self._clock()
        co = self.coordinator
        with self._lock:
            shard = self._find_locked(shard_id)
            if shard is None or shard.state is not ShardState.ASSIGNED:
                return
            if shard.assigned_host != host:
                # stale report: the lease already moved on (sweep requeued
                # it and another worker holds it now) — an evicted
                # worker's failure must not burn the current holder's
                # attempt, let alone the job's budget
                return
            entry = self._jobs[shard.job_id]
            shard.attempt += 1
            shard.assigned_host = ""
            entry.retried_parts += len(shard.gops)
            if shard.attempt > entry.max_attempts:
                shard.state = ShardState.FAILED
                shard.fail_reason = (
                    f"shard {shard.id} failed after {shard.attempt} "
                    f"attempts (last on {host or 'unknown'}): {error}")
                entry.failed_reason = entry.failed_reason or shard.fail_reason
                entry.failed_host = entry.failed_host or host
            else:
                shard.state = ShardState.PENDING
                shard.not_before = now + entry.backoff_s \
                    * (2 ** (shard.attempt - 1))
            job_id = shard.job_id
            shard_tenant = shard.tenant
            shard_is_band = shard.shape == "band"
            quarantine_after = entry.quarantine_after
            # capture under the lock: a concurrent claim can flip the
            # shard back to ASSIGNED before the emit below runs, which
            # must not relabel a routine requeue as an ERROR
            event_kind = ("shard-requeue"
                          if shard.state is ShardState.PENDING else "error")
            attempt_no = shard.attempt
        co.activity.emit(
            event_kind,
            f"shard {shard_id} attempt {attempt_no} on "
            f"{host or 'unknown'} failed: {error}",
            job_id=job_id, host=host)
        obs_trace.TRACE.record_error(
            job_id, f"shard {shard_id} attempt {attempt_no} on "
                    f"{host or 'unknown'}: {error}")
        if shard_is_band:
            self._restart_band_group(job_id)
        if host:
            streak = co.registry.record_shard_result(host, ok=False)
            if streak >= quarantine_after:
                co.registry.set_disabled(
                    host, True,
                    reason=f"quarantined: {streak} consecutive shard "
                           f"failures")
                co.activity.emit(
                    "quarantine",
                    f"worker {host} quarantined after {streak} "
                    f"consecutive shard failures", host=host)
                # postmortem artifact for the job the quarantine hit:
                # its spans, the shard failures above, settings
                obs_flight.record(
                    job_id,
                    reason=f"worker {host} quarantined after {streak} "
                           f"consecutive shard failures",
                    settings=self.coordinator._settings_fn(),
                    tenant=shard_tenant)

    def requeue_expired(self) -> list[str]:
        """Lease sweep: requeue ASSIGNED shards whose deadline passed or
        whose worker's heartbeat went stale (killed mid-shard). Returns
        the requeued/failed shard ids. The active set is computed
        UNDER the board lock so a lease granted concurrently (claims
        heartbeat on grant before releasing their `now`) can never be
        judged against a staler snapshot than the one that granted
        it."""
        now = self._clock()
        snap = self.coordinator._settings_fn()
        expired: list[tuple[str, str, str]] = []
        with self._lock:
            active = {w.host for w in self.coordinator.registry.active(
                float(snap.metrics_ttl_s), now=now)}
            for entry in self._jobs.values():
                for shard in entry.shards.values():
                    if shard.state is not ShardState.ASSIGNED:
                        continue
                    if now > shard.deadline_at:
                        expired.append((shard.id, shard.assigned_host,
                                        f"lease expired after "
                                        f"{shard.timeout_s:.0f}s"))
                    elif shard.assigned_host not in active:
                        expired.append((shard.id, shard.assigned_host,
                                        "worker heartbeat lost"))
        for sid, host, why in expired:
            self.report_failure(sid, host, why)
        return [sid for sid, _h, _w in expired]

    def _preempt_where(self, keep_assigned) -> list[tuple[str, str]]:
        """Shared preemption body: requeue every ASSIGNED shard for
        which `keep_assigned(shard)` is False. NOT a failure — no
        attempt is burned, no backoff, no quarantine accounting; the
        evicted worker's late part is still accepted while the shard
        is open (first result wins, deterministic encode), so no work
        is wasted either. Counted in the snapshot's `preempted`
        figure. Returns the (shard id, evicted host) pairs."""
        requeued: list[tuple[str, str]] = []
        band_jobs: set[str] = set()
        with self._lock:
            for entry in self._jobs.values():
                for shard in entry.shards.values():
                    if shard.state is not ShardState.ASSIGNED \
                            or keep_assigned(shard):
                        continue
                    shard.state = ShardState.PENDING
                    host = shard.assigned_host
                    shard.assigned_host = ""
                    shard.not_before = 0.0
                    requeued.append((shard.id, host))
                    self._preempted += 1
                    if shard.shape == "band":
                        band_jobs.add(shard.job_id)
        for jid in band_jobs:
            # a preempted band shard strands its lockstep siblings:
            # restart the group (and stale the halo epoch) together
            self._restart_band_group(jid)
        return requeued

    def preempt_batch(self) -> int:
        """QoS preemption (cluster/qos.py): requeue every ASSIGNED
        batch-rank shard so its worker frees up for the struggling
        live edge. Returns how many shards were requeued."""
        from .qos import BATCH_RANK

        requeued = self._preempt_where(
            lambda s: s.priority < BATCH_RANK)
        for sid, host in requeued:
            self.coordinator.activity.emit(
                "qos-preempt",
                f"batch shard {sid} requeued off {host or 'unknown'} "
                f"(live deadline breach)", host=host)
        return len(requeued)

    def preempt_host(self, host: str) -> int:
        """Requeue every shard ASSIGNED to `host` — the elastic farm's
        drain-grace escape hatch (farm/controller.py): a DRAINING
        worker stuck past `drain_grace_s` has its leases handed back
        with the same preemption semantics as the QoS path (shared
        body above). Returns how many leases were requeued."""
        requeued = self._preempt_where(
            lambda s: s.assigned_host != host)
        for sid, _h in requeued:
            self.coordinator.activity.emit(
                "farm", f"shard {sid} requeued off draining worker "
                f"{host}", host=host)
        return len(requeued)

    # alias the controller calls by intent (drain-grace requeue)
    requeue_host = preempt_host

    def host_leases(self, host: str) -> int:
        """ASSIGNED shards currently leased to `host` — the drain
        controller's single-host is-it-empty-yet re-check."""
        with self._lock:
            return sum(
                1 for entry in self._jobs.values()
                for s in entry.shards.values()
                if s.state is ShardState.ASSIGNED
                and s.assigned_host == host)

    def host_lease_counts(self) -> dict[str, int]:
        """ASSIGNED shards per host in ONE locked pass — the capacity
        controller's per-tick observation (per-host host_leases calls
        would take the board lock once per worker)."""
        out: dict[str, int] = {}
        with self._lock:
            for entry in self._jobs.values():
                for s in entry.shards.values():
                    if s.state is ShardState.ASSIGNED:
                        out[s.assigned_host] = \
                            out.get(s.assigned_host, 0) + 1
        return out

    def queue_depth(self, now: float | None = None) -> dict[int, int]:
        """Claimable PENDING shards by QoS rank — the capacity
        controller's demand input (backoff-gated shards excluded: they
        are not claimable THIS instant, and counting them would make
        the farm chase retries)."""
        now = self._clock() if now is None else now
        depth: dict[int, int] = {}
        with self._lock:
            for entry in self._jobs.values():
                for s in entry.shards.values():
                    if s.state is ShardState.PENDING \
                            and now >= s.not_before:
                        depth[s.priority] = depth.get(s.priority, 0) + 1
        return depth

    def tenant_assigned(self) -> dict[str, int]:
        """Currently-ASSIGNED shards per tenant — the
        `tvt_tenant_active_shards` gauge's scrape-time source."""
        out: dict[str, int] = {}
        with self._lock:
            for entry in self._jobs.values():
                for s in entry.shards.values():
                    if s.state is ShardState.ASSIGNED:
                        out[s.tenant] = out.get(s.tenant, 0) + 1
        return out

    def _find_locked(self, shard_id: str) -> Shard | None:
        for entry in self._jobs.values():
            shard = entry.shards.get(shard_id)
            if shard is not None:
                return shard
        return None

    # -- observability -------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Per-shard timing + queue depth for /metrics_snapshot and the
        dashboard's farm panel."""
        with self._lock:
            counts = {s.value: 0 for s in ShardState}
            per_job: dict[str, dict[str, int]] = {}
            tenants: dict[str, dict[str, int]] = {}
            for job_id, entry in self._jobs.items():
                jc = per_job.setdefault(job_id, dict.fromkeys(
                    (s.value for s in ShardState), 0))
                for shard in entry.shards.values():
                    counts[shard.state.value] += 1
                    jc[shard.state.value] += 1
                    tc = tenants.setdefault(shard.tenant, dict.fromkeys(
                        (s.value for s in ShardState), 0))
                    tc[shard.state.value] += 1
            recent = list(self._recent)
            preempted = self._preempted
            integrity_rejects = self._integrity_rejects
            resumed = self._resumed
            spool = self._parts
        workers = {}
        for w in self.coordinator.registry.all():
            if w.shards_done or w.shards_failed:
                workers[w.host] = {
                    "shards_done": w.shards_done,
                    "shards_failed": w.shards_failed,
                    "quarantined": w.disabled,
                }
        # walk recents newest-first so each worker gets its latest timing
        for rec in reversed(recent):
            stats = workers.setdefault(rec["host"], {
                "shards_done": 0, "shards_failed": 0, "quarantined": False})
            stats.setdefault("last_shard_s", rec["elapsed_s"])
        return {"shards": counts, "jobs": per_job, "workers": workers,
                "tenants": tenants, "recent": recent[-20:],
                "preempted": preempted,
                # durable-spool health (partstore.py): crash-resume
                # reuses, digest rejections, bytes spooled on disk
                "resumed": resumed,
                "integrity_rejects": integrity_rejects,
                "spool_bytes": spool.spool_bytes()
                if spool is not None else 0,
                # halo relay occupancy (cluster/halo.py): band-shard
                # rendezvous blobs buffered on the coordinator
                "halo": self.halo.snapshot()}


class RemoteExecutor(LocalExecutor):
    """Coordinator-side launcher that farms encode shards out to worker
    daemons instead of the local card. Shares LocalExecutor's whole
    probe → stitch → mux → complete scaffolding; only the encode stage
    (`_encode_job`) differs. vbr2pass jobs still encode locally — the
    two-pass QP solver needs global complexity stats in one place — and
    so do jobs the admission policy marked ``processing_mode="direct"``
    (whole-file mode: VC-1-style codecs, oversize files under
    ``large_file_behavior="direct"``), which would defeat the split.

    The shared run() only OPENS the source (streaming ingest,
    ingest.open_video): the farm path reads the frame count and the
    audio track for the mux without ever decoding the clip on the
    coordinator. Those local encodes run on `device` (the card by
    default; it raises without one unless ``"cpu"`` is asked for)."""

    #: wait-loop tick (real time; lease math runs on the injected
    #: clock). The protocol's timescales are seconds — shard leases,
    #: backoff, worker claim polls — so sub-second is already prompt;
    #: tests inject a faster tick.
    POLL_S = 0.25

    def __init__(self, coordinator, output_dir: str,
                 host: str = "coordinator", sync: bool = False,
                 poll_s: float | None = None,
                 clock: Callable[[], float] = time.time,
                 spool_dir: str | None = None, device="cuda",
                 mesh=None) -> None:
        super().__init__(coordinator, output_dir, mesh=mesh, host=host,
                         sync=sync, device=device)
        self._clock = clock
        self.poll_s = poll_s if poll_s is not None else self.POLL_S
        # durable part spool + board checkpoint root: the explicit
        # arg, else the part_spool_dir setting, else a STABLE path
        # under the output dir — a restarted coordinator must find the
        # crashed run's parts, so a tempdir would defeat resume
        if spool_dir is None:
            snap = coordinator._settings_fn()
            spool_dir = str(snap.get("part_spool_dir", "") or "") \
                or os.path.join(output_dir, ".part-spool")
        self.board = ShardBoard(coordinator, clock=clock,
                                spool_dir=spool_dir)
        # live deadline breach → requeue this board's ASSIGNED batch
        # shards (cluster/qos.py fires the hook outside its lock)
        qos = getattr(coordinator, "qos", None)
        if qos is not None:
            qos.on_preempt(self.board.preempt_batch)

    def run(self, job: Job) -> None:
        super().run(job)
        # release the durable checkpoint once the job's output is
        # COMMITTED (and only then — a crash between collect and the
        # mp4 commit must still resume from the spool). Best-effort:
        # spool hygiene never fails a finished job.
        try:
            done = self.coordinator.store.try_get(job.id)
            if done is not None and done.status is Status.DONE:
                self.board.parts.clear_job(job.id)
        except Exception:       # noqa: BLE001 - cleanup only
            pass

    # -- shard planning ------------------------------------------------

    def _live_workers(self):
        """Active CLAIM-CAPABLE workers (daemons flag themselves with
        ``worker: true`` in heartbeat metrics). The registry also holds
        the coordinator's own agent, its device pseudo-hosts, and
        metrics-only agents — none of which can take a shard, and
        counting them would both inflate the shard plan and keep the
        all-workers-dead fail-fast from ever firing."""
        snap = self.coordinator._settings_fn()
        reg = self.coordinator.registry
        reg.assign_roles(int(snap.pipeline_worker_count))
        active = reg.active(float(snap.metrics_ttl_s), now=self._clock())
        return [w for w in active if w.metrics.get("worker")]

    def _plan_remote(self, num_frames: int, settings) -> SegmentPlan:
        from ..parallel.planner import plan_segments

        workers = self._live_workers()
        plan_devices = int(settings.get("remote_plan_devices", 0)) \
            or max(1, len(workers))
        return plan_segments(num_frames, int(settings.gop_frames),
                             plan_devices, int(settings.max_segments))

    def _shards_for(self, job: Job, meta, plan: SegmentPlan, settings,
                    qp: int, rung=None, token: str = "") -> list[Shard]:
        """Cut one GOP plan into leased shards. With `rung` set
        (abr.ladder.Rung) the shards are tagged for that rendition —
        same GOP ranges as every other rung, so the rendition set stays
        boundary-aligned no matter which workers encode which rungs.

        Shard ids are RUN-SCOPED (the run token rides in the id): a
        restarted job plans fresh shards under a new token, so a part
        still in flight from the superseded run resolves to NO shard
        and is dropped instead of landing in the new run's entry — the
        old run may have encoded under different job settings (QP,
        gop_frames), so a same-id part would be silently wrong bytes.
        The TVT-M002 board model checks exactly this (`cross-run-part`
        invariant; the `shared_ids` mutation reproduces the hole)."""
        from .qos import job_rank

        workers = self._live_workers()
        per_shard = int(settings.get("remote_shard_gops", 0))
        if per_shard <= 0:
            # auto: ~2 shards per worker so a straggler can rebalance
            per_shard = max(1, -(-plan.num_gops
                                 // max(1, 2 * max(1, len(workers)))))
        shards = []
        base_timeout = float(settings.remote_shard_timeout_s)
        tag = f"{rung.name}-" if rung is not None else ""
        priority = job_rank(
            getattr(job, "job_type", "transcode"),
            str(settings.get("job_priority", "auto") or "auto"))
        trace_id = obs_trace.TRACE.trace_id(job.id)
        run = f"{token[:6]}-" if token else ""
        for i in range(0, plan.num_gops, per_shard):
            gops = plan.gops[i:i + per_shard]
            # the plan key is run-STABLE (no token): the durable
            # checkpoint and spool key on it so a resumed run's fresh
            # token still resolves the crashed run's accepted parts
            key = f"{tag}{gops[0].index:04d}"
            shards.append(Shard(
                id=f"{job.id[:12]}-{run}{key}", key=key,
                job_id=job.id, input_path=job.input_path, meta=meta,
                gops=tuple(gops), qp=int(qp),
                gop_frames=int(settings.gop_frames),
                # lease scales with shard size: a 100-GOP shard must
                # not be failure-counted on a single-GOP budget (dead
                # workers are swept by heartbeat TTL long before any
                # lease anyway — the lease only guards live-but-stuck)
                timeout_s=base_timeout * len(gops),
                rung=rung.name if rung is not None else "",
                rung_width=rung.width if rung is not None else 0,
                rung_height=rung.height if rung is not None else 0,
                priority=priority, trace_id=trace_id,
                tenant=getattr(job, "tenant", "default") or "default"))
        return shards

    def _build_shards(self, job: Job, meta, num_frames: int,
                      settings, token: str = ""
                      ) -> tuple[SegmentPlan, list[Shard]]:
        if self._band_shape(job, settings):
            return self._build_band_shards(job, meta, num_frames,
                                           settings, token=token)
        plan = self._plan_remote(num_frames, settings)
        return plan, self._shards_for(job, meta, plan, settings,
                                      qp=int(settings.qp), token=token)

    @staticmethod
    def _band_shape(job: Job, settings) -> bool:
        """Plan frame-band shards (farm SFE) instead of GOP ranges?
        `sfe_bands > 0` opts the job into split-frame encoding and
        `sfe_farm` (default on) lets the remote backend spread the
        bands across hosts; ladder/live jobs keep their existing shard
        shapes (rung x range / local edge). A deblock-enabled job
        keeps GOP-range shards: the in-loop filter's cross-band halo
        is a device collective, which a cross-host band slice cannot
        run (the SFE steps refuse it), while whole GOPs deblock
        entirely worker-locally."""
        from ..core.config import as_bool

        return (int(settings.get("sfe_bands", 0) or 0) > 0
                and bool(settings.get("sfe_farm", True))
                and not as_bool(settings.get("deblock", False), False)
                and getattr(job, "job_type", "transcode") == "transcode")

    def _build_band_shards(self, job: Job, meta, num_frames: int,
                           settings, token: str = ""
                           ) -> tuple[SegmentPlan, list[Shard]]:
        """Plan one frame-band shard per worker: a contiguous slice of
        the job's global band layout covering EVERY GOP, encoded in
        lockstep with the sibling slices (halo over the /work relay).
        The band count CLAMPS to workers x min(worker devices): a
        shard must never carry more bands than its host's mesh — a
        mid-job dense fallback on the slowest worker would silently
        serialize the whole group, so the plan refuses up front (WARN)
        instead."""
        from ..parallel.planner import plan_encode

        workers = self._live_workers()
        nworkers = max(1, len(workers))
        dev_counts = [max(1, int(w.metrics.get("worker_devices", 1)
                                 or 1)) for w in workers] or [1]
        min_dev = min(dev_counts)
        mbh = (meta.height + 15) // 16
        requested = int(settings.get("sfe_bands", 0) or 0) \
            or nworkers * min_dev
        cap = nworkers * min_dev
        if requested > cap:
            self.coordinator.activity.emit(
                "shard",
                f"WARN: sfe_bands={requested} clamped to {cap} "
                f"({nworkers} workers x {min_dev} devices on the "
                f"slowest): a band shard must fit its host's mesh",
                job_id=job.id, host=self.host)
            requested = cap
        eplan = plan_encode(
            num_frames, settings, num_devices=nworkers, shape="band",
            total_bands=min(requested, mbh), group_count=nworkers,
            mb_height=mbh)
        return eplan.segments, self._band_shards_for(
            job, meta, eplan, settings, token=token)

    def _band_shards_for(self, job: Job, meta, eplan, settings,
                         token: str = "") -> list[Shard]:
        from .qos import job_rank

        seg = eplan.segments
        priority = job_rank(
            getattr(job, "job_type", "transcode"),
            str(settings.get("job_priority", "auto") or "auto"))
        trace_id = obs_trace.TRACE.trace_id(job.id)
        run = f"{token[:6]}-" if token else ""
        base_timeout = float(settings.remote_shard_timeout_s)
        shards = []
        for lo, hi in eplan.band_groups:
            key = f"band{lo:03d}"
            shards.append(Shard(
                id=f"{job.id[:12]}-{run}{key}", key=key,
                job_id=job.id, input_path=job.input_path, meta=meta,
                gops=tuple(seg.gops), qp=int(settings.qp),
                gop_frames=int(seg.frames_per_gop),
                timeout_s=base_timeout * len(seg.gops),
                shape="band", band_start=int(lo),
                band_count=int(hi - lo),
                total_bands=int(eplan.total_bands),
                halo_rows=int(eplan.halo_rows),
                priority=priority, trace_id=trace_id,
                tenant=getattr(job, "tenant", "default") or "default"))
        return shards

    # -- durable checkpoint / crash-resume (cluster/partstore.py) ------

    @staticmethod
    def _plan_signature(job: Job, settings, rungs=None) -> str:
        """Fingerprint of everything that changes a shard's ENCODED
        BYTES: the input file's identity plus the settings the encode
        reads. A resumed run whose signature matches may reuse spooled
        parts verbatim; any drift (operator changed qp, file replaced)
        resets the checkpoint instead of rehydrating stale bytes."""
        from ..ingest.watcher import file_signature

        try:
            fsig = file_signature(job.input_path)
        except OSError:
            fsig = "unreadable"
        fields = [job.input_path, fsig,
                  getattr(job, "job_type", "transcode"),
                  str(int(settings.qp)), str(int(settings.gop_frames))]
        if rungs:
            fields.extend(f"{r.name}:{r.width}x{r.height}@{r.qp}"
                          for r in rungs)
        # band-shape knobs join the signature ONLY when SFE is on, so
        # every pre-existing GOP-shaped checkpoint keeps its signature
        # (a band-layout change MUST reset the checkpoint: the spooled
        # parts' slice structure would no longer match the plan)
        sfe_bands = int(settings.get("sfe_bands", 0) or 0)
        if sfe_bands > 0:
            fields.extend(["band", str(sfe_bands),
                           str(int(settings.get("sfe_halo_rows", 32)
                                   or 32))])
        return hashlib.sha256("|".join(fields).encode()).hexdigest()[:16]

    @staticmethod
    def _plan_record(sig: str, plan: SegmentPlan,
                     shards: list[Shard]) -> dict[str, Any]:
        """JSON-able form of one deterministic shard plan — what the
        board checkpoint journals so a restarted coordinator re-plans
        from the RECORD, not from whatever worker count happens to be
        live at recovery time."""
        def gop_rows(gops):
            return [[g.index, g.start_frame, g.num_frames, bool(g.idr)]
                    for g in gops]

        return {
            "sig": sig,
            "gop_frames": int(plan.frames_per_gop),
            "num_devices": int(plan.num_devices),
            "plan_gops": gop_rows(plan.gops),
            "shards": [{
                "key": s.key, "qp": int(s.qp),
                "gops": gop_rows(s.gops),
                "timeout_s": float(s.timeout_s),
                "rung": s.rung, "rung_width": int(s.rung_width),
                "rung_height": int(s.rung_height),
                # band shape (absent/"gop" on classic shards so old
                # checkpoints replay unchanged)
                "shape": s.shape,
                "band_start": int(s.band_start),
                "band_count": int(s.band_count),
                "total_bands": int(s.total_bands),
                "halo_rows": int(s.halo_rows),
            } for s in shards],
        }

    def _shards_from_record(self, job: Job, meta, rec: Mapping[str, Any],
                            settings, token: str
                            ) -> tuple[SegmentPlan, list[Shard]]:
        """Rebuild the checkpointed plan under the NEW run token: same
        plan keys (so done records resolve), fresh run-scoped ids (so
        the crashed run's in-flight parts still drop — the cross-run
        fence survives resume)."""
        from .qos import job_rank

        def gops_of(rows):
            return tuple(GopSpec(index=int(i), start_frame=int(s),
                                 num_frames=int(n), idr=bool(idr))
                         for i, s, n, idr in rows)

        gop_frames = int(rec.get("gop_frames", settings.gop_frames))
        plan = SegmentPlan(gops=gops_of(rec["plan_gops"]),
                           num_devices=int(rec.get("num_devices", 1)),
                           frames_per_gop=gop_frames)
        priority = job_rank(
            getattr(job, "job_type", "transcode"),
            str(settings.get("job_priority", "auto") or "auto"))
        trace_id = obs_trace.TRACE.trace_id(job.id)
        run = f"{token[:6]}-" if token else ""
        shards = []
        for srec in rec["shards"]:
            key = str(srec["key"])
            shards.append(Shard(
                id=f"{job.id[:12]}-{run}{key}", key=key,
                job_id=job.id, input_path=job.input_path, meta=meta,
                gops=gops_of(srec["gops"]), qp=int(srec["qp"]),
                gop_frames=gop_frames,
                timeout_s=float(srec["timeout_s"]),
                rung=str(srec.get("rung", "")),
                rung_width=int(srec.get("rung_width", 0)),
                rung_height=int(srec.get("rung_height", 0)),
                shape=str(srec.get("shape", "gop") or "gop"),
                band_start=int(srec.get("band_start", 0)),
                band_count=int(srec.get("band_count", 0)),
                total_bands=int(srec.get("total_bands", 0)),
                halo_rows=int(srec.get("halo_rows", 0)),
                priority=priority, trace_id=trace_id,
                tenant=getattr(job, "tenant", "default") or "default"))
        return plan, shards

    def _plan_or_resume(self, job: Job, token: str, settings, meta,
                        num_frames: int, rungs=None
                        ) -> tuple[SegmentPlan, list[Shard], int]:
        """The RESUME path `recover_jobs` grew: when a durable board
        checkpoint exists for this job and its plan signature still
        matches, re-plan deterministically FROM the checkpoint, verify
        every recorded part against its digests, rehydrate the
        verified ones as DONE under the fresh run token, and leave
        only the remainder PENDING. Otherwise plan fresh (waiting for
        the farm as usual) and anchor a new checkpoint. Returns
        (plan, shards, reused_count)."""
        co = self.coordinator
        sig = self._plan_signature(job, settings, rungs=rungs)
        parts = self.board.parts
        resume = bool(settings.get("resume_enabled", True))
        rec: Mapping[str, Any] | None = None
        if resume:
            ck = parts.load_job(job.id)
            if ck is not None and ck.plan.get("sig") == sig \
                    and ck.plan.get("shards"):
                rec = ck.plan
        if rec is not None:
            plan, shards = self._shards_from_record(job, meta, rec,
                                                    settings, token)
        else:
            self._await_first_workers(job, token, settings)
            if rungs is None:
                plan, shards = self._build_shards(job, meta, num_frames,
                                                  settings, token=token)
            else:
                plan = self._plan_remote(num_frames, settings)
                shards = []
                for rung in rungs:
                    shards.extend(self._shards_for(
                        job, meta, plan, settings, qp=rung.qp,
                        rung=rung, token=token))
            rec = self._plan_record(sig, plan, shards)
        refs = parts.begin_job(job.id, rec)
        reused = 0
        if resume and shards and shards[0].shape == "band":
            # band groups resume ALL-OR-NOTHING: a partially-resumed
            # group would strand the re-encoding shard waiting on halo
            # exchanges its DONE siblings will never send. Either every
            # band shard's part verifies (whole job rehydrates — no
            # encode at all) or none does (whole group re-encodes).
            verified = {s.key: refs[s.key] for s in shards
                        if refs.get(s.key) is not None
                        and parts.verify_part(refs[s.key])}
            if len(verified) == len(shards):
                for shard in shards:
                    self.board.rehydrate_done(shard, verified[shard.key])
                    reused += 1
            else:
                for shard in shards:
                    ref = refs.get(shard.key)
                    if ref is not None:
                        parts.drop_done(job.id, shard.key, ref)
                if verified:
                    co.activity.emit(
                        "resume",
                        f"band group resume is all-or-nothing: "
                        f"{len(verified)}/{len(shards)} parts verified "
                        f"— dropping them, the group re-encodes in "
                        f"lockstep", job_id=job.id, host=self.host)
        elif resume:
            for shard in shards:
                ref = refs.get(shard.key)
                if ref is None:
                    continue
                if parts.verify_part(ref):
                    self.board.rehydrate_done(shard, ref)
                    reused += 1
                else:
                    # bit rot / torn spool: retract the record and let
                    # the shard re-encode — a transfer/storage fault,
                    # no attempt burned
                    self.board.note_spool_corruption(
                        job.id, shard.key, "digest mismatch on the "
                        "spooled part")
                    parts.drop_done(job.id, shard.key, ref)
        if reused:
            co.activity.emit(
                "resume",
                f"crash-resume: {reused}/{len(shards)} shards "
                f"rehydrated DONE from the verified part spool",
                job_id=job.id, host=self.host)
        return plan, shards, reused

    # -- encode stage override -----------------------------------------

    #: after the FIRST worker of a cold farm heartbeats, keep waiting
    #: until the live-worker count has been stable this long before
    #: planning — staggered daemon restarts re-heartbeat over a few
    #: seconds (default agent interval is 1 s), and planning on worker
    #: #1 alone would still produce the degenerate 2-giant-shard plan.
    SETTLE_S = 2.0

    def _await_first_workers(self, job: Job, token: str, settings) -> None:
        """Defer shard planning on a COLD farm until claim-capable
        workers have heartbeated, bounded by
        `remote_no_worker_grace_s`. A coordinator restart recovers jobs
        as soon as the API is up (cli.py), usually BEFORE any worker
        re-heartbeats — and planning against an empty registry
        degenerates to 2 giant shards on a full farm (the round-2
        ROADMAP open item). A warm farm (workers already live) plans
        immediately with zero added latency; a cold one waits for the
        first heartbeat and then for the worker count to settle
        (SETTLE_S), so a staggered farm restart is counted whole. On
        grace expiry planning proceeds anyway; the encode loop's
        no-live-worker failsafe still fails the job if the farm stays
        dark."""
        if self._live_workers():
            return                      # warm farm: plan now
        co = self.coordinator
        grace = float(settings.remote_no_worker_grace_s)
        settle = min(self.SETTLE_S, grace / 4.0)
        t0 = self._clock()
        seen = 0
        last_change = t0

        def tick(note: str) -> None:
            if not co.token_is_current(job.id, token):
                raise HaltedError("stale run token")
            co.heartbeat_job(job.id, token, "segment", host=self.host,
                             note=note)
            time.sleep(self.poll_s)

        while self._clock() - t0 < grace:
            n = len(self._live_workers())
            if n != seen:
                seen = n
                last_change = self._clock()
            elif n > 0 and self._clock() - last_change >= settle:
                return                  # farm width stable: plan
            tick("waiting for first worker heartbeat" if n == 0 else
                 f"waiting for the farm to settle ({n} workers)")

    def _encode_job(self, job: Job, token: str, frames, settings, meta,
                    stage: list) -> list:
        co = self.coordinator
        target_kbps = float(settings.get("target_bitrate_kbps", 0.0))
        if str(settings.rc_mode) == "vbr2pass" and target_kbps > 0:
            co.activity.emit(
                "encode", "vbr2pass encodes on the coordinator mesh "
                "(global QP solve)", job_id=job.id, host=self.host)
            return super()._encode_job(job, token, frames, settings,
                                       meta, stage)
        if str(getattr(job, "processing_mode", "split") or "split") \
                == "direct":
            co.activity.emit(
                "encode", "direct mode: whole-clip encode on the "
                "coordinator mesh (admission policy bypasses the farm "
                "split)", job_id=job.id, host=self.host)
            return super()._encode_job(job, token, frames, settings,
                                       meta, stage)

        stage[0] = "segment"
        plan, shards, reused = self._plan_or_resume(
            job, token, settings, meta, len(frames))
        banded = bool(shards) and shards[0].shape == "band"
        parts_total = plan.num_gops * (len(shards) if banded else 1)
        co.update_progress(job.id, token, parts_total=parts_total,
                           segment_progress=100.0)
        if banded:
            note = (f"{plan.num_gops} GOPs x {len(shards)} band "
                    f"slices (farm SFE, {shards[0].total_bands} bands)")
            act = note
        else:
            note = f"{plan.num_gops} GOPs in {len(shards)} shards"
            act = f"{plan.num_gops} GOPs as {len(shards)} shards"
        co.heartbeat_job(job.id, token, stage[0], host=self.host,
                         note=note)
        co.activity.emit(
            "shard", f"dispatching {act} to the worker farm"
            + (f" ({reused} resumed from the spool)" if reused else ""),
            job_id=job.id, host=self.host)

        stage[0] = "encode"
        done_shards = self._drain_board(job, token, settings, shards)
        if banded:
            segments = stitch_band_shards(done_shards)
        else:
            segments = [seg for shard in done_shards
                        for seg in shard.segments]
        segments.sort(key=lambda s: s.gop.index)
        return segments

    def _drain_board(self, job: Job, token: str, settings,
                     shards: list[Shard]) -> list[Shard]:
        """Post the shards and babysit the farm until every one is
        DONE: lease sweeps, progress writes (only on change — the store
        is journal-backed), the all-workers-dead failsafe, and
        token-fenced cleanup. Returns the completed shard records."""
        self.board.add_job(
            job.id, shards,
            max_attempts=int(settings.part_failure_max_retries),
            backoff_s=float(settings.remote_retry_backoff_s),
            quarantine_after=int(settings.remote_worker_max_failures),
            token=token)
        try:
            return self._wait_board(job, token, settings)
        finally:
            self.board.cancel_job(job.id, token=token)

    def _wait_board(self, job: Job, token: str, settings,
                    report_progress: bool = True) -> list[Shard]:
        """Babysit the posted board entry to completion (the shared
        tail of _drain_board and the live catch-up fan-out, which owns
        its board entry's lifecycle — and its progress counters)."""
        co = self.coordinator
        grace = float(settings.remote_no_worker_grace_s)
        workerless_since: float | None = None
        last_progress = (-1, -1)
        while True:
            if not co.token_is_current(job.id, token):
                raise HaltedError("stale run token")
            self.board.requeue_expired()
            done, total, retried, failed, failed_host = \
                self.board.job_progress(job.id)
            if report_progress and (done, retried) != last_progress:
                last_progress = (done, retried)
                co.update_progress(
                    job.id, token, parts_done=done,
                    parts_retried=retried,
                    encode_progress=100.0 * done / max(1, total))
            if failed:
                raise RuntimeError(failed)
            if done >= total:
                return self.board.take_shards(job.id, token=token)
            live = self._live_workers()
            if live:
                workerless_since = None
            else:
                now = self._clock()
                if workerless_since is None:
                    workerless_since = now
                elif now - workerless_since > grace:
                    raise RuntimeError(
                        f"no live encode workers for {grace:.0f}s; "
                        f"{total - done} GOPs stranded")
            co.heartbeat_job(
                job.id, token, "encode", host=self.host,
                note=f"{done}/{total} GOPs on {len(live)} workers")
            time.sleep(self.poll_s)

    # -- live catch-up fan-out -----------------------------------------

    #: minimum whole backlog GOPs (beyond the live-edge GOP kept
    #: local) before a live batch fans across the farm: a one-GOP
    #: round-trip would put worker latency inside the glass-to-
    #: playlist path for nothing
    LIVE_FARM_MIN_GOPS = 2

    def _live_backlog_cap(self, job, settings, enc) -> int:
        """Catch-up batches may span the whole farm's width, not just
        the local card: the farm absorbs the backlog while the edge
        GOP encodes locally. When the fan-out cannot engage (knob off,
        direct-mode job), the LOCAL wave bound stays in force — an
        inflated batch would otherwise serialize whole farm-widths of
        GOPs through the local card before the packager sees a part."""
        base = enc.num_devices * enc.gops_per_wave
        if not bool(settings.get("live_farm_catchup", True))                 or str(getattr(job, "processing_mode", "split")
                       or "split") == "direct":
            return base
        return base * max(1, len(self._live_workers()))

    def _live_encode_batch(self, job: Job, token: str, settings, enc,
                           rungs, tail, frames_done: int,
                           gops_done: int, count: int, gop_n: int,
                           sfe_live: bool):
        """Fan a live job's catch-up GOPs across the farm while the
        NEWEST GOP (the live edge) encodes on the coordinator mesh —
        the farm eats the backlog concurrently with the edge, so one
        host's throughput no longer bounds how fast a live stream
        recovers. Small batches (the steady live edge) stay entirely
        local: a worker round-trip inside the glass-to-playlist path
        would only add latency."""
        from ..abr.ladder import LadderGopBundle

        workers = self._live_workers()
        farm_gops = count // gop_n - 1      # newest GOP stays local
        if (not bool(settings.get("live_farm_catchup", True))
                or not workers
                or farm_gops < self.LIVE_FARM_MIN_GOPS
                or str(getattr(job, "processing_mode", "split")
                       or "split") == "direct"):
            return super()._live_encode_batch(
                job, token, settings, enc, rungs, tail, frames_done,
                gops_done, count, gop_n, sfe_live)
        co = self.coordinator
        farm_frames = farm_gops * gop_n
        plan = SegmentPlan(
            gops=tuple(GopSpec(index=gops_done + i,
                               start_frame=frames_done + i * gop_n,
                               num_frames=gop_n)
                       for i in range(farm_gops)),
            num_devices=max(1, len(workers)), frames_per_gop=gop_n)
        shards: list[Shard] = []
        for rung in rungs:
            shards.extend(self._shards_for(job, tail.meta, plan,
                                           settings, qp=rung.qp,
                                           rung=rung, token=token))
        co.activity.emit(
            "shard", f"live catch-up: farming {farm_gops} backlog "
            f"GOPs x {len(rungs)} rungs across {len(workers)} workers "
            f"while the edge encodes locally",
            job_id=job.id, host=self.host)
        self.board.add_job(
            job.id, shards,
            max_attempts=int(settings.part_failure_max_retries),
            backoff_s=float(settings.remote_retry_backoff_s),
            quarantine_after=int(settings.remote_worker_max_failures),
            token=token)
        try:
            # edge GOP (+ any EOS partial tail) locally, farm in flight
            local = super()._live_encode_batch(
                job, token, settings, enc, rungs, tail,
                frames_done + farm_frames, gops_done + farm_gops,
                count - farm_frames, gop_n, sfe_live)
            try:
                done_shards = self._wait_board(job, token, settings,
                                               report_progress=False)
            except HaltedError:
                raise
            except RuntimeError as exc:
                # the farm died under the catch-up batch (shard budget
                # burned, all workers dark): a live stream must not
                # fail for it — nothing was consumed yet, so encode
                # the span locally (deterministic: identical bytes)
                co.activity.emit(
                    "shard", f"live catch-up farm failed ({exc}); "
                    f"re-encoding the {farm_gops}-GOP span locally",
                    job_id=job.id, host=self.host)
                self.board.cancel_job(job.id, token=token)
                return super()._live_encode_batch(
                    job, token, settings, enc, rungs, tail,
                    frames_done, gops_done, farm_frames, gop_n,
                    sfe_live) + local
        finally:
            self.board.cancel_job(job.id, token=token)
        by_gop: dict[int, dict] = {}
        gop_of: dict[int, GopSpec] = {}
        for shard in done_shards:
            for seg in shard.segments:
                name = shard.rung or rungs[0].name
                by_gop.setdefault(seg.gop.index, {})[name] = seg
                gop_of[seg.gop.index] = seg.gop
        farm_bundles = [
            LadderGopBundle(gop=gop_of[i], renditions=by_gop[i])
            for i in sorted(by_gop)]
        for b in farm_bundles:
            missing = [r.name for r in rungs
                       if r.name not in b.renditions]
            if missing:
                raise RuntimeError(
                    f"live catch-up GOP {b.gop.index} missing rungs "
                    f"{missing}")
        return farm_bundles + local

    def _encode_ladder(self, job: Job, token: str, frames, settings,
                       meta, stage: list):
        """Ladder jobs on the farm: rungs × GOP-range shards fan across
        the workers (every rung shares ONE GOP plan, so segments align
        no matter which host encodes which rung) and the coordinator
        only groups the streamed-back parts per rung for packaging.
        Direct-mode jobs still encode whole on the coordinator mesh."""
        from ..abr.ladder import plan_ladder

        co = self.coordinator
        if str(getattr(job, "processing_mode", "split") or "split") \
                == "direct":
            co.activity.emit(
                "encode", "direct mode: whole-ladder encode on the "
                "coordinator mesh", job_id=job.id, host=self.host)
            return super()._encode_ladder(job, token, frames, settings,
                                          meta, stage)

        stage[0] = "segment"
        rungs = plan_ladder(meta, settings)
        plan, shards, reused = self._plan_or_resume(
            job, token, settings, meta, len(frames), rungs=rungs)
        total_parts = plan.num_gops * len(rungs)
        co.update_progress(job.id, token, parts_total=total_parts,
                           segment_progress=100.0)
        co.heartbeat_job(
            job.id, token, stage[0], host=self.host,
            note=f"{plan.num_gops} GOPs x {len(rungs)} rungs in "
                 f"{len(shards)} shards")
        co.activity.emit(
            "shard", f"dispatching {plan.num_gops} GOPs x {len(rungs)} "
            f"rungs as {len(shards)} shards to the worker farm"
            + (f" ({reused} resumed from the spool)" if reused else ""),
            job_id=job.id, host=self.host)

        stage[0] = "encode"
        by_rung: dict[str, list] = {r.name: [] for r in rungs}
        for shard in self._drain_board(job, token, settings, shards):
            by_rung[shard.rung or rungs[0].name].extend(shard.segments)
        for segs in by_rung.values():
            segs.sort(key=lambda s: s.gop.index)
        return rungs, by_rung


def stitch_band_shards(shards: Iterable[Shard]) -> list[EncodedSegment]:
    """Zip a band-sharded job's per-GOP slice streams back into whole
    pictures: for every GOP, frame f's access unit is the concat of
    every band group's frame-f slice bytes in band order (group 0
    carries the SPS/PPS prefix on IDR frames). Byte-identical to what
    a one-card SfeShardEncoder with the same global band layout
    emits — the downstream stitch/mux path needs no band awareness."""
    groups = sorted((s for s in shards if s.shape == "band"),
                    key=lambda s: s.band_start)
    if not groups:
        return []
    per = [{seg.gop.index: seg for seg in s.segments} for s in groups]
    indices = sorted(per[0])
    out: list[EncodedSegment] = []
    for gi in indices:
        segs = []
        for p, s in zip(per, groups):
            if gi not in p:
                raise ValueError(
                    f"band shard {s.id} is missing GOP {gi}")
            segs.append(p[gi])
        nframes = {len(s.frame_sizes) for s in segs}
        if len(nframes) != 1:
            raise ValueError(
                f"band shards disagree on GOP {gi}'s frame count: "
                f"{sorted(len(s.frame_sizes) for s in segs)}")
        payload = bytearray()
        sizes = []
        offs = [0] * len(segs)
        for f in range(nframes.pop()):
            total = 0
            for k, seg in enumerate(segs):
                sz = seg.frame_sizes[f]
                payload += seg.payload[offs[k]:offs[k] + sz]
                offs[k] += sz
                total += sz
            sizes.append(total)
        out.append(EncodedSegment(gop=segs[0].gop,
                                  payload=bytes(payload),
                                  frame_sizes=tuple(sizes)))
    return out


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


class UnsupportedShardShape(RuntimeError):
    """The claim descriptor carries a shard shape this worker does not
    implement (version skew on a rolling upgrade): reported as
    `unsupported` so the board requeues with NO attempt burned and
    stops offering the shard to this host."""


def _encode_band_shard(desc: Mapping[str, Any], frames, tracer=None,
                       halo_transport=None, device="cuda", mesh=None
                       ) -> list[EncodedSegment]:
    """Encode one frame-band shard: this host owns bands
    [start, start+count) of the job's `total`-band layout, steps the
    shard's whole GOP walk in lockstep with the sibling groups, and
    exchanges per-frame halo rows / probe partials / histogram
    partials through `halo_transport` (cluster/halo.py — the
    coordinator-relayed route). Bit-identity contract as
    parallel/sfefarm.py documents."""
    from ..core.config import get_settings
    from ..parallel.dispatch import make_shard_encoder
    from .halo import HaloSession

    meta = meta_from_dict(desc["meta"])
    gops = tuple(GopSpec(index=int(i), start_frame=int(s),
                         num_frames=int(n))
                 for i, s, n in desc["gops"])
    band = desc.get("band") or {}
    lo = int(band.get("start", 0))
    cnt = max(1, int(band.get("count", 1) or 1))
    total = int(band.get("total", 0) or 0) or (lo + cnt)
    groups = [(int(a), int(b))
              for a, b in (band.get("groups") or [[lo, lo + cnt]])]
    session = None
    if len(groups) > 1:
        if halo_transport is None:
            raise ValueError(
                "band shard has sibling groups but no halo transport")
        session = HaloSession(halo_transport, band_lo=lo,
                              band_hi=lo + cnt, groups=groups)
    enc = make_shard_encoder(
        meta, get_settings(), mesh, shape="band",
        qp=int(desc["qp"]), total_bands=total,
        band_range=(lo, lo + cnt),
        halo_rows=int(band.get("halo_rows", 32) or 32),
        session=session, device=device)
    if tracer is not None:
        enc.stages.set_tracer(tracer)
    enc.plan_override = SegmentPlan(
        gops=gops, num_devices=enc.num_devices,
        frames_per_gop=int(desc.get("gop_frames", 32)))
    enc.gop_index_offset = int(desc["gop_index_offset"])
    enc.frame_offset = int(desc["start_frame"])
    f0 = int(desc["start_frame"])
    sub = frames[f0:f0 + int(desc["num_frames"])]
    if len(sub) != int(desc["num_frames"]):
        raise ValueError(
            f"{desc['input_path']}: band shard wants frames "
            f"[{f0}, {f0 + int(desc['num_frames'])}) but clip has "
            f"{len(frames)}")
    return enc.encode(sub)


def encode_shard(desc: Mapping[str, Any], frames, tracer=None,
                 halo_transport=None, device="cuda",
                 mesh=None) -> list[EncodedSegment]:
    """Encode one claimed shard on `device` (the card by default; it
    raises without one unless ``"cpu"`` is asked for), or on `mesh` (a
    DeviceMesh: a GOP shard's waves spread over its entries, a band
    slice's bands as one run an entry). Pure w.r.t.
    the descriptor: the plan override pins the coordinator's exact GOP
    boundaries and the index/frame offsets re-base the emitted segments
    to global coordinates, so the part is bit-identical to what a
    single-process encode of the whole clip would have produced for
    these GOPs.

    `frames` may be a materialized list of the WHOLE clip or a lazy
    FrameSource (ingest.open_video): slicing a source yields a window
    that decodes only this shard's [f0, f0+n) frame range — O(shard)
    decode work and resident memory per claim instead of O(clip).

    The encoder is built from this process's settings snapshot, so a
    worker inherits the full collect path — compact device→host level
    transfer (TVT_COMPACT_TRANSFER), per-shard concurrent fetch, and
    the pack backend (TVT_PACK_BACKEND) — from its own environment;
    output stays bit-identical to the coordinator's plan regardless of
    which transfer/pack path each worker takes (parity-tested).

    `tracer` (an obs/trace span sink — the daemon's SpanBuffer) binds
    to the encoder's stage profile so the worker's decode/dispatch/
    fetch/pack stages become spans in the job's distributed trace."""
    from ..parallel.dispatch import GopShardEncoder

    shape = str(desc.get("shape", "gop") or "gop")
    if shape == "band":
        return _encode_band_shard(desc, frames, tracer=tracer,
                                  halo_transport=halo_transport,
                                  device=device, mesh=mesh)
    if shape != "gop":
        raise UnsupportedShardShape(
            f"shard shape {shape!r} not implemented by this worker")
    meta = meta_from_dict(desc["meta"])
    gops = tuple(GopSpec(index=int(i), start_frame=int(s),
                         num_frames=int(n))
                 for i, s, n in desc["gops"])
    rung_desc = desc.get("rung")
    rung = None
    if rung_desc and (int(rung_desc["width"]), int(rung_desc["height"])) \
            != (meta.width, meta.height):
        # scaled ladder rung: decode at source resolution, derive the
        # rung on THIS worker's card (abr/scale.py), encode at the
        # rung's dims — the wire still carries plain segments
        from ..abr.ladder import LadderShardEncoder, Rung

        rung = Rung(name=str(rung_desc.get("name", "rung")),
                    width=int(rung_desc["width"]),
                    height=int(rung_desc["height"]), qp=int(desc["qp"]))
        enc = LadderShardEncoder(meta, [rung],
                                 gop_frames=int(desc.get("gop_frames",
                                                         32)),
                                 device=device, mesh=mesh)
    else:
        enc = GopShardEncoder(meta, qp=int(desc["qp"]),
                              gop_frames=int(desc.get("gop_frames", 32)),
                              device=device, mesh=mesh)
    if tracer is not None:
        enc.stages.set_tracer(tracer)
    enc.plan_override = SegmentPlan(
        gops=gops, num_devices=enc.num_devices,
        frames_per_gop=int(desc.get("gop_frames", 32)))
    enc.gop_index_offset = int(desc["gop_index_offset"])
    enc.frame_offset = int(desc["start_frame"])
    f0 = int(desc["start_frame"])
    sub = frames[f0:f0 + int(desc["num_frames"])]
    if len(sub) != int(desc["num_frames"]):
        raise ValueError(
            f"{desc['input_path']}: shard wants frames "
            f"[{f0}, {f0 + int(desc['num_frames'])}) but clip has "
            f"{len(frames)}")
    if rung is not None:
        return [b.renditions[rung.name] for b in enc.encode(sub)]
    return enc.encode(sub)


class WorkerClient:
    """Minimal stdlib HTTP client for the /work/* routes.

    Every request retries through transient transport failures —
    connection refused, resets, HTTP 5xx — with jittered exponential
    backoff (`remote_http_retries` × `remote_http_backoff_s`): a
    coordinator restart window (a few seconds of refused connections
    while the journal replays) must not fail shards or quarantine
    healthy workers. All three verbs are safe to repeat: claims are
    leases (a lost grant expires into the sweep), part uploads are
    idempotent via their digests (duplicates drop at the board), and
    failure reports are absorbing."""

    def __init__(self, base_url: str, timeout_s: float = 30.0,
                 retries: int | None = None,
                 backoff_s: float | None = None) -> None:
        from ..core.config import get_settings

        self.base = base_url.rstrip("/")
        self.timeout_s = timeout_s
        snap = get_settings()
        self.retries = int(snap.get("remote_http_retries", 4)) \
            if retries is None else max(0, int(retries))
        self.backoff_s = float(snap.get("remote_http_backoff_s", 0.5)) \
            if backoff_s is None else max(0.0, float(backoff_s))

    #: integrity-rejection re-sends per upload, ON TOP of the
    #: transport retries inside each _request: more than a couple of
    #: consecutive digest rejects means the corruption is persistent
    #: and re-encoding (via the requeued lease) is the better path —
    #: a full retries×retries product would defeat the configured
    #: bound on how long one upload can mask a dead coordinator
    INTEGRITY_RESENDS = 2

    def _request(self, path: str, data: bytes, content_type: str,
                 timeout_s: float | None = None,
                 trace_id: str = "") -> dict[str, Any]:
        import urllib.request

        from ..core.retry import call_with_backoff

        headers = {"Content-Type": content_type}
        if trace_id:
            # the remote worker protocol's trace-context header —
            # consumed by POST /work/spans, where the coordinator
            # validates it against the job's LIVE trace and drops
            # stale-run stragglers
            headers["X-Tvt-Trace"] = trace_id

        def send() -> dict[str, Any]:
            req = urllib.request.Request(
                self.base + path, data=data, method="POST",
                headers=headers)
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as resp:
                return json.loads(resp.read())

        return call_with_backoff(send, self.retries, self.backoff_s)

    def claim(self, host: str) -> dict[str, Any] | None:
        out = self._request("/work/claim",
                            json.dumps({"host": host}).encode(),
                            "application/json")
        return out.get("shard")

    def upload_part(self, shard_id: str, host: str,
                    segments: list[EncodedSegment]) -> bool:
        from ..core.retry import sleep_backoff

        data = pack_parts(segments)
        for attempt in range(self.INTEGRITY_RESENDS + 1):
            out = self._request(
                f"/work/part/{shard_id}?host={host}", data,
                "application/octet-stream",
                # parts can be large; scale the budget, floor at the
                # default
                timeout_s=max(self.timeout_s, 120.0))
            # digest rejection at ingest ({"retry": true}): the bytes
            # corrupted in TRANSIT, the lease came straight back with
            # no attempt burned — re-send the (idempotent) upload
            # instead of re-encoding the shard
            if out.get("ok") or not out.get("retry"):
                return bool(out.get("ok"))
            if attempt < self.INTEGRITY_RESENDS:
                sleep_backoff(attempt, self.backoff_s)
        return False

    def upload_spans(self, job_id: str, trace_id: str, host: str,
                     spans: list[dict[str, Any]]) -> int:
        """Ship a shard's collected spans to the coordinator's trace
        ring (POST /work/spans, trace id in X-Tvt-Trace). Returns how
        many the coordinator recorded."""
        out = self._request(
            "/work/spans", json.dumps({
                "job_id": job_id, "host": host, "spans": spans,
            }).encode(), "application/json", trace_id=trace_id)
        return int(out.get("recorded", 0))

    def report_failure(self, shard_id: str, host: str, error: str,
                       unsupported: bool = False) -> None:
        self._request("/work/status", json.dumps({
            "shard_id": shard_id, "host": host, "ok": False,
            "unsupported": bool(unsupported),
            "error": error[:500]}).encode(), "application/json")


class WorkerDaemon:
    """Claim → range-decode → encode → stream-back loop.

    One daemon per worker host (`python -m thinvids_tpu_torch.cli
    worker`), encoding on `device` (the card by default; it raises
    without one unless ``"cpu"`` is asked for), or on `mesh` (a
    core.devices.DeviceMesh: a GOP shard's waves and a band slice's runs
    of bands spread over its entries). It advertises the devices it
    encodes on: the mesh's entries, else one.
    The source cache holds the last `CACHE_CLIPS` OPENED inputs keyed
    by path+signature (header/demux state, compressed samples for mp4 —
    never decoded frames), and each claimed shard decodes only its own
    [f0, f0+n) frame range through the lazy slice — O(shard) decode
    work and memory per claim instead of decoding the whole clip to
    cut out one range (the farm analog of the reference worker's local
    scratch copy of its segment range)."""

    CACHE_CLIPS = 2

    def __init__(self, coordinator_url: str, host: str | None = None,
                 poll_s: float | None = None,
                 client: WorkerClient | None = None,
                 device="cuda", mesh=None) -> None:
        from ..core.config import get_settings
        from ..core.devices import as_mesh, resolve_device

        resolve_device(device)      # no card, no worker: raise now
        self.mesh = as_mesh(mesh) if mesh is not None else None

        self.host = host or socket.gethostname()
        self.client = client or WorkerClient(coordinator_url)
        # floor regardless of source: the env tier is coerced but not
        # clamped, and a non-positive poll busy-spins /work/claim
        self.poll_s = max(0.05, poll_s if poll_s is not None else
                          float(get_settings().remote_claim_poll_s))
        self.device = device
        self.busy = False
        self.shards_done = 0
        self.shards_failed = 0
        self._device_count = self.mesh.size if self.mesh is not None \
            else 1
        #: input_path → (signature, opened FrameSource — no decoded
        #: frames cached; shards range-decode on demand)
        self._cache: dict[str, tuple[str, Any]] = {}

    # -- metrics seam (NodeAgent extra_metrics) ------------------------

    def metrics(self) -> dict[str, Any]:
        # the heartbeat advertises the devices this worker encodes on,
        # so the coordinator's band planner can clamp a shard's band
        # count to the SLOWEST worker's: its mesh's entries, else its
        # one `device`
        return {"worker": True, "worker_busy": self.busy,
                "worker_devices": self._device_count,
                "worker_shards_done": self.shards_done,
                "worker_shards_failed": self.shards_failed}

    # -- source cache --------------------------------------------------

    def _frames(self, input_path: str):
        """Open (header parse / demux — NOT decode) the clip, cached by
        path+signature. The shard slice taken in step() is a lazy
        window over this source, so each claim decodes only its own
        [f0, f0+n) frame range."""
        from ..ingest.decode import open_video
        from ..ingest.watcher import file_signature

        sig = file_signature(input_path)
        hit = self._cache.get(input_path)
        if hit is not None and hit[0] == sig:
            return hit[1]
        # source only: the shard encode never touches meta (the shard
        # descriptor carries it) or audio (the coordinator muxes it)
        source = open_video(input_path)
        self._cache[input_path] = (sig, source)
        while len(self._cache) > self.CACHE_CLIPS:
            self._cache.pop(next(iter(self._cache)))
        return source

    # -- loop ----------------------------------------------------------

    def step(self) -> bool:
        """One claim attempt. Returns True when a shard was processed
        (successfully or not), False when the board had nothing.

        When the claim descriptor carries a trace context, the shard's
        worker-side spans (source open, encode incl. the encoder's
        stage clocks, part upload) collect in a local SpanBuffer and
        ship to the coordinator's trace ring afterwards — best-effort,
        never part of the shard's success or failure."""
        from .halo import HaloClient, HaloStaleError

        shard = self.client.claim(self.host)
        if not shard:
            return False
        trace = shard.get("trace") or {}
        buf = obs_trace.SpanBuffer(
            str(trace.get("trace_id", "")), str(trace.get("job_id", "")),
            host=self.host) if trace.get("trace_id") else None
        # inert recorder when untraced: span() is a no-op context, so
        # the work loop below stays unconditional
        sink = buf if buf is not None else obs_trace.NULL_RECORDER
        halo_transport = None
        if str(shard.get("shape", "gop") or "gop") == "band":
            band = shard.get("band") or {}
            halo_transport = HaloClient(
                self.client.base, str(shard.get("job_id", "")),
                int(band.get("gen", 1) or 1))
        self.busy = True
        try:
            with sink.span("worker_shard", shard=shard["id"],
                           attempt=shard.get("attempt", 0)):
                with sink.span("open_source"):
                    frames = self._frames(shard["input_path"])
                segments = encode_shard(shard, frames, tracer=buf,
                                        halo_transport=halo_transport,
                                        device=self.device, mesh=self.mesh)
                # the board may refuse the part (lease moved on, job
                # gone): only an ACCEPTED part counts toward the gauge
                with sink.span("upload_part"):
                    accepted = self.client.upload_part(
                        shard["id"], self.host, segments)
            if accepted:
                self.shards_done += 1
        except HaloStaleError:
            # the band group restarted under a newer halo generation:
            # the board already took this lease back (sibling requeue),
            # so abandon silently — not a failure, nothing to report
            pass
        except UnsupportedShardShape as exc:
            try:
                self.client.report_failure(
                    shard["id"], self.host, str(exc), unsupported=True)
            except Exception:       # noqa: BLE001 - coordinator gone;
                pass                # the lease sweep requeues the shard
        except Exception as exc:    # noqa: BLE001 - report, keep serving
            self.shards_failed += 1
            try:
                self.client.report_failure(
                    shard["id"], self.host,
                    f"{type(exc).__name__}: {exc}")
            except Exception:       # noqa: BLE001 - coordinator gone;
                pass                # the lease sweep requeues the shard
        finally:
            self.busy = False
            if buf is not None:
                try:
                    self.client.upload_spans(
                        buf.job_id, buf.trace_id, self.host, buf.drain())
                except Exception:   # noqa: BLE001 - tracing is never
                    pass            # allowed to fail the work loop
        return True

    def run_forever(self, stop: threading.Event | None = None) -> None:
        from ..core.log import get_logging

        log = get_logging("thinvids_tpu_torch.worker")
        stop = stop or threading.Event()
        claim_failures = 0
        while not stop.is_set():
            try:
                worked = self.step()
                claim_failures = 0
            except Exception as exc:  # noqa: BLE001 - claim failed
                worked = False        # (coordinator restarting): back off
                claim_failures += 1
                # throttled: surface a misconfigured coordinator (e.g.
                # local backend → /work 503) instead of idling silently
                if claim_failures in (1, 10) or claim_failures % 100 == 0:
                    log.warning(
                        "claim against %s failing (x%d): %s",
                        self.client.base, claim_failures, exc)
            if not worked:
                stop.wait(self.poll_s)
