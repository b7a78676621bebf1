"""GOP wave dispatch on one device: closed GOPs encoded in waves, levels
fetched compactly, slices entropy-packed on the host.

A wave of GOPs is staged (frames stacked into (G, F, H, W) arrays and
uploaded), dispatched (each GOP's IDR + P compute and device-side
transfer pack, torchinter.encode_gop_planes + torchcore's two-tier
sparse pack folded into one byte payload), and collected on a collector
thread: the tiny counts first, then only the used prefix of the payload,
then unpack + unflatten + CAVLC pack of every slice on the pack pool.
Encoded segments concat in GOP index order.

The reference's other forms of the same encoder are here too, each
bit-identical to it: every RD config (``rd``: mode decision, AQ, the
P_Skip bias and in-loop deblocking, with the intra mode/QP side channel
riding the dense prefix); the all-intra wave (``inter=False``: every
frame an IDR, per-frame element-granular sparse transfer,
torchcore._sparse_pack);
the three-array sparse2 transfer (``compact_transfer=False``); and
``pack_backend=process``, shared-memory pack sidecars (packproc.py) that
unpack + pack whole GOPs outside this process's GIL, degrading to an
inline pack of the same spool if the pool breaks. Every knob resolves
from the settings snapshot (core/config) in the reference's order, and
:func:`make_shard_encoder` is the settings-driven seam a job executor
calls (``encoder_factory``).

Host side, the pipeline is instrumented per stage (StageProfile): every
wave's source decode / staging (stack + H2D upload) / dispatch / device
wait / D2H fetch / sparse unpack / unflatten / CAVLC pack / concat
wall-clock accumulates on the encoder.

Ingest is a pipelined stage: `stage_waves` accepts a streaming source
(anything with ``iter_frames()``) or a materialized list and holds only
the current wave's decoded frames (a sliding _FrameCursor window), and
:func:`background_stage` runs the decode→stack→upload chain on a staging
thread up to `decode_ahead` waves ahead of dispatch.

Split-frame encoding (:class:`SfeShardEncoder`, ``sfe_bands > 0``) is
the single-stream latency mode: every frame is cut into MB-row bands,
each band its own slice, held on the card as a band stack (one run of
bands a mesh entry) and stepped one frame at a time.

On a :class:`~..core.devices.DeviceMesh` one host thread enqueues every
entry's work in entry order, each on its own card's default stream.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core.config import as_bool, get_settings
# re-exported: the reference's default_mesh lives in parallel/dispatch
from ..core.devices import DeviceMesh, as_mesh, default_mesh  # noqa: F401
from ..core.types import (BandPlan, EncodedSegment, Frame, GopSpec,
                          SegmentPlan, VideoMeta, is_yuv420)
from ..obs import metrics as obs_metrics
from ..codecs.h264 import torchcore, torchinter, torchme
from ..codecs.h264.encoder import (FrameLevels, _mode_policy,
                                   gop_slice_thunks_planes, pack_slice,
                                   unpack_mode16)
from ..codecs.h264.headers import PPS, SPS
from ..codecs.h264.layout import _INTRA_FLAT_MB as _INTRA_MB
from ..codecs.h264.layout import (_P_FLAT_MB, unflatten_gop,
                                  unflatten_gop_parts, unflatten_intra,
                                  unflatten_p_planes, unpack_compact_auto)
from ..codecs.h264.rdo import RD_OFF, RdConfig, rd_from_settings
from .planner import plan_bands, plan_fixed_segments, plan_segments

_LOG = logging.getLogger(__name__)


# ---- host-stage wall-clock instrumentation --------------------------------

#: canonical stage keys, in pipeline order (the reference's names; the
#: stages this single-device encoder never enters stay at 0)
STAGE_NAMES = ("decode", "stage", "scale", "dispatch", "device_wait",
               "fetch", "dense_retry", "sparse_unpack", "unflatten",
               "pack", "concat", "sfe", "halo")

#: monotonic counters riding in the same snapshot as the stage clocks
STAGE_COUNTERS = ("dense_fallback_waves", "h2d_bytes", "d2h_bytes",
                  "fetch_shards", "proc_pack_gops", "sfe_frames")


class StageProfile:
    """Thread-safe per-stage wall-clock accumulator for the host half of
    the wave pipeline. Stages overlap across pool threads, so per-stage
    sums can exceed elapsed time — they answer "where do host cycles
    go", not "what is the critical path".

    `mirror` (the process-wide cumulative profile) receives every add
    too, so a job's totals outlive its encoder; reset() only clears THIS
    profile (a timed pass resets without zeroing the process counters)."""

    def __init__(self, mirror: "StageProfile | None" = None,
                 metrics: bool = False) -> None:
        self._lock = threading.Lock()
        self._ms = {k: 0.0 for k in STAGE_NAMES}
        self._counts = {k: 0 for k in STAGE_COUNTERS}
        self._waves = 0
        self._mirror = mirror
        #: bridge into the obs/ metrics registry — set ONLY on the
        #: process-cumulative _TOTALS instance, so every add lands in
        #: the registry exactly once (per-encoder profiles mirror into
        #: _TOTALS, which forwards)
        self._metrics = bool(metrics)
        #: optional span recorder (obs/trace): an executor binds one per
        #: traced job so each timed stage also records a span in the
        #: job's trace. None = zero tracing overhead.
        self._tracer = None

    def set_tracer(self, recorder) -> None:
        """Bind (or clear, with None/an inert recorder) the span sink
        this profile's stage() blocks record into."""
        with self._lock:
            self._tracer = recorder if recorder is not None \
                and getattr(recorder, "enabled", False) else None

    def tracer(self):
        """The bound span recorder, or None (instrumentation sites
        that record spans outside a stage() block read this)."""
        return self._tracer

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._ms[stage] = self._ms.get(stage, 0.0) + seconds * 1e3
        if self._metrics:
            obs_metrics.STAGE_SECONDS.labels(stage).inc(seconds)
        if self._mirror is not None:
            self._mirror.add(stage, seconds)

    def bump(self, counter: str, n: int = 1) -> None:
        """Increment a monotonic counter (STAGE_COUNTERS) by `n`."""
        with self._lock:
            self._counts[counter] = self._counts.get(counter, 0) + int(n)
        if self._metrics:
            metric = obs_metrics.STAGE_COUNTER_TOTALS.get(counter)
            if metric is not None:
                metric.inc(n)
        if self._mirror is not None:
            self._mirror.bump(counter, n)

    @contextlib.contextmanager
    def stage(self, name: str, **tags):
        tracer = self._tracer
        t0_wall = time.time() if tracer is not None else 0.0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt)
            if tracer is not None:
                tracer.record(name, t0_wall, dt, **tags)

    def count_wave(self) -> None:
        with self._lock:
            self._waves += 1
        if self._metrics:
            obs_metrics.WAVES_TOTAL.inc()
        if self._mirror is not None:
            self._mirror.count_wave()

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: round(v, 2) for k, v in self._ms.items()}
            out.update(self._counts)
            out["waves"] = self._waves
            return out

    def reset(self) -> None:
        with self._lock:
            for k in self._ms:
                self._ms[k] = 0.0
            for k in self._counts:
                self._counts[k] = 0
            self._waves = 0


#: process-cumulative stage totals (every encoder mirrors into this;
#: the metrics flag bridges each add into the obs/ Prometheus registry)
_TOTALS = StageProfile(metrics=True)


def stage_snapshot() -> dict:
    """Process-cumulative stage_ms across every GopShardEncoder that ran
    here (running jobs' waves land as they complete, and finished jobs'
    totals persist)."""
    return _TOTALS.snapshot()


#: process-cumulative SFE per-frame latency samples (ms) — the gaps
#: between consecutive frames' bitstream-ready times across every
#: SfeShardEncoder that ran here; each sample also observes the
#: tvt_sfe_frame_latency_seconds histogram.
_SFE_LAT_MS: deque = deque(maxlen=4096)
#: guards ring iteration vs the collector threads' appends (a deque
#: mutated mid-iteration raises RuntimeError)
_SFE_LAT_LOCK = threading.Lock()


def frame_latency_percentiles() -> dict:
    """{"p50_ms", "p99_ms", "count"} over the recent SFE per-frame
    latency ring; {} when no SFE frame ever completed here."""
    with _SFE_LAT_LOCK:
        samples = sorted(_SFE_LAT_MS)
    pct = obs_metrics.percentiles(samples, {"p50_ms": 0.50,
                                            "p99_ms": 0.99})
    if not pct:
        return {}
    return {k: round(v, 1) for k, v in pct.items()} \
        | {"count": len(samples)}


class _FrameCursor:
    """Sliding decoded-frame window for wave staging.

    Pulls frames on demand from a materialized list or a streaming
    source (anything exposing ``iter_frames()``), pads them to
    macroblock multiples, and retains only ``[lo, hi)`` — the staging
    loop releases everything below the staged wave's end, so resident
    decoded frames stay bounded by one wave regardless of clip length."""

    def __init__(self, frames, profile: StageProfile,
                 require_420: bool = False,
                 stats: dict | None = None) -> None:
        iter_fn = getattr(frames, "iter_frames", None)
        self._it = iter_fn() if iter_fn is not None else iter(frames)
        self._profile = profile
        self._require_420 = require_420
        self._stats = stats if stats is not None else {}
        self._buf: deque = deque()      # padded frames [lo, hi)
        self._lo = 0
        self._hi = 0

    def get(self, i: int) -> Frame:
        """Padded frame at absolute index `i` (must not be released)."""
        if i < self._lo:
            raise IndexError(
                f"frame {i} already released (window starts at "
                f"{self._lo})")
        while self._hi <= i:
            with self._profile.stage("decode"):
                try:
                    f = next(self._it)
                except StopIteration:
                    raise ValueError(
                        f"frame stream ended at {self._hi}, but the "
                        f"wave plan needs frame {i}") from None
            # by value: frames from another package's ingest carry its
            # own ChromaFormat enum
            if self._require_420 and not is_yuv420(f):
                raise ValueError(
                    f"GopShardEncoder supports only 4:2:0 input, got "
                    f"{f.chroma.name}; convert before encoding")
            self._buf.append(f.padded(16))
            self._hi += 1
            if len(self._buf) > self._stats.get("peak_resident_frames", 0):
                self._stats["peak_resident_frames"] = len(self._buf)
        return self._buf[i - self._lo]

    def release_below(self, i: int) -> None:
        while self._lo < i and self._buf:
            self._buf.popleft()
            self._lo += 1


def background_stage(staged_waves, decode_ahead: int = 2):
    """Run a staging generator (stage_waves: source decode + np.stack +
    H2D upload) on its own thread, up to `decode_ahead` staged waves
    ahead of the consumer.

    Each queued wave is ALREADY uploaded: device-side input residency
    is the consumer's in-flight window plus `decode_ahead` (+1 blocked
    in the put) waves of YUV arrays.

    Returns a generator yielding the staged tuples in order; close()
    (or exhaustion, or an exception propagating out) stops the staging
    thread and releases its decode window. Exceptions raised while
    staging re-raise at the consumer's next pull."""
    import queue as queue_mod

    q: queue_mod.Queue = queue_mod.Queue(max(1, int(decode_ahead)))
    stop = threading.Event()
    done = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def feed() -> None:
        try:
            for staged in staged_waves:
                if not _put(staged):
                    return
            _put(done)
        except BaseException as exc:    # noqa: BLE001 - relay to consumer
            _put(exc)
        finally:
            close = getattr(staged_waves, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=feed, daemon=True, name="tvt-stage")

    def drain():
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return drain()


def _sparse_unpack2_host(nblk: int, nval: int, bitmap, bmask16, vals,
                         L: int) -> np.ndarray:
    """Two-tier sparse unpack: native scatter when a compiler exists,
    layout's numpy version otherwise (identical output)."""
    from .. import native as native_mod
    from ..codecs.h264.layout import block_sparse_unpack2_host

    if native_mod.available():
        return native_mod.block_sparse_unpack2(nblk, nval, bitmap,
                                               bmask16, vals, L)
    return block_sparse_unpack2_host(nblk, nval, bitmap, bmask16, vals, L)


def _per_gop_sparse(y, u, v, qp: int, mbw: int, mbh: int,
                    compact: bool = True, rd=RD_OFF):
    """(F, H, W) GOP → (mv int8, dense intra-DC segments, two-tier
    sparse levels for the rest).

    BOTH intra hadamard DC segments — luma DC (nmb * 16) and chroma DC
    (nmb * 8) — ship DENSE: hadamard DC levels are the only ones that
    exceed int8 at practical QPs, and the sparse pack has no escape
    side-channel — an escape anywhere forces the wave-wide dense
    fallback.

    With `compact` (the default transfer) the rest folds into one
    contiguous byte payload (torchcore._compact_stream): (mv8, dense,
    nblk, nval, n_esc, used, payload). Without it the three sparse
    streams ship as they are: (mv8, dense, nblk, nval, n_esc, bitmap,
    bmask16, vals). With rd.ships_modes the intra [mode16 | dqp16]
    tail (the flat vector's last 2·nmb values) rides the dense prefix
    too."""
    mv8, flat = torchinter.encode_gop_planes(y, u, v, qp, mbw=mbw, mbh=mbh,
                                             rd=rd)
    nmb = mbw * mbh
    ndc, nlac, ncdc = nmb * 16, nmb * 240, nmb * 8
    dense_parts = [flat[:ndc], flat[ndc + nlac:ndc + nlac + ncdc]]
    if rd.ships_modes:
        # small, and mode 0 = V would defeat the sparse pack anyway
        dense_parts.append(flat[-2 * nmb:])
        rest = torch.cat([flat[ndc:ndc + nlac],
                          flat[ndc + nlac + ncdc:-2 * nmb]])
    else:
        rest = torch.cat([flat[ndc:ndc + nlac], flat[ndc + nlac + ncdc:]])
    dense = torch.cat(dense_parts)
    nblk, nval, n_esc, bitmap, bmask16, vals = \
        torchcore._block_sparse_pack2(rest)
    if not compact:
        return (mv8, dense, nblk, nval, n_esc, bitmap, bmask16, vals)
    used, payload = torchcore._compact_stream(nblk, nval, bitmap, bmask16,
                                              vals)
    return (mv8, dense, nblk, nval, n_esc, used, payload)


def _per_gop_dense(y, u, v, qp: int, mbw: int, mbh: int, rd=RD_OFF):
    _mv8, flat = torchinter.encode_gop_planes(y, u, v, qp, mbw=mbw, mbh=mbh,
                                              rd=rd)
    return flat


def _encode_gop_single(ys, us, vs, qps, *, mbw: int, mbh: int,
                       compact: bool = True, rd=RD_OFF):
    """One wave on one device: ys (G, F, H, W) uint8, qps (G,) host
    ints. Each GOP runs the per-GOP program in turn; the 7 (compact) or
    8 outputs stack over G."""
    outs = [_per_gop_sparse(ys[g], us[g], vs[g], int(qps[g]), mbw, mbh,
                            compact=compact, rd=rd)
            for g in range(ys.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _encode_gop_single_dense(ys, us, vs, qps, *, mbw: int, mbh: int,
                             rd=RD_OFF):
    """Dense fallback for the wave: (G, L) int16 levels."""
    return torch.stack([_per_gop_dense(ys[g], us[g], vs[g], int(qps[g]),
                                       mbw, mbh, rd=rd)
                        for g in range(ys.shape[0])])


def _encode_wave(ys, us, vs, qps, *, mbw: int, mbh: int, rd=RD_OFF):
    """All-intra wave: ys (G, F, H, W) uint8, qps (G,) host ints, the
    per-GOP QP (the rate-control hook). Every frame is coded intra at
    its GOP's QP and sparse-packed on its own (torchcore._sparse_pack:
    ~10x fewer device→host bytes than raw int32); the 6 outputs come
    back with leading (G, F) dims, and the host checks the nnz/escape
    counts for the rare dense fallback."""
    outs = []
    for g in range(ys.shape[0]):
        frames = [torchcore._sparse_pack(torchcore._flat_levels(
            ys[g, f], us[g, f], vs[g, f], int(qps[g]), mbw, mbh, rd))
            for f in range(ys.shape[1])]
        outs.append(tuple(torch.stack(parts) for parts in zip(*frames)))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _encode_wave_dense(ys, us, vs, qps, *, mbw: int, mbh: int,
                       rd=RD_OFF):
    """Dense fallback of the all-intra wave: (G, F, L) int16 levels (int16
    covers the full CAVLC level range), at the same per-GOP QPs."""
    return torch.stack([
        torch.stack([torchcore._flat_levels(ys[g, f], us[g, f], vs[g, f],
                                            int(qps[g]), mbw, mbh, rd)
                     for f in range(ys.shape[1])])
        for g in range(ys.shape[0])]).to(torch.int16)


class Shards(tuple):
    """One array of a wave spread over a device mesh: entry i's
    contiguous run of the leading dimension, on entry i's device, in
    entry order (the port's form of the reference's `P("gop")`-sharded
    array). `shape` is the whole array's."""

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(int(t.shape[0]) for t in self),)
                          + tuple(self[0].shape[1:]))


def _parts(x) -> list:
    """The per-entry parts of `x` (a lone tensor is one part)."""
    return list(x) if isinstance(x, Shards) else [x]


def _join(parts):
    """Per-entry parts → one array: the lone tensor of a one-entry
    mesh, else Shards."""
    return parts[0] if len(parts) == 1 else Shards(parts)


def _to_host(t) -> np.ndarray:
    if isinstance(t, Shards):
        return np.concatenate([p.cpu().numpy() for p in t])
    return t.cpu().numpy()


def _wait(events) -> None:
    """Host-wait on a done event, or on each of a mesh's (None: the CPU,
    nothing to wait for)."""
    for ev in events if isinstance(events, list) else [events]:
        if ev is not None:
            ev.synchronize()


def _runs(n: int, d: int) -> list[int]:
    """Contiguous run lengths of `n` items over `d` entries, the first
    entries taking one more when `d` does not divide `n`."""
    q, r = divmod(int(n), int(d))
    return [q + (1 if i < r else 0) for i in range(int(d))]


class GopShardEncoder:
    """Encode a clip as closed GOPs (IDR + P, or all-intra) on one
    device, or fanned across a :class:`~..core.devices.DeviceMesh`, in
    waves.

    On a mesh of D entries a wave holds D × `gops_per_wave` GOPs (padded
    to a multiple of D with repeats of its last GOP, encoded and then
    discarded, as the reference pads its `shard_map` wave), entry i's
    contiguous run of GOPs is staged on entry i's device, and this
    thread enqueues each entry's run in turn on its card's default
    stream (:meth:`on_entries`): a card runs one entry's work while the
    host enqueues the next's. Each entry records its own done event, and
    the fetch moves one transfer per entry on a fetch pool, concatenated
    in GOP order. The GOP plan rounds the GOP count to the mesh width,
    so a stream depends on D: `mesh=None` is the one `device`."""

    def __init__(self, meta: VideoMeta, qp: int = 27, gop_frames: int = 32,
                 max_segments: int = 200, inter: bool = True,
                 gops_per_wave: int = 4,
                 pack_workers: int | None = None,
                 pipeline_window: int | None = None,
                 decode_ahead: int | None = None,
                 compact_transfer: bool | None = None,
                 pack_backend: str | None = None,
                 rd: RdConfig | None = None, device="cuda",
                 mesh=None):
        #: the entries the waves spread over (one, `device`, unless a
        #: mesh is given); `device` is its first entry, the device of
        #: everything that is per encoder
        self.mesh = as_mesh(mesh, device)
        self.device = self.mesh.devices[0]
        self.meta = meta
        self.qp = qp
        #: inter=True encodes each GOP as IDR + P frames (motion-coded);
        #: False keeps the all-intra path (every frame IDR).
        self.inter = inter
        self.gop_frames = gop_frames
        self.max_segments = max_segments
        #: GOPs encoded per wave — batches dispatch + transfer so
        #: per-call host<->device latency amortizes. Inter path only.
        self.gops_per_wave = max(1, int(gops_per_wave))
        self.sps = SPS(width=meta.width, height=meta.height,
                       fps_num=meta.fps_num, fps_den=meta.fps_den)
        self.pps = PPS(init_qp=qp)
        snap = get_settings()
        #: static RD feature set (codecs/h264/rdo.RdConfig): per-MB
        #: intra mode decision, P_Skip bias, in-loop deblocking,
        #: perceptual AQ. None resolves from the settings snapshot (the
        #: mode_decision/pskip/deblock/aq_strength knobs), as the
        #: reference does, so every settings-built encoder inherits it.
        if rd is None:
            rd = rd_from_settings(snap)
        self.rd = rd
        if self.rd.deblock and not inter:
            raise ValueError(
                "deblock requires the inter (GOP) path: the all-intra "
                "encoder has no recon chain to filter")
        #: slice-granular CAVLC pack threads (0/None in config = all
        #: cores). Decoupled from the wave window: the pack pool sizes
        #: to the HOST (cpu count), the window to device queue depth.
        if pack_workers is None:
            pack_workers = int(snap.get("pack_workers", 0) or 0)
        self.pack_workers = int(pack_workers) or (os.cpu_count() or 2)
        #: in-flight wave window: staged inputs + outputs of this many
        #: waves stay alive at once (device queue x transfer overlap)
        if pipeline_window is None:
            pipeline_window = int(snap.get("pipeline_window", 0) or 0)
        self.pipeline_window = int(pipeline_window) or self.PIPELINE_WINDOW
        #: staged waves decoded + uploaded ahead of dispatch by the
        #: background staging thread (encode() / background_stage); adds
        #: to input device residency on top of the in-flight window
        if decode_ahead is None:
            decode_ahead = int(snap.get("decode_ahead", 0) or 0)
        self.decode_ahead = int(decode_ahead) or self.DECODE_AHEAD
        #: device-side stream compaction (torchcore._compact_stream): the
        #: sparse GOP streams fold into one byte payload on device and
        #: the host fetches only the used prefix. Default on; off keeps
        #: the three-array sparse2 transfer (bit-identical either way).
        if compact_transfer is None:
            compact_transfer = as_bool(snap.get("compact_transfer", True),
                                       True)
        self.compact_transfer = bool(compact_transfer)
        #: per-stage host wall-clock (mirrored into the process totals)
        self.stages = StageProfile(mirror=_TOTALS)
        #: streaming-ingest instrumentation: peak decoded frames the
        #: staging cursor held at once
        self.staging_stats: dict = {"peak_resident_frames": 0}
        #: eager so concurrent collect_wave threads never race a lazy init
        self._pack_pool = self._new_pack_pool()
        #: the per-entry fetch threads (None on one entry)
        self._fetch_pool = self._new_fetch_pool()
        #: entropy-pack execution backend: "thread" (slice thunks on
        #: the pack pool) or "process" (GOP-granular shared-memory
        #: sidecars, packproc.py — unpack+pack outside this process's
        #: GIL). Process packing rides the compact payload; waves that
        #: fall off it (dense fallback, compact_transfer off, intra
        #: path) pack on threads as before.
        if pack_backend is None:
            pack_backend = str(snap.get("pack_backend", "thread")
                               or "thread")
        self.pack_backend = str(pack_backend)
        #: guards _proc_pool: collect_wave runs on one collector thread
        #: per in-flight wave, and any of them may retire a broken
        #: sidecar pool (_disable_proc_pool) while the others read it
        self._proc_lock = threading.Lock()
        self._proc_pool = self._new_proc_pool()
        #: Optional per-GOP QP overrides (rate control): gop index → qp.
        #: GOPs absent from the map encode at the base `qp`; slice
        #: headers carry the delta vs PPS init_qp.
        self.gop_qp: dict[int, int] = {}
        #: Elastic-replan continuation: when encoding a clip SUFFIX,
        #: emitted GopSpecs shift by these so indices / frame ranges
        #: (and idr_pic_id) stay globally consistent with the segments
        #: already completed (the executor's wave loop sets them).
        self.gop_index_offset = 0
        self.frame_offset = 0
        #: Externally supplied plan (remote shards): the EXACT
        #: shard-local GOP boundaries to encode, bypassing the local
        #: planner.
        self.plan_override: SegmentPlan | None = None

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def plan(self, num_frames: int) -> SegmentPlan:
        if self.plan_override is not None:
            return self.plan_override
        return plan_segments(num_frames, self.gop_frames, self.num_devices,
                             self.max_segments)

    def _new_fetch_pool(self):
        """min(32, 2D) fetch threads for a multi-entry mesh (None on one
        entry), shut down with the encoder."""
        if self.num_devices <= 1:
            return None
        import concurrent.futures as cf
        import weakref

        pool = cf.ThreadPoolExecutor(min(32, 2 * self.num_devices),
                                     thread_name_prefix="tvt-fetch")
        weakref.finalize(self, pool.shutdown, False)
        return pool

    def on_entries(self, fn) -> list:
        """[fn(i) for each mesh entry i], in entry order from this
        thread, each call with its entry's device and stream current.
        The calls only enqueue work, so a card runs one entry's while the
        host enqueues the next's."""
        out = []
        for i in range(self.num_devices):
            with self.mesh.on(i):
                out.append(fn(i))
        return out

    def _upload(self, arr: np.ndarray, entry: int = 0) -> torch.Tensor:
        t = torch.from_numpy(arr)
        dev = self.mesh.devices[entry]
        if dev.type != "cuda":
            return t
        # on the entry's stream, where its compute runs (the caching host
        # allocator keeps the pinned buffer until the copy is done)
        with self.mesh.on(entry):
            return t.pin_memory().to(dev, non_blocking=True)

    def _upload_split(self, arr: np.ndarray, runs, axis: int = 0):
        """A host stack → entry i's run [a, b) of `axis` on entry i's
        device, joined (_join: the lone tensor on one entry)."""
        return _join([self._upload(np.ascontiguousarray(
            arr[(slice(None),) * axis + (slice(a, b),)]), i)
            for i, (a, b) in enumerate(runs)])

    def _upload_runs(self, arr: np.ndarray):
        """A (G, ...) host stack → entry i's contiguous run of G/D rows
        on entry i's device (the lone tensor on one entry)."""
        offs = np.cumsum([0] + _runs(arr.shape[0], self.num_devices))
        return self._upload_split(arr, zip(offs[:-1], offs[1:]))

    def _event(self, entry: int = 0):
        """An event recorded on entry `entry`'s current stream after its
        last enqueued kernel (None on the CPU)."""
        dev = self.mesh.devices[entry]
        if dev.type != "cuda":
            return None
        with torch.cuda.device(dev):
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return done

    def _run_wave(self, fn, ysd, usd, vsd, qps):
        """fn(ys, us, vs, qps) on each entry's run of the wave. Returns (the outputs joined over the entries,
        one done event per entry)."""
        ys, us, vs = _parts(ysd), _parts(usd), _parts(vsd)
        offs = np.cumsum([0] + [int(y.shape[0]) for y in ys])

        def one(i):
            out = fn(ys[i], us[i], vs[i], qps[offs[i]:offs[i + 1]])
            return out, self._event(i)

        res = self.on_entries(one)
        outs = [r[0] for r in res]
        if isinstance(outs[0], tuple):
            joined = tuple(_join([o[j] for o in outs])
                           for j in range(len(outs[0])))
        else:
            joined = _join(outs)
        return joined, [r[1] for r in res]

    def stage_waves(self, frames):
        """Host-side staging generator: stack frames into per-wave
        (G, F, H, W) device arrays, lazily, one wave per iteration, so a
        long clip never pins more than the pipeline window of waves on
        the device. The per-GOP QPs stay on the host (G,) int32."""
        for wave, full, F, cursor in self._wave_groups(frames,
                                                       require_420=True):
            # prefetch the wave's frames OUTSIDE the "stage" timer so
            # the breakdown keeps decode (source pull) and stage
            # (stack + H2D) disjoint
            cursor.get(wave[-1].end_frame - 1)
            with self.stages.stage("stage"):
                ys = np.stack([self._gop_plane(cursor, g, F, "y")
                               for g in full])
                us = np.stack([self._gop_plane(cursor, g, F, "u")
                               for g in full])
                vs = np.stack([self._gop_plane(cursor, g, F, "v")
                               for g in full])
                qps = np.asarray([self.gop_qp.get(g.index, self.qp)
                                  for g in full], np.int32)
                self.stages.bump("h2d_bytes",
                                 ys.nbytes + us.nbytes + vs.nbytes)
                staged = (wave, self._upload_runs(ys),
                          self._upload_runs(us), self._upload_runs(vs),
                          qps)
            yield staged

    def stage_luma_waves(self, frames):
        """Luma-only staging for analysis passes (rate control): chroma
        never leaves the host, halving the upload of a pass that only
        reads Y. Yields (wave, ys), ys the (G, F, H, W) uint8 stack on
        this encoder's device (Shards on a mesh, pad GOPs included)."""
        for wave, full, F, cursor in self._wave_groups(frames):
            cursor.get(wave[-1].end_frame - 1)   # decode outside "stage"
            with self.stages.stage("stage"):
                ys = np.stack([self._gop_plane(cursor, g, F, "y")
                               for g in full])
                self.stages.bump("h2d_bytes", ys.nbytes)
                staged = (wave, self._upload_runs(ys))
            yield staged

    def _wave_groups(self, frames, require_420: bool = False):
        """Wave grouping: (wave, mesh-padded wave, static F, frame
        cursor). Stacks into (G, F, ...) with tail-repeat padding to
        static F; the wave itself pads to a multiple of D GOPs with
        repeats of its last GOP (encoded, then discarded). The cursor
        decodes frames on demand and each wave's frames are released
        once the caller has staged them."""
        plan = self.plan(len(frames))
        cursor = _FrameCursor(frames, self.stages, require_420=require_420,
                              stats=self.staging_stats)
        D = self.num_devices
        gops = list(plan.gops)
        per_wave = D * (self.gops_per_wave if self.inter else 1)
        for wave_start in range(0, len(gops), per_wave):
            wave = gops[wave_start:wave_start + per_wave]
            F = max(g.num_frames for g in wave)
            full = wave + [wave[-1]] * ((-len(wave)) % D)
            yield wave, full, F, cursor
            cursor.release_below(wave[-1].end_frame)

    def prepare_waves(self, frames) -> tuple[SegmentPlan, list[tuple]]:
        """Eager staging of ALL waves (benchmarks / short clips); for
        long clips prefer encode(), which streams with a bounded window."""
        return self.plan(len(frames)), list(self.stage_waves(frames))

    def encode(self, frames) -> list[EncodedSegment]:
        """Stream-encode: source decode + staging run on a background
        thread up to `decode_ahead` waves ahead (background_stage);
        dispatch/collect pipeline on the calling thread."""
        feed = background_stage(self.stage_waves(frames), self.decode_ahead)
        try:
            return self.encode_waves(feed)
        finally:
            feed.close()

    def dispatch_wave(self, staged: tuple) -> tuple:
        """Enqueue one staged wave's device compute (asynchronous on the
        card); returns an opaque pending handle for :meth:`collect_wave`.
        On CUDA the handle carries an event recorded after the wave's
        last kernel: collect_wave runs on another thread, and its
        device→host copies wait on that event first."""
        with self.stages.stage("dispatch"):
            wave, ysd, usd, vsd, qps = staged
            ph, pw = ysd.shape[2], ysd.shape[3]
            mbh, mbw = ph // 16, pw // 16
            if self.inter:
                fn = functools.partial(_encode_gop_single, mbw=mbw,
                                       mbh=mbh,
                                       compact=self.compact_transfer,
                                       rd=self.rd)
            else:
                fn = functools.partial(_encode_wave, mbw=mbw, mbh=mbh,
                                       rd=self.rd)
            out, done = self._run_wave(fn, ysd, usd, vsd, qps)
            return (wave, ysd, usd, vsd, qps, mbw, mbh, out, done)

    def _new_pack_pool(self):
        """This encoder's slice-pack pool (threads spawn on demand up
        to pack_workers), or None for inline packing (pack_workers <=
        1). Shut down when the encoder is garbage-collected."""
        if self.pack_workers <= 1:
            return None
        import concurrent.futures as cf
        import weakref

        pool = cf.ThreadPoolExecutor(self.pack_workers,
                                     thread_name_prefix="tvt-pack")
        weakref.finalize(self, pool.shutdown, False)
        return pool

    def _slice_pool(self):
        """The slice-pack pool (None when packing inline)."""
        return self._pack_pool

    def _new_proc_pool(self):
        """GOP-granular pack sidecar processes (pack_backend=process),
        or None for the threaded backend. Spawn context: children
        import packproc fresh and must never inherit (or initialize) a
        CUDA context. Falls back to threads with a warning when the
        platform can't spawn a pool."""
        if self.pack_backend != "process" or not self.inter:
            return None
        import concurrent.futures as cf
        import multiprocessing as mp
        import weakref

        try:
            pool = cf.ProcessPoolExecutor(
                max(1, min(self.pack_workers, 8)),
                mp_context=mp.get_context("spawn"))
        except Exception as exc:    # noqa: BLE001 - degrade, don't die
            _LOG.warning("pack_backend=process unavailable (%s: %s); "
                         "falling back to threaded pack",
                         type(exc).__name__, exc)
            return None
        weakref.finalize(self, pool.shutdown, False)
        return pool

    def _fetch_bulk(self, arrays) -> list[np.ndarray]:
        """Device→host fetch of whole arrays: plain copies on one entry;
        on a mesh one transfer per entry, every entry of every array in
        flight at once on the fetch pool, concatenated in GOP order."""
        pool = self._fetch_pool
        if pool is None:
            host = [_to_host(a) for a in arrays]
            self.stages.bump("d2h_bytes", sum(int(a.nbytes) for a in host))
            return host
        futss = []
        for arr in arrays:
            parts = _parts(arr)
            self.stages.bump("fetch_shards", len(parts))
            futss.append([pool.submit(_to_host, p) for p in parts])
        host = []
        for futs in futss:
            parts = [f.result() for f in futs]
            a = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self.stages.bump("d2h_bytes", int(a.nbytes))
            host.append(a)
        return host

    #: payload fetch slice quantum cap (bytes): used prefixes round up
    #: to a quantum of max(256, min(this, PB // 8)) so the fetched
    #: slice shapes repeat across waves; the cap bounds the over-fetch
    #: at < 64 KB per GOP.
    PAYLOAD_QUANTUM = 1 << 16

    def _fetch_payload_rows(self, payload, used) -> list[np.ndarray]:
        """Fetch the wave's compact payloads SLICED to their used
        prefix: max(used) bytes per GOP (rounded up to the quantum)
        instead of the whole budget-padded buffer. Returns a 1-D uint8
        row per GOP (row length >= that GOP's used bytes)."""
        used = np.asarray(used)
        G, PB = payload.shape
        q = max(256, min(self.PAYLOAD_QUANTUM, PB // 8))

        def cut(n) -> int:
            return min(PB, -(-max(int(n), 1) // q) * q)

        pool = self._fetch_pool
        if pool is None or not isinstance(payload, Shards):
            host = _to_host(payload[:, :cut(used.max())])
            self.stages.bump("d2h_bytes", int(host.nbytes))
            return list(host)
        # one transfer per entry, each cut to its own GOPs' longest use
        self.stages.bump("fetch_shards", len(payload))
        futs, a = [], 0
        for part in payload:
            n = int(part.shape[0])
            futs.append(pool.submit(
                lambda d=part, m=cut(used[a:a + n].max()):
                _to_host(d[:, :m])))
            a += n
        rows: list = []
        for f in futs:
            part = f.result()
            self.stages.bump("d2h_bytes", int(part.nbytes))
            rows.extend(part)
        return rows

    @staticmethod
    def _release_spool(shm, spools: list) -> None:
        if shm in spools:
            spools.remove(shm)
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:       # pragma: no cover
            pass

    def _disable_proc_pool(self, exc: BaseException) -> None:
        """Runtime degrade: a broken sidecar pool (spawn refused, child
        OOM-killed) must not fail the encode — retire the pool and pack
        the rest of the job on threads. Swap-under-lock: several
        collector threads can hit the broken pool in the same wave
        window, and exactly ONE of them must log the retirement."""
        with self._proc_lock:
            pool, self._proc_pool = self._proc_pool, None
        if pool is not None:
            _LOG.warning(
                "pack sidecar pool broke (%s: %s); packing on threads "
                "from here on", type(exc).__name__, exc)

    def _submit_process_pack(self, proc, mv8_g, dc16_g, payload_row,
                             nblk: int, nval: int, used: int,
                             gop: GopSpec, F: int, mbw: int, mbh: int,
                             gop_qp: int, spools: list):
        """Spool one GOP's compact transfer parts ([mv8 | dense DC |
        payload]) into a shared-memory block and submit its
        unpack+unflatten+pack to the sidecar pool (packproc). Returns a
        callable yielding the slice payloads; it releases the spool
        after the result lands (`spools` lets collect_wave release
        blocks whose gather was never reached when a wave fails
        mid-flight). A BROKEN pool degrades instead of failing the
        wave: the same spool bytes pack in-process via packproc (a host
        pack of the same bytes, counted in proc_pack_gops and logged)."""
        import dataclasses as _dc
        from concurrent.futures.process import BrokenProcessPool
        from multiprocessing import shared_memory

        from . import packproc

        mv = np.ascontiguousarray(mv8_g).view(np.uint8).reshape(-1)
        dn = np.ascontiguousarray(dc16_g).view(np.uint8).reshape(-1)
        pl = np.ascontiguousarray(payload_row[:used])
        total = mv.nbytes + dn.nbytes + pl.nbytes
        shm = shared_memory.SharedMemory(create=True, size=max(1, total))
        spools.append(shm)
        buf = np.frombuffer(shm.buf, np.uint8)
        buf[:mv.nbytes] = mv
        buf[mv.nbytes:mv.nbytes + dn.nbytes] = dn
        buf[mv.nbytes + dn.nbytes:total] = pl
        del buf     # shm.close() refuses while exported views exist
        args = (shm.name, mv.nbytes, dn.nbytes, pl.nbytes, nblk, nval,
                gop.num_frames, F, mbw, mbh, _dc.asdict(self.sps),
                _dc.asdict(self.pps), gop_qp, gop.index,
                _dc.asdict(self.rd))
        try:
            fut = proc.submit(packproc.pack_gop_from_shm, *args)
        except Exception:
            self._release_spool(shm, spools)
            raise
        self.stages.bump("proc_pack_gops")

        def gather() -> list[bytes]:
            try:
                return fut.result()
            except BrokenProcessPool as exc:
                self._disable_proc_pool(exc)
                # the spool holds everything the child would have read
                return packproc.pack_gop_from_shm(*args)
            finally:
                self._release_spool(shm, spools)

        return gather

    def collect_wave(self, pending: tuple) -> list[EncodedSegment]:
        """Fetch one dispatched wave's levels (compact or sparse, with
        the dense fallback) and entropy-pack its GOPs on the host,
        fanning the pack across the slice pool — or, with
        pack_backend=process, handing whole GOPs to the shared-memory
        sidecars."""
        wave, ysd, usd, vsd, qps, mbw, mbh, out, done = pending
        prof = self.stages
        F = ysd.shape[1]
        nmb = mbw * mbh
        ships_modes = self.rd.ships_modes
        tail = 2 * nmb if ships_modes else 0     # [mode16 | dqp16]
        L = (nmb * _INTRA_MB + (F - 1) * nmb * _P_FLAT_MB + tail
             if self.inter else nmb * _INTRA_MB + tail)
        compact = self.inter and self.compact_transfer
        # Barrier on the tiny count outputs first: they complete when
        # the wave's compute does, splitting "waiting on the device"
        # from the bulk D2H fetch in the stage breakdown — and letting
        # a budget overflow skip the bulk sparse fetch entirely.
        with prof.stage("device_wait"):
            _wait(done)
            if self.inter:
                tiny = [_to_host(t) for t in (out[2:6] if compact
                                              else out[2:5])]
            else:
                tiny = [_to_host(out[0]), _to_host(out[1])]
        prof.bump("d2h_bytes", sum(int(a.nbytes) for a in tiny))
        flat = None
        used = payload_rows = None
        if self.inter:
            nblk, nval, n_esc = tiny[0], tiny[1], tiny[2]
            # dense prefix = both intra hadamard DC segments (luma +
            # chroma) + the mode/dqp tail when shipped; the sparse
            # remainder skips them (_per_gop_sparse)
            ndc, ncdc = nmb * 16, nmb * 8
            Lr = L - ndc - ncdc - tail
            sparse_ok = torchcore.block_sparse2_fits(
                nblk.max(), nval.max(), n_esc.max(), Lr)
            if sparse_ok:
                with prof.stage("fetch"):
                    if compact:
                        used = tiny[3]
                        mv8, dc16 = self._fetch_bulk(out[0:2])
                        payload_rows = self._fetch_payload_rows(out[6],
                                                                used)
                    else:
                        mv8, dc16, bitmap, bmask16, vals = \
                            self._fetch_bulk(
                                (out[0], out[1], out[5], out[6], out[7]))
        else:
            nnz, n_esc = tiny
            sparse_ok = torchcore.sparse_fits(nnz.max(), n_esc.max(), L)
            if sparse_ok:
                with prof.stage("fetch"):
                    bitmap, vals, esc_pos, esc_val = \
                        self._fetch_bulk(out[2:6])
        if not sparse_ok:
            # Rare wave-wide dense retry: re-encode + wide int16 fetch.
            # Its own stage (not "fetch") so the fetch number answers
            # only "what does the common bulk transfer cost", plus a
            # counter so overflow-prone content is visible.
            prof.bump("dense_fallback_waves")
            with prof.stage("dense_retry"):
                fn = functools.partial(
                    _encode_gop_single_dense if self.inter
                    else _encode_wave_dense, mbw=mbw, mbh=mbh, rd=self.rd)
                dense, events = self._run_wave(fn, ysd, usd, vsd, qps)
                _wait(events)
                flat = _to_host(dense)
                prof.bump("d2h_bytes", int(flat.nbytes))
                if self.inter:
                    # the dense program re-emits levels only; MVs still
                    # come from the already-computed sparse outputs
                    (mv8,) = self._fetch_bulk(out[0:1])
        # Header QP must match what the device QUANTIZED with — read it
        # from the staged per-wave array, not the live gop_qp dict (a
        # caller mutating gop_qp between passes must not desync slices
        # already in flight).
        if self.gop_index_offset or self.frame_offset:
            import dataclasses as _dc

            wave = [_dc.replace(g, index=g.index + self.gop_index_offset,
                                start_frame=(g.start_frame
                                             + self.frame_offset))
                    for g in wave]
        # Phase 1: unpack levels and SUBMIT every GOP's pack work — the
        # slice pool packs the whole wave's slices concurrently (or the
        # process sidecars take whole GOPs); phase 2 gathers in GOP
        # order.
        pool = self._pack_pool
        with self._proc_lock:
            proc = self._proc_pool if (compact and sparse_ok) else None
        #: live shared-memory spools of this wave's process-pack jobs —
        #: released by each gather(), and swept below if the wave dies
        #: before every gather ran (a leaked block outlives the process)
        spools: list = []
        jobs: list[tuple] = []
        for gi, gop in enumerate(wave):
            gop_qp = int(qps[gi])
            if self.inter:
                if proc is not None:
                    jobs.append((gop, self._submit_process_pack(
                        proc, mv8[gi], dc16[gi], payload_rows[gi],
                        int(nblk[gi]), int(nval[gi]), int(used[gi]),
                        gop, F, mbw, mbh, gop_qp, spools)))
                    continue
                if sparse_ok:
                    with prof.stage("sparse_unpack"):
                        if compact:
                            rest = unpack_compact_auto(
                                payload_rows[gi][:int(used[gi])],
                                int(nblk[gi]), int(nval[gi]), Lr)
                        else:
                            rest = _sparse_unpack2_host(
                                int(nblk[gi]), int(nval[gi]), bitmap[gi],
                                bmask16[gi], vals[gi], Lr)
                    with prof.stage("unflatten"):
                        intra, planes = unflatten_gop_parts(
                            dc16[gi], rest, mv8[gi], F, mbw, mbh,
                            ships_modes=ships_modes)
                else:
                    with prof.stage("unflatten"):
                        intra, planes = unflatten_gop(
                            flat[gi], mv8[gi], F, mbw, mbh,
                            ships_modes=ships_modes)
                # gop.num_frames (not F) drops the wave's tail-repeat
                # padding
                thunks = gop_slice_thunks_planes(
                    intra, planes, gop.num_frames, mbw, mbh, self.sps,
                    self.pps, gop_qp, idr_pic_id=gop.index, rd=self.rd)
            else:
                thunks = []
                for fi in range(gop.num_frames):
                    if sparse_ok:
                        with prof.stage("sparse_unpack"):
                            raw = torchcore._sparse_unpack(
                                int(nnz[gi, fi]), int(n_esc[gi, fi]),
                                bitmap[gi, fi], vals[gi, fi],
                                esc_pos[gi, fi], esc_val[gi, fi], L)
                    else:
                        raw = flat[gi, fi]
                    thunks.append(functools.partial(
                        self._pack_intra_frame, raw, mbw, mbh, gop, fi,
                        gop_qp))
            if pool is None:
                jobs.append((gop, lambda ts=thunks: [t() for t in ts]))
            else:
                futs = [pool.submit(t) for t in thunks]
                jobs.append((gop, lambda fs=futs: [f.result() for f in fs]))
        segments: list[EncodedSegment] = []
        try:
            for gop, gather in jobs:
                with prof.stage("pack"):
                    payload = gather()
                with prof.stage("concat"):
                    seg = EncodedSegment(
                        gop=gop, payload=b"".join(payload),
                        frame_sizes=tuple(len(p) for p in payload))
                segments.append(seg)
        finally:
            for shm in list(spools):    # gathers that never ran
                self._release_spool(shm, spools)
        prof.count_wave()
        return segments

    def _pack_intra_frame(self, raw, mbw: int, mbh: int, gop: GopSpec,
                          fi: int, qp: int) -> bytes:
        """Pack one all-intra frame's IDR slice (+ SPS/PPS at the GOP
        head) from its flat levels — the intra path's slice-pool unit."""
        levels = torchcore._unpack_levels(raw, mbw, mbh, self.rd)
        nal = pack_slice(levels, mbw, mbh, self.sps, self.pps, qp,
                         idr=True,
                         idr_pic_id=(gop.start_frame + fi) % 65536)
        if fi == 0:
            nal = self.sps.to_nal() + self.pps.to_nal() + nal
        return nal

    #: default in-flight wave window
    PIPELINE_WINDOW = 4

    #: default staged-waves-ahead depth for the background staging thread
    DECODE_AHEAD = 2

    def encode_waves(self, waves, window: int | None = None,
                     pack_workers: int | None = None
                     ) -> list[EncodedSegment]:
        """Dispatch staged waves: device compute → compact fetch → host
        entropy pack, in wave order.

        Up to `window` (default: `pipeline_window`) waves are dispatched
        ahead, each wave's fetch+unpack runs on a collector thread per
        in-flight wave, and every slice of every in-flight GOP packs on
        this encoder's `pack_workers` pool (`pack_workers=` resizes it
        for this call and the ones after)."""
        import concurrent.futures as cf

        window = window or self.pipeline_window
        if pack_workers is not None and int(pack_workers) != self.pack_workers:
            self.pack_workers = int(pack_workers)
            if self._pack_pool is not None:   # resize: retire the old pool
                self._pack_pool.shutdown(wait=False)
            self._pack_pool = self._new_pack_pool()
        segments: list[EncodedSegment] = []
        waves = iter(waves)
        pending: list[cf.Future] = []

        with cf.ThreadPoolExecutor(self._collect_threads(window)) as pool:
            def dispatch_next():
                try:
                    staged = next(waves)
                except StopIteration:
                    return False
                pending.append(
                    pool.submit(self.collect_wave,
                                self.dispatch_wave(staged)))
                return True

            for _ in range(window):
                if not dispatch_next():
                    break
            while pending:
                segs = pending.pop(0).result()
                dispatch_next()
                segments.extend(segs)
        return segments

    def _collect_threads(self, window: int) -> int:
        """Collector threads for `encode_waves`: one per in-flight wave."""
        return window

    @staticmethod
    def _gop_plane(cursor: _FrameCursor, gop: GopSpec, F: int, plane: str
                   ) -> np.ndarray:
        arrs = [getattr(cursor.get(i), plane)
                for i in range(gop.start_frame, gop.end_frame)]
        while len(arrs) < F:            # tail-repeat to the wave's static F
            arrs.append(arrs[-1])
        return np.stack(arrs)



# ---------------------------------------------------------------------------
# split-frame encoding (SFE): one frame as MB-row bands on one card
#
# All parallelism above is GOP-level — ideal for farm throughput, useless
# for the latency of a single stream. SFE instead splits every frame into
# horizontal MB-row bands (parallel/planner.plan_bands) and steps ONE
# FRAME per device step: the recon carry chains between steps on the
# card, motion estimation reads a halo of reference rows from the
# neighbour bands (torchme.band_halo_exchange: the bands are one stack,
# so a halo is a slice), and every band entropy-codes as its own H.264
# slice (first_mb_in_slice = band start) so the concat of a frame's band
# slices is a legal picture with no host-side re-mux.
#
# The reference puts one band on each device of a ("band",) mesh and caps
# the band count at the device count; here a mesh entry holds a run of
# bands on its card as a leading band dimension, and the layout is
# plan_bands(mbh, mbw, sfe_bands) whatever the device count — the
# reference's streams on as many devices as there are bands, byte for
# byte.
# ---------------------------------------------------------------------------


def _sfe_pack_band(flat):
    """Per-band compact transfer pack of a (B, L) stack: two-tier sparse
    + byte-payload fold with UNIT budget divisors — the buffers are
    per-frame-band sized, the fetch moves only the used prefix, and the
    only overflow left is an int8 escape (n_esc > 0 → the GOP reruns
    dense, the wave path's fallback contract). Returns (nblk, nval,
    n_esc, used, payload), each with a leading band dimension."""
    outs = []
    for row in flat:
        nblk, nval, n_esc, bitmap, bmask16, vals = \
            torchcore._block_sparse_pack2(row, 1, 1)
        used, payload = torchcore._compact_stream(nblk, nval, bitmap,
                                                  bmask16, vals)
        outs.append((nblk, nval, n_esc, used, payload))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _sfe_intra_step(ys, us, vs, qp: int, real_rows, *, mbw: int,
                    mbh_band: int, rd=RD_OFF, total_mb_rows: int = 0,
                    dense: bool = False, defer_deblock: bool = False):
    """One IDR frame of a band stack (ys (B, Hb, W)): the slice-local
    intra core per band and each band's levels, with a leading band
    dimension: (dense, nblk, nval, n_esc, used, payload), the hadamard DC
    prefix uncompressed and the rest compact-packed — or, when `dense`
    (the escape fallback), (flat,), every level uncompressed
    (layout.unflatten_intra's inverse). Returns (levels, (ry, ru, rv));
    `defer_deblock` leaves the carry for torchinter.sfe_deblock."""
    kw = dict(mbw=mbw, mbh_band=mbh_band, rd=rd, total_mb_rows=total_mb_rows,
              defer_deblock=defer_deblock)
    if dense:
        flat, carry = torchinter.sfe_intra_band_dense(ys, us, vs, qp,
                                                      real_rows, **kw)
        return (flat,), carry[:3]
    head, rest, carry = torchinter.sfe_intra_band(ys, us, vs, qp, real_rows,
                                                  **kw)
    return (head,) + _sfe_pack_band(rest), carry[:3]


# ---------------------------------------------------------------------------
# the P step of a RUN of bands
#
# A run is a mesh entry's contiguous bands, of the whole layout or of a
# farm host's slice of a cross-host layout (parallel/sfefarm.py), or the
# whole layout on one entry. The halo exchange and the probe/median sums
# span the whole layout, so their cross-run halves move outside the
# step: neighbour reference rows arrive as injected inputs (a peer copy
# between the entries of a mesh; cluster/halo.py between hosts), the
# probe splits into a per-run partial cost + an argmin of the sum, and
# the median histogram leaves the step as a per-run partial. All three
# are integer sums, so the reduction equals the whole layout's — every
# split's stream equals one stack's. `edges` = (edge_top, edge_bot):
# whether the run's first / last band is the frame's.
# ---------------------------------------------------------------------------


def _sfe_probe_step(cur_y, ref_y, real_rows, top_y, bot_y, edges):
    """Per-run half of the split global-motion probe: the run's bands'
    partial per-window SAD cost, summed over the run. Returns the (n*n,)
    int32 cost vector; the caller sums it with the other runs' and
    argmins the sum (torchme.probe_center_t)."""
    return torchme.banded_probe_cost(
        cur_y.to(torch.int16), ref_y, real_rows, top_ext=top_y,
        bot_ext=bot_y, edge_top=edges[0], edge_bot=edges[1])


def _sfe_p_step(ys, us, vs, carry3, pred_mv, probe, ext, qp: int,
                real_rows, edges, *, mbw: int, mbh_band: int,
                halo_rows: int, rd=RD_OFF, dense: bool = False,
                defer_deblock: bool = False):
    """One P frame of a run of bands: the search runs on halo-extended
    planes whose run-edge rows are injected (`ext` = (ty, by, tu, bu,
    tv, bv), (rows, W) each, None at a frame edge), the probe center and
    the temporal median are inputs, and the run's histogram partial
    comes out beside its levels — (mv8, nblk, nval, n_esc, used,
    payload), or (mv8, flat) uncompressed when `dense`. Returns (levels,
    (cnt, n), (ry, ru, rv), the deblock inputs: (nz4, mv) with
    `defer_deblock` and rd.deblock, else ())."""
    mv8, flat, cnt, n, carry = torchinter.sfe_p_band(
        ys, us, vs, tuple(carry3) + (pred_mv,), qp, real_rows, mbw=mbw,
        mbh_band=mbh_band, halo_rows=halo_rows, ext=ext,
        edge_top=edges[0], edge_bot=edges[1], probe=probe,
        return_hist=True, rd=rd, defer_deblock=defer_deblock)
    levels = (mv8, flat) if dense else (mv8,) + _sfe_pack_band(flat)
    return levels, (cnt, n), carry[:3], carry[4:]


class SfeShardEncoder(GopShardEncoder):
    """Split-frame encoding: ONE frame cut into horizontal MB-row bands,
    each entropy-coded as its own H.264 slice, the bands held as band
    stacks: one contiguous run of bands a mesh entry.

    The GOP walk is sequential (this is the single-stream latency mode —
    GOP-level parallelism is the parent class); within a GOP, frames
    step one at a time with the recon carry resident on the card, and
    the collect path is PER FRAME: a frame's band levels are fetched and
    its band slices packed (concurrently on the pack pool) as soon as
    its step completes — `frame_done_t` records each frame's
    bitstream-ready timestamp (`frame_latencies_ms`).

    A "wave" for the executor's retry/progress machinery is one GOP
    (closed: an IDR step resets the carry, so a failed GOP re-dispatches
    from its retained staged frames like any wave).

    Output contract: byte-stream-legal multi-slice pictures — the concat
    of a GOP's frames is a closed GOP exactly like the parent's, just
    with `num_bands` slices per picture; downstream (MP4 mux) groups
    slices into access units by first_mb_in_slice.

    A farm band slice (parallel/sfefarm.FarmBandEncoder) pins the GLOBAL
    layout with `total_bands` and holds `band_range=(lo, hi)` of it as
    its stack; band indices, and so the slices' first_mb coordinates,
    stay global."""

    def __init__(self, meta: VideoMeta, qp: int = 27, gop_frames: int = 32,
                 max_segments: int = 200, bands: int = 0,
                 halo_rows: int | None = None,
                 pack_workers: int | None = None,
                 pipeline_window: int | None = None,
                 decode_ahead: int | None = None,
                 total_bands: int = 0,
                 band_range: tuple[int, int] | None = None,
                 rd: RdConfig | None = None, device="cuda", mesh=None):
        snap = get_settings()
        mesh = as_mesh(mesh, device)
        mbh = (meta.height + 15) // 16
        mbw = (meta.width + 15) // 16
        #: pinned GLOBAL band layout: a pure function of (mbh, mbw,
        #: bands). The reference caps `bands` at its device count; here
        #: an explicit count is never capped (a card holds any number of
        #: bands), and bands=0 = one band per mesh entry. On a farm the
        #: coordinator pins `total_bands` for the whole frame and
        #: `band_range=(lo, hi)` assigns this encoder a contiguous slice
        #: of it (the cross-host SFE shard, parallel/sfefarm.py) — the
        #: layout (and so the slice structure of the bitstream) never
        #: depends on any one host.
        want = int(total_bands) or int(bands) or mesh.size
        self.global_band_plan: BandPlan = plan_bands(mbh, mbw,
                                                     max(1, want))
        lo, hi = band_range if band_range is not None \
            else (0, self.global_band_plan.num_bands)
        lo, hi = int(lo), min(int(hi), self.global_band_plan.num_bands)
        if not 0 <= lo < hi:
            raise ValueError(f"empty band range [{lo}, {hi})")
        #: this encoder's slice of the layout (band indices, and hence
        #: slice first_mb coordinates, stay GLOBAL)
        self.band_lo, self.band_hi = lo, hi
        self.band_plan: BandPlan = BandPlan(
            bands=self.global_band_plan.bands[lo:hi],
            band_mb_rows=self.global_band_plan.band_mb_rows,
            mb_width=self.global_band_plan.mb_width)
        #: frame 0 of each GOP opens the picture's access unit with
        #: SPS/PPS — only the slice that owns band 0 emits them (a farm
        #: peer's slices join the SAME access unit downstream)
        self.emit_parameter_sets = lo == 0
        #: the bands split into contiguous runs, one a mesh entry (a mesh
        #: wider than the bands leaves its last entries idle). A farm
        #: slice's runs meet the other hosts' slices only at its outer
        #: edges, over the halo relay (parallel/sfefarm.py).
        entries = min(mesh.size, hi - lo)
        offs = np.cumsum([0] + _runs(hi - lo, entries))
        self._band_runs = tuple(zip(offs[:-1].tolist(), offs[1:].tolist()))
        if entries < mesh.size:
            mesh = DeviceMesh(mesh.devices[:entries])
        super().__init__(meta, qp=qp, gop_frames=gop_frames,
                         max_segments=max_segments, inter=True,
                         gops_per_wave=1, pack_workers=pack_workers,
                         pipeline_window=pipeline_window,
                         decode_ahead=decode_ahead, pack_backend="thread",
                         rd=rd, device=device, mesh=mesh)
        if halo_rows is None:
            halo_rows = int(snap.get("sfe_halo_rows", 32) or 32)
        #: reference rows exchanged per side (multiple of 16). >= 23
        #: (SEARCH_RANGE + window + taps) keeps the banded search
        #: bit-identical to full-frame; smaller clamps the vertical
        #: search range (torchme.halo_clamp) — bounded, not drifting.
        #: Capped at the band height: a halo comes from ONE neighbour, so
        #: very thin bands trade vertical range for width.
        self.halo_rows = max(16, (int(halo_rows) // 16) * 16)
        self.halo_rows = min(self.halo_rows,
                             self.band_plan.band_mb_rows * 16)
        #: per-frame bitstream-ready timestamps (time.perf_counter), in
        #: encode order — the latency source. Bounded: a long-running
        #: job appends one entry per frame.
        self.frame_done_t: deque = deque(maxlen=4096)
        #: previous frame's bitstream-ready perf_counter
        self._last_frame_done: float | None = None
        #: test hook: fetch each frame's recon carry into `recon_frames`
        #: (absolute frame index → display-cropped y/u/v uint8) — keyed,
        #: not appended: pipelined GOPs collect on concurrent threads
        self.keep_recon = False
        self.recon_frames: dict[int, tuple] = {}
        # perceptual AQ would make the activity mean band-local (a
        # different map than the unbanded program): strip it with a log
        # line rather than encode something byte-different per band count
        if self.rd.aq_q:
            _LOG.warning("perceptual AQ is not supported by split-frame "
                         "encoding; encoding this job with aq off")
            import dataclasses as _dc

            self.rd = _dc.replace(self.rd, aq_q=0)
        # the in-loop filter needs the cross-band halo of the whole
        # layout, which a cross-host slice cannot exchange in one step
        if self.rd.deblock and (self.band_lo, self.band_hi) != (
                0, self.global_band_plan.num_bands):
            raise ValueError(
                "deblock is not supported on cross-host band slices; "
                "the remote planner must fall back to GOP shards")
        #: the picture's REAL MB rows (band-grid padding rows beyond it
        #: carry no coded MBs): the deblock masks key off this
        self._total_mb_rows = mbh
        #: each band's real pixel rows (the last band may hold padding)
        self._real_rows = tuple(b.mb_rows * 16 for b in self.band_plan.bands)

    @property
    def num_bands(self) -> int:
        return self.band_plan.num_bands

    def plan(self, num_frames: int) -> SegmentPlan:
        if self.plan_override is not None:
            return self.plan_override
        # fixed grid: GOP boundaries are a pure function of (num_frames,
        # gop_frames, max_segments); max_segments is honored by growing
        # the GOP length once up front
        gop = max(self.gop_frames,
                  -(-num_frames // max(1, self.max_segments)))
        return plan_fixed_segments(num_frames, gop, self.num_bands)

    # -- staging --------------------------------------------------------

    @staticmethod
    def _pad_rows(plane: np.ndarray, rows: int) -> np.ndarray:
        if plane.shape[0] == rows:
            return plane
        pad = rows - plane.shape[0]
        return np.concatenate([plane, np.repeat(plane[-1:], pad, axis=0)])

    def stage_waves(self, frames):
        """One GOP per staged wave: its frames padded to the band grid's
        height (edge replication — the padding rows are computed and
        discarded), stacked and uploaded as (F, B, Hb, W) band stacks. A
        band SLICE (farm mode) pads to the GLOBAL grid height and
        uploads only its own rows — each host decodes the full frame but
        stages O(slice) pixels."""
        plan = self.plan(len(frames))
        cursor = _FrameCursor(frames, self.stages, require_420=True,
                              stats=self.staging_stats)
        bp = self.band_plan
        B, Hb = bp.num_bands, bp.band_mb_rows * 16
        Hg = self.global_band_plan.padded_mb_height * 16
        y0, y1 = self.band_lo * Hb, self.band_hi * Hb
        for gop in plan.gops:
            cursor.get(gop.end_frame - 1)   # decode outside "stage"
            with self.stages.stage("stage"):
                planes = []
                for name, rows, div in (("y", Hg, 1), ("u", Hg // 2, 2),
                                        ("v", Hg // 2, 2)):
                    a = np.stack([
                        self._pad_rows(getattr(cursor.get(i), name),
                                       rows)[y0 // div:y1 // div]
                        for i in range(gop.start_frame, gop.end_frame)])
                    planes.append(a.reshape(a.shape[0], B,
                                            Hb // div, a.shape[2]))
                self.stages.bump("h2d_bytes", sum(a.nbytes for a in planes))
                # entry r's run of bands, (F, n_r, Hb, W), on entry r
                ys, us, vs = (self._upload_split(a, self._band_runs, 1)
                              for a in planes)
                qp = int(self.gop_qp.get(gop.index, self.qp))
            yield (gop, ys, us, vs, qp)
            cursor.release_below(gop.end_frame)

    # -- device steps ---------------------------------------------------

    def encode_waves(self, waves, window: int | None = None,
                     pack_workers: int | None = None
                     ) -> list[EncodedSegment]:
        # fresh latency baseline per encode pass: the idle gap since a
        # previous pass's last frame is not a per-frame latency
        self._last_frame_done = None
        return super().encode_waves(waves, window=window,
                                    pack_workers=pack_workers)

    def _collect_threads(self, window: int) -> int:
        """One collector, whatever the window: frames finish in frame
        order, so each frame's gap is measured from the frame before it
        and the first frame of a pass records none. With a collector per
        in-flight GOP, a later GOP's first frame could finish before an
        earlier GOP's frames, and which frames recorded a gap (and the
        `sfe_frame` spans' frame tags) depended on thread timing. The
        card still runs `window` GOPs ahead."""
        return 1

    def _intra_step(self, ys, us, vs, qp: int, dense: bool = False):
        """The IDR step of a one-entry encoder's whole stack: (levels,
        (ry, ru, rv)), as _sfe_intra_step."""
        bp = self.band_plan
        return _sfe_intra_step(ys, us, vs, qp, self._real_rows,
                               mbw=bp.mb_width, mbh_band=bp.band_mb_rows,
                               rd=self.rd, total_mb_rows=self._total_mb_rows,
                               dense=dense)

    def dispatch_wave(self, staged: tuple) -> tuple:
        """Enqueue one GOP's per-frame steps (:meth:`_walk`; the cards run
        them in order as the recon carry chains). Returns the per-frame
        outputs, each frame's carry (the keep_recon hook only) and each
        frame's done events, one per entry."""
        with self.stages.stage("dispatch"):
            gop, ys, us, vs, qp = staged
            outs, carries, events = (list(x) for x in zip(*[
                (levels, carry if self.keep_recon else None, done)
                for levels, carry, _, done in self._walk(
                    gop.num_frames, ys, us, vs, qp)]))
            return (gop, staged, outs, carries, events)

    # -- the runs of bands ------------------------------------------------

    def _walk(self, nf: int, ys, us, vs, qp: int, dense: bool = False,
              link=None):
        """Step one GOP over every entry's run of bands, a frame at a time:
        each entry's step is enqueued on its card, and between the steps
        the inputs that cross runs move — the edge rows of the runs
        beside it, the probe cost and the median histograms summed over
        every run, and with rd.deblock the filter's one-MB-row halo. All
        reductions are integer sums, so each run's levels and recon equal
        those rows of one stack's step.

        A farm slice passes `link` (parallel/sfefarm.py), whose three
        seams reach the other hosts' slices: `link.edges(fi)`, the
        injected rows at the slice's outer edges for frame fi's search;
        `link.probe(fi, cost)` and `link.median(fi, cnt, n)`, the runs'
        probe cost and histogram totals on the first entry with the
        peers' added. Yields per frame (the levels joined over the
        entries in band order, each run's carry (ry, ru, rv), the runs'
        histogram total (cnt, n) on the first entry — None for the IDR
        frame — and one done event per entry)."""
        bp = self.band_plan
        E = self.num_devices
        ys, us, vs = _parts(ys), _parts(us), _parts(vs)
        rows = [self._real_rows[b0:b1] for b0, b1 in self._band_runs]
        top = self.band_lo == 0
        bot = self.band_hi == self.global_band_plan.num_bands
        edges = [(r == 0 and top, r == E - 1 and bot) for r in range(E)]
        kw = dict(mbw=bp.mb_width, mbh_band=bp.band_mb_rows, rd=self.rd,
                  dense=dense, defer_deblock=self.rd.deblock)
        carry = ext = pred = hist = None
        for fi in range(nf):
            if fi == 0:
                levels, carry = zip(*self.on_entries(
                    lambda r: _sfe_intra_step(ys[r][0], us[r][0], vs[r][0],
                                              qp, rows[r], **kw)))
                db_in = [()] * E
            else:
                cost = self._sum(self.on_entries(lambda r: _sfe_probe_step(
                    ys[r][fi], carry[r][0], rows[r], ext[r][0], ext[r][1],
                    edges[r])))
                if link is not None:
                    cost = link.probe(fi, cost)
                probe = self._to_all(torchme.probe_center_t(cost))
                levels, hists, carry, db_in = zip(*self.on_entries(
                    lambda r: _sfe_p_step(
                        ys[r][fi], us[r][fi], vs[r][fi], carry[r], pred[r],
                        probe[r], ext[r], qp, rows[r], edges[r],
                        halo_rows=self.halo_rows, **kw)))
                hist = tuple(self._sum(list(p)) for p in zip(*hists))
            if self.rd.deblock:
                carry = self._deblock_runs(carry, db_in, qp)
            events = [self._event(r) for r in range(E)]
            yield (tuple(_join(list(p)) for p in zip(*levels)), carry, hist,
                   events)
            if fi < nf - 1:
                ext = self._run_edges(
                    carry, None if link is None else link.edges(fi + 1))
                if hist is None:
                    pred = self._to_all(torch.zeros(
                        2, dtype=torch.int32, device=self.device))
                else:
                    total = hist if link is None else link.median(fi + 1,
                                                                  *hist)
                    pred = self._to_all(torchme.median_from_counts_t(
                        *total, 2 * torchme.SEARCH_RANGE))

    def _recv(self, t, src: int, dst: int):
        """Entry `src`'s tensor `t` on entry `dst`'s device: `t` itself on
        one device (this thread enqueues both entries' work on the one
        stream, in order), else a peer copy, ordered on both cards'
        streams after `t` is made and before `dst` reads it."""
        mesh = self.mesh
        if t is None or mesh.devices[src] == mesh.devices[dst]:
            return t
        with torch.cuda.stream(mesh.stream(src)), \
                torch.cuda.stream(mesh.stream(dst)):
            return t.to(mesh.devices[dst], non_blocking=True)

    def _sum(self, parts):
        """The sum of every entry's tensor, on the first entry (integer
        sums: exact in any order)."""
        total = parts[0]
        for src in range(1, len(parts)):
            total = total + self._recv(parts[src], src, 0)
        return total

    def _to_all(self, t) -> list:
        """The first entry's tensor `t` on every entry."""
        return [self._recv(t, 0, r) for r in range(self.num_devices)]

    def _run_edges(self, carry, outer=None) -> list:
        """Each run's injected rows for the next frame's search, on its
        entry: (ty, by, tu, bu, tv, bv), the last halo rows of the run
        above and the first of the run below. At a farm slice's outer
        edges they are `outer`, the peers' rows in the same order (the
        top ones on the first entry, the bottom ones on the last); None
        at a frame edge."""
        halo, hc = self.halo_rows, self.halo_rows // 2
        E = self.num_devices
        out = []
        for r in range(E):
            ext = [None] * 6
            if r > 0:
                ry, ru, rv = carry[r - 1]
                ext[0::2] = [self._recv(t, r - 1, r) for t in (
                    ry[-1, -halo:], ru[-1, -hc:], rv[-1, -hc:])]
            elif outer is not None:
                ext[0::2] = outer[0::2]
            if r < E - 1:
                ry, ru, rv = carry[r + 1]
                ext[1::2] = [self._recv(t, r + 1, r) for t in (
                    ry[0, :halo], ru[0, :hc], rv[0, :hc])]
            elif outer is not None:
                ext[1::2] = outer[1::2]
            out.append(tuple(ext))
        return out

    def _deblock_runs(self, carry, db_in, qp: int) -> list:
        """The in-loop filter of every run on its unfiltered carry, each
        run extended by one MB row of the runs beside it."""
        bp = self.band_plan
        E = self.num_devices
        kw = dict(mbw=bp.mb_width, mbh_band=bp.band_mb_rows)
        halos = [torchinter.sfe_deblock_edges(*carry[r], *db_in[r], **kw)
                 for r in range(E)]

        def side(src: int, dst: int, which: int):
            if not 0 <= src < E:
                return None
            return {k: self._recv(t, src, dst)
                    for k, t in halos[src][which].items()}

        def one(r: int):
            b0, b1 = self._band_runs[r]
            return torchinter.sfe_deblock(
                *carry[r], qp, self._real_rows[b0:b1],
                **dict(zip(("nz4", "mv"), db_in[r])),
                total_mb_rows=self._total_mb_rows,
                band0=self.band_lo + b0, above=side(r - 1, r, 1),
                below=side(r + 1, r, 0), **kw)

        return self.on_entries(one)

    # -- per-frame collect ---------------------------------------------

    def _band_sizes(self, intra: bool) -> tuple[int, int]:
        """(nmb_band, L) of one band's sparse transfer vector."""
        bp = self.band_plan
        nmb = bp.mb_width * bp.band_mb_rows
        L = nmb * (_INTRA_MB - 24) if intra else nmb * _P_FLAT_MB
        return nmb, L

    def _pack_intra_levels(self, intra, bi: int, qp: int,
                           idr_pic_id: int) -> bytes:
        """Shared tail of the sparse and dense-fallback intra band packs
        (which must stay bit-identical): truncate to the band's REAL MB
        rows and emit its IDR band slice. The mode raster — shipped per
        MB when rd.ships_modes, the slice-local _mode_policy otherwise —
        is BAND-relative either way: the band's first MB row is its
        slice's row 0."""
        bp = self.band_plan
        band = bp.bands[bi]
        mbw = bp.mb_width
        n_real = band.mb_rows * mbw
        if len(intra) == 6:
            il_dc, il_ac, ic_dc, ic_ac, mode16, _dqp = intra
            luma_mode, chroma_mode = unpack_mode16(mode16[:n_real])
        else:
            il_dc, il_ac, ic_dc, ic_ac = intra
            luma_mode, chroma_mode = _mode_policy(mbw, band.mb_rows)
        levels = FrameLevels(
            luma_mode=luma_mode, chroma_mode=chroma_mode,
            luma_dc=il_dc[:n_real], luma_ac=il_ac[:n_real],
            chroma_dc=ic_dc[:n_real], chroma_ac=ic_ac[:n_real])
        return pack_slice(levels, mbw, band.mb_rows, self.sps, self.pps,
                          qp, frame_num=0, idr=True,
                          idr_pic_id=idr_pic_id,
                          first_mb=band.start_mb_row * mbw,
                          deblock=self.rd.deblock)

    def _pack_intra_band(self, dense_b, rest, bi: int, qp: int,
                         idr_pic_id: int) -> bytes:
        bp = self.band_plan
        intra = unflatten_gop_parts(dense_b, rest,
                                    np.empty((0, 0, 2), np.int8), 1,
                                    bp.mb_width, bp.band_mb_rows,
                                    ships_modes=self.rd.ships_modes)[0]
        return self._pack_intra_levels(intra, bi, qp, idr_pic_id)

    def _pack_intra_band_dense(self, flat_b, bi: int, qp: int,
                               idr_pic_id: int) -> bytes:
        bp = self.band_plan
        nmb = bp.mb_width * bp.band_mb_rows
        flat_b = np.asarray(flat_b)
        intra = unflatten_intra(flat_b[:nmb * _INTRA_MB], nmb)
        if self.rd.ships_modes:
            t = nmb * _INTRA_MB
            intra = intra + (flat_b[t:t + nmb], flat_b[t + nmb:])
        return self._pack_intra_levels(intra, bi, qp, idr_pic_id)

    def _pack_p_band(self, mv8_b, rest, bi: int, qp: int,
                     frame_num: int) -> bytes:
        from ..codecs.h264 import inter as inter_mod

        bp = self.band_plan
        band = bp.bands[bi]
        mbw = bp.mb_width
        mv, lp, udc, vdc, uac, vac = unflatten_p_planes(
            rest, mv8_b, 2, mbw, bp.band_mb_rows)
        rr = band.mb_rows * 16
        n_real = band.mb_rows * mbw
        return inter_mod.pack_p_slice_plane(
            mv[:n_real], lp[0][:rr], udc[0][:n_real], vdc[0][:n_real],
            uac[0][:rr // 2], vac[0][:rr // 2], mbw, band.mb_rows,
            self.sps, self.pps, qp, frame_num=frame_num,
            first_mb=band.start_mb_row * mbw, deblock=self.rd.deblock)

    def _gather_frame(self, thunks: list) -> list[bytes]:
        pool = self._pack_pool
        if pool is None:
            return [t() for t in thunks]
        return [f.result() for f in [pool.submit(t) for t in thunks]]

    def _note_frame_done(self, frame_index: int) -> None:
        """One SFE frame's bitstream is ready: stamp frame_done_t (the
        latency source), count it, and — when a previous frame exists —
        record the steady-state gap as a latency sample (global
        percentile ring + histogram) and a `sfe_frame` span in the
        job's trace."""
        now = time.perf_counter()
        prev, self._last_frame_done = self._last_frame_done, now
        self.stages.bump("sfe_frames")
        self.frame_done_t.append(now)
        if prev is None or now <= prev:
            return
        gap = now - prev
        with _SFE_LAT_LOCK:
            _SFE_LAT_MS.append(gap * 1e3)
        obs_metrics.SFE_FRAME_SECONDS.observe(gap)
        tracer = self.stages.tracer()
        if tracer is not None:
            tracer.record("sfe_frame", time.time() - gap, gap,
                          frame=frame_index)

    def _keep_recon(self, carry, frame_index: int) -> None:
        """Fetch a frame's recon from each run's carry (ry, ru, rv)."""
        h, w = self.meta.height, self.meta.width
        self.recon_frames[frame_index] = tuple(
            _to_host(p).reshape(-1, p.shape[-1])[:rows, :cols].astype(
                np.uint8)
            for p, rows, cols in zip((_join(list(q)) for q in zip(*carry)),
                                     (h, h // 2, h // 2),
                                     (w, w // 2, w // 2)))

    def _frame_nal(self, thunks: list, fi: int) -> bytes:
        frame_nal = b"".join(self._gather_frame(thunks))
        if fi == 0 and self.emit_parameter_sets:
            frame_nal = self.sps.to_nal() + self.pps.to_nal() + frame_nal
        return frame_nal

    def collect_wave(self, pending: tuple) -> list[EncodedSegment]:
        """Per-FRAME collect: wait for frame fi's step, fetch its tiny
        counts, then its band payloads' used prefixes, entropy-pack its
        band slices on the pack pool, and emit the frame's bytes — while
        the card runs the frames after it. An int8 escape in any band
        reruns the whole GOP through the dense-transfer steps
        (bit-identical levels, wider fetch), the wave path's fallback
        contract."""
        gop, staged, outs, carries, events = pending
        prof = self.stages
        qp = staged[4]
        if self.gop_index_offset or self.frame_offset:
            import dataclasses as _dc

            gop = _dc.replace(gop, index=gop.index + self.gop_index_offset,
                              start_frame=(gop.start_frame
                                           + self.frame_offset))
        idr_pic_id = gop.index % 65536
        nals: list[bytes] = []
        dense_from = None
        for fi, out in enumerate(outs):
            head, nblk, nval, n_esc, used, payload = out
            with prof.stage("device_wait"):
                _wait(events[fi])
                tiny = [_to_host(t) for t in (nblk, nval, n_esc, used)]
            prof.bump("d2h_bytes", sum(int(a.nbytes) for a in tiny))
            if int(tiny[2].max()) > 0:
                dense_from = fi         # escape: rerun the GOP dense
                break
            nals.append(self._pack_band_frame(fi, head, payload, tiny, qp,
                                              idr_pic_id))
            self._note_frame_done(gop.start_frame + fi)
            if self.keep_recon:
                self._keep_recon(carries[fi], gop.start_frame + fi)
        if dense_from is not None:
            nals = self._collect_dense(gop, staged, nals, dense_from)
        with prof.stage("concat"):
            seg = EncodedSegment(gop=gop, payload=b"".join(nals),
                                 frame_sizes=tuple(len(n) for n in nals))
        prof.count_wave()
        return [seg]

    def _pack_band_frame(self, fi: int, head, payload, tiny, qp: int,
                         idr_pic_id: int) -> bytes:
        """One frame's band slices from its compact transfer: fetch the
        dense head and each band's used payload prefix (`tiny` = the
        fetched nblk, nval, n_esc, used), then entropy-pack the bands on
        the pack pool."""
        bp = self.band_plan
        nblk_h, nval_h, _, used_h = tiny
        _, L = self._band_sizes(intra=(fi == 0))
        with self.stages.stage("fetch"):
            (head_h,) = self._fetch_bulk([head])
            rows = self._fetch_payload_rows(payload, used_h)
        with self.stages.stage("sfe"):
            thunks = []
            for bi in range(bp.num_bands):
                rest = functools.partial(
                    unpack_compact_auto, rows[bi][:int(used_h[bi])],
                    int(nblk_h[bi]), int(nval_h[bi]), L)
                if fi == 0:
                    thunks.append(functools.partial(
                        lambda r, b: self._pack_intra_band(
                            head_h[b], r(), b, qp, idr_pic_id), rest, bi))
                else:
                    thunks.append(functools.partial(
                        lambda r, b, fn: self._pack_p_band(
                            head_h[b], r(), b, qp, fn), rest, bi, fi % 256))
            return self._frame_nal(thunks, fi)

    def _collect_dense(self, gop: GopSpec, staged: tuple,
                       nals: list[bytes], dense_from: int,
                       link=None) -> list[bytes]:
        """Escape fallback: rerun the GOP through the dense-transfer
        steps (same compute, uncompressed int16 levels) and pack every
        frame from `dense_from` on. Frames already packed from the sparse
        path are kept — levels are identical either way. A farm slice's
        `link` replays what the peers sent in the sparse walk."""
        prof = self.stages
        bp = self.band_plan
        qp = staged[4]
        idr_pic_id = gop.index % 65536
        prof.bump("dense_fallback_waves")
        with prof.stage("dense_retry"):
            for fi, head, flat, carry in self._dense_frames(gop, staged,
                                                            link):
                if fi < dense_from:
                    continue            # already packed from sparse
                if head is None:
                    (flat_h,) = self._fetch_bulk([flat])
                else:
                    head_h, flat_h = self._fetch_bulk([head, flat])
                thunks = []
                for bi in range(bp.num_bands):
                    if fi == 0:
                        thunks.append(functools.partial(
                            self._pack_intra_band_dense, flat_h[bi], bi,
                            qp, idr_pic_id))
                    else:
                        thunks.append(functools.partial(
                            self._pack_p_band, head_h[bi], flat_h[bi], bi,
                            qp, fi % 256))
                nals.append(self._frame_nal(thunks, fi))
                self._note_frame_done(gop.start_frame + fi)
                if self.keep_recon:
                    self._keep_recon(carry, gop.start_frame + fi)
        return nals

    def _dense_frames(self, gop: GopSpec, staged: tuple, link=None):
        """The dense-transfer steps of one GOP: (fi, mv8 or None, flat,
        each run's carry) per frame, ready to fetch."""
        _, ys, us, vs, qp = staged
        for fi, (levels, carry, _, events) in enumerate(self._walk(
                gop.num_frames, ys, us, vs, qp, dense=True, link=link)):
            _wait(events)
            head, flat = (None, levels[0]) if fi == 0 else levels
            yield fi, head, flat, carry

    def frame_latencies_ms(self) -> list[float]:
        """Per-frame pipeline latency: the gap between consecutive
        frames' bitstream-ready timestamps within the steady state — at
        the live edge each frame exits the (device step → fetch → band
        pack) pipeline one such gap after entering it. The first frame
        of the run (cold: includes dispatch of the whole first GOP) is
        excluded. Sorted first: overlapping collector threads append
        near-, not strictly-, in order."""
        ts = sorted(self.frame_done_t)
        return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]

def make_shard_encoder(meta: VideoMeta, settings, mesh=None, *,
                       shape: str | None = None, rungs=None,
                       qp: int | None = None, total_bands: int = 0,
                       band_range: tuple[int, int] | None = None,
                       halo_rows: int | None = None, session=None,
                       device="cuda") -> GopShardEncoder:
    """The settings-driven encoder seam a job executor calls
    (``encoder_factory``): the job's qp, gop_frames and max_segments
    from `settings`, every other knob from the settings snapshot in the
    GopShardEncoder constructor, as the reference resolves them.

    The RD features resolve inside GopShardEncoder from the process
    settings snapshot, as the reference's do (it passes no `rd` here).

    `shape=None` resolves from settings (`sfe_bands > 0` → the band
    shape, :class:`SfeShardEncoder`, with `sfe_halo_rows` unless
    `halo_rows` is given; else GOP waves).

    `rungs` selects the ladder form (abr/ladder.LadderShardEncoder, which
    stages once and fans the renditions out on the card);
    `band_range`/`total_bands` select the cross-host band-slice form
    (parallel/sfefarm.FarmBandEncoder) with `session` carrying the halo
    exchange.

    `mesh` (a core.devices.DeviceMesh) spreads the GOP waves, the
    ladder's waves or the split-frame bands over its entries; None is
    the one `device`. A farm band slice stays on the mesh's first
    entry."""
    if mesh is not None:
        mesh = as_mesh(mesh)
    if rungs:
        from ..abr.ladder import LadderShardEncoder

        return LadderShardEncoder(meta, list(rungs), mesh=mesh,
                                  gop_frames=int(settings.gop_frames),
                                  max_segments=int(settings.max_segments),
                                  device=device)
    if shape is None:
        shape = "band" if int(settings.get("sfe_bands", 0) or 0) > 0 \
            else "gop"
    qp = int(settings.qp) if qp is None else int(qp)
    if shape == "band":
        if halo_rows is None:
            halo_rows = int(settings.get("sfe_halo_rows", 32) or 32)
        if band_range is not None or total_bands:
            from .sfefarm import FarmBandEncoder

            return FarmBandEncoder(
                meta, qp=qp, gop_frames=int(settings.gop_frames),
                max_segments=int(settings.max_segments),
                total_bands=total_bands, band_range=band_range,
                halo_rows=halo_rows, session=session, device=device,
                mesh=mesh)
        return SfeShardEncoder(
            meta, qp=qp, gop_frames=int(settings.gop_frames),
            max_segments=int(settings.max_segments),
            bands=int(settings.get("sfe_bands", 0) or 0),
            halo_rows=halo_rows, device=device, mesh=mesh)
    if shape != "gop":
        raise ValueError(f"unknown shard shape {shape!r}")
    return GopShardEncoder(meta, qp=qp,
                           gop_frames=int(settings.gop_frames),
                           max_segments=int(settings.max_segments),
                           device=device, mesh=mesh)


def encode_clip_sharded(frames: list[Frame], meta: VideoMeta, qp: int = 27,
                        gop_frames: int = 32, inter: bool = True,
                        device="cuda", mesh=None) -> bytes:
    """Convenience: plan → shard encode → order-restoring concat."""
    from ..core.types import concat_segments

    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop_frames, inter=inter,
                          device=device, mesh=mesh)
    return concat_segments(enc.encode(frames))
