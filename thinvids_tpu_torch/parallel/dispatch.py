"""GOP wave dispatch on one device: closed GOPs encoded in waves, levels
fetched compactly, slices entropy-packed on a host thread pool.

A wave of GOPs is staged (frames stacked into (G, F, H, W) arrays and
uploaded), dispatched (each GOP's IDR + P compute and device-side
transfer pack, torchinter.encode_gop_planes + torchcore's two-tier
sparse pack folded into one byte payload), and collected on a collector
thread: the tiny counts first, then only the used prefix of the payload,
then unpack + unflatten + CAVLC pack of every slice on the pack pool.
Encoded segments concat in GOP index order.

Host side, the pipeline is instrumented per stage (StageProfile): every
wave's source decode / staging (stack + H2D upload) / dispatch / device
wait / D2H fetch / sparse unpack / unflatten / CAVLC pack / concat
wall-clock accumulates on the encoder.

Ingest is a pipelined stage: `stage_waves` accepts a streaming source
(anything with ``iter_frames()``) or a materialized list and holds only
the current wave's decoded frames (a sliding _FrameCursor window), and
:func:`background_stage` runs the decode→stack→upload chain on a staging
thread up to `decode_ahead` waves ahead of dispatch.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core.devices import resolve_device
from ..core.types import (ChromaFormat, EncodedSegment, Frame, GopSpec,
                          SegmentPlan, VideoMeta)
from ..codecs.h264 import torchcore, torchinter
from ..codecs.h264.encoder import gop_slice_thunks_planes
from ..codecs.h264.headers import PPS, SPS
from ..codecs.h264.layout import _INTRA_FLAT_MB as _INTRA_MB
from ..codecs.h264.layout import (_P_FLAT_MB, unflatten_gop,
                                  unflatten_gop_parts, unpack_compact_auto)
from ..codecs.h264.rdo import RD_OFF
from .planner import plan_segments


# ---- host-stage wall-clock instrumentation --------------------------------

#: canonical stage keys, in pipeline order (the reference's names; the
#: stages this single-device GOP path never enters stay at 0)
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
    go", not "what is the critical path"."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ms = {k: 0.0 for k in STAGE_NAMES}
        self._counts = {k: 0 for k in STAGE_COUNTERS}
        self._waves = 0

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._ms[stage] = self._ms.get(stage, 0.0) + seconds * 1e3

    def bump(self, counter: str, n: int = 1) -> None:
        """Increment a monotonic counter (STAGE_COUNTERS) by `n`."""
        with self._lock:
            self._counts[counter] = self._counts.get(counter, 0) + int(n)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def count_wave(self) -> None:
        with self._lock:
            self._waves += 1

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
            if self._require_420 and f.chroma is not ChromaFormat.YUV420:
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


def _per_gop_sparse(y, u, v, qp: int, mbw: int, mbh: int):
    """(F, H, W) GOP → (mv int8, dense intra-DC segments, nblk, nval,
    n_esc, used, payload): the compact transfer.

    BOTH intra hadamard DC segments — luma DC (nmb * 16) and chroma DC
    (nmb * 8) — ship DENSE: hadamard DC levels are the only ones that
    exceed int8 at practical QPs, and the sparse pack has no escape
    side-channel — an escape anywhere forces the wave-wide dense
    fallback. The rest folds into one contiguous byte payload
    (torchcore._compact_stream)."""
    mv8, flat = torchinter.encode_gop_planes(y, u, v, qp, mbw=mbw, mbh=mbh)
    nmb = mbw * mbh
    ndc, nlac, ncdc = nmb * 16, nmb * 240, nmb * 8
    dense = torch.cat([flat[:ndc], flat[ndc + nlac:ndc + nlac + ncdc]])
    rest = torch.cat([flat[ndc:ndc + nlac], flat[ndc + nlac + ncdc:]])
    nblk, nval, n_esc, bitmap, bmask16, vals = \
        torchcore._block_sparse_pack2(rest)
    used, payload = torchcore._compact_stream(nblk, nval, bitmap, bmask16,
                                              vals)
    return (mv8, dense, nblk, nval, n_esc, used, payload)


def _per_gop_dense(y, u, v, qp: int, mbw: int, mbh: int):
    _mv8, flat = torchinter.encode_gop_planes(y, u, v, qp, mbw=mbw, mbh=mbh)
    return flat


def _encode_gop_single(ys, us, vs, qps, *, mbw: int, mbh: int):
    """One wave on one device: ys (G, F, H, W) uint8, qps (G,) host
    ints. Each GOP runs the per-GOP program in turn; the 7 outputs
    stack over G."""
    outs = [_per_gop_sparse(ys[g], us[g], vs[g], int(qps[g]), mbw, mbh)
            for g in range(ys.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _encode_gop_single_dense(ys, us, vs, qps, *, mbw: int, mbh: int):
    """Dense fallback for the wave: (G, L) int16 levels."""
    return torch.stack([_per_gop_dense(ys[g], us[g], vs[g], int(qps[g]),
                                       mbw, mbh)
                        for g in range(ys.shape[0])])


def _to_host(t) -> np.ndarray:
    return t.cpu().numpy()


class GopShardEncoder:
    """Encode a clip as closed GOPs (IDR + P) on one device, in waves."""

    def __init__(self, meta: VideoMeta, qp: int = 27, gop_frames: int = 32,
                 max_segments: int = 200, gops_per_wave: int = 4,
                 pack_workers: int | None = None,
                 pipeline_window: int | None = None,
                 decode_ahead: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.meta = meta
        self.qp = qp
        self.gop_frames = gop_frames
        self.max_segments = max_segments
        #: GOPs encoded per wave — batches dispatch + transfer so
        #: per-call host<->device latency amortizes
        self.gops_per_wave = max(1, int(gops_per_wave))
        self.sps = SPS(width=meta.width, height=meta.height,
                       fps_num=meta.fps_num, fps_den=meta.fps_den)
        self.pps = PPS(init_qp=qp)
        self.rd = RD_OFF
        #: slice-granular CAVLC pack threads (None = all cores)
        self.pack_workers = int(pack_workers or 0) or (os.cpu_count() or 2)
        #: in-flight wave window: staged inputs + outputs of this many
        #: waves stay alive at once (device queue x transfer overlap)
        self.pipeline_window = int(pipeline_window or 0) \
            or self.PIPELINE_WINDOW
        #: staged waves decoded + uploaded ahead of dispatch by the
        #: background staging thread (encode() / background_stage)
        self.decode_ahead = int(decode_ahead or 0) or self.DECODE_AHEAD
        #: per-stage host wall-clock
        self.stages = StageProfile()
        #: streaming-ingest instrumentation: peak decoded frames the
        #: staging cursor held at once
        self.staging_stats: dict = {"peak_resident_frames": 0}
        #: eager so concurrent collect_wave threads never race a lazy init
        self._pack_pool = self._new_pack_pool()
        #: Optional per-GOP QP overrides (rate control): gop index → qp.
        #: GOPs absent from the map encode at the base `qp`; slice
        #: headers carry the delta vs PPS init_qp.
        self.gop_qp: dict[int, int] = {}

    @property
    def num_devices(self) -> int:
        return 1

    def plan(self, num_frames: int) -> SegmentPlan:
        return plan_segments(num_frames, self.gop_frames, self.num_devices,
                             self.max_segments)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def stage_waves(self, frames):
        """Host-side staging generator: stack frames into per-wave
        (G, F, H, W) device arrays, lazily, one wave per iteration, so a
        long clip never pins more than the pipeline window of waves on
        the device. The per-GOP QPs stay on the host (G,) int32."""
        for wave, F, cursor in self._wave_groups(frames):
            # prefetch the wave's frames OUTSIDE the "stage" timer so
            # the breakdown keeps decode (source pull) and stage
            # (stack + H2D) disjoint
            cursor.get(wave[-1].end_frame - 1)
            with self.stages.stage("stage"):
                ys = np.stack([self._gop_plane(cursor, g, F, "y")
                               for g in wave])
                us = np.stack([self._gop_plane(cursor, g, F, "u")
                               for g in wave])
                vs = np.stack([self._gop_plane(cursor, g, F, "v")
                               for g in wave])
                qps = np.asarray([self.gop_qp.get(g.index, self.qp)
                                  for g in wave], np.int32)
                self.stages.bump("h2d_bytes",
                                 ys.nbytes + us.nbytes + vs.nbytes)
                staged = (wave, self._upload(ys), self._upload(us),
                          self._upload(vs), qps)
            yield staged

    def _wave_groups(self, frames):
        """Wave grouping: (wave, static F, frame cursor). Stacks into
        (G, F, ...) with tail-repeat padding to static F. The cursor
        decodes frames on demand and each wave's frames are released
        once the caller has staged them."""
        plan = self.plan(len(frames))
        cursor = _FrameCursor(frames, self.stages, require_420=True,
                              stats=self.staging_stats)
        gops = list(plan.gops)
        per_wave = self.gops_per_wave
        for wave_start in range(0, len(gops), per_wave):
            wave = gops[wave_start:wave_start + per_wave]
            F = max(g.num_frames for g in wave)
            yield wave, F, cursor
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
            out = _encode_gop_single(ysd, usd, vsd, qps, mbw=mbw, mbh=mbh)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
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

        host = _to_host(payload[:, :cut(used.max())])
        self.stages.bump("d2h_bytes", int(host.nbytes))
        return list(host)

    def collect_wave(self, pending: tuple) -> list[EncodedSegment]:
        """Fetch one dispatched wave's levels (compact, with the dense
        fallback) and entropy-pack its GOPs on the host, fanning the
        pack across the slice pool."""
        wave, ysd, usd, vsd, qps, mbw, mbh, out, done = pending
        prof = self.stages
        F = ysd.shape[1]
        nmb = mbw * mbh
        L = nmb * _INTRA_MB + (F - 1) * nmb * _P_FLAT_MB
        # Barrier on the tiny count outputs first: they complete when
        # the wave's compute does, splitting "waiting on the device"
        # from the bulk D2H fetch in the stage breakdown — and letting
        # a budget overflow skip the bulk sparse fetch entirely.
        with prof.stage("device_wait"):
            if done is not None:
                done.synchronize()
            tiny = [_to_host(t) for t in out[2:6]]
        prof.bump("d2h_bytes", sum(int(a.nbytes) for a in tiny))
        nblk, nval, n_esc, used = tiny
        # dense prefix = both intra hadamard DC segments (luma +
        # chroma); the sparse remainder skips them (_per_gop_sparse)
        ndc, ncdc = nmb * 16, nmb * 8
        Lr = L - ndc - ncdc
        sparse_ok = torchcore.block_sparse2_fits(
            nblk.max(), nval.max(), n_esc.max(), Lr)
        flat = payload_rows = None
        if sparse_ok:
            with prof.stage("fetch"):
                mv8, dc16 = _to_host(out[0]), _to_host(out[1])
                prof.bump("d2h_bytes", mv8.nbytes + dc16.nbytes)
                payload_rows = self._fetch_payload_rows(out[6], used)
        else:
            # Rare wave-wide dense retry: re-encode + wide int16 fetch.
            # Its own stage (not "fetch") so the fetch number answers
            # only "what does the common bulk transfer cost", plus a
            # counter so overflow-prone content is visible.
            prof.bump("dense_fallback_waves")
            with prof.stage("dense_retry"):
                flat = _to_host(_encode_gop_single_dense(
                    ysd, usd, vsd, qps, mbw=mbw, mbh=mbh))
                prof.bump("d2h_bytes", int(flat.nbytes))
                # the dense program re-emits levels only; MVs still
                # come from the already-computed sparse outputs
                mv8 = _to_host(out[0])
        # Header QP must match what the device QUANTIZED with — read it
        # from the staged per-wave array, not the live gop_qp dict (a
        # caller mutating gop_qp between passes must not desync slices
        # already in flight).
        # Phase 1: unpack levels and SUBMIT every GOP's pack work — the
        # slice pool packs the whole wave's slices concurrently; phase 2
        # gathers in GOP order.
        pool = self._pack_pool
        jobs: list[tuple] = []
        for gi, gop in enumerate(wave):
            gop_qp = int(qps[gi])
            if sparse_ok:
                with prof.stage("sparse_unpack"):
                    rest = unpack_compact_auto(
                        payload_rows[gi][:int(used[gi])], int(nblk[gi]),
                        int(nval[gi]), Lr)
                with prof.stage("unflatten"):
                    intra, planes = unflatten_gop_parts(
                        dc16[gi], rest, mv8[gi], F, mbw, mbh)
            else:
                with prof.stage("unflatten"):
                    intra, planes = unflatten_gop(flat[gi], mv8[gi], F,
                                                  mbw, mbh)
            # gop.num_frames (not F) drops the wave's tail-repeat padding
            thunks = gop_slice_thunks_planes(
                intra, planes, gop.num_frames, mbw, mbh, self.sps,
                self.pps, gop_qp, idr_pic_id=gop.index, rd=self.rd)
            if pool is None:
                jobs.append((gop, lambda ts=thunks: [t() for t in ts]))
            else:
                futs = [pool.submit(t) for t in thunks]
                jobs.append((gop, lambda fs=futs: [f.result() for f in fs]))
        segments: list[EncodedSegment] = []
        for gop, gather in jobs:
            with prof.stage("pack"):
                payload = gather()
            with prof.stage("concat"):
                seg = EncodedSegment(
                    gop=gop, payload=b"".join(payload),
                    frame_sizes=tuple(len(p) for p in payload))
            segments.append(seg)
        prof.count_wave()
        return segments

    #: default in-flight wave window
    PIPELINE_WINDOW = 4

    #: default staged-waves-ahead depth for the background staging thread
    DECODE_AHEAD = 2

    def encode_waves(self, waves, window: int | None = None
                     ) -> list[EncodedSegment]:
        """Dispatch staged waves: device compute → compact fetch → host
        entropy pack, in wave order.

        Up to `window` (default: `pipeline_window`) waves are dispatched
        ahead, each wave's fetch+unpack runs on a collector thread per
        in-flight wave, and every slice of every in-flight GOP packs on
        this encoder's `pack_workers` pool."""
        import concurrent.futures as cf

        window = window or self.pipeline_window
        segments: list[EncodedSegment] = []
        waves = iter(waves)
        pending: list[cf.Future] = []

        with cf.ThreadPoolExecutor(window) as pool:
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

    @staticmethod
    def _gop_plane(cursor: _FrameCursor, gop: GopSpec, F: int, plane: str
                   ) -> np.ndarray:
        arrs = [getattr(cursor.get(i), plane)
                for i in range(gop.start_frame, gop.end_frame)]
        while len(arrs) < F:            # tail-repeat to the wave's static F
            arrs.append(arrs[-1])
        return np.stack(arrs)
