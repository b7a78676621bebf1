"""Executor: turns a reserved Job into encode waves on the card + a muxed
file (a copy of the reference package's executor, on the port's
encoders).

The worker task chain `transcode → split → encode×N → stitch` runs on
one card or a device mesh: "split" is the GOP plan, "encode×N" is the
wave loop over the port's GopShardEncoder / SfeShardEncoder /
LadderShardEncoder, "stitch" is the ordered concat + MP4 mux (or the
HLS package). Progress, heartbeats and completion flow back through the
coordinator's token-fenced callbacks; a stale token halts the run
between waves.

Wave-level fault handling: a wave that raises is re-dispatched up to
`part_failure_max_retries` times; when its budget is spent, the
remaining frames are re-planned on a mesh with fewer entries (the
elastic replan). One card has no smaller mesh to re-plan on, so there an
exhausted wave fails the job with stage/host attribution.

Live jobs run :func:`run_live`: tail a growing source, encode each
completed GOP on the card, package LL-HLS as it goes. The coordinator
calls that loop makes (run-token fencing, progress, heartbeats,
publishing the served tree, the QoS deadline report, completion) go
through one :class:`LiveHooks` object; the executor passes one bound to
its job and run token, and a caller without a coordinator passes none.

The GOP grid of a live stream is pinned (`_live_batch_plan`), so its
parts, segments and playlists are a pure function of the frame index:
the batch sizes (one GOP at the live edge, up to the backlog cap during
catch-up) change how the work is grouped, never the bytes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from typing import Callable

from ..core.types import concat_segments
from ..ingest.decode import open_video
from ..io.mp4 import mux_mp4
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..parallel.planner import plan_fixed_segments
from .coordinator import Coordinator
from .jobs import Job

_LOG = logging.getLogger(__name__)


class HaltedError(RuntimeError):
    """Run token went stale mid-run (stop/restart/watchdog revocation)."""


def _live_batch_plan(num_frames: int, gop_frames: int,
                     num_devices: int):
    """Fixed GOP grid for one live batch: exactly `gop_frames` per GOP
    (short tail at end of stream), indices local to the batch. The
    default planner's wave balancing would split GOPs differently per
    batch size, making live part boundaries nondeterministic. (Shared
    with the SFE encoder's GOP walk — parallel/planner.
    plan_fixed_segments.)"""
    return plan_fixed_segments(num_frames, gop_frames, num_devices)


class _WaveExhausted(RuntimeError):
    """One wave burned its whole retry budget; carries the segments the
    failing range completed."""

    def __init__(self, reason: str, completed: list) -> None:
        super().__init__(reason)
        self.reason = reason
        self.completed = completed


class LocalExecutor:
    """Runs reserved jobs on this process's card, or on a device mesh.

    Plugs into :class:`Coordinator` as its launcher: `launch()` spawns a
    worker thread per job (pass ``sync=True`` for deterministic tests).
    `device` defaults to the card and raises without one; ``"cpu"`` runs
    the same code on the CPU (the tests). `mesh` (a core.devices.
    DeviceMesh) spreads every job's waves over its entries; None is the
    one `device` (the reference's None is every device — the port keeps
    one card so a stream never depends on the host's card count).
    """

    def __init__(self, coordinator: Coordinator, output_dir: str,
                 mesh=None, host: str = "local", sync: bool = False,
                 encoder_factory: Callable | None = None,
                 device="cuda") -> None:
        # torch loads inside the calls that need the device, never at
        # import: cluster.remote subclasses this executor and must
        # import on a control plane without torch
        from ..core.devices import as_mesh, resolve_device

        resolve_device(device)      # no card, no executor: raise now
        if mesh is not None:
            mesh = as_mesh(mesh)
        self.device = device
        self.coordinator = coordinator
        self.output_dir = output_dir
        self.mesh = mesh
        self.host = host
        self.sync = sync
        #: test seam: (meta, settings, mesh) -> GopShardEncoder-like
        self._encoder_factory = encoder_factory or self._default_encoder
        self._threads: list[threading.Thread] = []
        # flight-recorder artifacts (<job>.trace.json) land next to the
        # output tree this executor writes (obs/flight.py)
        obs_flight.configure(output_dir)

    # -- coordinator launcher interface --------------------------------

    def launch(self, job: Job) -> None:
        if self.sync:
            self.run(job)
            return
        t = threading.Thread(target=self.run, args=(job,), daemon=True,
                             name=f"tvt-exec-{job.id[:8]}")
        self._threads.append(t)
        t.start()

    def join(self, timeout: float | None = None) -> None:
        for t in self._threads:
            t.join(timeout)

    # -- pipeline ------------------------------------------------------

    def _default_encoder(self, meta, settings, mesh):
        """Plan-driven encoder resolution (parallel/dispatch.
        make_shard_encoder) on this executor's device: `sfe_bands > 0`
        selects the split-frame band shape (every frame cut into MB-row
        band slices on the card — the single-stream latency path; 0
        keeps GOP waves)."""
        from ..parallel.dispatch import make_shard_encoder

        return make_shard_encoder(meta, settings, mesh, device=self.device)

    def run(self, job: Job) -> None:
        token = job.run_token
        # bind the job's trace context to this thread: spans record
        # through the encoder's StageProfile + the wave loop below, and
        # the structured JSON log mode stamps (job_id, trace_id) onto
        # every line emitted while the run owns this thread
        with obs_trace.bind(job.id, obs_trace.TRACE.trace_id(job.id)):
            self._run_traced(job, token)

    def _run_traced(self, job: Job, token: str) -> None:
        co = self.coordinator
        # one-element list: the encode hook advances the stage marker in
        # place so failure attribution survives the subclass seam
        stage = ["probe"]
        source = None
        try:
            settings = co.job_settings(job)
            co.heartbeat_job(job.id, token, stage[0], host=self.host)
            if getattr(job, "job_type", "transcode") == "live":
                # live LL-HLS: the source is still GROWING — tail it
                # GOP-by-GOP and serve viewers during ingest (live/)
                with self._maybe_trace(settings, job):
                    self._run_live(job, token, settings, stage)
                return
            # streaming ingest: open (header parse / container demux)
            # WITHOUT decoding — frames decode wave-by-wave during the
            # encode, so the clip never materializes in host RAM and
            # time-to-first-wave is one wave's decode
            source = open_video(job.input_path)
            meta, audio = source.meta, source.audio
            if not len(source):
                raise ValueError(f"no frames in {job.input_path}")
            if not co.mark_running(job.id, token):
                raise HaltedError("fenced before start")

            if getattr(job, "job_type", "transcode") == "ladder":
                # ABR ladder: rungs encode from ONE staged wave stream
                # (lower rungs scale on the card) and the output is a
                # served HLS directory, not a single MP4 (abr/).
                with self._maybe_trace(settings, job):
                    rungs, rung_segs = self._encode_ladder(
                        job, token, source, settings, meta, stage)
                self._package_ladder(job, token, rungs, rung_segs, meta,
                                     audio, settings, len(source), stage)
                return

            with self._maybe_trace(settings, job):
                segments = self._encode_job(job, token, source, settings,
                                            meta, stage)

            stage[0] = "stitch"
            co.heartbeat_job(job.id, token, stage[0], host=self.host)
            stream = concat_segments(segments)
            base = os.path.splitext(os.path.basename(job.input_path))[0]
            out_path = os.path.join(self.output_dir, base + ".mp4")
            os.makedirs(self.output_dir, exist_ok=True)
            data = mux_mp4(stream, meta, audio=audio)
            tmp = f"{out_path}.{job.id}.tmp"    # job-unique: no clobber
                                                # across same-name jobs
            with open(tmp, "wb") as fp:
                fp.write(data)
            os.replace(tmp, out_path)       # atomic commit
            co.update_progress(job.id, token, combine_progress=100.0)
            co.complete_job(job.id, token, out_path, len(data))
        except HaltedError:
            pass                            # fenced: a newer run owns the job
        except Exception as exc:            # noqa: BLE001 - attribute & fail
            co.fail_job(job.id, token, stage=stage[0], host=self.host,
                        reason=f"{type(exc).__name__}: {exc}")
        finally:
            if source is not None:
                source.close()

    def _encode_job(self, job: Job, token: str, frames, settings, meta,
                    stage: list) -> list:
        """segment + encode stages → ordered EncodedSegments. `frames`
        is a lazy FrameSource (len + slicing + iteration; ingest/
        decode.py) — treat it as a sequence, never materialize it
        wholesale. `stage` is a one-element list the hook mutates for
        failure attribution."""
        co = self.coordinator
        stage[0] = "segment"
        enc = self._encoder_factory(meta, settings, self.mesh)
        self._bind_trace(job, enc)
        plan = enc.plan(len(frames))
        co.update_progress(job.id, token, parts_total=plan.num_gops,
                           segment_progress=100.0)
        co.heartbeat_job(job.id, token, stage[0], host=self.host,
                         note=f"{plan.num_gops} GOPs planned")

        stage[0] = "encode"
        target_kbps = float(settings.get("target_bitrate_kbps", 0.0))
        if str(settings.rc_mode) == "vbr2pass" and target_kbps > 0:
            segments = self._encode_vbr2pass(job, token, enc, frames,
                                             settings, meta, target_kbps)
        else:
            segments = self._encode_with_retry(job, token, enc, frames,
                                               settings)
        self._emit_stage_breakdown(job, enc)
        return segments

    def _encode_ladder(self, job: Job, token: str, frames, settings,
                       meta, stage: list):
        """Ladder encode stage: one LadderShardEncoder fans every wave
        across the rung set on the card (decode + upload once; lower
        rungs scale on the card). Returns (rungs, {rung name → ordered
        EncodedSegments})."""
        from ..abr.ladder import plan_ladder, rung_segments
        from ..parallel.dispatch import make_shard_encoder

        co = self.coordinator
        if str(settings.rc_mode) == "vbr2pass":
            # the two-pass QP solver has no multi-rendition form yet;
            # say so instead of silently dropping the bitrate target
            co.activity.emit(
                "encode", "ladder jobs use the octave-model per-rung "
                "QPs; rc_mode=vbr2pass / target_bitrate_kbps ignored",
                job_id=job.id, host=self.host)
        stage[0] = "segment"
        rungs = plan_ladder(meta, settings)
        enc = make_shard_encoder(meta, settings, self.mesh, rungs=rungs,
                                 device=self.device)
        self._bind_trace(job, enc)
        plan = enc.plan(len(frames))
        co.update_progress(job.id, token, parts_total=plan.num_gops,
                           segment_progress=100.0)
        co.heartbeat_job(
            job.id, token, stage[0], host=self.host,
            note=f"{plan.num_gops} GOPs x {len(rungs)} rungs")

        stage[0] = "encode"
        # no re-plan for ladders: a change mid-job would re-plan GOP
        # boundaries and break cross-rung segment alignment
        bundles = self._encode_with_retry(job, token, enc, frames,
                                          settings, allow_replan=False)
        self._emit_stage_breakdown(job, enc)
        return rungs, {r.name: rung_segments(bundles, r.name)
                       for r in rungs}

    def _package_ladder(self, job: Job, token: str, rungs, rung_segs,
                        meta, audio, settings, num_frames: int,
                        stage: list) -> None:
        """Package stage: rungs → fMP4 segments + playlists under
        `<output_dir>/<base>.hls/`, lint-checked, committed with an
        atomic directory rename; the job completes pointing at the
        master playlist (served via /hls/<job>/master.m3u8)."""
        import shutil

        from ..abr import hls

        co = self.coordinator
        stage[0] = "package"
        co.heartbeat_job(job.id, token, stage[0], host=self.host,
                         note=f"{len(rungs)} rungs → HLS")
        # audio passes through bit-exact on EVERY rung: variants must
        # share one codec set or an adaptive down-switch at a segment
        # edge drops the sound track (players handle codec-set changes
        # across variants poorly); the duplicated compressed audio is
        # noise next to any rung's video bytes
        streams = [hls.RungStream(
            name=r.name, width=r.width, height=r.height,
            segments=rung_segs[r.name], audio=audio) for r in rungs]
        base = os.path.splitext(os.path.basename(job.input_path))[0]
        out_dir = os.path.join(self.output_dir, base + ".hls")
        tmp = f"{out_dir}.{job.id}.tmp"     # job-unique staging dir
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            hls.package_ladder(
                tmp, streams, meta.fps_num, meta.fps_den,
                segment_s=float(settings.get("segment_s", 6.0)))
            fps = meta.fps_num / max(1, meta.fps_den)
            hls.lint_ladder(tmp, expected_duration_s=num_frames / fps)
            shutil.rmtree(out_dir, ignore_errors=True)
            os.rename(tmp, out_dir)         # atomic commit
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        total = 0
        for root, _dirs, files in os.walk(out_dir):
            total += sum(os.path.getsize(os.path.join(root, f))
                         for f in files)
        master = os.path.join(out_dir, hls.MASTER_PLAYLIST)
        co.update_progress(job.id, token, combine_progress=100.0)
        co.complete_job(job.id, token, master, total)

    def _run_live(self, job: Job, token: str, settings,
                  stage: list) -> None:
        """Live LL-HLS pipeline (:func:`run_live`) for one job, its
        coordinator calls bound to the job and this run's token. The
        tree lands in `<output_dir>/<input stem>.hls/`. Batches do not
        retry: a live edge cannot rewind, so a failure fails the job
        with attribution."""
        run_live(job.input_path, self.output_dir, settings,
                 device=self.device, mesh=self.mesh,
                 hooks=_JobLiveHooks(self, job, token, settings),
                 stage=stage)

    def _live_backlog_cap(self, job: Job, settings, enc) -> int:
        """Whole GOPs one live catch-up batch may hold: one local wave
        (the remote backend widens it to the farm's width)."""
        return live_backlog_cap(enc)

    def _live_encode_batch(self, job: Job, token: str, settings, enc,
                           rungs, tail, frames_done: int, gops_done: int,
                           count: int, gop_n: int, sfe_live: bool):
        """Encode one live batch on this executor's card (the remote
        backend fans a catch-up batch's backlog out to its workers and
        keeps the edge GOP here)."""
        return live_encode_batch(enc, rungs, tail, frames_done, gops_done,
                                 count, gop_n, sfe_live)

    def _bind_trace(self, job: Job, enc) -> None:
        """Bind the job's span recorder to the encoder's stage profile:
        every timed stage (decode/stage/dispatch/device_wait/fetch/
        pack/concat, SFE per-frame) then records a span into the job's
        distributed trace. Inert when the job was sampled out
        (trace_sample) or the encoder is a test double without a
        profile."""
        stages = getattr(enc, "stages", None)
        set_tracer = getattr(stages, "set_tracer", None)
        if set_tracer is not None:
            set_tracer(obs_trace.TRACE.recorder(job.id, host=self.host))

    def _emit_stage_breakdown(self, job: Job, enc) -> None:
        """Record the encoder's host-stage wall-clock breakdown (wave
        dispatch / device wait / D2H fetch / sparse unpack / unflatten /
        CAVLC pack / concat) in the job's activity feed — the per-job
        counterpart of /metrics_snapshot's live aggregate."""
        stages = getattr(enc, "stages", None)
        if stages is None:
            return
        import json

        self.coordinator.activity.emit(
            "encode", "stage_ms " + json.dumps(stages.snapshot()),
            job_id=job.id, host=self.host)

    def _maybe_trace(self, settings, job: Job):
        """torch.profiler trace of the encode stage when `profile_dir` is
        set: host ops and, on the card, its kernels, as one Chrome trace
        under ``<profile_dir>/job-<id8>/`` beside the job's span
        trace."""
        from ..core.devices import resolve_device

        profile_dir = str(settings.get("profile_dir", "") or "")
        if not profile_dir:
            return contextlib.nullcontext()
        return _profiled(os.path.join(profile_dir, f"job-{job.id[:8]}"),
                         cuda=resolve_device(self.device).type == "cuda")

    def _encode_vbr2pass(self, job: Job, token: str, enc, frames,
                         settings, meta, target_kbps: float) -> list:
        """Two-pass VBR via rc.encode_vbr2pass's single solve/refine
        loop, with every pass riding this executor's retry/halt/progress
        wrapper and heartbeating its pass number."""
        from ..parallel import rc

        co = self.coordinator

        def on_pass(pass_no, gop_qps):
            note = ("vbr pass 1 (analysis)" if gop_qps is None else
                    f"vbr pass {pass_no} (qp {gop_qps.min()}"
                    f"-{gop_qps.max()})")
            co.heartbeat_job(job.id, token, "encode", host=self.host,
                             note=note)

        segments, _stats = rc.encode_vbr2pass(
            frames, meta, target_kbps, base_qp=int(settings.qp), enc=enc,
            encode_fn=lambda e: self._encode_with_retry(
                job, token, e, frames, settings, allow_replan=False),
            on_pass=on_pass,
            aq_strength=float(settings.get("aq_strength", 0.0) or 0.0))
        return segments

    def _encode_with_retry(self, job: Job, token: str, enc, frames,
                           settings, allow_replan: bool = True) -> list:
        """Wave loop with per-wave retry and halt checks. When a wave
        exhausts its retry budget, `_shrink_encoder` is asked for an
        encoder over fewer devices to re-plan the remaining frames on;
        on one card there is none, and the job fails with attribution.

        `allow_replan=False` (the vbr2pass passes, the ladder) fails
        without asking: a change mid-pass would change the GOP count
        under the QP solver and orphan the per-GOP QP map.
        """
        co = self.coordinator
        total_gops = enc.plan(len(frames)).num_gops
        segments: list = []
        start_frame = 0
        shrink_attempt = 0
        while True:
            try:
                segments.extend(self._encode_range(
                    job, token, enc, frames, start_frame, settings,
                    total_gops, len(segments)))
                segments.sort(key=lambda s: s.gop.index)
                return segments
            except _WaveExhausted as exc:
                segments.extend(exc.completed)
                shrink_attempt += 1
                shrunk = (self._shrink_encoder(enc, settings,
                                               shrink_attempt)
                          if allow_replan else None)
                if shrunk is None:
                    raise RuntimeError(exc.reason) from exc
                # completed waves are a contiguous frame prefix (waves
                # collect in order); resume after it on the new encoder
                start_frame = max(
                    (s.gop.end_frame for s in segments), default=0)
                # the suffix re-plans with a different device count, so
                # the GOP total changes — keep progress honest
                total_gops = len(segments) + shrunk.plan(
                    len(frames) - start_frame).num_gops
                co.update_progress(job.id, token, parts_total=total_gops)
                co.activity.emit(
                    "encode", f"wave retries exhausted; replanning "
                    f"frames {start_frame}+ on {shrunk.num_devices} "
                    f"devices (was {enc.num_devices})",
                    job_id=job.id, host=self.host)
                enc = shrunk

    def _qos_pause(self, job: Job, token: str, settings) -> None:
        """Hold a BATCH-class job's wave loop while the QoS controller
        has batch work preempted for a struggling live edge
        (cluster/qos.py): in-flight waves drain, no new wave
        dispatches, heartbeats keep the watchdog off. Ladder and live
        jobs never pause; re-raises HaltedError if fenced mid-pause."""
        from .qos import BATCH_RANK, job_rank

        co = self.coordinator
        qos = getattr(co, "qos", None)
        if qos is None or qos.batch_allowed():
            return
        override = str(settings.get("job_priority", "auto") or "auto")
        if job_rank(getattr(job, "job_type", "transcode"),
                    override) < BATCH_RANK:
            return
        co.activity.emit("qos", "batch waves paused: live QoS "
                         "preemption", job_id=job.id, host=self.host)
        while not qos.wait_batch_allowed(0.1):
            if not co.token_is_current(job.id, token):
                raise HaltedError("stale run token")
            co.heartbeat_job(job.id, token, "encode", host=self.host,
                             note="paused: live QoS preemption")

    def _shrink_encoder(self, enc, settings, attempt: int):
        """Encoder over a shrunken copy of enc's mesh, or None when it
        cannot shrink further (one entry) or the encoder exposes no mesh.

        A wave failure carries no device attribution, so the shrink is
        blind: it drops entries from the tail, doubling the count each
        consecutive attempt (1, 2, 4, ...) so a bad card at a low index
        is excluded in O(log n) rounds rather than n retry budgets."""
        mesh = getattr(enc, "mesh", None)
        meta = getattr(enc, "meta", None)
        if mesh is None or meta is None or mesh.size <= 1:
            return None
        drop = min(mesh.size - 1, 2 ** (attempt - 1))
        return self._encoder_factory(meta, settings, mesh.shrink(drop))

    def _encode_range(self, job: Job, token: str, enc, frames,
                      start_frame: int, settings, total_gops: int,
                      done0: int) -> list:
        """Depth-2 pipelined wave loop over frames[start_frame:].

        The decode → stack → upload staging chain runs on a background
        staging thread (`decode_ahead` waves ahead of the dispatch
        window — parallel/dispatch.background_stage), so ingest
        overlaps device compute instead of serializing ahead of it.
        Staging stays bounded, not free: input residency is the 2
        in-flight waves PLUS up to `decode_ahead` staged-but-undispatched
        waves (+1 blocked in the queue put) of card-resident YUV
        tensors — size `decode_ahead` against the card's memory
        headroom, not just source latency. A retried wave re-dispatches
        from its retained staged tuple.
        Raises _WaveExhausted (carrying the range's completed segments)
        when one wave fails `part_failure_max_retries` times.
        """
        from ..parallel.dispatch import GopShardEncoder, background_stage

        co = self.coordinator
        max_retries = int(settings.part_failure_max_retries)
        if start_frame:
            # GOP indices / frame ranges restart at 0 for the subrange;
            # offset emitted segments so ordering + idr_pic_id stay
            # globally consistent with already-completed ones
            enc.gop_index_offset = done0
            enc.frame_offset = start_frame
        # the encoder already resolved the `decode_ahead` setting in
        # its constructor (like pack_workers/pipeline_window), so honor
        # its knob — incl. explicit constructor overrides; the class
        # default only covers test doubles that lack the attribute
        decode_ahead = int(getattr(enc, "decode_ahead", 0) or 0) \
            or GopShardEncoder.DECODE_AHEAD
        feed = background_stage(
            enc.stage_waves(frames[start_frame:] if start_frame
                            else frames),
            decode_ahead)
        staged_iter = enumerate(feed)
        segments: list = []
        done = done0
        pending: deque = deque()        # (idx, staged, handle)
        attempts: dict[int, int] = {}
        # per-wave spans in the job's distributed trace (inert when
        # the job was sampled out — trace_sample)
        rec = obs_trace.TRACE.recorder(job.id, host=self.host)

        def halt_check() -> None:
            if not co.token_is_current(job.id, token):
                raise HaltedError("stale run token")

        def dispatch_next() -> None:
            try:
                i, staged = next(staged_iter)
            except StopIteration:
                return
            with rec.span("wave_dispatch", wave=i):
                pending.append((i, staged, enc.dispatch_wave(staged)))

        try:
            dispatch_next()
            while pending:
                halt_check()
                self._qos_pause(job, token, settings)
                if len(pending) < 2:
                    dispatch_next()     # overlap: depth-2 window, no more
                i, staged, handle = pending.popleft()
                try:
                    with rec.span("wave_collect", wave=i):
                        segs = enc.collect_wave(handle)
                except HaltedError:
                    raise
                except Exception as exc:  # noqa: BLE001 - wave retry budget
                    n = attempts.get(i, 0) + 1
                    attempts[i] = n
                    if n > max_retries:
                        raise _WaveExhausted(
                            f"wave {i} failed after {n - 1} retries: "
                            f"{type(exc).__name__}: {exc}", segments) \
                            from exc
                    co.activity.emit(
                        "encode", f"wave {i} attempt {n} failed, "
                        f"retrying: {exc}", job_id=job.id, host=self.host)
                    # staged[0] is the wave's GOP list (GopShardEncoder)
                    # or a single GopSpec (SfeShardEncoder: one GOP per
                    # wave, frames cut into bands within it)
                    wave_gops = (len(staged[0])
                                 if hasattr(staged[0], "__len__") else 1)
                    retried = co.store.get(job.id).parts_retried \
                        + wave_gops
                    co.update_progress(job.id, token, parts_retried=retried)
                    halt_check()
                    pending.appendleft((i, staged,
                                        enc.dispatch_wave(staged)))
                    continue
                segments.extend(segs)
                done += len(segs)
                co.update_progress(
                    job.id, token, parts_done=done,
                    encode_progress=100.0 * done / max(1, total_gops))
                co.heartbeat_job(job.id, token, "encode", host=self.host,
                                 note=f"{done}/{total_gops} GOPs")
            return segments
        finally:
            feed.close()                # stop the staging thread
                                        # (halt / exhaustion)


@contextlib.contextmanager
def _profiled(out_dir: str, cuda: bool):
    """torch.profiler over the block (host ops; the card's kernels too
    when `cuda`), written as one Chrome trace into `out_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
    path = os.path.join(out_dir,
                        f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _LOG.info("profiler trace %s: %d bytes, %.1f s to stop and write",
              path, os.path.getsize(path), time.perf_counter() - t0)


class LiveHooks:
    """The coordinator calls a live run makes, each a no-op here. A job
    executor passes an adapter bound to its job and run token."""

    def mark_running(self) -> bool:
        """Claim the job for this run; False = fenced before start."""
        return True

    def token_is_current(self) -> bool:
        """False once a newer run owns the job (fencing)."""
        return True

    def publish_output(self, master_path: str) -> None:
        """The served tree exists: announce it while the job runs."""

    def note_live_part(self, seconds: float, budget: float) -> None:
        """One batch's frames-available to parts-fetchable wall-clock,
        beside the part deadline (the coordinator's QoS input)."""

    def update_progress(self, **fields) -> None:
        """Progress fields (parts_total, parts_done, *_progress)."""

    def heartbeat(self, stage: str, note: str = "") -> None:
        """Liveness + the stage the run is in."""

    def bind_trace(self, enc) -> None:
        """Bind the job's span recorder to the encoder's stage profile
        (``enc.stages.set_tracer``)."""

    def stage_breakdown(self, enc) -> None:
        """The encoder's host-stage breakdown at end of stream
        (``enc.stages.snapshot()``) for the job's activity feed."""

    def complete(self, master_path: str, nbytes: int) -> None:
        """The stream closed and the final tree passed its lint."""

    def backlog_cap(self, enc) -> int:
        """Whole GOPs one catch-up batch may hold
        (:func:`live_backlog_cap`; a farm widens it)."""
        return live_backlog_cap(enc)

    def encode_batch(self, enc, rungs, tail, frames_done: int,
                     gops_done: int, count: int, gop_n: int,
                     sfe_live: bool):
        """Encode one live batch (:func:`live_encode_batch`; a farm
        fans a catch-up batch's backlog GOPs out to its workers)."""
        return live_encode_batch(enc, rungs, tail, frames_done, gops_done,
                                 count, gop_n, sfe_live)


def live_encoder(meta, settings, rungs, *, device="cuda", mesh=None):
    """Live-edge encoder selection (plan-driven, like every other path):
    the ladder stack by default; a SINGLE-rung stream with
    `sfe_bands > 0` runs the split-frame encoder at the live edge
    instead — every frame cut into band slices on the card (or the
    mesh), so glass-to-playlist latency rides the per-frame SFE pipeline
    rather than whole-GOP waves. Returns (encoder, sfe_mode)."""
    from ..parallel.dispatch import make_shard_encoder

    sfe_bands = int(settings.get("sfe_bands", 0) or 0)
    if sfe_bands > 0 and len(rungs) == 1:
        return make_shard_encoder(meta, settings, mesh, shape="band",
                                  device=device), True
    return make_shard_encoder(meta, settings, mesh, rungs=rungs,
                              device=device), False


def live_backlog_cap(enc) -> int:
    """Whole GOPs one catch-up dispatch may batch: one local wave (4
    GOPs a mesh entry for the ladder, 1 for split-frame)."""
    return enc.num_devices * enc.gops_per_wave


def live_encode_batch(enc, rungs, tail, frames_done: int, gops_done: int,
                      count: int, gop_n: int, sfe_live: bool):
    """Encode one live batch. GOP indices / frame ranges continue the
    global stream (the elastic-replan offset contract), and the batch's
    GOP boundaries are pinned EXPLICITLY: a live stream's GOP grid must
    be a pure function of the frame index (gop_frames-sized), never of
    arrival timing or batch size."""
    enc.gop_index_offset = gops_done
    enc.frame_offset = frames_done
    enc.plan_override = _live_batch_plan(count, gop_n, enc.num_devices)
    # lazy window, not a materialized list: the staging thread decodes
    # the batch wave-by-wave (bounded residency, same contract as batch
    # ingest)
    out = enc.encode(tail[frames_done:frames_done + count])
    if not sfe_live:
        return out
    # SFE live edge: plain EncodedSegments wrap into single-rung bundles
    # so the incremental packager consumes them unchanged
    from ..abr.ladder import LadderGopBundle

    return [LadderGopBundle(gop=s.gop, renditions={rungs[0].name: s})
            for s in out]


def warm_live_shapes(enc, meta, gop_n: int) -> None:
    """Run one live-edge batch (one gop_n-frame GOP) on synthetic frames
    before real ones arrive, so the first part's latency does not pay
    the first launches (kernel builds, allocator growth, pack pools).
    Best-effort: a failure here is logged, and a real defect fails the
    REAL first batch with proper attribution."""
    import numpy as np

    from ..core.types import Frame

    h, w = meta.height, meta.width
    dummy = [Frame(y=np.zeros((h, w), np.uint8),
                   u=np.full((h // 2, w // 2), 128, np.uint8),
                   v=np.full((h // 2, w // 2), 128, np.uint8))
             for _ in range(gop_n)]
    enc.plan_override = _live_batch_plan(gop_n, gop_n, enc.num_devices)
    try:
        enc.encode(dummy)
    except Exception:       # noqa: BLE001 - warm-up is best-effort
        _LOG.warning("live warm-up batch failed; the first real batch "
                     "will raise the same defect", exc_info=True)


def run_live(input_path: str, output_dir: str, settings, *,
             device="cuda", hooks: LiveHooks | None = None,
             stage: list | None = None, on_bundles=None,
             mesh=None) -> dict:
    """Live LL-HLS pipeline: tail the growing source, encode each
    completed GOP through the ladder (or split-frame) encoder batch by
    batch, and hand every finished GOP bundle to the incremental
    packager — output availability is decoupled from job completion
    (the master playlist is published after the FIRST GOP clears all
    rungs).

    Latency model: at the live edge one GOP encodes at a time
    (glass-to-playlist ≈ GOP duration + one batch's encode+package);
    during backlog/catch-up, up to `live_backlog_cap` GOPs batch per
    dispatch. End-of-stream is the tail source's stall timeout
    (`live_stall_s`) or `.eos` marker; the packager then finalizes with
    EXT-X-ENDLIST and — when nothing was GC'd out of the DVR window —
    the tree passes the full VOD conformance lint. Batches do not retry:
    a live edge cannot rewind, so a failure fails the job.

    The tree lands in `<output_dir>/<input stem>.hls/`. `stage` (a
    one-element list) tracks the stage for failure attribution;
    `on_bundles(bundles)` sees each batch's bundles after packaging.
    `mesh` (a DeviceMesh) spreads each batch over its entries. Returns
    the master playlist's path, the GOPs and frames done and the
    packager's counters."""
    import shutil

    from ..abr import hls
    from ..abr.ladder import plan_ladder
    from ..core.devices import resolve_device
    from ..ingest.tail import TailFrameSource
    from ..live.packager import LiveLadderPackager

    resolve_device(device)      # no card, no run: raise before tailing
    hooks = hooks if hooks is not None else LiveHooks()
    stage = stage if stage is not None else [""]
    stage[0] = "tail"
    stall = float(settings.get("live_stall_s", 10.0))
    tail = TailFrameSource(input_path, stall_timeout_s=stall)
    meta = tail.meta                    # header facts; num_frames grows
    if not hooks.mark_running():
        raise HaltedError("fenced before start")
    gop_n = int(settings.gop_frames)
    rungs = plan_ladder(meta, settings)
    enc, sfe_live = live_encoder(meta, settings, rungs, device=device,
                                 mesh=mesh)
    hooks.bind_trace(enc)
    base = os.path.splitext(os.path.basename(input_path))[0]
    out_dir = os.path.join(output_dir, base + ".hls")
    os.makedirs(output_dir, exist_ok=True)
    # a restarted live job re-tails from frame 0: the previous attempt's
    # tree is stale output, not resumable state
    shutil.rmtree(out_dir, ignore_errors=True)
    packager = LiveLadderPackager(
        out_dir, rungs, meta.fps_num, meta.fps_den,
        segment_s=float(settings.get("segment_s", 6.0)),
        gop_frames=gop_n,
        dvr_window_s=float(settings.get("dvr_window_s", 0.0)))
    hooks.heartbeat(stage[0],
                    f"tailing x{len(rungs)} rungs (stall {stall:.0f}s)")

    def fenced() -> bool:
        return not hooks.token_is_current()

    stage[0] = "encode"
    # warm the live-edge batch NOW, while the source is still filling
    # its first GOP
    warm_live_shapes(enc, meta, gop_n)
    # QoS deadline: a live batch slower than this budget is reported
    # over budget. 0 = auto: 2x the stream's segment duration.
    part_budget = float(settings.get("live_part_budget_s", 0.0)) \
        or 2.0 * float(settings.get("segment_s", 6.0))
    wave_cap = hooks.backlog_cap(enc)
    frames_done = gops_done = 0
    published = False
    while True:
        avail = tail.wait_frames(frames_done + gop_n, stop_check=fenced)
        batch_t0 = time.monotonic()
        if fenced():
            raise HaltedError("stale run token")
        if avail <= frames_done and tail.ended:
            break
        if tail.ended:
            # drain wave-by-wave (the final partial GOP rides the last
            # batch) — never one giant batch, a fast writer can leave an
            # arbitrarily deep backlog at EOS
            count = min(avail - frames_done, wave_cap * gop_n)
        else:
            whole = (avail - frames_done) // gop_n
            # at the live edge whole==1 (lowest latency); during
            # catch-up batch up to the backlog cap per dispatch
            count = min(whole, wave_cap) * gop_n
        bundles = hooks.encode_batch(enc, rungs, tail, frames_done,
                                     gops_done, count, gop_n, sfe_live)
        for bundle in bundles:
            packager.add_gop(bundle)
        if on_bundles is not None:
            on_bundles(bundles)
        if not published:
            # the served tree now exists: announce it while the job
            # keeps RUNNING — viewers join during ingest
            hooks.publish_output(packager.master_path)
            published = True
        gops_done += len(bundles)
        frames_done += count
        # deadline report: wall-clock from the batch's frames being
        # available to its parts being fetchable
        hooks.note_live_part(time.monotonic() - batch_t0, part_budget)
        hooks.update_progress(parts_total=gops_done, parts_done=gops_done,
                              segment_progress=100.0)
        hooks.heartbeat(stage[0],
                        f"live edge: {gops_done} GOPs, "
                        f"{packager.segments_announced} segments, "
                        f"{packager.segments_gced} GC'd")
    if gops_done == 0:
        raise ValueError(f"live source {input_path} ended with no frames")

    stage[0] = "finalize"
    hooks.heartbeat(stage[0], "end of stream; writing ENDLIST")
    packager.close()
    fps = meta.fps_num / max(1, meta.fps_den)
    if packager.segments_gced == 0:
        # nothing left the DVR window: the closed tree is a full VOD and
        # must pass the batch conformance gate unchanged
        hls.lint_ladder(out_dir, expected_duration_s=frames_done / fps)
    else:
        for r in rungs:
            hls.lint_live_media_playlist(os.path.join(
                out_dir, r.name, hls.MEDIA_PLAYLIST))
    hooks.stage_breakdown(enc)
    hooks.update_progress(encode_progress=100.0, combine_progress=100.0)
    nbytes = packager.total_bytes()
    hooks.complete(packager.master_path, nbytes)
    return {"master": packager.master_path, "gops": gops_done,
            "frames": frames_done, "bytes": nbytes,
            "segments_announced": packager.segments_announced,
            "parts_announced": packager.parts_announced,
            "segments_gced": packager.segments_gced}


class _JobLiveHooks(LiveHooks):
    """The live loop's coordinator calls, bound to one job and its run
    token (the calls the reference executor's `_run_live` makes)."""

    def __init__(self, execu: LocalExecutor, job: Job, token: str,
                 settings) -> None:
        self.execu, self.job, self.token = execu, job, token
        self.settings = settings
        self.co = execu.coordinator

    def mark_running(self) -> bool:
        return self.co.mark_running(self.job.id, self.token)

    def token_is_current(self) -> bool:
        return self.co.token_is_current(self.job.id, self.token)

    def publish_output(self, master_path: str) -> None:
        self.co.publish_output(self.job.id, self.token, master_path)

    def note_live_part(self, seconds: float, budget: float) -> None:
        self.co.note_live_part(self.job.id, self.token, seconds, budget)

    def update_progress(self, **fields) -> None:
        self.co.update_progress(self.job.id, self.token, **fields)

    def heartbeat(self, stage: str, note: str = "") -> None:
        self.co.heartbeat_job(self.job.id, self.token, stage,
                              host=self.execu.host, note=note)

    def bind_trace(self, enc) -> None:
        self.execu._bind_trace(self.job, enc)

    def stage_breakdown(self, enc) -> None:
        self.execu._emit_stage_breakdown(self.job, enc)

    def complete(self, master_path: str, nbytes: int) -> None:
        self.co.complete_job(self.job.id, self.token, master_path, nbytes)

    def backlog_cap(self, enc) -> int:
        return self.execu._live_backlog_cap(self.job, self.settings, enc)

    def encode_batch(self, enc, rungs, tail, frames_done: int,
                     gops_done: int, count: int, gop_n: int,
                     sfe_live: bool):
        return self.execu._live_encode_batch(
            self.job, self.token, self.settings, enc, rungs, tail,
            frames_done, gops_done, count, gop_n, sfe_live)
