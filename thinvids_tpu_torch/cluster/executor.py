"""Live part of the job executor: tail a growing source, encode each
completed GOP on the card, package LL-HLS as it goes.

These are the reference executor's live methods (`_run_live`,
`_live_encoder`, `_live_backlog_cap`, `_live_encode_batch`,
`_warm_live_shapes`) as module-level functions over the port's encoders,
so a job executor can call them. The coordinator calls the reference's
loop makes (run-token fencing, progress, heartbeats, publishing the
served tree, the QoS deadline report, completion) go through one
:class:`LiveHooks` object instead; the default does nothing, which is
what a caller without a coordinator needs.

The GOP grid is pinned (`_live_batch_plan`), so a live stream's parts,
segments and playlists are a pure function of the frame index: the
batch sizes (one GOP at the live edge, up to the backlog cap during
catch-up) change how the work is grouped, never the bytes.
"""

from __future__ import annotations

import logging
import os
import time

from ..parallel.planner import plan_fixed_segments

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


def live_encoder(meta, settings, rungs, *, device="cuda"):
    """Live-edge encoder selection (plan-driven, like every other path):
    the ladder stack by default; a SINGLE-rung stream with
    `sfe_bands > 0` runs the split-frame encoder at the live edge
    instead — every frame cut into band slices on the card, so
    glass-to-playlist latency rides the per-frame SFE pipeline rather
    than whole-GOP waves. Returns (encoder, sfe_mode)."""
    from ..parallel.dispatch import make_shard_encoder

    sfe_bands = int(settings.get("sfe_bands", 0) or 0)
    if sfe_bands > 0 and len(rungs) == 1:
        return make_shard_encoder(meta, settings, None, shape="band",
                                  device=device), True
    return make_shard_encoder(meta, settings, None, rungs=rungs,
                              device=device), False


def live_backlog_cap(enc) -> int:
    """Whole GOPs one catch-up dispatch may batch: one local wave (4
    GOPs for the ladder on one card, 1 for split-frame)."""
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
             stage: list | None = None, on_bundles=None) -> dict:
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
    Returns the master playlist's path, the GOPs and frames done and the
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
    enc, sfe_live = live_encoder(meta, settings, rungs, device=device)
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
    wave_cap = live_backlog_cap(enc)
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
        bundles = live_encode_batch(enc, rungs, tail, frames_done,
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
