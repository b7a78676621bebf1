"""Open-loop live edge: frames fall due at a fixed rate, and each GOP is
handed to the split-frame encoder when its last frame falls due.

The generator plays the live executor's edge (`cluster.executor.run_live`)
without the growing file and the packager: `live_encoder` builds the
single-rung split-frame encoder, set-up runs `warm_live_shapes` and one
GOP of the stream's own content, and in the window each GOP goes through
`live_encode_batch`, one GOP a batch. The schedule does not wait for the
encoder: a slow GOP delays the next one's start, and every frame's
latency is measured from its due time to its GOP's segments coming back.

Mix parameters: `rate_fps` (frames due a second), `trace_gops` (the
traced run's device trace covers the window's last GOPs, so that the
profiler's stop, which takes seconds, falls after the window),
`check_gops` (GOPs, drawn from the seed, that the reference follows
whole, from the IDR picture to the last).
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from tvbench import checkpool, devtrace
from tvbench.content import Scene
from tvbench.reference import h264


class _Spans:
    """A span sink for the encoder's StageProfile (its `set_tracer`
    hook): (name, start, end) in time.time() seconds."""

    enabled = True

    def __init__(self) -> None:
        self.spans: list[tuple[str, float, float]] = []

    def record(self, name, t0, dur_s, **tags) -> None:
        self.spans.append((name, t0, t0 + dur_s))


class _Frames:
    """The stream's frames by absolute index, made on demand."""

    def __init__(self, scene: Scene) -> None:
        self.scene = scene

    def __getitem__(self, s: slice):
        from thinvids_tpu_torch.core.types import Frame

        return [Frame(*self.scene.planes(i)) for i in range(s.start, s.stop)]


def run(ctx) -> dict:
    import torch

    from thinvids_tpu_torch.abr.ladder import plan_ladder
    from thinvids_tpu_torch.cluster.executor import (live_encode_batch,
                                                     live_encoder,
                                                     warm_live_shapes)
    from thinvids_tpu_torch.core.config import get_settings
    from thinvids_tpu_torch.core.types import VideoMeta
    from thinvids_tpu_torch.parallel.dispatch import stage_snapshot

    cfg, mix = ctx.config, ctx.traffic
    w, h = cfg["width"], cfg["height"]
    gop = int(cfg["settings"]["gop_frames"])
    rate = float(mix["rate_fps"])
    scene = Scene([ctx.seed, 0], w, h)
    frames = _Frames(scene)
    meta = VideoMeta(width=w, height=h, fps_num=int(cfg["frame_rate"]),
                     fps_den=1)
    settings = get_settings()
    rungs = plan_ladder(meta, settings)
    enc, sfe = live_encoder(meta, settings, rungs, device=ctx.device)
    if not sfe:
        raise RuntimeError("the configuration does not select the "
                           "split-frame live edge")
    warm_live_shapes(enc, meta, gop)
    # one GOP of this stream's content, far past the window's frames:
    # the content-dependent shapes (sparse pack sizes) are warm too
    far = 1 << 20
    live_encode_batch(enc, rungs, frames, far, 0, gop, gop, True)
    sink = _Spans()
    if ctx.trace:
        enc.stages.set_tracer(sink)
        devtrace.DeviceTrace.warm()

    n_gops = int(rate * ctx.seconds) // gop
    first, last = max(0, n_gops - int(mix["trace_gops"])), n_gops - 1
    dev = devtrace.DeviceTrace() if ctx.trace else None
    lat, lag, enc_s, segs, spans = [], [], [], {}, sink.spans
    failed = 0
    t_open = t_close = ctx.open_window()
    snap0 = stage_snapshot()
    for g in range(n_gops):
        ready = t_open + (g * gop + gop - 1) / rate
        now = time.time()
        if ready > now:
            spans.append(("awaiting_frames", now, ready))
            time.sleep(ready - now)
        if dev is not None and g == first:
            dev.start()
        t0 = time.time()
        lag.append(t0 - ready)
        try:
            bundles = live_encode_batch(enc, rungs, frames, g * gop, g, gop,
                                        gop, True)
            segs[g] = bundles[0].renditions[rungs[0].name].payload
        except Exception as exc:  # noqa: BLE001 - counted, run goes on
            failed += gop
            segs[g] = None
            print(f"tvbench: GOP {g} failed: {type(exc).__name__}: {exc}",
                  file=sys.stderr, flush=True)
            continue
        t1 = t_close = time.time()
        spans.append(("live_encode_batch", t0, t1))
        enc_s.append(t1 - t0)
        lat.extend((t1 - (t_open + i / rate)) * 1e3
                   for i in range(g * gop, g * gop + gop))
        if dev is not None and g == last:
            dev.stop()
    snap1 = stage_snapshot()
    ctx.close_window()
    if dev is not None and dev.open:
        dev.stop()
    enc.stages.set_tracer(None)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device != "cpu" else 0)
    close = getattr(enc, "close", None)
    if close is not None:
        close()
    del enc

    rec = {
        "attempted": n_gops * gop, "failed": failed,
        "frames": n_gops * gop, "latencies_ms": lat,
        "window_s": t_close - t_open,
        "stage_delta": {k: snap1[k] - snap0.get(k, 0) for k in snap1},
        "memory_peak_bytes": peak, "shapes": cfg["kernel_shapes"],
        "info": {"gops": n_gops, "rate_fps": rate,
                 "start_lag_max_ms": 1e3 * max(lag) if lag else None,
                 "gop_period_ms": 1e3 * gop / rate,
                 "gop_encode_ms_quartiles": [
                     1e3 * q for q in statistics.quantiles(enc_s, n=4)]
                 if len(enc_s) > 1 else None},
    }
    if dev is not None and dev.done:
        rec["trace"] = devtrace.reduce(dev, spans)
        rec["breakdown"] = rec["trace"]["breakdown"]
        rec["info"]["trace_start_s"] = rec["trace"]["start_s"]
    t_check = time.time()
    rec["checks"] = check(ctx, scene, segs, gop)
    rec["check_s"] = time.time() - t_check
    return rec


def check(ctx, scene, segs, gop) -> dict:
    """Every GOP came back whole, each picture in the configuration's
    slices; GOPs drawn from the seed hold the reference's levels at the
    configured QP, every picture of each."""
    qp = int(ctx.config["settings"]["qp"])
    slices = int(ctx.config["slices_per_picture"])
    missing = errors = bad = qp_off = 0
    for g, payload in segs.items():
        if payload is None:
            missing += gop
            continue
        try:
            pictures = h264.picture_slices(payload)
        except (ValueError, IndexError) as exc:
            errors += 1
            missing += gop
            print(f"tvbench: GOP {g}: {exc}", file=sys.stderr, flush=True)
            continue
        missing += max(0, gop - sum(c == slices for c in pictures))
        errors += len(pictures) > gop
    rng = np.random.default_rng([ctx.seed, 1])
    ok = [g for g, p in segs.items() if p is not None]
    picks = sorted(rng.permutation(len(ok))[:int(ctx.traffic["check_gops"])])
    tasks = [{"stream": segs[ok[i]], "first": 0, "count": gop,
              "scene": scene.seed, "width": scene.width,
              "height": scene.height, "offset": ok[i] * gop, "qp": qp}
             for i in picks]
    for r in checkpool.run(tasks):
        bad += r["mismatched_levels"]
        qp_off += r["qp_off"]
        errors += len(r["errors"]) + (r["checked"] != gop and not r["errors"])
    return {"frames_missing": {"value": missing, "limit": 0},
            "stream_errors": {"value": errors, "limit": 0},
            "slices_off_qp": {"value": qp_off, "limit": 0},
            "level_mismatches": {"value": bad, "limit": 0}}
