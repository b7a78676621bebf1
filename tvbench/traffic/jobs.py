"""Closed-loop transcode jobs: the farm's file path, end to end.

Set-up writes the mix's clips (y4m, made from the seed) once, then runs
one job to warm every shape. In the window the generator submits a job the
moment the previous one finished, round robin over the clips, each
through `Coordinator.add_job` and a synchronous `LocalExecutor` to an
MP4, as a farm node drains its backlog. The job in flight when the window
ends runs to completion and counts.

Another generator may call `run(ctx, mesh=...)` to run the same jobs on a
device mesh (`LocalExecutor(mesh=...)`, the path `cli worker --devices`
builds); the memory peak is then the fullest card's.

Mix parameters: `frames` a clip, `clips` distinct clips, `fps`,
`trace_first` and `trace_jobs` (which jobs the traced run's device trace
covers), `check_gops` (how many GOPs, drawn from the seed, the reference
follows whole, from the IDR picture to the last).
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np

from tvbench import checkpool, devtrace
from tvbench.content import Scene
from tvbench.reference import h264, mp4


def _write_y4m(path, scene: Scene, n: int, fps: int) -> None:
    with open(path, "wb") as fp:
        fp.write(f"YUV4MPEG2 W{scene.width} H{scene.height} F{fps}:1 Ip "
                 f"A1:1 C420jpeg\n".encode())
        for i in range(n):
            fp.write(b"FRAME\n")
            for plane in scene.planes(i):
                fp.write(np.ascontiguousarray(plane).tobytes())
        # on disk before the window opens: a write-back of the clip
        # inside the window would take the host from the jobs
        fp.flush()
        os.fsync(fp.fileno())


def _quartiles(values):
    return statistics.quantiles(values, n=4) if len(values) > 1 else values


def run(ctx, mesh=None) -> dict:
    import torch

    from thinvids_tpu_torch.cluster.coordinator import (Coordinator,
                                                        WorkerRegistry)
    from thinvids_tpu_torch.cluster.executor import LocalExecutor
    from thinvids_tpu_torch.cluster.jobs import Status
    from thinvids_tpu_torch.core.types import VideoMeta
    from thinvids_tpu_torch.obs import trace as obs_trace
    from thinvids_tpu_torch.parallel.dispatch import stage_snapshot

    cfg, mix = ctx.config, ctx.traffic
    w, h, n = cfg["width"], cfg["height"], int(mix["frames"])
    gop = int(cfg["settings"]["gop_frames"])
    fps = int(mix["fps"])
    src_dir, out_dir = ctx.workdir / "in", ctx.workdir / "out"
    src_dir.mkdir(parents=True)
    scenes, clips = [], []
    for c in range(int(mix["clips"])):
        scene = Scene([ctx.seed, c], w, h)
        path = src_dir / f"clip{c}.y4m"
        _write_y4m(path, scene, n, fps)
        scenes.append(scene)
        clips.append(path)

    registry = WorkerRegistry()
    coord = Coordinator(registry=registry)
    execu = LocalExecutor(coord, str(out_dir), mesh=mesh, sync=True,
                          device=ctx.device)
    cards = [ctx.device] if mesh is None else \
        sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
    coord._launcher = execu.launch
    meta = VideoMeta(width=w, height=h, fps_num=fps, fps_den=1,
                     num_frames=n)

    def submit(k: int):
        """Job k on clip k mod clips, under a name of its own (a link to
        the clip), so that every job leaves its own MP4."""
        link = src_dir / f"job{k:05d}-clip{k % len(clips)}.y4m"
        os.symlink(clips[k % len(clips)].name, link)
        registry.heartbeat(execu.host, metrics={
            "devices": 1 if mesh is None else mesh.size})
        t0 = time.time()
        job = coord.add_job(str(link), meta)
        t1 = time.time()
        job = coord.store.get(job.id)
        return {"k": k, "clip": k % len(clips), "id": job.id, "t0": t0,
                "t1": t1, "ok": job.status is Status.DONE,
                "out": job.output_path, "why": job.failure_reason}

    warm = submit(-1)
    if not warm["ok"]:
        raise RuntimeError(f"warm-up job failed: {warm['why']}")

    if ctx.trace:
        devtrace.DeviceTrace.warm()
    trace_first = int(mix["trace_first"])
    trace_last = trace_first + int(mix["trace_jobs"]) - 1
    dev = devtrace.DeviceTrace() if ctx.trace else None
    jobs, spans = [], []
    t_open = ctx.open_window()
    snap0 = stage_snapshot()
    k = 0
    while time.time() - t_open < ctx.seconds:
        if dev is not None and k == trace_first:
            dev.start()
        job = submit(k)
        if dev is not None and trace_first <= k <= trace_last:
            snap = obs_trace.TRACE.snapshot(job["id"]) or {"spans": []}
            job["spans"] = [(s["name"], s["t0"], s["t0"] + s["dur_s"])
                            for s in snap["spans"]]
            spans.append(("job", job["t0"], job["t1"]))
            spans.extend(job["spans"])
            if k == trace_last:
                dev.stop()
        jobs.append(job)
        k += 1
    t_close = jobs[-1]["t1"]
    snap1 = stage_snapshot()
    ctx.close_window()
    if dev is not None and dev.open:
        dev.stop()              # the window ended inside the traced jobs
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards) \
        if ctx.device != "cpu" and cards else 0

    done = [j for j in jobs if j["ok"]]
    rec = {
        "attempted": len(jobs), "failed": len(jobs) - len(done),
        "frames": n * len(jobs), "frames_done": n * len(done),
        "window_s": t_close - t_open,
        "stage_delta": {k: snap1[k] - snap0.get(k, 0) for k in snap1},
        "jobs": jobs, "memory_peak_bytes": peak,
        "shapes": cfg["kernel_shapes"],
        "info": {"jobs": len(jobs), "clip_frames": n,
                 "job_s_quartiles": _quartiles(
                     [j["t1"] - j["t0"] for j in jobs])},
    }
    if dev is not None and dev.done:
        rec["trace"] = devtrace.reduce(dev, spans)
        rec["breakdown"] = rec["trace"]["breakdown"]
        rec["info"]["trace_start_s"] = rec["trace"]["start_s"]
    t_check = time.time()
    rec["checks"] = check(ctx, jobs, scenes, n, gop)
    rec["check_s"] = time.time() - t_check
    return rec


def check(ctx, jobs, scenes, n, gop) -> dict:
    """Every job's MP4 holds its clip's frames, each picture whole (the
    configuration's slices a picture); GOPs drawn from the seed hold the
    reference's levels at the configured QP, every picture of each."""
    qp = int(ctx.config["settings"]["qp"])
    slices = int(ctx.config["slices_per_picture"])
    missing = errors = bad = qp_off = 0
    streams = {}
    for j in jobs:
        if not j["ok"]:
            missing += n
            continue
        try:
            with open(j["out"], "rb") as fp:
                stream, samples = mp4.video_annexb(fp.read())
            pictures = h264.picture_slices(stream)
        except (OSError, ValueError, IndexError) as exc:
            missing += n
            errors += 1
            j["why"] = f"{type(exc).__name__}: {exc}"
            continue
        missing += max(0, n - sum(c == slices for c in pictures))
        errors += samples != len(pictures) or len(pictures) > n
        streams[j["k"]] = stream
    rng = np.random.default_rng([ctx.seed, 1])
    pool = [(k, g) for k in sorted(streams) for g in range(-(-n // gop))]
    picks = sorted(rng.permutation(len(pool))[:int(ctx.traffic["check_gops"])])
    tasks = []
    for i in picks:
        k, g = pool[i]
        scene = scenes[k % len(scenes)]
        tasks.append({"stream": streams[k], "first": g * gop,
                      "count": min(gop, n - g * gop), "scene": scene.seed,
                      "width": scene.width, "height": scene.height,
                      "offset": 0, "qp": qp})
    for task, r in zip(tasks, checkpool.run(tasks)):
        bad += r["mismatched_levels"]
        qp_off += r["qp_off"]
        errors += len(r["errors"]) + (r["checked"] != task["count"]
                                      and not r["errors"])
    for j in jobs:
        if j.get("out") and os.path.exists(j["out"]):
            os.unlink(j["out"])
    return {"frames_missing": {"value": missing, "limit": 0},
            "stream_errors": {"value": errors, "limit": 0},
            "slices_off_qp": {"value": qp_off, "limit": 0},
            "level_mismatches": {"value": bad, "limit": 0}}
