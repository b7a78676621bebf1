"""The host critical path's spans on the card, and what tracing costs.

    python3 scripts/host_trace_point.py [--jobs 16] [--gops 40] [--seed N]
        [--out FILE]

Run from the repository root on a machine with a CUDA card. Two parts,
each in this one process, so that what is compared shares a process:

- films: tvbench's tx1080-films configuration (a seeded 448-frame 1080p
  y4m, written once) transcoded job after job through
  `Coordinator.add_job` and a synchronous `LocalExecutor`, alternating
  `trace_sample` 1 and 0 in the order 1, 0, 0, 1, ... For each traced
  job it takes the job's trace and measures how much of the job
  thread's run the job layer, `await_staged`, `wave_dispatch` and
  `wave_collect` spans cover.
- live: tvbench's sfe2160-live configuration (the split-frame live edge
  at 4K, GOPs of 8), GOPs encoded back to back through
  `live_encode_batch`, alternating a trace-store recorder bound and none
  (bound, none, none, bound, ...). For each bound GOP it measures how
  much of the calling thread's `live_encode_batch` the `await_staged`,
  `dispatch` and `await_collect` spans cover.

Both parts also hold the bytes to tracing: every films job's MP4 (one
source) must be the same, traced or not, and the last GOP, encoded again
with the recorder bound and without, must give the same segment.

Prints one JSON object (medians and quartiles of the job and GOP walls
with tracing on and off, the coverage shares, the spans a traced job
keeps), and with `--out` writes it to FILE too.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tvbench import harness  # noqa: E402
from tvbench.content import Scene  # noqa: E402

#: where the encoders run
DEVICE = "cuda"
#: the spans that, on the job thread, should cover a transcode job's run
JOB_THREAD = ("job_open", "encoder_build", "stitch", "mux", "commit",
              "await_staged", "wave_dispatch", "wave_collect")
#: the spans that, on the live edge's thread, should cover an encode
LIVE_THREAD = ("await_staged", "dispatch", "await_collect")


def covered(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the union of `intervals` covers."""
    total, cur = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e > cur:
            total += e - max(s, cur)
            cur = e
    return total


def share(spans, names, thread: str, lo: float, hi: float) -> float:
    ivals = [(s["t0"], s["t0"] + s["dur_s"]) for s in spans
             if s["name"] in names and s["thread"] == thread]
    return covered(ivals, lo, hi) / (hi - lo)


def summary(values) -> dict:
    values = list(values)
    q = statistics.quantiles(values, n=4) if len(values) > 1 else values * 3
    return {"n": len(values), "median": statistics.median(values),
            "q1": q[0], "q3": q[2], "min": min(values), "max": max(values)}


def order(k: int) -> bool:
    """Traced or not for the k-th of an alternating run: on, off, off,
    on, ... (each pair in both orders)."""
    return k % 4 in (0, 3)


def set_sample(value: float) -> None:
    from thinvids_tpu_torch.core.config import get_settings

    os.environ["TVT_TRACE_SAMPLE"] = str(value)
    get_settings(refresh=True)


def films(seed: int, jobs: int) -> dict:
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, "tx1080-films")
    harness.set_environment(spec["config"])
    from thinvids_tpu_torch.cluster.coordinator import (Coordinator,
                                                        WorkerRegistry)
    from thinvids_tpu_torch.cluster.executor import LocalExecutor
    from thinvids_tpu_torch.cluster.jobs import Status
    from thinvids_tpu_torch.core.types import VideoMeta
    from thinvids_tpu_torch.obs import trace as obs_trace

    cfg, mix = spec["config"], spec["traffic"]
    w, h, n, fps = cfg["width"], cfg["height"], int(mix["frames"]), \
        int(mix["fps"])
    work = Path(tempfile.mkdtemp(prefix="host-trace-films-"))
    clip = work / "clip.y4m"
    harness.generator("jobs")._write_y4m(clip, Scene([seed, 0], w, h), n,
                                         fps)
    set_sample(1.0)
    registry = WorkerRegistry()
    coord = Coordinator(registry=registry)
    execu = LocalExecutor(coord, str(work / "out"), sync=True, device=DEVICE)
    run = {}

    def launch(job):
        run["thread"] = threading.current_thread().name
        run["t0"] = time.time()
        execu.launch(job)
        run["t1"] = time.time()

    coord._launcher = launch
    meta = VideoMeta(width=w, height=h, fps_num=fps, fps_den=1, num_frames=n)
    out = {"on": [], "off": [], "cpu_on": [], "cpu_off": [], "cover": [],
           "spans_a_job": [], "job_layer_ms": []}
    digests = set()
    for k in range(-1, jobs):
        traced = k < 0 or order(k)
        set_sample(1.0 if traced else 0.0)
        link = work / f"job{k + 1:04d}.y4m"
        os.symlink(clip.name, link)
        registry.heartbeat(execu.host, metrics={"devices": 1})
        cpu0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.time()
        job = coord.add_job(str(link), meta)
        t1 = time.time()
        cpu1 = resource.getrusage(resource.RUSAGE_SELF)
        job = coord.store.get(job.id)
        if job.status is not Status.DONE:
            raise RuntimeError(f"job failed: {job.failure_reason}")
        with open(job.output_path, "rb") as fp:
            digests.add(hashlib.sha256(fp.read()).hexdigest())
        os.unlink(job.output_path)
        if k < 0:
            continue                    # the warm-up job
        cpu = (cpu1.ru_utime + cpu1.ru_stime) - (cpu0.ru_utime
                                                  + cpu0.ru_stime)
        out["on" if traced else "off"].append(t1 - t0)
        out["cpu_on" if traced else "cpu_off"].append(cpu)
        snap = obs_trace.TRACE.snapshot(job.id)
        if traced:
            spans = snap["spans"]
            out["cover"].append(share(spans, JOB_THREAD, run["thread"],
                                      run["t0"], run["t1"]))
            out["spans_a_job"].append(len(spans))
            out["job_layer_ms"].append(1e3 * sum(
                s["dur_s"] for s in spans if s["name"] in JOB_THREAD[:5]))
        else:
            assert not snap["sampled"] and not snap["spans"]
    set_sample(1.0)
    if len(digests) != 1:
        raise RuntimeError(f"the jobs' MP4s differ: {len(digests)} digests")
    res = {k: summary(v) for k, v in out.items() if v}
    res["frames_a_job"] = n
    res["same_bytes"] = True
    res["fps_on_over_off"] = (statistics.median(out["off"])
                              / statistics.median(out["on"]))
    return res


def live(seed: int, gops: int) -> dict:
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, "sfe2160-live")
    harness.set_environment(spec["config"])
    from thinvids_tpu_torch.abr.ladder import plan_ladder
    from thinvids_tpu_torch.cluster.executor import (live_encode_batch,
                                                     live_encoder,
                                                     warm_live_shapes)
    from thinvids_tpu_torch.core.config import get_settings
    from thinvids_tpu_torch.core.types import VideoMeta
    from thinvids_tpu_torch.obs import trace as obs_trace

    cfg = spec["config"]
    w, h = cfg["width"], cfg["height"]
    gop = int(cfg["settings"]["gop_frames"])
    settings = get_settings(refresh=True)
    meta = VideoMeta(width=w, height=h, fps_num=int(cfg["frame_rate"]),
                     fps_den=1)
    rungs = plan_ladder(meta, settings)
    enc, sfe = live_encoder(meta, settings, rungs, device=DEVICE)
    assert sfe
    frames = harness.generator("live")._Frames(Scene([seed, 0], w, h))
    warm_live_shapes(enc, meta, gop)
    live_encode_batch(enc, rungs, frames, 1 << 20, 0, gop, gop, True)
    thread = threading.current_thread().name
    out = {"on": [], "off": [], "cover": [], "spans_a_gop": []}
    for g in range(gops):
        traced = order(g)
        if traced:
            obs_trace.TRACE.start("live-edge")
            enc.stages.set_tracer(obs_trace.TRACE.recorder("live-edge"))
        t0 = time.time()
        live_encode_batch(enc, rungs, frames, g * gop, g, gop, gop, True)
        t1 = time.time()
        enc.stages.set_tracer(None)
        out["on" if traced else "off"].append(t1 - t0)
        if traced:
            spans = obs_trace.TRACE.snapshot("live-edge")["spans"]
            obs_trace.TRACE.drop("live-edge")
            out["cover"].append(share(spans, LIVE_THREAD, thread, t0, t1))
            out["spans_a_gop"].append(len(spans))
    payloads = []
    for traced in (True, False):
        if traced:
            obs_trace.TRACE.start("live-edge")
            enc.stages.set_tracer(obs_trace.TRACE.recorder("live-edge"))
        bundles = live_encode_batch(enc, rungs, frames, (gops - 1) * gop,
                                    gops - 1, gop, gop, True)
        enc.stages.set_tracer(None)
        obs_trace.TRACE.drop("live-edge")
        payloads.append(bundles[0].renditions[rungs[0].name].payload)
    if payloads[0] != payloads[1]:
        raise RuntimeError("a GOP's segment differs with a recorder bound")
    res = {k: summary(v) for k, v in out.items() if v}
    res["gop_on_over_off"] = (statistics.median(out["on"])
                              / statistics.median(out["off"]))
    res["same_bytes"] = True
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--gops", type=int, default=40)
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("host_trace_point: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"card": card, "seed": args.seed,
           "films": films(args.seed, args.jobs),
           "live": live(args.seed, args.gops)}
    text = json.dumps(res)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
