"""The port's host critical path in its stage profile and job trace.

- a stage keeps the CPU time of its thread beside its wall time
  (`cpu.<stage>`): a busy loop reads about its wall, a sleep about 0;
- the thread that drives the card records its waits: `await_staged` for
  each staged wave, `await_collect` for each collected one, in
  `encode()` and in a job's wave loop;
- each slice's pack on the pack pool is a `cavlc` stage;
- the split-frame walk's steps are stages of their own, once a frame,
  inside `dispatch`;
- a job's open, encoder construction, stitch, mux and commit are spans
  of its trace, in order, and with the waits and the wave spans they
  cover the job thread's run;
- `host_syncs` counts every blocking device→host point of a wave and of
  a split-frame GOP;
- the bytes are the same with a tracer bound or not.
"""

import time

import numpy as np
import pytest
import torch

from thinvids_tpu_torch.cluster import Coordinator, WorkerRegistry
from thinvids_tpu_torch.cluster.executor import LocalExecutor
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.status import Status
from thinvids_tpu_torch.core.types import Frame, VideoMeta, concat_segments
from thinvids_tpu_torch.io.y4m import write_y4m
from thinvids_tpu_torch.obs import trace as ttrace
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

#: the job layer's spans, in the order a transcode job records them
JOB_LAYER = ("job_open", "encoder_build", "stitch", "mux", "commit")


def _clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (128 + 50 * np.sin((xx + 2 * i) * 0.1) * np.cos((yy + i) * 0.08)
             + rng.normal(0, 1.0, (h, w)))
        c = 128 + 30 * np.sin(xx[::2, ::2] * 0.06 + i * 0.1)
        out.append(Frame(np.clip(y, 0, 255).astype(np.uint8),
                         np.clip(c, 0, 255).astype(np.uint8),
                         np.clip(255 - c, 0, 255).astype(np.uint8)))
    return out


def _traced(job, enc, encode):
    """(result, spans) of `encode()` with a job trace bound to `enc`."""
    ttrace.TRACE.start(job)
    enc.stages.set_tracer(ttrace.TRACE.recorder(job))
    try:
        out = encode()
    finally:
        enc.stages.set_tracer(None)
    spans = ttrace.TRACE.snapshot(job)["spans"]
    ttrace.TRACE.drop(job)
    return out, spans


def _covered(intervals, lo, hi):
    """Seconds of [lo, hi] that the union of `intervals` covers."""
    total, cur = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e > cur:
            total += e - max(s, cur)
            cur = e
    return total


# ---- CPU time beside wall time ---------------------------------------------------

@pytest.mark.parametrize("work, cpu_share", [("spin", (0.6, 1.05)),
                                             ("sleep", (0.0, 0.2))])
def test_a_stage_keeps_its_threads_cpu_time_beside_its_wall(work, cpu_share):
    prof = tdispatch.StageProfile()
    with prof.stage("pack"):
        t_end = time.perf_counter() + 0.2
        if work == "spin":
            while time.perf_counter() < t_end:
                pass
        else:
            time.sleep(0.2)
    snap = prof.snapshot()
    assert snap["pack"] >= 190.0
    lo, hi = cpu_share
    assert lo * snap["pack"] <= snap["cpu.pack"] <= hi * snap["pack"]
    # every key a number, every stage with its CPU key, and reset clears
    assert all(isinstance(v, (int, float)) for v in snap.values())
    assert {f"cpu.{k}" for k in tdispatch.STAGE_NAMES} <= set(snap)
    prof.reset()
    assert prof.snapshot()["cpu.pack"] == 0.0


def test_the_process_totals_carry_the_cpu_time():
    before = tdispatch.stage_snapshot()
    prof = tdispatch.StageProfile(mirror=tdispatch._TOTALS)
    with prof.stage("cavlc"):
        t_end = time.perf_counter() + 0.05
        while time.perf_counter() < t_end:
            pass
    after = tdispatch.stage_snapshot()
    assert after["cpu.cavlc"] - before["cpu.cavlc"] >= \
        0.5 * prof.snapshot()["cpu.cavlc"] > 0


# ---- the driving thread's waits ------------------------------------------------

def test_encode_records_its_waits_for_staging_and_collect():
    w, h, n = 64, 48, 16
    frames = _clip(n, w, h, seed=1)
    enc = tdispatch.GopShardEncoder(VideoMeta(width=w, height=h,
                                              num_frames=n),
                                    qp=30, gop_frames=2, device="cpu")
    _, spans = _traced("host-waits", enc, lambda: enc.encode(frames))
    # 8 GOPs, 4 a wave: two waves, and the pull that finds the end
    assert [s["tags"]["wave"] for s in spans
            if s["name"] == "await_staged"] == [0, 1, 2]
    assert [s["tags"]["wave"] for s in spans
            if s["name"] == "await_collect"] == [0, 1]
    snap = enc.stages.snapshot()
    assert snap["await_staged"] > 0 and snap["await_collect"] > 0
    # each slice packs as one cavlc stage on the pack pool
    cavlc = [s for s in spans if s["name"] == "cavlc"]
    assert len(cavlc) == n
    assert {s["thread"] for s in cavlc} != {"MainThread"}
    assert snap["cpu.cavlc"] > 0


def test_inline_packing_times_each_slice_too():
    w, h, n = 64, 48, 4
    enc = tdispatch.GopShardEncoder(VideoMeta(width=w, height=h,
                                              num_frames=n),
                                    qp=30, gop_frames=2, pack_workers=1,
                                    device="cpu")
    assert enc._slice_pool() is None
    _, spans = _traced("host-inline", enc,
                       lambda: enc.encode(_clip(n, w, h, seed=2)))
    assert sum(s["name"] == "cavlc" for s in spans) == n


# ---- the split-frame walk -------------------------------------------------------

def test_the_walk_steps_come_once_a_frame_inside_dispatch():
    w, h, n, gop = 64, 96, 8, 4
    enc = tdispatch.SfeShardEncoder(VideoMeta(width=w, height=h,
                                              num_frames=n),
                                    qp=30, gop_frames=gop, bands=2,
                                    device="cpu")
    _, spans = _traced("host-walk", enc,
                       lambda: enc.encode(_clip(n, w, h, seed=3)))
    frames = {name: [s["tags"]["frame"] for s in spans if s["name"] == name]
              for name in ("walk_intra", "walk_probe", "walk_p",
                           "walk_link")}
    assert frames["walk_intra"] == [0, 0]
    for name in ("walk_probe", "walk_p", "walk_link"):
        assert frames[name] == [1, 2, 3] * 2, name
    dispatch = [(s["t0"], s["t0"] + s["dur_s"]) for s in spans
                if s["name"] == "dispatch"]
    assert len(dispatch) == n // gop
    slack = 1e-3
    for s in spans:
        if s["name"].startswith("walk_"):
            assert any(a - slack <= s["t0"] and s["t0"] + s["dur_s"]
                       <= b + slack for a, b in dispatch), s
    snap = enc.stages.snapshot()
    steps = sum(snap[k] for k in ("walk_intra", "walk_probe", "walk_p",
                                  "walk_link"))
    assert 0 < steps <= snap["dispatch"] + 1.0


# ---- host syncs -------------------------------------------------------------------

@pytest.fixture
def counted_syncs(monkeypatch):
    """{"to_host": calls, "events": events waited on} of the module's
    two blocking helpers, counted as they are called."""
    calls = {"to_host": 0, "events": 0}
    to_host, wait = tdispatch._to_host, tdispatch._wait

    def counting_to_host(t, prof):
        calls["to_host"] += 1
        return to_host(t, prof)

    def counting_wait(events, prof):
        evs = events if isinstance(events, list) else [events]
        calls["events"] += sum(ev is not None for ev in evs)
        return wait(events, prof)

    monkeypatch.setattr(tdispatch, "_to_host", counting_to_host)
    monkeypatch.setattr(tdispatch, "_wait", counting_wait)
    return calls


def test_host_syncs_count_a_waves_blocking_points(counted_syncs):
    w, h, n = 64, 48, 8
    enc = tdispatch.GopShardEncoder(VideoMeta(width=w, height=h,
                                              num_frames=n),
                                    qp=30, gop_frames=2, device="cpu")
    enc.encode(_clip(n, w, h, seed=4))
    snap = enc.stages.snapshot()
    assert snap["waves"] == 1
    # the tiny counts (4), the mv and DC prefix (2), the payload (1)
    assert snap["host_syncs"] == counted_syncs["to_host"] == 7


def test_host_syncs_count_an_sfe_gops_blocking_points(counted_syncs):
    w, h, n = 64, 96, 4
    enc = tdispatch.SfeShardEncoder(VideoMeta(width=w, height=h,
                                              num_frames=n),
                                    qp=30, gop_frames=n, bands=2,
                                    device="cpu")
    enc.encode(_clip(n, w, h, seed=5))
    snap = enc.stages.snapshot()
    assert snap["waves"] == 1
    # a frame: its tiny counts (4), its dense head (1), its payloads (1)
    assert snap["host_syncs"] == counted_syncs["to_host"] == 6 * n


def test_wait_counts_each_event_it_synchronizes():
    class Event:
        def __init__(self):
            self.waited = 0

        def synchronize(self):
            self.waited += 1

    prof = tdispatch.StageProfile()
    evs = [Event(), None, Event()]
    tdispatch._wait(evs, prof)
    tdispatch._wait(None, prof)
    tdispatch._wait(evs[0], prof)
    assert prof.snapshot()["host_syncs"] == 3
    assert [e.waited for e in evs if e is not None] == [2, 1]


# ---- bytes with tracing bound or not -----------------------------------------

@pytest.mark.parametrize("shape", ["waves", "sfe"])
def test_bytes_are_the_same_with_a_tracer_bound(shape):
    w, h, n = 64, 96, 6
    meta = VideoMeta(width=w, height=h, num_frames=n)
    frames = _clip(n, w, h, seed=6)
    if shape == "waves":
        enc = tdispatch.GopShardEncoder(meta, qp=30, gop_frames=3,
                                        device="cpu")
    else:
        enc = tdispatch.SfeShardEncoder(meta, qp=30, gop_frames=3, bands=2,
                                        device="cpu")
    plain = concat_segments(enc.encode(frames))
    traced, spans = _traced(f"host-bytes-{shape}", enc,
                            lambda: concat_segments(enc.encode(frames)))
    assert spans and traced == plain
    assert concat_segments(enc.encode(frames)) == plain


# ---- the job layer ------------------------------------------------------------------

def _job(tmp_path, n=32, w=64, h=48):
    """(job, its spans, the run's [t0, t1]) of one CPU transcode job."""
    frames = _clip(n, w, h, seed=7)
    meta = VideoMeta(width=w, height=h, fps_num=30, num_frames=n)
    src = tmp_path / "clip.y4m"
    write_y4m(src, meta, frames)
    snap = tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, gop_frames=4,
                                     qp=30, heartbeat_throttle_s=0.0,
                                     min_idle_workers=0))
    reg = WorkerRegistry()
    coord = Coordinator(registry=reg, settings_fn=lambda: snap)
    execu = LocalExecutor(coord, output_dir=str(tmp_path / "out"),
                          sync=True, device="cpu")
    reg.heartbeat(execu.host, metrics={"devices": 1})
    run = {}

    def launch(job):
        run["t0"] = time.time()
        execu.launch(job)
        run["t1"] = time.time()

    coord._launcher = launch
    job = coord.add_job(str(src), meta)
    job = coord.store.get(job.id)
    assert job.status is Status.DONE, job.failure_reason
    spans = ttrace.TRACE.snapshot(job.id)["spans"]
    return job, spans, (run["t0"], run["t1"])


def test_a_jobs_layer_spans_come_in_order_and_cover_its_thread(tmp_path):
    job, spans, (t0, t1) = _job(tmp_path)
    layer = [s for s in spans if s["name"] in JOB_LAYER]
    assert [s["name"] for s in layer] == list(JOB_LAYER)
    assert all(t0 <= s["t0"] and s["t0"] + s["dur_s"] <= t1 for s in layer)
    assert all(a["t0"] + a["dur_s"] <= b["t0"]
               for a, b in zip(layer, layer[1:]))
    # the wave loop's waits for staging, in the encoder's profile too
    waits = [s for s in spans if s["name"] == "await_staged"]
    assert [s["tags"]["wave"] for s in waits] == [0, 1, 2]
    thread = layer[0]["thread"]
    assert all(s["thread"] == thread for s in layer + waits)
    # on the job's thread, the job layer, the waits for staging and the
    # wave spans cover the run
    cover = [(s["t0"], s["t0"] + s["dur_s"]) for s in spans
             if s["thread"] == thread and s["name"] in
             JOB_LAYER + ("await_staged", "wave_dispatch", "wave_collect")]
    assert _covered(cover, t0, t1) >= 0.9 * (t1 - t0)


def test_a_sampled_out_job_records_no_job_layer_span(tmp_path,
                                                     monkeypatch):
    # the trace store samples from the process settings
    monkeypatch.setenv("TVT_TRACE_SAMPLE", "0")
    tcfg.get_settings(refresh=True)
    try:
        job, spans, _ = _job(tmp_path, n=8)
    finally:
        monkeypatch.delenv("TVT_TRACE_SAMPLE")
        tcfg.get_settings(refresh=True)
    assert spans == []
    assert ttrace.TRACE.snapshot(job.id)["sampled"] is False
