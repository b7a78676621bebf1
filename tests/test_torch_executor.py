"""The port's own job executor: a job run by the port's Coordinator and
LocalExecutor (on the CPU; no class of the JAX package in the run)
writes what the JAX package's Coordinator and LocalExecutor write from
the same file.

- transcode jobs, RD off, every RD feature on (RD_ALL, from the process
  settings snapshot, where both packages' encoders read it) and
  split-frame with `sfe_bands=3`: the same MP4;
- a vbr2pass job: the same MP4; a ladder job: the same HLS tree (on a
  clip whose scaled planes equal the JAX package's, asserted first); a
  live job on a growing source: the same live tree;
- an injected wave failure is retried to the same bytes, and
  `parts_retried` moves as the reference's does; an exhausted retry
  budget fails the job with attribution (one card has nothing to
  re-plan on); a stopped job halts between waves;
- `profile_dir` writes a torch.profiler Chrome trace of the job;
- without a card the executor refuses the default device, and a mesh
  that is not a DeviceMesh is refused.
"""

import contextlib
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from thinvids_tpu import cluster as jcluster
from thinvids_tpu.abr.scale import PlaneScaler as JScaler
from thinvids_tpu.cluster import executor as jexecutor
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.status import Status as JStatus
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.ingest import tail as jtail
from thinvids_tpu.io.y4m import Y4MWriter, write_y4m
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch import cluster as tcluster
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.abr.scale import PlaneScaler as TScaler
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.status import Status as TStatus
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

#: package → (cluster package, executor module, config, VideoMeta, Status)
PKGS = {"jax": (jcluster, jexecutor, jcfg, JMeta, JStatus),
        "torch": (tcluster, texecutor, tcfg, TMeta, TStatus)}


def _smooth_clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (128 + 50 * np.sin((xx + 2 * i) * 0.1) * np.cos((yy + i) * 0.08)
             + rng.normal(0, 1.0, (h, w)))
        c = 128 + 30 * np.sin(xx[::2, ::2] * 0.06 + i * 0.1)
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    np.clip(c, 0, 255).astype(np.uint8),
                    np.clip(255 - c, 0, 255).astype(np.uint8)))
    return out


def _write_clip(path, clip, w, h):
    write_y4m(path, JMeta(width=w, height=h, fps_num=30,
                          num_frames=len(clip)),
              [JFrame(*f) for f in clip])
    return str(path)


def _one_device_mesh():
    return jdispatch.default_mesh(jax.devices()[:1])


def _rig(pkg, tmp_path, name, over=None, **executor_kw):
    """(coordinator, executor) of one package over a fixed settings
    snapshot: the port's executor on the CPU, the reference's on one
    device unless `executor_kw` says otherwise."""
    cluster, executor, cfg, _meta, _status = PKGS[pkg]
    snap = cfg.Settings(values=dict(cfg.DEFAULT_SETTINGS, gop_frames=4,
                                    qp=30, heartbeat_throttle_s=0.0,
                                    **(over or {})))
    reg = cluster.WorkerRegistry()
    for i in range(8):
        reg.heartbeat(f"w{i:02d}")
    coord = cluster.Coordinator(registry=reg, settings_fn=lambda: snap)
    if pkg == "torch":
        executor_kw.setdefault("device", "cpu")
    else:
        executor_kw.setdefault("mesh", _one_device_mesh())
    execu = executor.LocalExecutor(coord, output_dir=str(tmp_path / name),
                                   sync=True, **executor_kw)
    coord._launcher = execu.launch
    return coord, execu


def _run(pkg, coord, path, w, h, n, want=None):
    _c, _e, _cfg, meta, status = PKGS[pkg]
    job = coord.add_job(path, meta(width=w, height=h, fps_num=30,
                                   num_frames=n))
    job = coord.store.get(job.id)
    assert job.status is (want or status.DONE), job.failure_reason
    return job


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = _read(full)
    return out


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want) and len(want) > 6
    for name in want:
        assert got[name] == want[name], name


@pytest.fixture
def built(monkeypatch):
    """Every encoder the port's executor builds through
    make_shard_encoder, in order."""
    out = []
    real = tdispatch.make_shard_encoder

    def spy(*args, **kw):
        enc = real(*args, **kw)
        out.append(enc)
        return enc

    monkeypatch.setattr(tdispatch, "make_shard_encoder", spy)
    return out


@contextlib.contextmanager
def _process_settings(monkeypatch, env: dict):
    """Both packages' process settings snapshots with `env` set."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tcfg.invalidate_settings_cache()
    jcfg.invalidate_settings_cache()
    try:
        yield
    finally:
        for k in env:
            monkeypatch.delenv(k)
        tcfg.invalidate_settings_cache()
        jcfg.invalidate_settings_cache()


_RD_ALL_ENV = {"TVT_MODE_DECISION": "1", "TVT_PSKIP": "1",
               "TVT_DEBLOCK": "1", "TVT_AQ_STRENGTH": "1.0"}


# ---- transcode jobs ---------------------------------------------------------------

@pytest.mark.parametrize("case,w,h,n", [("rd_off", 64, 48, 12),
                                        ("rd_all", 64, 48, 8),
                                        ("sfe_3_bands", 64, 96, 8)])
def test_port_job_writes_the_reference_mp4(tmp_path, monkeypatch, built,
                                           case, w, h, n):
    path = _write_clip(tmp_path / "clip.y4m",
                       _smooth_clip(n, w, h, seed=w + n), w, h)
    over, ref_kw = {}, {}
    env = _RD_ALL_ENV if case == "rd_all" else {}
    if case == "sfe_3_bands":
        # the reference puts one band on each device: three of them
        over["sfe_bands"] = 3
        ref_kw["mesh"] = None
    with _process_settings(monkeypatch, env):
        port = _run("torch", _rig("torch", tmp_path, "port", over)[0],
                    path, w, h, n)
        ref = _run("jax", _rig("jax", tmp_path, "ref", over, **ref_kw)[0],
                   path, w, h, n)
    (enc,) = built
    if case == "sfe_3_bands":
        assert type(enc) is tdispatch.SfeShardEncoder
        assert enc.num_bands == 3
    else:
        assert type(enc) is tdispatch.GopShardEncoder
        assert enc.rd == (trdo.RdConfig(mode_decision=True, pskip=True,
                                        deblock=True,
                                        aq_q=trdo.aq_from_strength(1.0))
                          if case == "rd_all" else trdo.RD_OFF)
    assert enc.device.type == "cpu"
    assert port.parts_done == port.parts_total == -(-n // 4)
    assert port.encode_progress == port.combine_progress == 100.0
    assert port.output_path == os.path.join(str(tmp_path / "port"),
                                            "clip.mp4")
    got = _read(port.output_path)
    assert got == _read(ref.output_path)
    assert port.output_bytes == len(got)


def test_port_vbr2pass_job_writes_the_reference_mp4(tmp_path, built):
    w, h, n = 64, 48, 16
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(n, w, h, seed=29),
                       w, h)
    over = dict(rc_mode="vbr2pass", target_bitrate_kbps=150.0)
    port = _run("torch", _rig("torch", tmp_path, "port", over)[0], path, w,
                h, n)
    ref = _run("jax", _rig("jax", tmp_path, "ref", over)[0], path, w, h, n)
    (enc,) = built
    # the solved per-GOP QPs moved off the base QP: the passes ran
    assert set(enc.gop_qp) == {0, 1, 2, 3}
    assert list(enc.gop_qp.values()) != [30] * 4
    assert port.parts_done == port.parts_total == ref.parts_total == 4
    assert _read(port.output_path) == _read(ref.output_path)


def test_port_ladder_job_writes_the_reference_tree(tmp_path, built):
    w, h, n = 64, 48, 16
    clip = _smooth_clip(n, w, h, seed=3)
    # precondition of a whole-ladder comparison: the port's scaled planes
    # equal the JAX package's on this clip (tests/test_torch_abr.py holds
    # the rungs given the same planes)
    padded = [TFrame(*f).padded(16) for f in clip]
    planes = [np.stack([getattr(f, p) for f in padded]) for p in "yuv"]
    for dw, dh in ((42, 32), (32, 24)):
        got = TScaler(w, h, dw, dh, device="cpu").scale_wave(
            *(torch.from_numpy(p) for p in planes))
        for g, j in zip(got, JScaler(w, h, dw, dh).scale_wave(*planes)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    path = _write_clip(tmp_path / "clip.ladder.y4m", clip, w, h)
    over = dict(segment_s=0.25, ladder_rungs="32,24")
    port = _run("torch", _rig("torch", tmp_path, "port", over)[0], path, w,
                h, n)
    ref = _run("jax", _rig("jax", tmp_path, "ref", over)[0], path, w, h, n)
    (enc,) = built
    assert type(enc) is tladder.LadderShardEncoder
    assert [r.name for r in enc.rungs] == ["48p", "32p", "24p"]
    assert port.job_type == "ladder"
    assert port.output_path.endswith("master.m3u8")
    assert port.parts_done == port.parts_total == ref.parts_total == 4
    tree = _tree(os.path.dirname(port.output_path))
    _assert_same_tree(tree, _tree(os.path.dirname(ref.output_path)))
    assert port.output_bytes == ref.output_bytes == \
        sum(len(v) for v in tree.values())


def _frame_records(w, h, clip):
    """(header bytes, [one y4m record per frame]) for incremental
    writes."""
    import io

    buf = io.BytesIO()
    writer = Y4MWriter(buf, JMeta(width=w, height=h, fps_num=30))
    header = buf.getvalue()
    records = []
    for planes in clip:
        buf.seek(0)
        buf.truncate()
        writer.write(JFrame(*planes))
        records.append(buf.getvalue())
    return header, records


def test_port_live_job_on_a_growing_source_writes_the_reference_tree(
        tmp_path, built):
    """The writer holds the stream open (two GOPs short of its end) until
    the port's job has published its master playlist, then finishes and
    drops `.eos`: the port's final tree equals the JAX executor's over
    the same file written in one go. (The 2-rung ladder of
    tests/test_torch_live.py, whose clip scales to the JAX package's
    planes.)"""
    w, h, n = 64, 48, 16
    clip = _smooth_clip(n, w, h, seed=27)
    header, recs = _frame_records(w, h, clip)
    over = dict(segment_s=0.25, ladder_rungs="24", live_stall_s=30.0)
    done = tmp_path / "done" / "cam.live.y4m"
    done.parent.mkdir()
    done.write_bytes(header + b"".join(recs))
    open(str(done) + jtail.EOS_SUFFIX, "wb").close()
    ref = _run("jax", _rig("jax", tmp_path, "ref", over)[0], str(done), w,
               h, n)

    coord, _ = _rig("torch", tmp_path, "port", over)
    path = str(tmp_path / "cam.live.y4m")
    held = []

    def published():
        return any(j.output_path for j in coord.store.list())

    def writer():
        with open(path, "wb") as out:
            out.write(header)
            out.flush()
            for i, rec in enumerate(recs):
                if i == n - 8:
                    deadline = time.monotonic() + 60.0
                    while not published() and time.monotonic() < deadline:
                        time.sleep(0.01)
                    held.append(published())
                out.write(rec)
                out.flush()
                time.sleep(0.005)
        open(path + jtail.EOS_SUFFIX, "wb").close()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        port = _run("torch", coord, path, w, h, n)
    finally:
        wt.join(90)
    assert held == [True], "the master was never published mid-stream"
    (enc,) = built
    assert type(enc) is tladder.LadderShardEncoder
    assert port.job_type == "live"
    assert port.parts_done == port.parts_total == ref.parts_total == 4
    _assert_same_tree(_tree(os.path.dirname(port.output_path)),
                      _tree(os.path.dirname(ref.output_path)))


# ---- faults, halts, traces ----------------------------------------------------------

class _Flaky:
    """Wraps an encoder; its first `fails` collects raise."""

    def __init__(self, inner, fails):
        self.inner, self.fails, self.collects = inner, fails, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def collect_wave(self, pending):
        self.collects += 1
        if self.fails > 0:
            self.fails -= 1
            raise RuntimeError("injected wave failure")
        return self.inner.collect_wave(pending)


def test_wave_failure_retries_to_the_same_bytes_as_the_reference(tmp_path):
    w, h, n = 64, 48, 12
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(n, w, h, seed=7),
                       w, h)
    over = dict(part_failure_max_retries=2)
    runs, executors = {}, {}
    for pkg in ("torch", "jax"):
        encs = []

        def factory(meta, settings, mesh, pkg=pkg, encs=encs):
            inner = (executors[pkg]._default_encoder(meta, settings, mesh)
                     if pkg == "torch" else
                     jexecutor.LocalExecutor._default_encoder(
                         meta, settings, _one_device_mesh()))
            encs.append(_Flaky(inner, fails=2))
            return encs[-1]

        coord, executors[pkg] = _rig(pkg, tmp_path, pkg, over,
                                     encoder_factory=factory)
        job = _run(pkg, coord, path, w, h, n)
        runs[pkg] = (job, encs[0], coord)
    clean = _run("torch", _rig("torch", tmp_path, "clean")[0], path, w, h, n)
    (tjob, tenc, tco), (jjob, jenc, _) = runs["torch"], runs["jax"]
    # one wave holds the 3 GOPs: 2 failures, then its collect
    assert tenc.collects == jenc.collects == 3
    # both executors count each retry as the wave's GOPs
    assert tjob.parts_retried == jjob.parts_retried == 2 * 3
    assert tjob.parts_done == tjob.parts_total == 3
    assert any("attempt 2 failed, retrying" in line
               for line in tco.activity.fetch_job(tjob.id))
    assert _read(tjob.output_path) == _read(jjob.output_path) == \
        _read(clean.output_path)


def test_exhausted_retry_budget_fails_with_attribution(tmp_path):
    class Dead(_Flaky):
        def collect_wave(self, pending):
            raise RuntimeError("card on fire")

    holder = {}
    coord, execu = _rig(
        "torch", tmp_path, "lib", dict(part_failure_max_retries=1),
        encoder_factory=lambda m, s, mesh: Dead(
            holder["execu"]._default_encoder(m, s, mesh), 0))
    holder["execu"] = execu
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(8, 64, 48), 64,
                       48)
    job = _run("torch", coord, path, 64, 48, 8, want=TStatus.FAILED)
    assert job.failure_stage == "encode" and job.failure_host == "local"
    assert "wave 0 failed after 1 retries" in job.failure_reason
    assert "card on fire" in job.failure_reason
    assert job.output_path == ""
    assert execu._shrink_encoder(execu._default_encoder(
        TMeta(width=64, height=48), coord._settings_fn(), None),
        coord._settings_fn(), 1) is None


def test_stale_run_token_halts_between_waves(tmp_path):
    """The job is stopped after its first collected wave: the next halt
    check sees the stale token, no further wave is collected, nothing is
    written."""
    holder = {}

    class Stopping(_Flaky):
        def collect_wave(self, pending):
            out = self.inner.collect_wave(pending)
            self.collects += 1
            holder["coord"].stop_job(holder["job_id"])
            return out

    def factory(meta, settings, mesh):
        # one GOP a wave: 3 waves, so a halt check falls between them
        holder["enc"] = Stopping(tdispatch.GopShardEncoder(
            meta, qp=30, gop_frames=4, gops_per_wave=1, device="cpu"), 0)
        return holder["enc"]

    coord, execu = _rig("torch", tmp_path, "lib", encoder_factory=factory)
    holder.update(coord=coord, execu=execu)
    launch = coord._launcher

    def launch_and_note(job):
        holder["job_id"] = job.id
        launch(job)

    coord._launcher = launch_and_note
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(12, 64, 48), 64,
                       48)
    job = _run("torch", coord, path, 64, 48, 12, want=TStatus.STOPPED)
    assert holder["enc"].collects == 1
    assert job.output_path == ""
    assert not os.path.exists(tmp_path / "lib" / "clip.mp4")


def test_progress_is_monotonic_and_heartbeats_carry_the_stage(tmp_path):
    progress = []

    class Spy(tcluster.Coordinator):
        def update_progress(self, job_id, token, **fields):
            progress.append(dict(fields))
            return super().update_progress(job_id, token, **fields)

    snap = tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, gop_frames=4,
                                     qp=30, heartbeat_throttle_s=0.0,
                                     min_idle_workers=0))
    reg = tcluster.WorkerRegistry()
    # one node with one card: two scheduler slots, enough to admit
    reg.heartbeat("node", metrics={"devices": 1})
    coord = Spy(registry=reg, settings_fn=lambda: snap)
    execu = texecutor.LocalExecutor(coord, str(tmp_path / "lib"), sync=True,
                                    device="cpu")
    coord._launcher = execu.launch
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(12, 64, 48), 64,
                       48)
    job = _run("torch", coord, path, 64, 48, 12)
    encs = [p["encode_progress"] for p in progress if "encode_progress" in p]
    assert encs == sorted(encs) and encs[-1] == 100.0
    dones = [p["parts_done"] for p in progress if "parts_done" in p]
    assert dones == sorted(dones) and dones[-1] == job.parts_total == 3
    assert job.heartbeat_stage in ("encode", "stitch")
    assert any(line.startswith("stage_ms ") or "stage_ms " in line
               for line in coord.activity.fetch_job(job.id))


def test_profile_dir_writes_a_chrome_trace_of_the_job(tmp_path):
    trace_dir = tmp_path / "traces"
    coord, _ = _rig("torch", tmp_path, "lib",
                    dict(profile_dir=str(trace_dir)))
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(4, 32, 32), 32,
                       32)
    job = _run("torch", coord, path, 32, 32, 4)
    (sub,) = os.listdir(trace_dir)
    assert sub == f"job-{job.id[:8]}"
    (name,) = os.listdir(trace_dir / sub)
    assert name.endswith(".pt.trace.json")
    doc = json.loads((trace_dir / sub / name).read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    # the encode's torch ops are in it (the card's kernels, on a card)
    assert any(n.startswith("aten::") for n in names)


def test_the_executor_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    coord = tcluster.Coordinator()
    with pytest.raises(TypeError, match="DeviceMesh"):
        texecutor.LocalExecutor(coord, str(tmp_path), device="cpu",
                                mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texecutor.LocalExecutor(coord, str(tmp_path))
