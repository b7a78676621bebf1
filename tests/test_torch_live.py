"""Port parity for live LL-HLS: the tail source, the live packager and the
live edge, each fed the same seeded inputs as the JAX package.

- the port's TailFrameSource passes every case of the reference's tail
  tests (tests/test_live.py), each case run over both packages' modules;
- `_live_batch_plan` equals the reference's over a grid of (frames, gop,
  devices);
- the port's LiveLadderPackager, fed the same GOP bundles as the
  reference's, writes the same tree, names and bytes, after every GOP
  and after close: EVENT mode, a short tail GOP and DVR garbage
  collection;
- a live job through the reference's LocalExecutor, whose `_run_live`
  calls the port's `run_live(device="cpu")` with a coordinator adapter
  as its hooks (the reference's `_live_encode_batch` raises meanwhile),
  writes the JAX executor's HLS tree byte for byte: the 2-rung ladder
  edge (its scaled planes asserted equal to JAX's first), a DVR window,
  a short tail and the 3-band split-frame edge; and, with the source
  still growing until the master playlist is published, the same tree
  as the pre-written run.

The port's catch-up batch is 4 GOPs (1 for split-frame) where the
reference batches 8 x 4 on the suite's 8 virtual devices: the pinned GOP
grid makes the bytes independent of the batching.
"""

import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from thinvids_tpu.abr import ladder as jladder
from thinvids_tpu.abr.scale import PlaneScaler as JScaler
from thinvids_tpu.cluster import Coordinator, WorkerRegistry
from thinvids_tpu.cluster import executor as jexecutor
from thinvids_tpu.cluster.executor import LocalExecutor
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.status import Status
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.ingest import decode as jdecode
from thinvids_tpu.ingest import tail as jtail
from thinvids_tpu.io.y4m import Y4MWriter, write_y4m
from thinvids_tpu.live import packager as jpackager
from thinvids_tpu_torch.abr import hls as thls
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.abr.scale import PlaneScaler as TScaler
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.ingest import decode as tdecode
from thinvids_tpu_torch.ingest import tail as ttail
from thinvids_tpu_torch.live import packager as tpackager
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

W, H = 64, 48
META = JMeta(width=W, height=H, fps_num=30, fps_den=1)

#: package name → (its tail module, its DecodeError)
TAILS = {"jax": (jtail, jdecode.DecodeError),
         "torch": (ttail, tdecode.DecodeError)}


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


def _frame_records(meta, clip):
    """(header bytes, [one y4m record per frame]) for incremental
    writes."""
    buf = io.BytesIO()
    writer = Y4MWriter(buf, meta)
    header = buf.getvalue()
    records = []
    for planes in clip:
        buf.seek(0)
        buf.truncate()
        writer.write(JFrame(*planes))
        records.append(buf.getvalue())
    return header, records


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as fp:
                out[os.path.relpath(full, root)] = fp.read()
    return out


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# ---- tail ingest ----------------------------------------------------------------

@pytest.fixture(params=sorted(TAILS))
def tail_pkg(request):
    return TAILS[request.param]


class TestTailIngest:
    def test_mid_frame_partial_append_not_counted(self, tmp_path, tail_pkg):
        tail_mod, _ = tail_pkg
        clip = _smooth_clip(3, W, H)
        header, recs = _frame_records(META, clip)
        path = str(tmp_path / "grow.live.y4m")
        with open(path, "wb") as fp:
            fp.write(header + recs[0] + recs[1][: len(recs[1]) // 2])
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=1.0,
                                        poll_s=0.01)
        assert tail.available() == 1          # torn record excluded
        got = list(tail.iter_frames())
        assert len(got) == 1
        assert np.array_equal(got[0].y, clip[0][0])
        with open(path, "ab") as fp:
            fp.write(recs[1][len(recs[1]) // 2:])
        assert tail.available() == 2
        assert tail.meta.num_frames == 2      # the header's count grows
        assert not tail.ended

    def test_writer_stall_then_resume(self, tmp_path, tail_pkg):
        tail_mod, _ = tail_pkg
        header, recs = _frame_records(META, _smooth_clip(4, W, H))
        path = str(tmp_path / "grow.live.y4m")
        with open(path, "wb") as fp:
            fp.write(header + recs[0])
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=5.0,
                                        poll_s=0.005)

        def resume():
            time.sleep(0.15)                  # a stall SHORTER than the
            with open(path, "ab") as fp:      # budget, then more frames
                fp.write(recs[1] + recs[2])
        t = threading.Thread(target=resume)
        t.start()
        n = tail.wait_frames(3)
        t.join()
        assert n == 3 and not tail.ended
        assert [f.pts for f in tail.iter_frames(1, 3)] == [1, 2]

    def test_stall_timeout_is_clean_end_of_stream(self, tmp_path, tail_pkg):
        tail_mod, _ = tail_pkg
        header, recs = _frame_records(META, _smooth_clip(2, W, H))
        path = str(tmp_path / "grow.live.y4m")
        with open(path, "wb") as fp:
            fp.write(header + recs[0] + recs[1])
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=0.5,
                                        poll_s=0.01)
        t0 = time.monotonic()
        n = tail.wait_frames(10)              # never arrives
        assert tail.ended and n == 2
        assert time.monotonic() - t0 >= 0.4

    def test_eos_marker_ends_without_waiting_out_the_stall(self, tmp_path,
                                                           tail_pkg):
        tail_mod, _ = tail_pkg
        header, recs = _frame_records(META, _smooth_clip(1, W, H))
        path = str(tmp_path / "grow.live.y4m")
        with open(path, "wb") as fp:
            fp.write(header + recs[0])
        with open(path + tail_mod.EOS_SUFFIX, "wb"):
            pass
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=30.0,
                                        poll_s=0.01)
        t0 = time.monotonic()
        n = tail.wait_frames(5)
        assert tail.ended and n == 1
        assert time.monotonic() - t0 < 5.0

    def test_header_arriving_late_is_waited_for(self, tmp_path, tail_pkg):
        tail_mod, _ = tail_pkg
        header, recs = _frame_records(META, _smooth_clip(1, W, H))
        path = str(tmp_path / "grow.live.y4m")
        with open(path, "wb"):
            pass                              # file exists, empty

        def write_header():
            time.sleep(0.1)
            with open(path, "ab") as fp:
                fp.write(header + recs[0])
        t = threading.Thread(target=write_header)
        t.start()
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=5.0,
                                        poll_s=0.01)
        t.join()
        assert tail.wait_frames(1) == 1
        assert (tail.meta.width, tail.meta.height) == (W, H)

    def test_header_never_arriving_raises_decode_error(self, tmp_path,
                                                       tail_pkg):
        tail_mod, decode_error = tail_pkg
        path = str(tmp_path / "never.live.y4m")
        with pytest.raises(decode_error):
            tail_mod.TailFrameSource(path, stall_timeout_s=0.3, poll_s=0.01)

    def test_stop_check_aborts_wait_early(self, tmp_path, tail_pkg):
        tail_mod, _ = tail_pkg
        header, recs = _frame_records(META, _smooth_clip(1, W, H))
        path = str(tmp_path / "grow.live.y4m")
        with open(path, "wb") as fp:
            fp.write(header + recs[0])
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=30.0,
                                        poll_s=0.005)
        t0 = time.monotonic()
        tail.wait_frames(5, stop_check=lambda: True)
        assert time.monotonic() - t0 < 1.0
        assert not tail.ended                 # aborted, not ended

    def test_spool_stream_reproduces_file_and_marks_eos(self, tmp_path,
                                                        tail_pkg):
        tail_mod, _ = tail_pkg
        header, recs = _frame_records(META, _smooth_clip(3, W, H))
        data = header + b"".join(recs)
        path = str(tmp_path / "sock.live.y4m")
        n = tail_mod.spool_stream(io.BytesIO(data), path, chunk_bytes=64)
        assert n == len(data)
        assert open(path, "rb").read() == data
        assert os.path.exists(path + tail_mod.EOS_SUFFIX)
        tail = tail_mod.TailFrameSource(path, stall_timeout_s=5.0)
        assert tail.wait_frames(99) == 3 and tail.ended

    def test_live_name_convention_is_stem_suffix_only(self, tail_pkg):
        tail_mod, _ = tail_pkg
        assert tail_mod.is_live_name("cam1.live.y4m")
        assert tail_mod.is_live_name("/a/b/Show.LIVE.Y4M")
        assert not tail_mod.is_live_name("clip.y4m")
        assert not tail_mod.is_live_name("clip.live.stamped.y4m")
        assert not tail_mod.is_live_name("alive.y4m")


def test_port_tail_frames_equal_the_reference_tail(tmp_path):
    """Both tails read the same growing file into the same planes, and a
    lazy slice of the port's tail (what the live batch encodes) yields
    the frames [a, b) even while the file grows past b."""
    clip = _smooth_clip(6, W, H, seed=5)
    header, recs = _frame_records(META, clip)
    path = str(tmp_path / "cam.live.y4m")
    with open(path, "wb") as fp:
        fp.write(header + b"".join(recs[:4]))
    jt = jtail.TailFrameSource(path, stall_timeout_s=1.0)
    tt = ttail.TailFrameSource(path, stall_timeout_s=1.0)
    assert tt.meta.num_frames == jt.meta.num_frames == 4
    window = tt[1:3]
    with open(path, "ab") as fp:
        fp.write(b"".join(recs[4:]))
    got = list(window.iter_frames())
    assert [f.pts for f in got] == [1, 2]
    for j, t in zip(jt.iter_frames(), tt.iter_frames()):
        for p in "yuv":
            np.testing.assert_array_equal(getattr(t, p), getattr(j, p))
    assert len(tt) == len(jt) == 6


# ---- the batch plan ---------------------------------------------------------------

@pytest.mark.parametrize("frames", [1, 3, 8, 9, 31, 32, 33])
@pytest.mark.parametrize("gop,devices", [(1, 1), (4, 1), (4, 8), (8, 4),
                                         (32, 8)])
def test_live_batch_plan_equals_the_reference(frames, gop, devices):
    got = texecutor._live_batch_plan(frames, gop, devices)
    want = jexecutor._live_batch_plan(frames, gop, devices)
    assert [(g.index, g.start_frame, g.num_frames) for g in got.gops] == \
        [(g.index, g.start_frame, g.num_frames) for g in want.gops]
    assert (got.num_devices, got.frames_per_gop) == \
        (want.num_devices, want.frames_per_gop)


# ---- the packager -------------------------------------------------------------

def _port_bundles(clip, gop, rungs_spec):
    """The port's CPU ladder over `clip` on the live grid: (the port's
    rungs, the JAX package's rungs, the GOP bundles)."""
    n = len(clip)
    over = dict(qp=30, gop_frames=gop, ladder_rungs=rungs_spec)
    tmeta = TMeta(width=W, height=H, fps_num=30, num_frames=n)
    trungs = tladder.plan_ladder(
        tmeta, tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, **over)))
    jrungs = jladder.plan_ladder(
        JMeta(width=W, height=H, fps_num=30, num_frames=n),
        jcfg.Settings(values=dict(jcfg.DEFAULT_SETTINGS, **over)))
    enc = tladder.LadderShardEncoder(tmeta, trungs, gop_frames=gop,
                                     device="cpu")
    enc.plan_override = texecutor._live_batch_plan(n, gop, 1)
    return trungs, jrungs, enc.encode([TFrame(*f) for f in clip])


@pytest.mark.parametrize("case,n,gop,segment_s,dvr_s", [
    ("event", 16, 4, 0.25, 0.0),
    ("short_tail", 6, 4, 10.0, 0.0),
    ("dvr_gc", 32, 4, 0.25, 0.5),
])
def test_packager_writes_the_reference_tree(tmp_path, case, n, gop,
                                            segment_s, dvr_s):
    trungs, jrungs, bundles = _port_bundles(_smooth_clip(n, W, H, seed=7),
                                            gop, "24")
    assert [r.name for r in trungs] == [r.name for r in jrungs] == \
        ["48p", "24p"]
    kw = dict(segment_s=segment_s, gop_frames=gop, dvr_window_s=dvr_s)
    tpk = tpackager.LiveLadderPackager(str(tmp_path / "port"), trungs, 30, 1,
                                       **kw)
    jpk = jpackager.LiveLadderPackager(str(tmp_path / "ref"), jrungs, 30, 1,
                                       **kw)
    for bundle in bundles:
        tpk.add_gop(bundle)
        jpk.add_gop(bundle)
        _assert_same_tree(_tree(tpk.out_dir), _tree(jpk.out_dir))
    tpk.close()
    jpk.close()
    port_tree = _tree(tpk.out_dir)
    _assert_same_tree(port_tree, _tree(jpk.out_dir))
    counters = ("segments_announced", "parts_announced", "segments_gced")
    assert [getattr(tpk, c) for c in counters] == \
        [getattr(jpk, c) for c in counters]
    assert tpk.total_bytes() == jpk.total_bytes()
    assert tpk.parts_announced == -(-n // gop)
    media = os.path.join(tpk.out_dir, "48p", thls.MEDIA_PLAYLIST)
    final = thls.lint_live_media_playlist(media)
    assert final["ended"]
    if case == "dvr_gc":
        assert tpk.segments_gced > 0 and final["media_sequence"] > 0
        assert "48p/" + thls.SEGMENT_PATTERN % 0 not in port_tree
    else:
        info = thls.lint_ladder(tpk.out_dir, expected_duration_s=n / 30)
        assert info["rungs"] == 2
        if case == "short_tail":
            assert info["segments"] == 1


# ---- the live job -----------------------------------------------------------------

class _CoordinatorHooks(texecutor.LiveHooks):
    """The port's live hooks bound to a reference executor's job: each
    call is the coordinator call the reference's `_run_live` makes."""

    def __init__(self, execu, job, token, published=None):
        self.execu, self.job, self.token = execu, job, token
        self.co = execu.coordinator
        self.published = published
        self.encoders = []

    def mark_running(self):
        return self.co.mark_running(self.job.id, self.token)

    def token_is_current(self):
        return self.co.token_is_current(self.job.id, self.token)

    def publish_output(self, master_path):
        self.co.publish_output(self.job.id, self.token, master_path)
        if self.published is not None:
            self.published.set()

    def note_live_part(self, seconds, budget):
        self.co.note_live_part(self.job.id, self.token, seconds, budget)

    def update_progress(self, **fields):
        self.co.update_progress(self.job.id, self.token, **fields)

    def heartbeat(self, stage, note=""):
        self.co.heartbeat_job(self.job.id, self.token, stage,
                              host=self.execu.host, note=note)

    def bind_trace(self, enc):
        self.encoders.append(enc)
        self.execu._bind_trace(self.job, enc)

    def stage_breakdown(self, enc):
        self.execu._emit_stage_breakdown(self.job, enc)

    def complete(self, master_path, nbytes):
        self.co.complete_job(self.job.id, self.token, master_path, nbytes)


class PortLiveExecutor(LocalExecutor):
    """The reference's executor with its live seam routed to the port."""

    published = None
    hooks: list

    def _run_live(self, job, token, settings, stage):
        hooks = _CoordinatorHooks(self, job, token, self.published)
        self.hooks.append(hooks)
        texecutor.run_live(job.input_path, self.output_dir, settings,
                           device="cpu", hooks=hooks, stage=stage)


def _live_settings(**over):
    values = dict(jcfg.DEFAULT_SETTINGS, qp=30, gop_frames=4,
                  segment_s=0.25, ladder_rungs="24", live_stall_s=30.0,
                  heartbeat_throttle_s=0.0)
    values.update(over)
    return jcfg.Settings(values=values)


def _rig(tmp_path, name, snap, cls=LocalExecutor):
    reg = WorkerRegistry()
    for i in range(8):
        reg.heartbeat(f"w{i:02d}")
    coord = Coordinator(registry=reg, settings_fn=lambda: snap)
    execu = cls(coord, output_dir=str(tmp_path / name), sync=True)
    if cls is PortLiveExecutor:
        execu.hooks = []
    coord._launcher = execu.launch
    return coord, execu


def _run_live_job(coord, path, w, h, n):
    job = coord.add_job(str(path), JMeta(width=w, height=h, fps_num=30,
                                         num_frames=n))
    job = coord.store.get(job.id)
    assert job.job_type == "live"
    assert job.status is Status.DONE, job.failure_reason
    assert job.parts_done == job.parts_total == -(-n // 4)
    assert job.output_path.endswith("master.m3u8")
    return job


def _refuse(*a, **k):
    raise AssertionError("the reference's live batch ran")


def _assert_planes_equal_jax(clip, w, h, dims):
    """The precondition of a whole-ladder byte comparison: on this clip
    the port's scaled planes equal the JAX package's (a sample exactly
    on a half may round the other way in another summation order)."""
    padded = [TFrame(*f).padded(16) for f in clip]
    planes = [np.stack([getattr(f, p) for f in padded])[None] for p in "yuv"]
    for dw, dh in dims:
        got = TScaler(w, h, dw, dh, device="cpu").scale_wave(
            *(torch.from_numpy(p) for p in planes))
        want = JScaler(w, h, dw, dh).scale_wave(*planes)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("case,w,h,n,over", [
    ("ladder", 64, 48, 16, {}),
    ("ladder_dvr_gc", 64, 48, 32, {"dvr_window_s": 0.5}),
    ("ladder_short_tail", 64, 48, 6, {"segment_s": 10.0}),
    ("sfe_3_bands", 64, 96, 8, {"sfe_bands": 3, "ladder_rungs": "96"}),
])
def test_live_job_writes_the_reference_tree(tmp_path, monkeypatch, case, w,
                                            h, n, over):
    clip = _smooth_clip(n, w, h, seed=11 + n)
    if case.startswith("ladder"):
        _assert_planes_equal_jax(clip, w, h, [(32, 24)])
    path = tmp_path / "cam.live.y4m"
    write_y4m(path, JMeta(width=w, height=h, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    open(str(path) + jtail.EOS_SUFFIX, "wb").close()
    snap = _live_settings(**over)
    coord, execu = _rig(tmp_path, "port", snap, PortLiveExecutor)
    with monkeypatch.context() as mp:
        mp.setattr(LocalExecutor, "_live_encode_batch", _refuse)
        port_job = _run_live_job(coord, path, w, h, n)
    ref_job = _run_live_job(_rig(tmp_path, "ref", snap)[0], path, w, h, n)
    (hooks,) = execu.hooks
    (enc,) = hooks.encoders
    if case == "sfe_3_bands":
        assert type(enc) is tdispatch.SfeShardEncoder
        assert enc.num_bands == 3
    else:
        assert type(enc) is tladder.LadderShardEncoder
        assert [r.name for r in enc.rungs] == ["48p", "24p"]
    port_tree = _tree(os.path.dirname(port_job.output_path))
    _assert_same_tree(port_tree,
                      _tree(os.path.dirname(ref_job.output_path)))
    assert port_job.output_bytes == ref_job.output_bytes == \
        sum(len(v) for v in port_tree.values())
    if case == "ladder_dvr_gc":
        assert "48p/" + thls.SEGMENT_PATTERN % 0 not in port_tree


def test_growing_live_source_writes_the_prewritten_tree(tmp_path,
                                                        monkeypatch):
    """The writer holds the stream open (two GOPs short of its end) until
    the port has published the master playlist through its hooks, then
    finishes and drops `.eos`: the port's final tree equals the JAX
    executor's over the same file written in one go."""
    w, h, n = 64, 48, 16
    clip = _smooth_clip(n, w, h, seed=27)
    header, recs = _frame_records(JMeta(width=w, height=h, fps_num=30),
                                  clip)
    done_path = tmp_path / "done" / "cam.live.y4m"
    done_path.parent.mkdir()
    done_path.write_bytes(header + b"".join(recs))
    open(str(done_path) + jtail.EOS_SUFFIX, "wb").close()
    snap = _live_settings()
    ref_job = _run_live_job(_rig(tmp_path, "ref", snap)[0], done_path, w, h,
                            n)

    path = str(tmp_path / "cam.live.y4m")
    published = threading.Event()
    held = []

    def writer():
        with open(path, "wb") as out:
            out.write(header)
            out.flush()
            for i, rec in enumerate(recs):
                if i == n - 8:
                    held.append(published.wait(60.0))
                out.write(rec)
                out.flush()
                time.sleep(0.005)
        open(path + jtail.EOS_SUFFIX, "wb").close()

    coord, execu = _rig(tmp_path, "port", snap, PortLiveExecutor)
    execu.published = published
    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        with monkeypatch.context() as mp:
            mp.setattr(LocalExecutor, "_live_encode_batch", _refuse)
            port_job = _run_live_job(coord, path, w, h, n)
    finally:
        published.set()
        wt.join(30)
    assert held == [True], "the master was never published mid-stream"
    _assert_same_tree(_tree(os.path.dirname(port_job.output_path)),
                      _tree(os.path.dirname(ref_job.output_path)))


def test_run_live_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    path = tmp_path / "cam.live.y4m"
    write_y4m(path, JMeta(width=W, height=H, fps_num=30, num_frames=1),
              [JFrame(*_smooth_clip(1, W, H)[0])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texecutor.run_live(str(path), str(tmp_path / "out"),
                           _live_settings())
    assert not (tmp_path / "out").exists()


def test_run_live_without_a_coordinator_returns_its_counters(tmp_path):
    """The default hooks do nothing: run_live alone tails, encodes and
    packages, and `on_bundles` sees every GOP once, in order."""
    n = 10
    clip = _smooth_clip(n, W, H, seed=31)
    path = tmp_path / "solo.live.y4m"
    write_y4m(path, JMeta(width=W, height=H, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    open(str(path) + ttail.EOS_SUFFIX, "wb").close()
    seen = []
    out = texecutor.run_live(
        str(path), str(tmp_path / "lib"),
        tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, qp=30, gop_frames=4,
                                  segment_s=0.25, ladder_rungs="24",
                                  live_stall_s=5.0)),
        device="cpu", on_bundles=lambda b: seen.extend(
            x.gop.index for x in b))
    assert seen == [0, 1, 2]
    assert out["gops"] == 3 and out["frames"] == n
    assert out["parts_announced"] == 3 and out["segments_gced"] == 0
    assert out["master"] == str(tmp_path / "lib" / "solo.live.hls" /
                                "master.m3u8")
    info = thls.lint_ladder(os.path.dirname(out["master"]),
                            expected_duration_s=n / 30)
    assert info["rungs"] == 2


def test_scaler_products_do_not_depend_on_the_wave_shape(monkeypatch):
    """A live batch is one GOP, a batch ladder's wave four: a product
    batched over the wave would let the BLAS choose its kernel (and so
    the rounding of a sample on a half) by the frame count, and on a card
    the live 540p rung then differed from the batch ladder's. The scaler
    runs the same fixed-shape 2-D products for every plane whatever wave
    holds it, and a wave scales to the bits of its frames one by one."""
    shapes = []
    real = torch.matmul

    def recording(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    rng = np.random.default_rng(13)
    wave = torch.from_numpy(rng.integers(0, 256, (4, 2, 48, 64),
                                         dtype=np.uint8))
    scaler = TScaler(64, 48, 32, 24, device="cpu")
    monkeypatch.setattr(torch, "matmul", recording)
    whole = scaler.scale_wave(wave, wave[..., ::2, ::2], wave[..., ::2, ::2])
    wave_shapes = set(shapes)
    shapes.clear()
    ones = [scaler.scale_wave(wave[g:g + 1, f:f + 1],
                              wave[g:g + 1, f:f + 1, ::2, ::2],
                              wave[g:g + 1, f:f + 1, ::2, ::2])
            for g in range(4) for f in range(2)]
    assert set(shapes) == wave_shapes
    assert all(len(a) == len(b) == 2 for a, b in wave_shapes)
    for p in range(3):
        got = torch.cat([o[p].reshape(-1, *o[p].shape[-2:]) for o in ones])
        assert torch.equal(whole[p].reshape(got.shape), got)
