"""GOP staging writes each frame once, into its place in a GOP buffer,
and hands dispatch the arrays the plain staging chain gave.

The plain reference, written here: every frame `Frame.padded(16)`, each
GOP's planes `np.stack`ed with its last frame repeated up to the wave's
F, each wave's GOPs stacked with the mesh's repeat of its last GOP, and
the stack cut into each entry's run of GOPs. Held byte for byte against
`GopShardEncoder.stage_waves` and `stage_luma_waves` on the CPU:

- a y4m source read straight into the buffers (1080p, a width and a
  height that are not multiples of 16, a last GOP shorter than F, a
  two-entry CPU mesh with an odd GOP count, an executor's subrange
  `src[start:]`), and a list of decoded Frames copied into them; the
  `staged_direct_frames` / `staged_copied_frames` counters say which;
- staged CPU waves share no memory, listed (`prepare_waves`) or queued
  (`background_stage`);
- a truncated y4m and a bad FRAME marker still raise;
- a `LocalExecutor` job writes the MP4 that plain staging gives;
- the slot ring hands a slot out again only once the events behind its
  copies have completed, and times that wait as `stage_slot_wait`.
"""

import functools
import itertools
import os
import time

import numpy as np
import pytest
import torch

from thinvids_tpu_torch import cluster as tcluster
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.status import Status
from thinvids_tpu_torch.core.types import Frame, VideoMeta
from thinvids_tpu_torch.ingest.decode import open_video
from thinvids_tpu_torch.io.y4m import write_y4m
from thinvids_tpu_torch.parallel import dispatch

torch.set_num_threads(1)


def _frames(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return [Frame(rng.integers(0, 256, (h, w), dtype=np.uint8),
                  rng.integers(0, 256, (ch, cw), dtype=np.uint8),
                  rng.integers(0, 256, (ch, cw), dtype=np.uint8))
            for _ in range(n)]


def _write(path, frames):
    h, w = frames[0].y.shape
    write_y4m(str(path), VideoMeta(width=w, height=h, fps_num=30,
                                   num_frames=len(frames)), frames)
    return str(path)


def _plain_waves(enc, frames, planes="yuv"):
    """[(wave, [per plane: the whole (G, F, Hp, Wp) stack]), ...] as the
    plain chain stages `frames` for `enc`."""
    gops = list(enc.plan(len(frames)).gops)
    d = enc.num_devices
    per_wave = d * enc.gops_per_wave
    padded = [f.padded(16) for f in frames]
    out = []
    for start in range(0, len(gops), per_wave):
        wave = gops[start:start + per_wave]
        f_static = max(g.num_frames for g in wave)
        full = wave + [wave[-1]] * ((-len(wave)) % d)
        stacks = []
        for name in planes:
            per_gop = []
            for g in full:
                arrs = [getattr(padded[i], name)
                        for i in range(g.start_frame, g.end_frame)]
                arrs += [arrs[-1]] * (f_static - len(arrs))
                per_gop.append(np.stack(arrs))
            stacks.append(np.stack(per_gop))
        out.append((wave, stacks))
    return out


def _assert_same_wave(enc, got_planes, want_stacks):
    """Each staged plane (one part an entry) is the plain stack cut into
    the entries' runs of GOPs, byte for byte."""
    runs = dispatch._runs(want_stacks[0].shape[0], enc.num_devices)
    offs = np.cumsum([0] + runs)
    for got, want in zip(got_planes, want_stacks, strict=True):
        parts = dispatch._parts(got)
        assert len(parts) == enc.num_devices
        for part, a, b in zip(parts, offs[:-1], offs[1:]):
            assert part.dtype == torch.uint8
            assert part.shape == want[a:b].shape
            assert np.array_equal(part.numpy(), want[a:b])


def _encoder(n, w, h, gop, gops_per_wave, mesh=None):
    return dispatch.GopShardEncoder(
        VideoMeta(width=w, height=h, num_frames=n), qp=27, gop_frames=gop,
        gops_per_wave=gops_per_wave, device="cpu", mesh=mesh)


#: name → (width, height, frames, gop, GOPs a wave, mesh, source, start):
#: source "y4m" stages open_video(path) (or its window [start:]),
#: "frames" the decoded list
CASES = {
    "1080p_pad_rows": (1920, 1080, 3, 2, 2, None, "y4m", 0),
    "odd_size_pad_columns": (66, 42, 11, 4, 2, None, "y4m", 0),
    "short_last_gop": (64, 48, 10, 4, 3, None, "y4m", 0),
    "mesh_odd_gop_count": (64, 40, 12, 4, 1, ("cpu", "cpu"), "y4m", 0),
    "executor_subrange": (64, 48, 17, 4, 2, None, "y4m", 5),
    "decoded_frames": (66, 42, 9, 4, 2, None, "frames", 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_waves_equal_the_plain_chain(tmp_path, case):
    w, h, n, gop, gpw, mesh, kind, start = CASES[case]
    frames = _frames(n, w, h, seed=n)
    src = open_video(_write(tmp_path / "clip.y4m", frames))
    want_frames = frames[start:]
    staged_from = (frames if kind == "frames"
                   else src[start:] if start else src)
    enc = _encoder(len(want_frames), w, h, gop, gpw, mesh)
    got = list(enc.stage_waves(staged_from))
    want = _plain_waves(enc, want_frames)
    assert len(got) == len(want) > 0
    for (wave, ys, us, vs, qps), (want_wave, stacks) in zip(got, want):
        assert wave == want_wave
        _assert_same_wave(enc, (ys, us, vs), stacks)
        assert qps.dtype == np.int32
        assert qps.tolist() == [27] * stacks[0].shape[0]
    snap = enc.stages.snapshot()
    direct = len(want_frames) if kind == "y4m" else 0
    assert snap["staged_direct_frames"] == direct
    assert snap["staged_copied_frames"] == len(want_frames) - direct
    assert src.frames_decoded == direct
    assert snap["h2d_bytes"] == sum(
        sum(s.nbytes for s in stacks) for _w, stacks in want)
    assert snap["stage_slot_wait"] == 0.0      # no slot on the CPU


@pytest.mark.parametrize("kind", ["y4m", "frames"])
def test_luma_waves_equal_the_plain_chain(tmp_path, kind):
    w, h, n = 66, 42, 10
    frames = _frames(n, w, h, seed=3)
    src = open_video(_write(tmp_path / "clip.y4m", frames))
    enc = _encoder(n, w, h, 4, 1, ("cpu", "cpu"))
    got = list(enc.stage_luma_waves(src if kind == "y4m" else frames))
    want = _plain_waves(enc, frames, planes="y")
    assert len(got) == len(want)
    for (wave, ys), (want_wave, stacks) in zip(got, want):
        assert wave == want_wave
        _assert_same_wave(enc, (ys,), stacks)
    snap = enc.stages.snapshot()
    counter = ("staged_direct_frames" if kind == "y4m"
               else "staged_copied_frames")
    assert snap[counter] == n
    assert snap["h2d_bytes"] == sum(s[0].nbytes for _w, s in want)


def _planes_of(staged):
    return [p.numpy() for t in staged[1:4] for p in dispatch._parts(t)]


@pytest.mark.parametrize("how", ["prepare_waves", "background_stage"])
def test_staged_cpu_waves_share_no_memory(tmp_path, how):
    w, h, n = 64, 48, 16
    frames = _frames(n, w, h, seed=7)
    src = open_video(_write(tmp_path / "clip.y4m", frames))
    enc = _encoder(n, w, h, 2, 2)
    if how == "prepare_waves":
        _plan, waves = enc.prepare_waves(src)
    else:
        waves = list(dispatch.background_stage(
            enc.stage_waves(src), decode_ahead=2, profile=enc.stages))
    assert len(waves) == 4
    for a, b in itertools.combinations(waves, 2):
        for pa, pb in itertools.product(_planes_of(a), _planes_of(b)):
            assert not np.shares_memory(pa, pb)
    # and each still holds its own frames once every wave is staged
    for (wave, *planes), (_w, stacks) in zip(waves,
                                              _plain_waves(enc, frames)):
        _assert_same_wave(enc, planes[:3], stacks)


def test_frames_of_another_size_are_refused():
    frames = _frames(4, 64, 48) + _frames(1, 48, 48)
    enc = _encoder(5, 64, 48, 8, 1)
    with pytest.raises(ValueError, match="first frame"):
        list(enc.stage_waves(frames))


@pytest.mark.parametrize("fault", ["truncated", "bad_marker"])
def test_a_damaged_y4m_still_raises(tmp_path, fault):
    w, h, n = 64, 48, 8
    path = _write(tmp_path / "clip.y4m", _frames(n, w, h))
    src = open_video(path)               # the frame count is read here
    record = len(b"FRAME\n") + w * h * 3 // 2
    size = os.path.getsize(path)
    if fault == "truncated":
        with open(path, "r+b") as fp:
            fp.truncate(size - record // 2)
        want = (EOFError, "truncated y4m frame payload")
    else:
        with open(path, "r+b") as fp:
            fp.seek(size - 3 * record)
            fp.write(b"FRAMX\n")
        want = (ValueError, "not a bare FRAME record")
    enc = _encoder(n, w, h, 4, 1)
    with pytest.raises(want[0], match=want[1]):
        list(enc.stage_waves(src))


def _plain_stage_waves(enc, frames):
    """stage_waves as the plain chain gives it, for one CPU entry."""
    for wave, (ys, us, vs) in _plain_waves(enc, list(frames)):
        qps = np.asarray([enc.gop_qp.get(g.index, enc.qp)
                          for g in wave], np.int32)
        yield (wave, torch.from_numpy(ys), torch.from_numpy(us),
               torch.from_numpy(vs), qps)


def _job_mp4(tmp_path, name, path, n, w, h, plain):
    snap = tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, gop_frames=4,
                                     qp=30, heartbeat_throttle_s=0.0))
    built = []

    def factory(meta, settings, mesh):
        enc = dispatch.make_shard_encoder(meta, settings, mesh,
                                          device="cpu")
        if plain:
            enc.stage_waves = functools.partial(_plain_stage_waves, enc)
        built.append(enc)
        return enc

    reg = tcluster.WorkerRegistry()
    for i in range(8):
        reg.heartbeat(f"w{i:02d}")
    coord = tcluster.Coordinator(registry=reg, settings_fn=lambda: snap)
    execu = texecutor.LocalExecutor(coord, output_dir=str(tmp_path / name),
                                    sync=True, device="cpu",
                                    encoder_factory=factory)
    coord._launcher = execu.launch
    job = coord.add_job(path, VideoMeta(width=w, height=h, fps_num=30,
                                        num_frames=n))
    job = coord.store.get(job.id)
    assert job.status is Status.DONE, job.failure_reason
    with open(job.output_path, "rb") as fp:
        return fp.read(), built[0].stages.snapshot()


def test_a_job_writes_the_mp4_of_the_plain_chain(tmp_path):
    w, h, n = 64, 40, 10
    path = _write(tmp_path / "clip.y4m", _frames(n, w, h, seed=11))
    got, snap = _job_mp4(tmp_path, "new", path, n, w, h, plain=False)
    want, _ = _job_mp4(tmp_path, "plain", path, n, w, h, plain=True)
    assert got[4:8] == b"ftyp" and got == want
    assert snap["staged_direct_frames"] == n
    assert snap["staged_copied_frames"] == 0


class _StandInEvent:
    """A CUDA event's stand-in: done `delay` seconds after it is made."""

    def __init__(self, delay: float) -> None:
        self._at = time.monotonic() + delay

    def query(self) -> bool:
        return time.monotonic() >= self._at

    def synchronize(self) -> None:
        time.sleep(max(0.0, self._at - time.monotonic()))


def test_a_slot_is_handed_out_again_only_after_its_copies():
    prof = dispatch.StageProfile()
    made = []

    def make():
        made.append(dispatch._Slot([np.zeros((2, 16, 16), np.uint8)]))
        return made[-1]

    ring = dispatch._SlotRing(3, make, prof)
    first = [ring.take() for _ in range(3)]
    assert first == made and len(set(map(id, first))) == 3
    copies = [_StandInEvent(0.08), _StandInEvent(0.02)]
    first[0].events.extend(copies)
    again = ring.take()
    assert again is first[0]
    assert all(ev.query() for ev in copies)
    assert again.events == []
    waited = prof.snapshot()["stage_slot_wait"]
    assert 60.0 <= waited < 2000.0
    # a slot whose copies are done, or that holds none, comes back at once
    first[1].events.append(_StandInEvent(0.0))
    assert ring.take() is first[1] and ring.take() is first[2]
    assert ring.take() is first[0] and len(made) == 3
    assert prof.snapshot()["stage_slot_wait"] < waited + 50.0
