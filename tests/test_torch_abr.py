"""Port parity for the ABR ladder (thinvids_tpu_torch/abr/): the Lanczos
scaler, the rung planner, LadderShardEncoder and HLS packaging, against
the JAX package's on the same seeded clips.

- the scaler's matrices equal the reference's, and its planes are within
  1 LSB of the port's `scale_plane_np` and of the JAX package's
  `_apply_separable` over tests/test_abr.py's geometries (random
  content) and the ladder's rungs of bench.py's and tests/test_abr.py's
  clips (the counts of samples off by 1 LSB print under `pytest -rP`);
- `plan_ladder` gives the reference's rungs for several sources and
  specs;
- the ladder's top rung equals the single-rendition stream (and the JAX
  package's), `h2d_bytes` is paid once per wave whatever the rung count,
  the `scale` stage is timed and every rung shares one GOP plan;
- the lower rungs equal the JAX package's given the same planes: the JAX
  scaler's planes are fed to the port's rung encoders through the port
  ladder's own dispatch_wave, with and without a per-GOP QP override
  (carried across the rungs as the reference carries it);
- the whole ladder, the port's own scaled planes included, equals the
  JAX package's on a clip whose scaled planes are equal (asserted first:
  content whose chroma is constant along one axis lands samples exactly
  on a half, where float rounding order decides the LSB);
- the port's `package_ladder` + `lint_ladder` write the reference's tree
  (names and bytes) from the same segments, with and without audio.

The JAX side runs on a one-device mesh.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from thinvids_tpu.abr import hls as jhls
from thinvids_tpu.abr import ladder as jladder
from thinvids_tpu.abr import scale as jscale
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.io import mp4 as jmp4
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.abr import hls as thls
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.abr import scale as tscale
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.types import EncodedSegment as TSegment
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import GopSpec as TGop
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.io import mp4 as tmp4
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

W, H, N, GOP, QP, RUNGS = 64, 48, 16, 4, 30, "32,24"


def _one_device_mesh():
    return jdispatch.default_mesh(jax.devices()[:1])


def _textured(n=N, w=W, h=H, seed=0):
    """tests/test_abr.py's clip: a gradient + sine luma with grain, chroma
    that varies along one axis only."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 20 * np.sin(xx * 0.2)
    out = []
    for i in range(n):
        y = np.clip(base + 5 * i + rng.normal(0, 3, (h, w)), 0,
                    255).astype(np.uint8)
        u = np.clip(120 + 30 * np.sin(yy[::2, ::2] * 0.05 + i), 0,
                    255).astype(np.uint8)
        v = np.clip(130 + 30 * np.cos(xx[::2, ::2] * 0.04 + i), 0,
                    255).astype(np.uint8)
        out.append((y, u, v))
    return out


def _smooth(n=N, w=W, h=H, seed=3):
    """tests/test_torch_job.py's clip: smooth moving luma with grain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = (128 + 50 * np.sin((xx + 2 * i) * 0.1) * np.cos((yy + i) * 0.08)
             + rng.normal(0, 1.0, (h, w)))
        c = 128 + 30 * np.sin(xx[::2, ::2] * 0.06 + i * 0.1)
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    np.clip(c, 0, 255).astype(np.uint8),
                    np.clip(255 - c, 0, 255).astype(np.uint8)))
    return out


def _settings(cfg, **over):
    return cfg.Settings(values=dict(cfg.DEFAULT_SETTINGS, **over))


def _meta(cls, n=N, w=W, h=H):
    return cls(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)


def _ladders(spec=RUNGS, n=N):
    jmeta, tmeta = _meta(JMeta, n), _meta(TMeta, n)
    jr = jladder.plan_ladder(jmeta, _settings(jcfg, qp=QP, ladder_rungs=spec))
    tr = tladder.plan_ladder(tmeta, _settings(tcfg, qp=QP, ladder_rungs=spec))
    return (jladder.LadderShardEncoder(jmeta, jr, mesh=_one_device_mesh(),
                                       gop_frames=GOP),
            tladder.LadderShardEncoder(tmeta, tr, gop_frames=GOP,
                                       device="cpu"))


def _record_planes(ladder, to_np):
    """Wrap every scaler of `ladder` to keep the planes it returns:
    {rung name: [(y, u, v) numpy per wave]}."""
    seen = {}
    for rung, scaler in zip(ladder.rungs, ladder.scalers):
        if scaler is None:
            continue
        seen[rung.name] = []

        def record(ys, us, vs, _scale=scaler.scale_wave,
                   _out=seen[rung.name]):
            planes = _scale(ys, us, vs)
            _out.append(tuple(to_np(p) for p in planes))
            return planes

        scaler.scale_wave = record
    return seen


def _rung_streams(bundles, rungs, concat, segments):
    return {r.name: concat(segments(bundles, r.name)) for r in rungs}


# ---- the scaler ----------------------------------------------------------------

def _scaler_clip(content, w, h):
    """(ys, us, vs) uint8 stacks of one clip, every frame MB-padded:
    one frame of random samples, 8 frames of bench.py's content (chroma
    that varies along one axis), or tests/test_abr.py's 16-frame
    textured clip."""
    if content == "random":
        rng = np.random.default_rng(7)
        frames = [TFrame(
            y=rng.integers(0, 256, (h, w), np.uint8),
            u=rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8),
            v=rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8))]
    elif content == "bench":
        from bench import make_frames
        frames = [TFrame(y=f.y, u=f.u, v=f.v)
                  for f in make_frames(8, w, h, seed=5, pan=2)]
    else:
        frames = [TFrame(y=y, u=u, v=v) for y, u, v in _textured(16, w, h)]
    padded = [f.padded(16) for f in frames]
    return tuple(np.stack([getattr(f, p) for f in padded]) for p in "yuv")


@pytest.mark.parametrize("content,src,dst", [
    ("random", (64, 48), (32, 24)),      # clean power-of-two, mb-aligned
    ("random", (62, 50), (36, 24)),      # even, not mb-aligned
    ("random", (61, 37), (24, 16)),      # odd luma dims (odd chroma too)
    ("random", (352, 288), (314, 240)),
    ("random", (352, 288), (188, 144)),
    # the rungs plan_ladder gives: samples on k + 1/2 round by summation
    # order, so these differ from JAX's by 1 LSB in a few percent at most
    ("bench", (352, 288), (294, 240)),
    ("bench", (352, 288), (176, 144)),
    ("bench", (128, 96), (86, 64)),
    ("bench", (128, 96), (64, 48)),
    ("textured", (64, 48), (42, 32)),
    ("textured", (64, 48), (32, 24)),
])
def test_scaler_within_one_lsb_of_numpy_and_jax(content, src, dst):
    (w, h), (dw, dh) = src, dst
    planes = _scaler_clip(content, w, h)
    ts = tscale.PlaneScaler(w, h, dw, dh, device="cpu")
    js = jscale.PlaneScaler(w, h, dw, dh)
    for name in ("y_v", "y_h", "c_v", "c_h"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    got = [p.numpy() for p in ts.scale_wave(
        *(torch.from_numpy(p) for p in planes))]
    frames_np = [ts.scale_frame_np(*(p[i] for p in planes))
                 for i in range(len(planes[0]))]
    want_np = [np.stack(ps) for ps in zip(*frames_np)]
    want_jax = [np.asarray(p) for p in js.scale_wave(
        *(jnp.asarray(p) for p in planes))]
    for plane, g, n_, j in zip("yuv", got, want_np, want_jax):
        assert g.dtype == np.uint8 and g.shape == j.shape == n_.shape
        for ref_name, ref in (("scale_plane_np", n_), ("JAX", j)):
            diff = np.abs(g.astype(int) - ref.astype(int))
            off = (f"{content} {w}x{h} -> {dw}x{dh} plane {plane}: "
                   f"{int((diff != 0).sum())} of {diff.size} samples off "
                   f"{ref_name}'s, at most {int(diff.max())} LSB")
            print(off)                    # shown by pytest -rP
            assert diff.max() <= 1, off
            assert (diff == 0).mean() > 0.95, off


def test_scaler_takes_any_leading_dims_and_copies_the_reference_helpers():
    t = np.linspace(-4, 4, 97)
    np.testing.assert_array_equal(tscale.lanczos_kernel(t),
                                  jscale.lanczos_kernel(t))
    assert tscale.LANCZOS_A == jscale.LANCZOS_A
    assert [tscale._pad16(n) for n in (1, 16, 17, 1080)] == \
        [jscale._pad16(n) for n in (1, 16, 17, 1080)]
    for bad in ((16, 24, 20, 20), (16, 16, 8, 9)):
        with pytest.raises(ValueError, match="downscale only"):
            tscale.resample_matrix(*bad)
    with pytest.raises(ValueError, match="even"):
        tscale.PlaneScaler(64, 48, 31, 24, device="cpu")
    rng = np.random.default_rng(1)
    ys = rng.integers(0, 256, (2, 3, 48, 64), np.uint8)
    us = rng.integers(0, 256, (2, 3, 24, 32), np.uint8)
    sc = tscale.PlaneScaler(64, 48, 32, 24, device="cpu")
    sy, su, sv = sc.scale_wave(*(torch.from_numpy(a) for a in (ys, us, us)))
    assert sy.shape == (2, 3, 32, 32) and su.shape == sv.shape == (2, 3, 16, 16)
    one = sc.scale_wave(*(torch.from_numpy(a[1, 2]) for a in (ys, us, us)))
    np.testing.assert_array_equal(one[0].numpy(), sy[1, 2].numpy())


# ---- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("w,h,qp,spec", [
    (1920, 1080, 27, None),
    (1280, 720, 30, "1080,720,480,360"),
    (640, 480, 30, "360p, nope, 240,"),
    (64, 48, 30, "32,24"),
    (3840, 2160, 22, "2160;1441,721,3"),
    (352, 288, 51, "240,144"),
])
def test_plan_ladder_equals_the_reference(w, h, qp, spec):
    over = {} if spec is None else {"ladder_rungs": spec}
    jr = jladder.plan_ladder(JMeta(width=w, height=h),
                             _settings(jcfg, qp=qp, **over))
    tr = tladder.plan_ladder(TMeta(width=w, height=h),
                             _settings(tcfg, qp=qp, **over))
    assert [dataclasses.astuple(r) for r in tr] == \
        [dataclasses.astuple(r) for r in jr]
    assert [r.pixels for r in tr] == [r.pixels for r in jr]
    assert tladder.LADDER_ALPHA == jladder.LADDER_ALPHA
    assert tladder.DEFAULT_RUNGS == jladder.DEFAULT_RUNGS


# ---- the ladder encoder --------------------------------------------------------

def test_top_rung_is_the_single_rendition_stream_and_uploads_once():
    clip = _textured()
    jl, tl = _ladders()
    assert len(tl.rungs) == 3 and tl.scalers[0] is None
    bundles = tl.encode([TFrame(*f) for f in clip])
    single = tdispatch.GopShardEncoder(_meta(TMeta), qp=QP, gop_frames=GOP,
                                       device="cpu")
    ref = tconcat(single.encode([TFrame(*f) for f in clip]))
    top = tconcat(tladder.rung_segments(bundles, tl.rungs[0].name))
    assert top == ref
    jbundles = jl.encode([JFrame(*f) for f in clip])
    assert top == jconcat(jladder.rung_segments(jbundles, jl.rungs[0].name))

    snap = tl.stages.snapshot()
    assert snap["h2d_bytes"] == single.stages.snapshot()["h2d_bytes"] > 0
    assert snap["scale"] > 0 and snap["pack"] > 0
    assert snap["waves"] == 1
    plans = [[(s.gop.index, s.gop.start_frame, s.gop.num_frames)
              for s in tladder.rung_segments(bundles, r.name)]
             for r in tl.rungs]
    assert len(plans[0]) == N // GOP and all(p == plans[0] for p in plans)
    assert [b.gop.index for b in bundles] == list(range(N // GOP))
    tl.stages.reset()
    assert tl.stages.snapshot()["h2d_bytes"] == 0


def test_h2d_does_not_scale_with_rung_count():
    clip = _textured(n=8)
    totals = []
    for spec in ("32", "32,24"):
        _, tl = _ladders(spec, n=8)
        tl.encode([TFrame(*f) for f in clip])
        totals.append(tl.stages.snapshot()["h2d_bytes"])
    assert totals[0] == totals[1] > 0


class _JaxPlanes:
    """A scaler that hands the port ladder the JAX package's planes."""

    def __init__(self, jscaler):
        self._j = jscaler

    def scale_wave(self, ys, us, vs):
        out = self._j.scale_wave(*(jnp.asarray(p.numpy()) for p in
                                   (ys, us, vs)))
        return tuple(torch.from_numpy(np.array(p)) for p in out)


@pytest.mark.parametrize("gop_qp", [None, {0: 24, 1: 36, 2: 31, 3: 27}])
def test_lower_rungs_equal_the_reference_given_the_same_planes(gop_qp):
    clip = _textured()
    jl, tl = _ladders()
    tl.scalers = [None if s is None else _JaxPlanes(j)
                  for s, j in zip(tl.scalers, jl.scalers)]
    if gop_qp:
        jl._stager.gop_qp = dict(gop_qp)
        tl._stager.gop_qp = dict(gop_qp)
    jb = jl.encode([JFrame(*f) for f in clip])
    tb = tl.encode([TFrame(*f) for f in clip])
    want = _rung_streams(jb, jl.rungs, jconcat, jladder.rung_segments)
    got = _rung_streams(tb, tl.rungs, tconcat, tladder.rung_segments)
    assert list(got) == list(want) == ["48p", "32p", "24p"]
    for name in want:
        assert got[name] == want[name], name
    if gop_qp:
        # the override moves every rung, relative to its own QP
        _, plain = _ladders()
        plain.scalers = tl.scalers
        base = _rung_streams(plain.encode([TFrame(*f) for f in clip]),
                             plain.rungs, tconcat, tladder.rung_segments)
        assert all(base[name] != got[name] for name in got)


def test_whole_ladder_equals_the_reference_where_planes_are_equal():
    clip = _smooth()
    jl, tl = _ladders()
    jplanes = _record_planes(jl, np.asarray)
    tplanes = _record_planes(tl, lambda p: p.numpy())
    jb = jl.encode([JFrame(*f) for f in clip])
    tb = tl.encode([TFrame(*f) for f in clip])
    # precondition: the port's own scaled planes are the JAX package's
    assert list(tplanes) == list(jplanes) == ["32p", "24p"]
    for name in jplanes:
        for tw, jw in zip(tplanes[name], jplanes[name], strict=True):
            for t, j, plane in zip(tw, jw, "yuv"):
                assert t.shape == j.shape
                ndiff = int((t != j).sum())
                assert ndiff == 0, (f"rung {name} plane {plane}: {ndiff} "
                                    "samples differ from JAX's")
    want = _rung_streams(jb, jl.rungs, jconcat, jladder.rung_segments)
    got = _rung_streams(tb, tl.rungs, tconcat, tladder.rung_segments)
    assert got == want


def test_ladder_refuses_a_mesh_and_needs_the_card():
    rungs = tladder.plan_ladder(_meta(TMeta), _settings(tcfg, qp=QP,
                                                        ladder_rungs=RUNGS))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tladder.LadderShardEncoder(_meta(TMeta), rungs, mesh=object(),
                                   device="cpu")
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError):
            tladder.LadderShardEncoder(_meta(TMeta), rungs,
                                       mesh=["cuda:7"], device="cpu")
    with pytest.raises(ValueError, match="at least one rung"):
        tladder.LadderShardEncoder(_meta(TMeta), [], device="cpu")
    if not torch.cuda.is_available():
        for make in (lambda: tladder.LadderShardEncoder(_meta(TMeta), rungs),
                     lambda: tscale.PlaneScaler(64, 48, 32, 24)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


def test_every_rung_scaled_stages_on_its_own_encoder():
    """All rungs below the source (a remote single-rung shard): a
    source-resolution encoder only plans and stages."""
    clip = _textured(n=8)
    tmeta = _meta(TMeta, n=8)
    rungs = tladder.plan_ladder(tmeta, _settings(tcfg, qp=QP,
                                                 ladder_rungs=RUNGS))[1:]
    tl = tladder.LadderShardEncoder(tmeta, rungs, gop_frames=GOP,
                                    device="cpu")
    assert tl._stager not in tl.encoders and len(tl._all_encoders()) == 3
    tl.gop_index_offset, tl.frame_offset = 5, 40
    assert all(e.gop_index_offset == 5 and e.frame_offset == 40
               for e in tl._all_encoders())
    tl.gop_index_offset, tl.frame_offset = 0, 0
    bundles = tl.encode([TFrame(*f) for f in clip])
    assert [sorted(b.renditions) for b in bundles] == [["24p", "32p"]] * 2
    assert tl.stages.snapshot()["h2d_bytes"] > 0


# ---- HLS packaging -------------------------------------------------------------

def _to_port_segment(seg):
    g = seg.gop
    return TSegment(gop=TGop(index=g.index, start_frame=g.start_frame,
                             num_frames=g.num_frames, idr=g.idr),
                    payload=seg.payload, frame_sizes=tuple(seg.frame_sizes),
                    distortion_sse=seg.distortion_sse,
                    elapsed_s=seg.elapsed_s)


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fp:
                out[os.path.relpath(path, root)] = fp.read()
    return out


@pytest.fixture(scope="module")
def jax_ladder_segments():
    clip = _textured()
    jl, _ = _ladders()
    bundles = jl.encode([JFrame(*f) for f in clip])
    return [(r, jladder.rung_segments(bundles, r.name)) for r in jl.rungs]


@pytest.mark.parametrize("audio", [False, True])
def test_package_ladder_writes_the_reference_tree(tmp_path, audio,
                                                  jax_ladder_segments):
    def track(mod):
        if not audio:
            return None
        return mod.Mp4Track(handler="soun",
                            stsd_entry=mod._box(b"mp4a", b"\x00" * 28),
                            timescale=48000, stts=[(8, 12000)],
                            samples=[bytes([i] * 8) for i in range(8)])

    jstreams = [jhls.RungStream(r.name, r.width, r.height, segs,
                                audio=track(jmp4))
                for r, segs in jax_ladder_segments]
    tstreams = [thls.RungStream(r.name, r.width, r.height,
                                [_to_port_segment(s) for s in segs],
                                audio=track(tmp4))
                for r, segs in jax_ladder_segments]
    jout, tout = str(tmp_path / "ref.hls"), str(tmp_path / "port.hls")
    jmaster = jhls.package_ladder(jout, jstreams, 30, 1, segment_s=0.25)
    tmaster = thls.package_ladder(tout, tstreams, 30, 1, segment_s=0.25)
    assert os.path.relpath(tmaster, tout) == os.path.relpath(jmaster, jout)
    want, got = _tree(jout), _tree(tout)
    assert sorted(got) == sorted(want) and len(got) > 6
    for name in want:
        assert got[name] == want[name], name
    assert thls.lint_ladder(tout, expected_duration_s=N / 30) == \
        jhls.lint_ladder(jout, expected_duration_s=N / 30)
    seg = want[os.path.join("32p", "seg_00000.m4s")]
    assert thls.segment_track_samples(seg) == jhls.segment_track_samples(seg)
    init = want[os.path.join("32p", thls.INIT_NAME)]
    assert thls.init_video_entry(init) == jhls.init_video_entry(init)


def test_package_ladder_refuses_misaligned_rungs(tmp_path,
                                                 jax_ladder_segments):
    (top, tsegs), (low, lsegs) = jax_ladder_segments[:2]
    streams = [thls.RungStream(top.name, top.width, top.height,
                               [_to_port_segment(s) for s in tsegs]),
               thls.RungStream(low.name, low.width, low.height,
                               [_to_port_segment(s) for s in lsegs[:-1]])]
    with pytest.raises(ValueError, match="align"):
        thls.package_ladder(str(tmp_path / "bad.hls"), streams, 30, 1)


def test_live_playlist_renders_as_the_reference():
    def refs(mod):
        parts = [mod.LivePart(f"part_{i}.m4s", 0.13333, True)
                 for i in range(2)]
        segs = [mod.LiveSegmentRef(f"seg_{i:05d}.m4s", 0.26667, list(parts))
                for i in range(3)]
        return segs, parts

    for kw in (dict(preload_uri="part_2.m4s"), dict(event=True, ended=True)):
        texts = []
        for mod in (jhls, thls):
            segs, parts = refs(mod)
            texts.append(mod.render_live_media_playlist(
                segs, parts, media_sequence=4, target_s=0.5,
                part_target_s=0.13333, **kw))
        assert texts[0] == texts[1]
        assert thls.live_playlist_state(texts[1]) == \
            jhls.live_playlist_state(texts[0])
