"""The port's device mesh against the JAX package's, on the CPU.

The port builds a D-wide mesh as ``DeviceMesh(("cpu",) * D)``; the JAX
package runs on ``Mesh(jax.devices()[:D], ("gop",))`` over the
conftest's 8 virtual CPU devices. The same seeded frames go through
both, and the tolerance is 0 bytes unless a case says otherwise:

- GopShardEncoder at D in {2, 3, 4} on a 14-frame clip at gop 4: inter
  with the compact transfer on and off, all-intra, one RD_ALL case, and
  one case whose `max_segments` cap leaves a wave short of D (pad GOPs);
- rate control: the complexity shares at D = 4 within rtol 1e-5 of
  JAX's and equal to the port's own D = 1; `encode_vbr2pass` at D = 2
  gives JAX's QPs and stream;
- the ladder at D = 2: on a clip whose scaled planes equal JAX's (every
  plane is asserted first) every rung equals JAX's; on another clip the
  top rung does;
- split-frame encoding: 4 bands on 1, 2 and 4 entries equal each other
  and JAX's 4-device stream (recon included), 3 bands on 2 entries (a
  2 + 1 split), RD with deblock on 2 entries, the escape's dense rerun
  on 2 entries;
- DeviceMesh itself: entries repeat, a CUDA entry names its card, a
  card the host lacks raises, and a mesh that is not one raises.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch
from jax.sharding import Mesh

from thinvids_tpu.abr import ladder as jladder
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu.parallel import rc as jrc
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core import devices as tdevices
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch
from thinvids_tpu_torch.parallel import rc as trc

torch.set_num_threads(1)

W, H, N, GOP, QP = 64, 48, 14, 4, 28


def _pan(n=N, w=W, h=H, seed=0):
    """A smooth scene panning (2, 1) pel a frame with fresh grain."""
    rng = np.random.default_rng(seed)
    clip = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        yy, xx = yy + i, xx + 2 * i
        y = (128 + 60 * np.sin(xx * 0.11) * np.cos(yy * 0.09)
             + 30 * np.sin((xx + yy) * 0.05) + rng.normal(0, 1.5, (h, w)))
        c = 128 + 40 * np.sin(xx[::2, ::2] * 0.07 + yy[::2, ::2] * 0.03)
        clip.append((np.clip(y, 0, 255).astype(np.uint8),
                     np.clip(c, 0, 255).astype(np.uint8),
                     np.clip(255 - c, 0, 255).astype(np.uint8)))
    return clip


def _bands_clip(w, h, n, step=3, seed=0):
    """tests/test_sfe.py's clip: a pan over a textured scene."""
    rng = np.random.default_rng(seed)
    pad = step * n + 2
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad]
    scene = np.clip((xx * 3 + yy * 2) % 256
                    + rng.normal(0, 2.0, yy.shape), 0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        y = np.ascontiguousarray(scene[pad:pad + h,
                                       pad + step * i:pad + step * i + w])
        u = np.clip(128 + 20 * np.sin(xx[:h // 2, :w // 2] * 0.1 + i),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 20 * np.cos(yy[:h // 2, :w // 2] * 0.1 + i),
                    0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _noise(w, h, n, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _jmesh(d, axis="gop"):
    return Mesh(np.array(jax.devices()[:d]), (axis,))


def _tmesh(d):
    return DeviceMesh(("cpu",) * d)


def _metas(n=N, w=W, h=H):
    return (JMeta(width=w, height=h, fps_num=30, num_frames=n),
            TMeta(width=w, height=h, fps_num=30, num_frames=n))


def _same_segments(tsegs, jsegs):
    assert [dataclasses.astuple(s.gop) for s in tsegs] == \
        [dataclasses.astuple(s.gop) for s in jsegs]
    assert [s.payload for s in tsegs] == [s.payload for s in jsegs]


# ---- the mesh itself --------------------------------------------------------------

def test_device_mesh_entries():
    mesh = DeviceMesh(("cpu",) * 3)
    assert mesh.size == len(mesh) == 3 and mesh.distinct_cards == 1
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.stream(1) is None
    assert mesh.shrink(2) == DeviceMesh(["cpu"])
    assert tdevices.as_mesh(None, "cpu") == DeviceMesh(["cpu"])
    assert tdevices.as_mesh(["cpu", "cpu"]) == DeviceMesh(("cpu", "cpu"))
    assert tdevices.parse_devices("cpu,cpu", "cpu").size == 2
    assert tdevices.parse_devices("", "cpu") == DeviceMesh(["cpu"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdevices.as_mesh(object())
    with pytest.raises(ValueError):
        DeviceMesh(())
    with pytest.raises(ValueError, match="name the card"):
        DeviceMesh(["cuda"])
    if torch.cuda.device_count() < 8:
        # a card the host lacks raises, whether or not there is a card
        with pytest.raises(RuntimeError):
            DeviceMesh(["cuda:7"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdevices.default_mesh()


# ---- GOP waves --------------------------------------------------------------------

_GOP_CASES = {
    "inter": {},
    "inter_sparse2": {"compact_transfer": False},
    "intra": {"inter": False},
}


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("case", list(_GOP_CASES))
def test_gop_waves_on_a_mesh_equal_jax(case, d):
    kw = _GOP_CASES[case]
    clip = _pan()
    jmeta, tmeta = _metas()
    jenc = jdispatch.GopShardEncoder(jmeta, qp=QP, gop_frames=GOP,
                                     mesh=_jmesh(d), **kw)
    tenc = tdispatch.GopShardEncoder(tmeta, qp=QP, gop_frames=GOP,
                                     mesh=_tmesh(d), **kw)
    assert tenc.num_devices == d
    assert dataclasses.astuple(tenc.plan(N)) == \
        dataclasses.astuple(jenc.plan(N))
    jsegs = jenc.encode([JFrame(*f) for f in clip])
    tsegs = tenc.encode([TFrame(*f) for f in clip])
    _same_segments(tsegs, jsegs)
    tsnap, jsnap = tenc.stages.snapshot(), jenc.stages.snapshot()
    for key in ("waves", "fetch_shards", "dense_fallback_waves"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["fetch_shards"] > 0


def test_gop_waves_rd_all_on_a_mesh_equal_jax():
    clip = _pan(n=8)
    jmeta, tmeta = _metas(n=8)
    rd = dict(mode_decision=True, pskip=True, deblock=True,
              aq_q=trdo.aq_from_strength(1.0))
    jenc = jdispatch.GopShardEncoder(jmeta, qp=QP, gop_frames=GOP,
                                     mesh=_jmesh(2),
                                     rd=jrdo.RdConfig(**rd))
    tenc = tdispatch.GopShardEncoder(tmeta, qp=QP, gop_frames=GOP,
                                     mesh=_tmesh(2),
                                     rd=trdo.RdConfig(**rd))
    _same_segments(tenc.encode([TFrame(*f) for f in clip]),
                   jenc.encode([JFrame(*f) for f in clip]))


def test_a_wave_short_of_the_mesh_pads_as_jax_does():
    """max_segments caps the GOP count after the rounding to D: the one
    wave holds 4 GOPs on 3 entries, padded with two repeats of its last
    GOP, which are encoded and dropped."""
    clip = _pan()
    jmeta, tmeta = _metas()
    jenc = jdispatch.GopShardEncoder(jmeta, qp=QP, gop_frames=GOP,
                                     max_segments=4, mesh=_jmesh(3))
    tenc = tdispatch.GopShardEncoder(tmeta, qp=QP, gop_frames=GOP,
                                     max_segments=4, mesh=_tmesh(3))
    assert tenc.plan(N).num_gops == 4
    staged = list(tenc.stage_waves([TFrame(*f) for f in clip]))
    (wave, ys, _us, _vs, qps), = staged
    assert len(wave) == 4 and ys.shape[0] == len(qps) == 6
    assert [int(p.shape[0]) for p in ys] == [2, 2, 2]
    assert torch.equal(ys[2][1], ys[2][0])      # the pad repeats GOP 3
    tsegs = tenc.encode_waves(staged)
    assert len(tsegs) == 4
    _same_segments(tsegs, jenc.encode([JFrame(*f) for f in clip]))


# ---- rate control ------------------------------------------------------------------

def test_complexity_shares_on_a_mesh():
    clip = _pan(n=32)
    jmeta, tmeta = _metas(n=32)
    jenc = jdispatch.GopShardEncoder(jmeta, qp=QP, gop_frames=GOP,
                                     mesh=_jmesh(4))
    want = jrc.analyze_complexity(jenc, [JFrame(*f) for f in clip])
    shares = {}
    for d in (1, 4):
        tenc = tdispatch.GopShardEncoder(tmeta, qp=QP, gop_frames=GOP,
                                         mesh=_tmesh(d))
        shares[d] = trc.analyze_complexity(tenc,
                                           [TFrame(*f) for f in clip])
    np.testing.assert_allclose(shares[4], want, rtol=1e-5)
    np.testing.assert_array_equal(shares[4], shares[1])
    assert len(shares[4]) == 8 and abs(shares[4].sum() - 1.0) < 1e-12


def test_vbr2pass_on_a_mesh_equals_jax():
    clip = _pan(n=16)
    jmeta, tmeta = _metas(n=16)
    jsegs, jstats = jrc.encode_vbr2pass(
        [JFrame(*f) for f in clip], jmeta, 300.0, base_qp=27, gop_frames=4,
        mesh=_jmesh(2))
    tsegs, tstats = trc.encode_vbr2pass(
        [TFrame(*f) for f in clip], tmeta, 300.0, base_qp=27, gop_frames=4,
        mesh=_tmesh(2), device="cpu")
    assert tstats["gop_qps"] == jstats["gop_qps"]
    assert tstats["passes"] == jstats["passes"]
    assert tconcat(tsegs) == jconcat(jsegs)


# ---- the ladder --------------------------------------------------------------------

def _ladders(clip, spec="32,24", d=2):
    n = len(clip)
    jmeta, tmeta = _metas(n=n)
    jr = jladder.plan_ladder(jmeta, jcfg.Settings(values=dict(
        jcfg.DEFAULT_SETTINGS, qp=30, ladder_rungs=spec)))
    tr = tladder.plan_ladder(tmeta, tcfg.Settings(values=dict(
        tcfg.DEFAULT_SETTINGS, qp=30, ladder_rungs=spec)))
    return (jladder.LadderShardEncoder(jmeta, jr, mesh=_jmesh(d),
                                       gop_frames=GOP),
            tladder.LadderShardEncoder(tmeta, tr, mesh=_tmesh(d),
                                       gop_frames=GOP, device="cpu"))


def _record(ladder, to_np):
    """Every scaled plane `ladder` makes, per GOP: {rung: sorted list of
    (y, u, v) bytes}. A mesh scales each entry's run from its own
    thread, so calls arrive in any order; per-GOP bytes do not."""
    seen = {}
    for rung, scaler in zip(ladder.rungs, ladder.scalers):
        if scaler is None:
            continue
        seen[rung.name] = []

        def rec(ys, us, vs, _scale=scaler.scale_wave, _out=seen[rung.name]):
            planes = _scale(ys, us, vs)
            arrs = [to_np(p) for p in planes]
            _out.extend(tuple(a[g].tobytes() for a in arrs)
                        for g in range(arrs[0].shape[0]))
            return planes

        scaler.scale_wave = rec
    return seen


def _rungs(bundles, rungs, concat, segments):
    return {r.name: concat(segments(bundles, r.name)) for r in rungs}


def test_ladder_on_a_mesh_equals_jax_where_the_planes_are_equal():
    clip = _pan(n=16, seed=3)
    jl, tl = _ladders(clip)
    jseen = _record(jl, np.asarray)
    tseen = _record(tl, lambda p: p.numpy())
    jb = jl.encode([JFrame(*f) for f in clip])
    tb = tl.encode([TFrame(*f) for f in clip])
    assert list(tseen) == list(jseen) == ["32p", "24p"]
    for name in jseen:
        assert sorted(tseen[name]) == sorted(jseen[name]), name
    want = _rungs(jb, jl.rungs, jconcat, jladder.rung_segments)
    got = _rungs(tb, tl.rungs, tconcat, tladder.rung_segments)
    assert got == want and len(got) == 3
    assert tl.num_devices == 2


def test_ladder_top_rung_on_a_mesh_equals_jax():
    """Content whose chroma lands samples on a half: the top rung (never
    scaled) equals JAX's, and every rung of the port's equals the port's
    own on one entry (16 frames at gop 4 plan the same four GOPs on one
    entry and on two): each entry's run scales to the bits the whole
    wave does."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (xx * 1.7 + yy * 0.9) % 256 + 20 * np.sin(xx * 0.2)
    clip = [(np.clip(base + 5 * i + rng.normal(0, 3, (H, W)), 0,
                     255).astype(np.uint8),
             np.clip(120 + 30 * np.sin(yy[::2, ::2] * 0.05 + i), 0,
                     255).astype(np.uint8),
             np.clip(130 + 30 * np.cos(xx[::2, ::2] * 0.04 + i), 0,
                     255).astype(np.uint8)) for i in range(16)]
    jl, tl = _ladders(clip)
    _, t1 = _ladders(clip, d=1)
    want = _rungs(jl.encode([JFrame(*f) for f in clip]), jl.rungs, jconcat,
                  jladder.rung_segments)
    got = _rungs(tl.encode([TFrame(*f) for f in clip]), tl.rungs, tconcat,
                 tladder.rung_segments)
    one = _rungs(t1.encode([TFrame(*f) for f in clip]), t1.rungs, tconcat,
                 tladder.rung_segments)
    assert got["48p"] == want["48p"]
    assert got == one


# ---- split-frame encoding -----------------------------------------------------------

def _sfe(frames, w, h, bands, d, qp=27, gop=3, rd=None):
    n = len(frames)
    jmeta = JMeta(width=w, height=h, num_frames=n)
    tmeta = TMeta(width=w, height=h, num_frames=n)
    tenc = tdispatch.SfeShardEncoder(
        tmeta, qp=qp, gop_frames=gop, bands=bands, halo_rows=32,
        rd=trdo.RdConfig(**rd) if rd else None, mesh=_tmesh(d))
    tenc.keep_recon = True
    ts = tconcat(tenc.encode([TFrame(*f) for f in frames]))
    return tenc, ts, jmeta


def _jax_sfe(frames, jmeta, bands, qp=27, gop=3, rd=None):
    jenc = jdispatch.SfeShardEncoder(
        jmeta, qp=qp, gop_frames=gop, bands=bands, halo_rows=32,
        rd=jrdo.RdConfig(**rd) if rd else None,
        mesh=_jmesh(bands, "gop"))
    jenc.keep_recon = True
    return jenc, jconcat(jenc.encode([JFrame(*f) for f in frames]))


def test_sfe_four_bands_on_one_two_and_four_entries_equal_jax():
    w, h, n = 64, 128, 6
    frames = _bands_clip(w, h, n)
    streams = {}
    for d in (1, 2, 4):
        tenc, ts, jmeta = _sfe(frames, w, h, 4, d)
        assert tenc.num_devices == d and tenc.num_bands == 4
        streams[d] = (ts, tenc.recon_frames)
    jenc, js = _jax_sfe(frames, jmeta, 4)
    for d, (ts, recon) in streams.items():
        assert ts == js, d
        for i in range(n):
            for a, b in zip(recon[i], jenc.recon_frames[i]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["three_bands_two_entries", "rd_deblock",
                                  "escape_dense_rerun"])
def test_sfe_on_two_entries_equals_jax(case):
    rd = None
    if case == "three_bands_two_entries":
        w, h, bands, qp, frames = 64, 112, 3, 27, _bands_clip(64, 112, 4)
    elif case == "rd_deblock":
        w, h, bands, qp, frames = 96, 112, 3, 27, _bands_clip(96, 112, 4)
        rd = dict(mode_decision=True, pskip=True, deblock=True)
    else:
        w, h, bands, qp, frames = 64, 128, 4, 4, _noise(64, 128, 4)
    tenc, ts, jmeta = _sfe(frames, w, h, bands, 2, qp=qp, gop=4, rd=rd)
    assert tenc._band_runs == ((0, 2), (2, bands))
    jenc, js = _jax_sfe(frames, jmeta, bands, qp=qp, gop=4, rd=rd)
    assert ts == js
    for i in range(len(frames)):
        for a, b in zip(tenc.recon_frames[i], jenc.recon_frames[i]):
            np.testing.assert_array_equal(a, b)
    tsnap, jsnap = tenc.stages.snapshot(), jenc.stages.snapshot()
    for key in ("sfe_frames", "dense_fallback_waves", "waves"):
        assert tsnap[key] == jsnap[key], key
    if case == "escape_dense_rerun":
        assert tsnap["dense_fallback_waves"] >= 1


def test_sfe_bands_default_to_one_per_entry_and_stay_uncapped():
    meta = TMeta(width=64, height=192, num_frames=4)
    assert tdispatch.SfeShardEncoder(meta, mesh=_tmesh(3)).num_bands == 3
    wide = tdispatch.SfeShardEncoder(meta, bands=6, mesh=_tmesh(2))
    assert wide.num_bands == 6 and wide._band_runs == ((0, 3), (3, 6))
    narrow = tdispatch.SfeShardEncoder(meta, bands=2, mesh=_tmesh(4))
    assert narrow.num_devices == 2      # an entry a band, the rest idle


# ---- one host thread over the entries -------------------------------------------

def test_eight_entries_under_thread_pressure_give_one_entrys_bytes():
    """Eight entries with the interpreter switching threads every 10 us
    (the staging thread, the collector and the fetch pool run beside the
    thread that enqueues every entry's work): the exchanges between the
    runs and the fetch pool keep the GOP and split-frame bytes equal to
    one entry's."""
    import sys

    w, h, n = 64, 256, 3
    frames = [TFrame(*f) for f in _bands_clip(w, h, n)]
    meta = TMeta(width=w, height=h, num_frames=n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = {}
        for d in (1, 8):
            sfe = tdispatch.SfeShardEncoder(meta, gop_frames=3, bands=8,
                                            halo_rows=16, mesh=_tmesh(d))
            gop = tdispatch.GopShardEncoder(meta, gop_frames=1,
                                            gops_per_wave=1, mesh=_tmesh(d))
            got[d] = (tconcat(sfe.encode(frames)),
                      [s.payload for s in gop.encode(frames)])
            assert sfe.num_devices == d
    finally:
        sys.setswitchinterval(old)
    assert got[8][0] == got[1][0]
    # one GOP a frame: 3 frames plan 3 GOPs on either mesh (rounding to
    # 8 would leave GOPs without a frame), and the wave pads to 8 entries
    assert len(got[8][1]) == 3 and got[8][1] == got[1][1]


def test_a_failing_entry_raises_its_own_error(monkeypatch):
    """One entry's step raises: the encode stops and raises that entry's
    error."""
    real = tdispatch._sfe_p_step

    def boom(*args, **kw):
        edge_top, _ = args[9]
        if not edge_top:                # the second entry's run
            raise RuntimeError("entry 1 lost its card")
        return real(*args, **kw)

    monkeypatch.setattr(tdispatch, "_sfe_p_step", boom)
    w, h, n = 64, 128, 3
    enc = tdispatch.SfeShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                    gop_frames=3, bands=4, mesh=_tmesh(2))
    with pytest.raises(RuntimeError, match="entry 1 lost its card"):
        enc.encode([TFrame(*f) for f in _bands_clip(w, h, n)])
