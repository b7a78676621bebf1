"""Port parity for rate control (thinvids_tpu_torch/parallel/rc.py):
the same seeded clips through the JAX package's rc and the port's.

- the numpy helpers (jnd_masked_shares, solve_gop_qps, ladder_rung_qps,
  refine_gop_qps) give the reference's values on seeded inputs;
- `GopShardEncoder.stage_luma_waves` stages the reference's luma planes
  (a short last GOP included) and uploads luma only;
- the complexity stats are exact (an int64 sum of |diffs| over its
  count: the same value on every device), the shares are within rtol
  1e-5 of the JAX package's float32 means and sum to 1, and the per-GOP
  QP vectors solved from them are equal;
- `encode_vbr2pass` at 200 and 600 kbps, at an unreachable 5000 kbps and
  with aq_strength 1.0 gives the reference's gop_qps, passes and segment
  bytes;
- the entry points default to the card and raise without one; a mesh
  that is not a DeviceMesh raises TypeError, and a mesh entry naming a
  card the host lacks raises (tests/test_torch_mesh.py runs the mesh).

The reference runs on a one-device mesh with the port's wave grouping
(4 GOPs a wave), so the JAX side compiles one GOP program.
"""

import numpy as np
import pytest

import jax
import torch

from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu.parallel import rc as jrc
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.parallel import dispatch as tdispatch
from thinvids_tpu_torch.parallel import rc as trc

torch.set_num_threads(1)


def _one_device_mesh():
    return jdispatch.default_mesh(jax.devices()[:1])


def _clip(n=32, w=128, h=64, seed=0):
    """tests/test_rc.py's clip: half flat, half busy content, so the
    complexity shares differ. (y, u, v) planes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        if i < n // 2:
            y = np.full((h, w), 120, np.uint8)
        else:
            y = ((xx * 3 + yy + 5 * i) % 256).astype(np.uint8)
            y = np.clip(y + rng.integers(-20, 21, (h, w)), 0,
                        255).astype(np.uint8)
        out.append((y, np.full((h // 2, w // 2), 110, np.uint8),
                    np.full((h // 2, w // 2), 140, np.uint8)))
    return out


def _metas(clip):
    h, w = clip[0][0].shape
    kw = dict(width=w, height=h, fps_num=30, fps_den=1, num_frames=len(clip))
    return JMeta(**kw), TMeta(**kw)


def _encoders(clip, qp=27, gop=4):
    jmeta, tmeta = _metas(clip)
    return (jdispatch.GopShardEncoder(jmeta, qp=qp, gop_frames=gop,
                                      mesh=_one_device_mesh()),
            tdispatch.GopShardEncoder(tmeta, qp=qp, gop_frames=gop,
                                      device="cpu"))


# ---- the numpy helpers -------------------------------------------------------

def test_constants_equal_the_reference():
    assert (trc.QP_MIN, trc.QP_MAX, trc._QP_PER_OCTAVE) == \
        (jrc.QP_MIN, jrc.QP_MAX, jrc._QP_PER_OCTAVE)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_numpy_helpers_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = int(rng.integers(1, 12))
    shares = rng.random(g)
    shares /= shares.sum()
    for s in (0.0, 0.5, 1.0, 2.0):
        np.testing.assert_array_equal(trc.jnd_masked_shares(shares, s),
                                      jrc.jnd_masked_shares(shares, s))
    nbytes = rng.integers(100, 50_000, g).astype(np.float64)
    for target in (1e3, 1e5, float(nbytes.sum()) * 8, 1e8, 0.0):
        for mod in (2.0, 0.5):
            np.testing.assert_array_equal(
                trc.solve_gop_qps(27, nbytes, shares, target, mod),
                jrc.solve_gop_qps(27, nbytes, shares, target, mod))
    ratios = np.concatenate([[1.0], rng.random(5)])
    for alpha in (0.75, 0.5, 1.0):
        for base in (10, 27, 48):
            np.testing.assert_array_equal(
                trc.ladder_rung_qps(base, ratios, alpha),
                jrc.ladder_rung_qps(base, ratios, alpha))
    prev = rng.integers(10, 49, g).astype(np.int32)
    for actual, target in ((1e6, 5e5), (5e5, 1e6), (0.0, 1e5), (1e5, 0.0)):
        np.testing.assert_array_equal(
            trc.refine_gop_qps(prev, actual, target),
            jrc.refine_gop_qps(prev, actual, target))


# ---- staging and the complexity stats ------------------------------------------

def test_stage_luma_waves_gives_the_reference_planes():
    clip = _clip(n=30)               # 8 GOPs, the last one short
    jenc, tenc = _encoders(clip)
    jw = list(jenc.stage_luma_waves([JFrame(*f) for f in clip]))
    tw = list(tenc.stage_luma_waves([TFrame(*f) for f in clip]))
    assert len(jw) == len(tw) == 2
    for (jwave, jys), (twave, tys) in zip(jw, tw):
        assert [(g.index, g.start_frame, g.num_frames) for g in twave] == \
            [(g.index, g.start_frame, g.num_frames) for g in jwave]
        assert tys.dtype == torch.uint8 and tys.device.type == "cpu"
        np.testing.assert_array_equal(tys.numpy(), np.asarray(jys))
    # the short last GOP is tail-repeated to the wave's static F
    last = tw[-1][0][-1]
    assert last.num_frames < 4 and tw[-1][1].shape[1] == 4
    # luma only: the h2d counter holds exactly the luma stacks
    assert tenc.stages.snapshot()["h2d_bytes"] == \
        sum(ys.numel() for _, ys in tw)


def test_complexity_stats_are_exact():
    """The port's stats equal a float64 numpy computation of the same
    integer sums over their counts, bit for bit."""
    rng = np.random.default_rng(5)
    ys = rng.integers(0, 256, (3, 5, 32, 48), dtype=np.uint8)
    ys[1] = 7                                        # a flat GOP
    local, total = trc._complexity_stats(torch.from_numpy(ys))
    y = ys.astype(np.int64)
    want = []
    for g in range(3):
        t = np.abs(y[g, 1:] - y[g, :-1]).sum() / y[g, 1:].size
        g0 = y[g, 0]
        grad = (np.abs(g0[:, 1:] - g0[:, :-1]).sum() / g0[:, 1:].size
                + np.abs(g0[1:] - g0[:-1]).sum() / g0[1:].size)
        want.append(t + 0.5 * grad)
    assert local.dtype == torch.float64
    np.testing.assert_array_equal(local.numpy(), np.asarray(want))
    np.testing.assert_array_equal(total.numpy(), np.full(3, sum(want)))
    one, _ = trc._complexity_stats(torch.from_numpy(ys[:, :1]))
    assert one[1].item() == 0.0


@pytest.mark.parametrize("n", [32, 30])
def test_complexity_shares_match_the_reference(n):
    clip = _clip(n=n)
    jenc, tenc = _encoders(clip)
    js = jrc.analyze_complexity(jenc, [JFrame(*f) for f in clip])
    ts = trc.analyze_complexity(tenc, [TFrame(*f) for f in clip])
    assert ts.dtype == np.float64 and len(ts) == len(js) == -(-n // 4)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    assert abs(ts.sum() - 1.0) < 1e-12
    if n == 32:                  # GOPs 4-7 are the busy half
        assert ts[4:].sum() > 0.9


def test_solved_qp_vectors_equal_the_reference():
    clip = _clip()
    jenc, tenc = _encoders(clip)
    jframes = [JFrame(*f) for f in clip]
    tframes = [TFrame(*f) for f in clip]
    jshares = jrc.analyze_complexity(jenc, jframes)
    tshares = trc.analyze_complexity(tenc, tframes)
    jsegs = jenc.encode_waves(jenc.stage_waves(jframes))
    tsegs = tenc.encode_waves(tenc.stage_waves(tframes))
    assert [s.payload for s in tsegs] == [s.payload for s in jsegs]
    nbytes = np.asarray([len(s.payload) for s in tsegs], np.float64)
    for target in (30_000.0, 100_000.0, 300_000.0, 1e6):
        for aq in (0.0, 1.0):
            np.testing.assert_array_equal(
                trc.solve_gop_qps(27, nbytes,
                                  trc.jnd_masked_shares(tshares, aq), target),
                jrc.solve_gop_qps(27, nbytes,
                                  jrc.jnd_masked_shares(jshares, aq), target))


# ---- the two-pass loop ---------------------------------------------------------

@pytest.mark.parametrize("kbps,aq", [(200.0, 0.0), (600.0, 0.0),
                                     (5000.0, 0.0), (600.0, 1.0)])
def test_encode_vbr2pass_matches_the_reference(kbps, aq):
    clip = _clip()
    jmeta, tmeta = _metas(clip)
    jsegs, jstats = jrc.encode_vbr2pass(
        [JFrame(*f) for f in clip], jmeta, kbps, base_qp=27, gop_frames=4,
        mesh=_one_device_mesh(), aq_strength=aq)
    passes = []
    tsegs, tstats = trc.encode_vbr2pass(
        [TFrame(*f) for f in clip], tmeta, kbps, base_qp=27, gop_frames=4,
        aq_strength=aq, device="cpu",
        on_pass=lambda p, q: passes.append((p, None if q is None
                                            else q.tolist())))
    assert tstats["gop_qps"] == jstats["gop_qps"]
    assert tstats["passes"] == jstats["passes"]
    assert [s.payload for s in tsegs] == [s.payload for s in jsegs]
    for key in ("pass1_bits", "pass2_bits", "target_bits"):
        assert tstats[key] == jstats[key], key
    np.testing.assert_allclose(tstats["complexity_shares"],
                               jstats["complexity_shares"], rtol=1e-5)
    assert [p for p, _ in passes] == list(range(1, tstats["passes"] + 1))
    assert passes[0][1] is None and passes[-1][1] == tstats["gop_qps"]
    if kbps == 5000.0:      # unreachable: the loop stops at the QP floor
        assert all(q == trc.QP_MIN for q in tstats["gop_qps"])
        assert tstats["pass2_bits"] < tstats["target_bits"]


def test_encode_vbr2pass_reuses_an_injected_encoder():
    """The executor's form: its own encoder and encode function; every
    pass goes through them, the last one at the solved QPs."""
    clip = _clip(n=16)
    _, tmeta = _metas(clip)
    frames = [TFrame(*f) for f in clip]
    enc = tdispatch.GopShardEncoder(tmeta, qp=27, gop_frames=4,
                                    device="cpu")
    seen = []

    def encode_fn(e):
        seen.append(dict(e.gop_qp))
        return e.encode(frames)

    segs, stats = trc.encode_vbr2pass(frames, tmeta, 600.0, base_qp=27,
                                      enc=enc, encode_fn=encode_fn)
    assert len(seen) == stats["passes"] and seen[0] == {}
    assert seen[-1] == {i: q for i, q in enumerate(stats["gop_qps"])}
    assert len(segs) == 4 and stats["passes"] >= 2


def test_entry_points_need_the_card_or_refuse_a_mesh():
    clip = _clip(n=8)
    _, tmeta = _metas(clip)
    frames = [TFrame(*f) for f in clip]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trc.encode_vbr2pass(frames, tmeta, 200.0, gop_frames=4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        trc.encode_vbr2pass(frames, tmeta, 200.0, gop_frames=4,
                            mesh=object(), device="cpu")
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError):
            trc.encode_vbr2pass(frames, tmeta, 200.0, gop_frames=4,
                                mesh=["cuda:7"], device="cpu")
