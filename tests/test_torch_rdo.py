"""Port parity for the rate-distortion features: SATD intra mode
decision, variance AQ (per-MB QP) and the P_Skip bias.

- rdo's numpy twins and constants equal the reference's;
- torchcore's SATD, activity, AQ map, greedy selection, three-way pick
  and chroma DC prediction equal jaxcore's;
- `_intra_core` gives jaxcore's ten outputs (levels, recon, modes, QP
  deltas) under five RD configs, and the all-intra encoder its bytes;
- `encode_gop` gives the JAX package's stream and recon with mode
  decision + AQ, with every feature on, and with the P_Skip bias alone,
  and the reference's decoder decodes the port's stream to the port's
  recon.

Seeded numpy inputs, zero tolerance. (The deblocking filter's parity is
tests/test_torch_deblock.py; the RD configs through GopShardEncoder and
a job are tests/test_torch_job.py.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bench import make_frames
from thinvids_tpu.codecs.h264 import decoder as jdec
from thinvids_tpu.codecs.h264 import encoder as jencoder
from thinvids_tpu.codecs.h264 import jaxcore
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.codecs.h264 import torchcore
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta

torch.set_num_threads(1)

_jcore = jax.jit(jaxcore._intra_core, static_argnames=("mbw", "mbh", "rd"))


def _both(**kw):
    """(port, reference) RdConfig pair of the same fields."""
    return trdo.RdConfig(**kw), jrdo.RdConfig(**kw)


# ---- rdo: constants and numpy twins ------------------------------------

def test_rdo_constants_and_config_match():
    for name in ("AQ_QUANT", "AQ_MAX_DELTA", "PSKIP_SUM", "AQ_ACT_BITS"):
        assert getattr(trdo, name) == getattr(jrdo, name), name
    assert not hasattr(trdo, "require_rd_off")
    for s in (0.0, 0.3, 1.0, 2.6, 10.0):
        assert trdo.aq_from_strength(s) == jrdo.aq_from_strength(s)
    t, j = _both(mode_decision=True, aq_q=4)
    assert (t.ships_modes, t.aq, t.aq_strength) == \
        (j.ships_modes, j.aq, j.aq_strength)


def test_numpy_twins_match():
    rng = np.random.default_rng(11)
    for _ in range(20):
        r16 = rng.integers(-255, 256, (16, 16)).astype(np.int32)
        r8 = rng.integers(-255, 256, (8, 8)).astype(np.int32)
        assert trdo.satd16_np(r16) == jrdo.satd16_np(r16)
        assert trdo.satd8_np(r8) == jrdo.satd8_np(r8)
    y = make_frames(1, 320, 256, seed=8)[0].y
    np.testing.assert_array_equal(trdo.mb_activity_np(y, 20, 16),
                                  jrdo.mb_activity_np(y, 20, 16))
    act = rng.integers(0, 33, 77)
    for aq_q in (0, 1, 4, 12):
        np.testing.assert_array_equal(
            trdo.aq_offsets_from_activity(act, aq_q),
            jrdo.aq_offsets_from_activity(act, aq_q))
        np.testing.assert_array_equal(trdo.aq_offsets_np(y, aq_q, 20, 16),
                                      jrdo.aq_offsets_np(y, aq_q, 20, 16))
    off = rng.integers(-6, 7, 50)
    for base in (0, 3, 27, 49):
        np.testing.assert_array_equal(trdo.clamp_qp_map(base, off),
                                      jrdo.clamp_qp_map(base, off))


def test_quality_metrics_match():
    from thinvids_tpu.tools import metrics as jmetrics
    from thinvids_tpu_torch.tools import metrics as tmetrics

    frames = make_frames(3, 64, 48, seed=4)
    rng = np.random.default_rng(4)
    dist = [np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                    0, 255).astype(np.uint8) for f in frames]
    for f, d in zip(frames, dist):
        assert tmetrics.psnr(f.y, d) == jmetrics.psnr(f.y, d)
        assert tmetrics.ssim(f.y, d) == jmetrics.ssim(f.y, d)
    assert tmetrics.psnr(dist[0], dist[0]) == float("inf")
    for p, s in ((37.54, 0.9146), (float("inf"), 1.0), (20.0, 0.5)):
        assert tmetrics.vmaf_proxy(p, s) == jmetrics.vmaf_proxy(p, s)
    assert tmetrics.clip_quality(frames, dist) == \
        jmetrics.clip_quality(frames, dist)


# ---- torchcore helpers ---------------------------------------------------

def test_satd_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    r16 = rng.integers(-255, 256, (9, 16, 16)).astype(np.int32)
    r8 = rng.integers(-255, 256, (9, 8, 8)).astype(np.int32)
    s16 = torchcore._satd16(torch.from_numpy(r16))
    s8 = torchcore._satd8(torch.from_numpy(r8))
    assert s16.dtype == s8.dtype == torch.int32
    np.testing.assert_array_equal(s16.numpy(),
                                  np.asarray(jaxcore._satd16(jnp.asarray(r16))))
    np.testing.assert_array_equal(s8.numpy(),
                                  np.asarray(jaxcore._satd8(jnp.asarray(r8))))
    assert s16.tolist() == [jrdo.satd16_np(r) for r in r16]
    assert s8.tolist() == [jrdo.satd8_np(r) for r in r8]


@pytest.mark.parametrize("kind", ["alternating", "content"])
def test_mb_activity_matches(kind):
    mbh, mbw = 3, 4
    if kind == "alternating":
        # the largest variance a 16x16 block can hold (V = 256·Σx² −
        # (Σx)² ≈ 1.07e9), and a flat 255 block, whose 256·Σx² term
        # (≈ 4.26e9) is past int32 before the (Σx)² term cancels it
        yy, xx = np.mgrid[0:16 * mbh, 0:16 * mbw]
        y = (((yy + xx) % 2) * 255).astype(np.uint8)
        y[:16, :16] = 255
    else:
        y = make_frames(1, 16 * mbw, 16 * mbh, seed=2)[0].y
    got = torchcore._mb_activity(torch.from_numpy(y).to(torch.int32), mbw,
                                 mbh)
    want = np.asarray(jaxcore._mb_activity(jnp.asarray(y, jnp.int32), mbw,
                                           mbh))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, jrdo.mb_activity_np(y, mbw, mbh))
    if kind == "alternating":
        assert want[0] == 0 and (want[1:] == 29).all()


@pytest.mark.parametrize("qp,aq_q", [(27, 4), (50, 12), (2, 7), (30, 1)])
def test_aq_qp_map_matches(qp, aq_q):
    y = make_frames(1, 128, 96, seed=qp)[0].y
    got = torchcore._aq_qp_map(torch.from_numpy(y).to(torch.int32), qp,
                               aq_q, 8, 6)
    want = np.asarray(jaxcore._aq_qp_map(jnp.asarray(y, jnp.int32),
                                         jnp.int32(qp), aq_q, 8, 6))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, jrdo.clamp_qp_map(qp, jrdo.aq_offsets_np(y, aq_q, 8, 6)))


def test_greedy_pick3_and_chroma_dc_pred_match():
    rng = np.random.default_rng(5)
    cases = [rng.random(23) < p for p in (0.2, 0.5, 0.8)]
    cases += [np.ones(9, bool), np.zeros(9, bool), np.arange(12) % 2 == 0,
              np.ones(1, bool)]
    for d in cases:
        np.testing.assert_array_equal(
            torchcore._greedy_allowed(torch.from_numpy(d)).numpy(),
            np.asarray(jaxcore._greedy_allowed(jnp.asarray(d))))
    # ties included: strict-< keeps the earlier candidate
    c = [rng.integers(0, 6, 40).astype(np.int32) for _ in range(3)]
    tb, tm = torchcore._pick3(torch.from_numpy(c[0]), 0,
                              torch.from_numpy(c[1]), 1,
                              torch.from_numpy(c[2]), 2)
    jb, jm = jaxcore._pick3(jnp.asarray(c[0]), 0, jnp.asarray(c[1]), 1,
                            jnp.asarray(c[2]), 2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    ts = rng.integers(0, 1021, (8, 2)).astype(np.int32)
    ls = rng.integers(0, 1021, (8, 2)).astype(np.int32)
    left = np.array([0, 1, 1, 0, 1, 1, 0, 1], bool)
    top = np.array([1, 0, 1, 1, 1, 0, 1, 1], bool)
    got = torchcore._chroma_dc_pred_row(*(torch.from_numpy(a) for a in
                                          (ts, ls, left, top)))
    want = jaxcore._chroma_dc_pred_row(*(jnp.asarray(a) for a in
                                         (ts, ls, left, top)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the intra core ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(mode_decision=True), dict(aq_q=4),
    dict(mode_decision=True, aq_q=6), dict(aq_q=12)],
    ids=["off", "md", "aq4", "md_aq6", "aq12"])
def test_intra_core_matches(kw):
    f = make_frames(1, 144, 112, seed=3)[0].padded(16)
    mbh, mbw = f.y.shape[0] // 16, f.y.shape[1] // 16
    trd, jrd = _both(**kw)
    for qp in (27, 40):
        got = torchcore._intra_core(
            *(torch.from_numpy(p) for p in (f.y, f.u, f.v)), qp, mbw=mbw,
            mbh=mbh, rd=trd)
        want = _jcore(*(jnp.asarray(p) for p in (f.y, f.u, f.v)),
                      jnp.int32(qp), mbw=mbw, mbh=mbh, rd=jrd)
        assert len(got) == len(want) == 10
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == torch.int32, i
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"output {i} qp {qp}")
    modes = got[7].numpy()
    if trd.mode_decision:     # all three luma modes in play on texture
        assert set(np.unique(modes)) >= {0, 1, 2}
    assert got[9].numpy().any() == trd.aq


def test_intra_encoder_with_mode_decision_and_aq_matches():
    w, h = 96, 80
    trd, jrd = _both(mode_decision=True, aq_q=4)
    frames = make_frames(2, w, h, seed=9)
    tenc = tencoder.H264Encoder(TMeta(width=w, height=h), qp=27, rd=trd,
                                device="cpu")
    jenc = jencoder.H264Encoder(JMeta(width=w, height=h), qp=27, rd=jrd)
    for i, f in enumerate(frames):
        assert tenc.encode_frame(TFrame(y=f.y, u=f.u, v=f.v),
                                 idr_pic_id=i) == \
            jenc.encode_frame(f, idr_pic_id=i)
    p = frames[0].padded(16)
    got = torchcore.encode_intra(p.y, p.u, p.v, 27, trd, device="cpu")
    want = jaxcore.encode_intra_jax(p.y, p.u, p.v, 27, jrd)
    for name in ("luma_mode", "chroma_mode", "qp_delta", "luma_dc",
                 "luma_ac", "chroma_dc", "chroma_ac"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert torchcore.intra_flat_len(30, trd) == \
        jaxcore.intra_flat_len(30, jrd) == 30 * 386


# ---- the P frame -----------------------------------------------------------

@pytest.mark.parametrize("qp", [20, 30])
def test_residual_p_with_pskip_and_deblock_matches(qp):
    """The P_Skip bias on the levels and recon, and nz4 from the final
    (bias-zeroed) luma levels, against jaxinter._residual_p."""
    from thinvids_tpu.codecs.h264 import jaxinter
    from thinvids_tpu_torch.codecs.h264 import torchinter

    w, h = 96, 80
    f0, f1 = make_frames(2, w, h, seed=qp)
    rng = np.random.default_rng(qp)
    cur = [p.astype(np.int16) for p in (f1.y, f1.u, f1.v)]
    # a prediction close to the source, so some MBs quantize to ~0
    pred = [np.clip(p.astype(np.int32) + rng.integers(-2, 3, p.shape),
                    0, 255).astype(np.int16) for p in (f1.y, f1.u, f1.v)]
    pred[0][:, :48] = np.clip(cur[0][:, :48] + 40, 0, 255)  # and some not
    qpc = torchcore.chroma_qp(qp)
    trd, jrd = _both(pskip=True, deblock=True)
    got = torchinter._residual_p(
        *(torch.from_numpy(a) for a in cur + pred), qp, qpc, mbw=w // 16,
        mbh=h // 16, rd=trd)
    want = jax.jit(jaxinter._residual_p,
                   static_argnames=("mbw", "mbh", "blocked", "rd"))(
        *(jnp.asarray(a) for a in cur + pred), jnp.int32(qp),
        jnp.int32(qpc), mbw=w // 16, mbh=h // 16, blocked=False, rd=jrd)
    assert len(got) == len(want) == 7
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"output {i}")
    nz4 = got[6].numpy()
    assert nz4.any() and not nz4.all()


# ---- encode_gop ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(mode_decision=True, aq_q=4),
    dict(mode_decision=True, pskip=True, deblock=True,
         aq_q=jrdo.aq_from_strength(1.0)),
    dict(pskip=True)], ids=["md_aq4", "all", "pskip"])
def test_encode_gop_with_rd_matches(kw):
    w, h, n = 96, 80, 4
    frames = make_frames(n, w, h)
    trd, jrd = _both(**kw)
    want, wrec = jencoder.encode_gop(
        frames, JMeta(width=w, height=h, fps_num=30, fps_den=1,
                      num_frames=n), qp=27, return_recon=True, rd=jrd)
    got, grec = tencoder.encode_gop(
        [TFrame(y=f.y, u=f.u, v=f.v) for f in frames],
        TMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n),
        qp=27, return_recon=True, rd=trd, device="cpu")
    for i in range(n):
        for a, b, name in zip(grec, wrec, "yuv"):
            np.testing.assert_array_equal(a[i], np.asarray(b)[i],
                                          err_msg=f"frame {i} {name}")
    assert got == want
    dec = jdec.decode_annexb(got)
    assert len(dec.frames) == n
    for i in range(n):
        np.testing.assert_array_equal(dec.frames[i].y, grec[0][i][:h, :w])
        np.testing.assert_array_equal(dec.frames[i].v,
                                      grec[2][i][:h // 2, :w // 2])
