"""Port parity for the all-intra path and the codec surface: the same
seeded frames through the JAX package and the port (on the CPU) give the
same levels, sparse transfer, recon and bytes.

- torchcore: `_flat_levels`, the element-granular `_sparse_pack`
  (escapes and budget overflow included) and its host inverse,
  `encode_intra`;
- encoder: `H264Encoder` / `encode_frames` (all-intra) and `encode_gop`
  with its recon;
- dispatch: the all-intra GopShardEncoder wave, per-GOP QP overrides and
  the dense fallback.

JAX-side encoders run on one device of conftest's virtual CPU mesh.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from thinvids_tpu.codecs.h264 import encoder as jencoder
from thinvids_tpu.codecs.h264 import jaxcore
from thinvids_tpu.codecs.h264.rdo import RdConfig as JRdConfig
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.codecs import h264 as th264
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import torchcore
from thinvids_tpu_torch.codecs.h264.rdo import RdConfig
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

_jflat = jax.jit(jdispatch._flat_levels, static_argnames=("mbw", "mbh"))
_jsparse = jax.jit(jaxcore._sparse_pack)


def _smooth_clip(n, w, h, seed=0):
    """Smooth panning scene with light grain: inside every sparse budget."""
    rng = np.random.default_rng(seed)
    clip = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (128 + 50 * np.sin((xx + 2 * i) * 0.1) * np.cos((yy + i) * 0.08)
             + rng.normal(0, 1.0, (h, w)))
        c = 128 + 30 * np.sin(xx[::2, ::2] * 0.06 + i * 0.1)
        clip.append((np.clip(y, 0, 255).astype(np.uint8),
                     np.clip(c, 0, 255).astype(np.uint8),
                     np.clip(255 - c, 0, 255).astype(np.uint8)))
    return clip


def _noise_clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _saturated_clip(n, w, h):
    """Smooth luma + saturated chroma: chroma DC escapes int8 at low QP."""
    yy, xx = np.mgrid[0:h, 0:w]
    return [(np.clip(xx // 4 * 2 + 60 + 2 * i, 0, 255).astype(np.uint8),
             np.full((h // 2, w // 2), 235, np.uint8),
             np.full((h // 2, w // 2), 20, np.uint8)) for i in range(n)]


def _planes(f):
    """One padded frame's planes as (torch CPU, jnp) triples + MB dims."""
    p = TFrame(*f).padded(16)
    mbh, mbw = p.y.shape[0] // 16, p.y.shape[1] // 16
    return ((torch.from_numpy(p.y), torch.from_numpy(p.u),
             torch.from_numpy(p.v)),
            (jnp.asarray(p.y), jnp.asarray(p.u), jnp.asarray(p.v)), mbw, mbh)


def _assert_levels_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x, np.int64),
                                          np.asarray(y, np.int64),
                                          err_msg=f.name)


# ---- torchcore ------------------------------------------------------------

@pytest.mark.parametrize("kind,w,h,qp", [
    ("smooth", 64, 48, 27), ("smooth", 80, 48, 36), ("noise", 80, 48, 12),
    ("saturated", 64, 48, 8), ("noise", 64, 40, 0)])
def test_flat_levels_and_sparse_pack_match(kind, w, h, qp):
    clip = {"smooth": _smooth_clip, "noise": _noise_clip,
            "saturated": _saturated_clip}[kind](1, w, h)
    tp, jp, mbw, mbh = _planes(clip[0])
    tflat = torchcore._flat_levels(*tp, qp, mbw, mbh)
    jflat = np.asarray(_jflat(*jp, qp, mbw=mbw, mbh=mbh))
    assert tflat.dtype == torch.int32
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    L = torchcore.intra_flat_len(mbw * mbh)
    assert L == jaxcore.intra_flat_len(mbw * mbh) == tflat.shape[0]
    tout = [t.numpy() for t in torchcore._sparse_pack(tflat)]
    jout = [np.asarray(a) for a in _jsparse(jnp.asarray(jflat))]
    for name, a, b in zip(("nnz", "n_esc", "bitmap", "vals", "esc_pos",
                           "esc_val"), tout, jout):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    nnz, n_esc = int(tout[0]), int(tout[1])
    fits = torchcore.sparse_fits(nnz, n_esc, L)
    assert fits == jaxcore.sparse_fits(nnz, n_esc, L)
    if fits:
        back = torchcore._sparse_unpack(nnz, n_esc, *tout[2:], L)
        np.testing.assert_array_equal(back, jflat)
        np.testing.assert_array_equal(
            back, jaxcore._sparse_unpack(nnz, n_esc, *jout[2:], L))


@pytest.mark.parametrize("case", ["escapes", "overflow", "escape_overflow",
                                  "empty", "odd_length"])
def test_sparse_pack_edge_cases_match(case):
    rng = np.random.default_rng(7)
    L = {"odd_length": 8 * 384 + 5}.get(case, 6 * 384)
    flat = np.zeros(L, np.int32)
    if case in ("escapes", "odd_length"):
        idx = rng.choice(L, L // 10, replace=False)
        flat[idx] = rng.integers(-400, 401, idx.size)
    elif case == "overflow":
        flat[:] = rng.integers(-3, 4, L)          # density far past 1/4
    elif case == "escape_overflow":
        # more escapes than the side channel holds
        L = 4 * (jaxcore._SPARSE_ESCAPES + 64)
        flat = np.zeros(L, np.int32)
        idx = rng.choice(L, jaxcore._SPARSE_ESCAPES + 50, replace=False)
        flat[idx] = rng.choice([-300, 200, 999], idx.size)
    tout = [t.numpy() for t in torchcore._sparse_pack(torch.from_numpy(flat))]
    jout = [np.asarray(a) for a in _jsparse(jnp.asarray(flat))]
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    nnz, n_esc = int(tout[0]), int(tout[1])
    fits = torchcore.sparse_fits(nnz, n_esc, L)
    assert fits == {"escapes": True, "overflow": False,
                    "escape_overflow": False, "empty": True,
                    "odd_length": True}[case]
    if fits:
        np.testing.assert_array_equal(
            torchcore._sparse_unpack(nnz, n_esc, *tout[2:], L), flat)


@pytest.mark.parametrize("kind,qp", [("smooth", 27), ("noise", 6)])
def test_encode_intra_levels_match(kind, qp):
    w, h = 80, 48
    clip = (_smooth_clip if kind == "smooth" else _noise_clip)(1, w, h)
    p = TFrame(*clip[0]).padded(16)
    got = torchcore.encode_intra(p.y, p.u, p.v, qp, device="cpu")
    want = jaxcore.encode_intra_jax(p.y, p.u, p.v, qp)
    _assert_levels_equal(got, want)
    fn = torchcore.build_intra_encoder(p.y.shape, qp, device="cpu")
    _assert_levels_equal(fn(p.y, p.u, p.v), want)


# ---- encoder surface --------------------------------------------------------

@pytest.mark.parametrize("w,h,qp", [(64, 48, 27), (80, 48, 33), (72, 40, 20)])
def test_encode_frames_matches(w, h, qp):
    clip = _smooth_clip(3, w, h, seed=w)
    want = jencoder.encode_frames([JFrame(*f) for f in clip],
                                  JMeta(width=w, height=h), qp=qp)
    got = th264.encode_frames([TFrame(*f) for f in clip],
                              TMeta(width=w, height=h), qp=qp, device="cpu")
    assert got == want
    enc = th264.H264Encoder(TMeta(width=w, height=h), qp=qp, device="cpu")
    jenc = jencoder.H264Encoder(JMeta(width=w, height=h), qp=qp)
    for i, f in enumerate(clip):
        assert enc.encode_frame(TFrame(*f), idr_pic_id=70000 + i,
                                with_headers=False) == \
            jenc.encode_frame(JFrame(*f), idr_pic_id=70000 + i,
                              with_headers=False)


@pytest.mark.parametrize("w,h,n,qp,idr", [(64, 48, 4, 27, 0),
                                          (80, 48, 3, 30, 5),
                                          (64, 40, 1, 24, 2)])
def test_encode_gop_bytes_and_recon_match(w, h, n, qp, idr):
    clip = _smooth_clip(n, w, h, seed=n)
    want, wrec = jencoder.encode_gop([JFrame(*f) for f in clip],
                                     JMeta(width=w, height=h), qp=qp,
                                     idr_pic_id=idr, return_recon=True)
    got, grec = th264.encode_gop([TFrame(*f) for f in clip],
                                 TMeta(width=w, height=h), qp=qp,
                                 idr_pic_id=idr, return_recon=True,
                                 device="cpu")
    assert got == want
    assert len(grec) == 3
    for a, b in zip(grec, wrec):
        assert a.dtype == np.int32 and a.shape[0] == n
        np.testing.assert_array_equal(a, np.asarray(b))
    bare = th264.encode_gop([TFrame(*f) for f in clip],
                            TMeta(width=w, height=h), qp=qp,
                            idr_pic_id=idr, with_headers=False, device="cpu")
    assert bare == jencoder.encode_gop([JFrame(*f) for f in clip],
                                       JMeta(width=w, height=h), qp=qp,
                                       idr_pic_id=idr, with_headers=False)


def test_codec_surface_refuses_what_it_cannot_encode():
    meta = TMeta(width=64, height=48)
    jmeta = JMeta(width=64, height=48)
    clip = _smooth_clip(2, 64, 48)
    frames = [TFrame(*f) for f in clip]
    # the RD features the reference accepts here encode its bytes
    assert th264.H264Encoder(meta, rd=RdConfig(mode_decision=True),
                             device="cpu").encode_frame(frames[0]) == \
        jencoder.H264Encoder(jmeta, rd=JRdConfig(mode_decision=True)
                             ).encode_frame(JFrame(*clip[0]))
    assert th264.encode_gop(frames, meta, rd=RdConfig(aq_q=2),
                            device="cpu") == \
        jencoder.encode_gop([JFrame(*f) for f in clip], jmeta,
                            rd=JRdConfig(aq_q=2))
    # the reference's own refusal comes first, as there
    with pytest.raises(ValueError, match="deblock/pskip"):
        th264.H264Encoder(meta, rd=RdConfig(deblock=True), device="cpu")
    with pytest.raises(ValueError, match="deblock/pskip"):
        jencoder.H264Encoder(JMeta(width=64, height=48),
                             rd=JRdConfig(deblock=True))
    with pytest.raises(ValueError, match="empty GOP"):
        th264.encode_gop([], meta, device="cpu")
    f444 = TFrame(y=frames[0].y, u=frames[0].y, v=frames[0].y)
    with pytest.raises(ValueError, match="4:2:0"):
        th264.encode_gop([f444], meta, device="cpu")
    assert set(th264.__all__) >= {"H264Encoder", "encode_frames",
                                  "encode_gop"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th264.H264Encoder(meta)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th264.encode_gop(frames, meta)


# ---- the all-intra wave -----------------------------------------------------

def _intra_both(clip, w, h, qp, gop, gop_qp=None, **tkw):
    n = len(clip)
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=qp, gop_frames=gop,
        inter=False, mesh=jdispatch.default_mesh(jax.devices()[:1]))
    tenc = tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=qp, gop_frames=gop,
        inter=False, device="cpu", **tkw)
    if gop_qp:
        jenc.gop_qp.update(gop_qp)
        tenc.gop_qp.update(gop_qp)
    jsegs = jenc.encode([JFrame(*f) for f in clip])
    tsegs = tenc.encode([TFrame(*f) for f in clip])
    assert [dataclasses.astuple(s.gop) for s in tsegs] == [
        dataclasses.astuple(s.gop) for s in jsegs]
    assert [s.frame_sizes for s in tsegs] == [s.frame_sizes for s in jsegs]
    assert tconcat(tsegs) == jconcat(jsegs)
    tsnap, jsnap = tenc.stages.snapshot(), jenc.stages.snapshot()
    assert tsnap["dense_fallback_waves"] == jsnap["dense_fallback_waves"]
    assert tsnap["waves"] == jsnap["waves"]
    return tsegs, tsnap


def test_intra_wave_honors_per_gop_qp():
    w, h, n = 64, 48, 8
    clip = _smooth_clip(n, w, h, seed=21)
    qp_map = {g: 27 + 3 * (g % 3) for g in range(4)}
    segs, snap = _intra_both(clip, w, h, 27, 2, gop_qp=qp_map)
    assert snap["dense_fallback_waves"] == 0 and snap["waves"] == 4
    # every GOP is its frames' IDR slices at that GOP's QP: the same
    # bytes as the port's frame encoder at that QP, headers from the
    # encoder's own PPS (init_qp 27)
    enc = tdispatch.GopShardEncoder(TMeta(width=w, height=h), qp=27,
                                    inter=False, device="cpu")
    for seg in segs:
        qp = qp_map[seg.gop.index]
        fn = torchcore.build_intra_encoder((48, 64), qp, device="cpu")
        out = []
        for fi, i in enumerate(range(seg.gop.start_frame, seg.gop.end_frame)):
            p = TFrame(*clip[i]).padded(16)
            nal = tencoder.pack_slice(fn(p.y, p.u, p.v), 4, 3, enc.sps,
                                      enc.pps, qp, idr=True, idr_pic_id=i)
            out.append(enc.sps.to_nal() + enc.pps.to_nal() + nal
                       if fi == 0 else nal)
        assert seg.payload == b"".join(out)


@pytest.mark.parametrize("kind,w,h,qp", [("noise", 64, 48, 8),
                                         ("saturated", 80, 48, 4)])
def test_intra_wave_dense_fallback_matches(kind, w, h, qp):
    clip = (_noise_clip(4, w, h, seed=3) if kind == "noise"
            else _saturated_clip(4, w, h))
    _, snap = _intra_both(clip, w, h, qp, 2)
    if kind == "noise":
        assert snap["dense_fallback_waves"] >= 1 and snap["dense_retry"] > 0


def test_intra_wave_tail_gop_and_single_pack_thread():
    w, h = 80, 48
    clip = _smooth_clip(7, w, h, seed=4)
    segs, _ = _intra_both(clip, w, h, 30, 3, pack_workers=1)
    assert [len(s.frame_sizes) for s in segs] == [3, 2, 2]


def test_encode_clip_sharded_matches():
    w, h, n = 64, 48, 6
    clip = _smooth_clip(n, w, h, seed=8)
    mesh = jdispatch.default_mesh(jax.devices()[:1])
    for inter in (False, True):
        want = jdispatch.encode_clip_sharded(
            [JFrame(*f) for f in clip], JMeta(width=w, height=h,
                                              num_frames=n),
            qp=29, mesh=mesh, gop_frames=3, inter=inter)
        got = tdispatch.encode_clip_sharded(
            [TFrame(*f) for f in clip], TMeta(width=w, height=h,
                                              num_frames=n),
            qp=29, gop_frames=3, inter=inter, device="cpu")
        assert got == want

