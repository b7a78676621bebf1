"""The port's numpy compute path and GOP pack entries against the
reference's (codecs/h264/encoder.py), on the CPU.

- `encode_frame_arrays`: levels (all seven `FrameLevels` fields) and the
  three recon planes equal the reference's, over shapes with an even and
  an odd MB count and CIF, iid noise and tests/test_jaxcore.py's
  gradient + jitter content, QP 10/27/45, and RD off, mode decision,
  AQ and both.
- ``H264Encoder(use_device=False)`` / ``encode_frames(...,
  use_device=False)`` give the reference's ``use_jax=False`` bytes, and
  the port's own ``device="cpu"`` bytes: the spec oracle agrees with the
  batched path.
- `pack_gop_slices` (the reference's blocked `jaxinter.encode_gop_jit`
  arrays, through both packages) and `pack_gop_slices_planes` (the
  port's `torchinter.encode_gop_planes` on the CPU), serial and over a
  4-thread pool, give the same bytes as each other and as `encode_gop`.

Inputs come from a numpy seed. Tolerance: 0 (bit-exact) throughout.
"""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinvids_tpu.codecs.h264 import encoder as jencoder
from thinvids_tpu.codecs.h264 import jaxinter
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.codecs.h264.headers import PPS as JPPS
from thinvids_tpu.codecs.h264.headers import SPS as JSPS
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.codecs.h264 import torchinter
from thinvids_tpu_torch.codecs.h264.headers import PPS, SPS
from thinvids_tpu_torch.codecs.h264.layout import unflatten_gop
from thinvids_tpu_torch.core.types import Frame, VideoMeta

torch.set_num_threads(1)

FIELDS = ("luma_mode", "chroma_mode", "luma_dc", "luma_ac", "chroma_dc",
          "chroma_ac", "qp_delta")

#: RdConfig fields of the intra features: off, mode decision, AQ, both
RD_CASES = {"off": {}, "md": {"mode_decision": True},
            "aq": {"aq_q": 4}, "md_aq": {"mode_decision": True, "aq_q": 4}}

RD_GOP = {"off": {}, "all": {"mode_decision": True, "pskip": True,
                             "deblock": True, "aq_q": 4}}


def _planes(w, h, content, seed=7):
    """iid noise, or tests/test_jaxcore.py's gradient + jitter."""
    rng = np.random.default_rng(seed)
    if content == "noise":
        return (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(((xx * 2 + yy) % 256) + rng.integers(-8, 8, (h, w)),
                0, 255).astype(np.uint8)
    u = np.clip(128 + rng.integers(-20, 20, (h // 2, w // 2)),
                0, 255).astype(np.uint8)
    v = np.clip(128 + rng.integers(-20, 20, (h // 2, w // 2)),
                0, 255).astype(np.uint8)
    return y, u, v


def _assert_levels_equal(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name


@pytest.mark.parametrize("rd", sorted(RD_CASES))
@pytest.mark.parametrize("qp", [10, 27, 45])
@pytest.mark.parametrize("content", ["noise", "gradient"])
@pytest.mark.parametrize("size", [(64, 48), (80, 48), (352, 288)])
def test_encode_frame_arrays_equals_the_reference(size, content, qp, rd):
    w, h = size
    y, u, v = _planes(w, h, content)
    want, want_recon = jencoder.encode_frame_arrays(
        y, u, v, qp, rd=jrdo.RdConfig(**RD_CASES[rd]))
    got, got_recon = tencoder.encode_frame_arrays(
        y, u, v, qp, rd=trdo.RdConfig(**RD_CASES[rd]))
    _assert_levels_equal(got, want)
    for g, wr in zip(got_recon, want_recon, strict=True):
        np.testing.assert_array_equal(g, wr)
        assert g.dtype == wr.dtype


def _clip(w, h, n, seed):
    frames = []
    for i in range(n):
        y, u, v = _planes(w, h, "gradient" if i % 2 else "noise",
                          seed=seed + i)
        frames.append((y, u, v))
    return frames


@pytest.mark.parametrize("rd", sorted(RD_CASES))
@pytest.mark.parametrize("size,qp", [((64, 48), 27), ((80, 48), 10),
                                     ((36, 20), 45)])
def test_h264_encoder_without_the_device_gives_both_streams(size, qp, rd):
    """use_device=False bytes == the reference's use_jax=False bytes ==
    the port's device="cpu" bytes (36x20 is a cropped 48x32 frame)."""
    w, h = size
    planes = _clip(w, h, 1, seed=3)[0]
    meta, jmeta = VideoMeta(width=w, height=h), JMeta(width=w, height=h)
    spec = tencoder.H264Encoder(meta, qp=qp, rd=trdo.RdConfig(**RD_CASES[rd]),
                                use_device=False)
    assert spec.device is None
    got = spec.encode_frame(Frame(*planes), idr_pic_id=5)
    want = jencoder.H264Encoder(
        jmeta, qp=qp, use_jax=False,
        rd=jrdo.RdConfig(**RD_CASES[rd])).encode_frame(JFrame(*planes),
                                                       idr_pic_id=5)
    batched = tencoder.H264Encoder(
        meta, qp=qp, rd=trdo.RdConfig(**RD_CASES[rd]),
        device="cpu").encode_frame(Frame(*planes), idr_pic_id=5)
    assert got == want == batched


def test_encode_frames_without_the_device_gives_both_streams():
    w, h = 80, 48
    clip = _clip(w, h, 3, seed=11)
    meta = VideoMeta(width=w, height=h, num_frames=3)
    got = tencoder.encode_frames([Frame(*p) for p in clip], meta, qp=30,
                                 use_device=False)
    want = jencoder.encode_frames([JFrame(*p) for p in clip],
                                  JMeta(width=w, height=h, num_frames=3),
                                  qp=30, use_jax=False)
    batched = tencoder.encode_frames([Frame(*p) for p in clip], meta, qp=30,
                                     device="cpu")
    assert got == want == batched


def test_without_the_device_no_card_is_asked_for():
    """use_device=False resolves no device: the default "cuda" is
    ignored on a host without one, and the device path still raises."""
    meta = VideoMeta(width=32, height=32)
    enc = tencoder.H264Encoder(meta, qp=27, use_device=False)
    assert enc.encode_frame(Frame(*_planes(32, 32, "noise")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tencoder.H264Encoder(meta, qp=27)


@pytest.mark.parametrize("pool_workers", [0, 4])
@pytest.mark.parametrize("rd", sorted(RD_GOP))
def test_pack_gop_slices_on_the_reference_arrays(rd, pool_workers):
    """The reference's blocked GOP arrays (jaxinter.encode_gop_jit on the
    CPU) pack to the same slices through both packages, and those
    slices are the reference's and the port's encode_gop streams."""
    w, h, n, qp = 80, 48, 4, 27
    mbw, mbh = w // 16, h // 16
    clip = _clip(w, h, n, seed=2)
    jrd, trd = jrdo.RdConfig(**RD_GOP[rd]), trdo.RdConfig(**RD_GOP[rd])
    ys, us, vs = (jnp.asarray(np.stack([p[c] for p in clip]))
                  for c in range(3))
    intra, pouts = jax.device_get(jaxinter.encode_gop_jit(
        ys, us, vs, jnp.asarray(qp), mbw=mbw, mbh=mbh, rd=jrd))
    pool = cf.ThreadPoolExecutor(pool_workers) if pool_workers else None
    try:
        want = jencoder.pack_gop_slices(
            intra, pouts, n, mbw, mbh, JSPS(width=w, height=h),
            JPPS(init_qp=qp), qp, 3, pool=pool, rd=jrd)
        got = tencoder.pack_gop_slices(
            intra, pouts, n, mbw, mbh, SPS(width=w, height=h),
            PPS(init_qp=qp), qp, 3, pool=pool, rd=trd)
    finally:
        if pool is not None:
            pool.shutdown()
    assert len(got) == n
    assert got == want
    meta = VideoMeta(width=w, height=h, num_frames=n)
    stream = tencoder.encode_gop([Frame(*p) for p in clip], meta, qp=qp,
                                 idr_pic_id=3, rd=trd, device="cpu")
    assert b"".join(got) == stream
    assert stream == jencoder.encode_gop(
        [JFrame(*p) for p in clip], JMeta(width=w, height=h, num_frames=n),
        qp=qp, idr_pic_id=3, rd=jrd)


@pytest.mark.parametrize("pool_workers", [0, 4])
@pytest.mark.parametrize("rd", sorted(RD_GOP))
def test_pack_gop_slices_planes_gives_encode_gop(rd, pool_workers):
    """The port's plane-layout GOP (torchinter.encode_gop_planes on the
    CPU) packs through pack_gop_slices_planes to encode_gop's bytes."""
    w, h, n, qp = 64, 48, 4, 30
    mbw, mbh = w // 16, h // 16
    clip = _clip(w, h, n, seed=8)
    trd = trdo.RdConfig(**RD_GOP[rd])
    mv8, flat = torchinter.encode_gop_planes(
        *(torch.from_numpy(np.stack([p[c] for p in clip])) for c in range(3)),
        qp, mbw=mbw, mbh=mbh, rd=trd)
    intra, planes = unflatten_gop(flat.numpy(), mv8.numpy(), n, mbw, mbh,
                                  ships_modes=trd.ships_modes)
    pool = cf.ThreadPoolExecutor(pool_workers) if pool_workers else None
    try:
        got = tencoder.pack_gop_slices_planes(
            intra, planes, n, mbw, mbh, SPS(width=w, height=h),
            PPS(init_qp=qp), qp, 0, pool=pool, rd=trd)
    finally:
        if pool is not None:
            pool.shutdown()
    assert len(got) == n
    meta = VideoMeta(width=w, height=h, num_frames=n)
    assert b"".join(got) == tencoder.encode_gop(
        [Frame(*p) for p in clip], meta, qp=qp, rd=trd, device="cpu")
