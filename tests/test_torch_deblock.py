"""Port parity for the in-loop deblocking filter (§8.7, shifted-plane
schedule) and the GOP encodes that run it.

- the port's numpy `deblock.deblock_frame` equals the reference's, and
  `torchdeblock.deblock_frame_torch` equals `jaxdeblock.deblock_frame_jax`
  (intra and P pictures, full frames and band slices), bit for bit;
- `nz4_from_luma_plane` equals the reference's;
- `encode_gop` with the filter on (alone, and with the P_Skip bias)
  gives the JAX package's stream and deblocked recon, and the
  reference's decoder decodes the port's stream to the port's recon.

Seeded numpy inputs, zero tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bench import make_frames
from thinvids_tpu.codecs.h264 import decoder as jdec
from thinvids_tpu.codecs.h264 import deblock as jdeblock
from thinvids_tpu.codecs.h264 import encoder as jencoder
from thinvids_tpu.codecs.h264 import jaxdeblock
from thinvids_tpu.codecs.h264.rdo import RdConfig as JRdConfig
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu_torch.codecs.h264 import deblock as tdeblock
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import torchdeblock
from thinvids_tpu_torch.codecs.h264.rdo import RdConfig
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta

torch.set_num_threads(1)

#: the JAX backend as the encode programs run it: traced into one program
_jdeblock = jax.jit(jaxdeblock.deblock_frame_jax,
                    static_argnames=("intra", "mb_row0", "total_mb_rows"))


def _rand_frame(mbh, mbw, seed=0, smooth=False):
    """The reference test's fields: uniform noise, or 4x4-blocky smooth
    content that the filter must touch."""
    rng = np.random.default_rng(seed)
    if smooth:
        base = rng.integers(90, 120, (4 * mbh, 4 * mbw))
        y = np.repeat(np.repeat(base, 4, 0), 4, 1).astype(np.uint8)
    else:
        y = rng.integers(0, 256, (16 * mbh, 16 * mbw), np.uint8)
    u = y[::2, ::2].copy()
    v = 255 - u
    return y, u, v


def _inputs(seed, intra, mbh=5, mbw=7):
    y, u, v = _rand_frame(mbh, mbw, seed, smooth=(seed == 1))
    rng = np.random.default_rng(seed + 100)
    qp = rng.integers(16, 48, (mbh, mbw))
    kw = {}
    if not intra:
        kw = dict(nz4=rng.random((4 * mbh, 4 * mbw)) < 0.4,
                  mv=rng.integers(-12, 13, (mbh, mbw, 2)))
    return (y, u, v), qp, kw


def _torch16(planes):
    return tuple(torch.from_numpy(p.astype(np.int16)) for p in planes)


def test_tables_match():
    for name in ("ALPHA_TABLE", "BETA_TABLE", "TC0_TABLE", "_QPC_NP"):
        np.testing.assert_array_equal(getattr(tdeblock, name),
                                      getattr(jdeblock, name), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("intra", [True, False])
def test_numpy_schedule_equals_the_reference(seed, intra):
    planes, qp, kw = _inputs(seed, intra)
    want = jdeblock.deblock_frame(*planes, qp, intra=intra, **kw)
    got = tdeblock.deblock_frame(*planes, qp, intra=intra, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("intra", [True, False])
def test_torch_backend_equals_jax_backend(seed, intra):
    planes, qp, kw = _inputs(seed, intra)
    want = _jdeblock(
        *(jnp.asarray(p.astype(np.int16)) for p in planes), qp,
        intra=intra, **kw)
    tkw = {k: torch.from_numpy(np.asarray(a)) for k, a in kw.items()}
    got = torchdeblock.deblock_frame_torch(*_torch16(planes),
                                           torch.from_numpy(qp),
                                           intra=intra, **tkw)
    for a, b, p in zip(got, want, planes):
        assert a.dtype == torch.int16
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the filter did something on these fields
    assert (got[0].numpy() != planes[0]).any()


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("mb_row0,total", [(2, 6), (0, 3)])
def test_band_slice_matches(intra, mb_row0, total):
    """A band slice positioned inside a taller picture: horizontal
    edges outside the picture's real MB rows are masked."""
    planes, qp, kw = _inputs(3, intra, mbh=4, mbw=5)
    want = _jdeblock(
        *(jnp.asarray(p.astype(np.int16)) for p in planes), qp,
        intra=intra, mb_row0=mb_row0, total_mb_rows=total, **kw)
    tkw = {k: torch.from_numpy(np.asarray(a)) for k, a in kw.items()}
    got = torchdeblock.deblock_frame_torch(
        *_torch16(planes), torch.from_numpy(qp), intra=intra,
        mb_row0=mb_row0, total_mb_rows=total, **tkw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jdeblock.deblock_frame(*planes, qp, intra=intra, mb_row0=mb_row0,
                                 total_mb_rows=total, **kw)
    for a, b in zip(tdeblock.deblock_frame(*planes, qp, intra=intra,
                                           mb_row0=mb_row0,
                                           total_mb_rows=total, **kw), ref):
        np.testing.assert_array_equal(a, b)


def test_nz4_from_luma_plane_matches():
    rng = np.random.default_rng(4)
    mbh, mbw = 3, 5
    z = np.where(rng.random((16 * mbh, 16 * mbw)) < 0.02,
                 rng.integers(-3, 4, (16 * mbh, 16 * mbw)), 0
                 ).astype(np.int32)
    want = np.asarray(jaxdeblock.nz4_from_luma_plane(jnp.asarray(z), mbh,
                                                     mbw))
    got = torchdeblock.nz4_from_luma_plane(torch.from_numpy(z), mbh, mbw)
    assert got.dtype == torch.bool and got.shape == (4 * mbh, 4 * mbw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_filter_behaviour_and_contract():
    y, u, v = _rand_frame(3, 3, 1, smooth=True)
    y2, u2, _ = tdeblock.deblock_frame(y, u, v, np.full((3, 3), 30),
                                       intra=True)
    assert (y2 != y).sum() > y.size // 4     # blocking edges filtered
    assert (u2 != u).any()
    # indexA < 16 -> alpha/beta 0 -> nothing may change
    for out, src in zip(torchdeblock.deblock_frame_torch(
            *_torch16((y, u, v)), torch.full((3, 3), 10), intra=True),
            (y, u, v)):
        np.testing.assert_array_equal(out.numpy(), src)
    with pytest.raises(ValueError, match="nz4 and mv"):
        torchdeblock.deblock_frame_torch(*_torch16((y, u, v)),
                                         torch.full((3, 3), 30),
                                         intra=False)


# ---- encode_gop with the filter on ---------------------------------------

@pytest.mark.parametrize("kw", [dict(deblock=True),
                                dict(pskip=True, deblock=True)],
                         ids=["deblock", "pskip_deblock"])
def test_encode_gop_with_deblock_matches(kw):
    w, h, n = 96, 80, 4
    frames = make_frames(n, w, h)
    want, wrec = jencoder.encode_gop(
        frames, JMeta(width=w, height=h, fps_num=30, fps_den=1,
                      num_frames=n), qp=27, return_recon=True,
        rd=JRdConfig(**kw))
    got, grec = tencoder.encode_gop(
        [TFrame(y=f.y, u=f.u, v=f.v) for f in frames],
        TMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n),
        qp=27, return_recon=True, rd=RdConfig(**kw), device="cpu")
    # plane by plane, frame by frame first: a 1-LSB recon difference
    # compounds through the carry before it shows in the stream
    for i in range(n):
        for a, b, name in zip(grec, wrec, "yuv"):
            np.testing.assert_array_equal(a[i], np.asarray(b)[i],
                                          err_msg=f"frame {i} {name}")
    assert got == want
    dec = jdec.decode_annexb(got)
    assert len(dec.frames) == n
    for i in range(n):
        np.testing.assert_array_equal(dec.frames[i].y, grec[0][i][:h, :w])
        np.testing.assert_array_equal(dec.frames[i].u,
                                      grec[1][i][:h // 2, :w // 2])
