"""The port's H.264 decoder (`codecs/h264/decoder.py`, host numpy) against
the JAX package's, frame for frame (tolerance 0), on streams the port
encodes, and against the encoder's own reconstruction:

- a GOP stream with P frames (the port's GopShardEncoder), whose frames
  are the port's `encode_gop` recon;
- a multi-slice split-frame stream (3 bands on a 2-entry mesh), whose
  frames are the encoder's `keep_recon` planes;
- an RD_ALL stream (mode decision, P_Skip, AQ, in-loop deblocking),
  whose frames are the deblocked recon.
"""

import numpy as np
import pytest
import torch

from thinvids_tpu.codecs.h264 import decoder as jdecoder
from thinvids_tpu_torch.codecs.h264 import decoder as tdecoder
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)


def _clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (128 + 60 * np.sin((xx + 3 * i) * 0.11) * np.cos((yy + i) * 0.09)
             + rng.normal(0, 2.0, (h, w)))
        c = 128 + 40 * np.sin(xx[::2, ::2] * 0.07 + i * 0.2)
        out.append(TFrame(np.clip(y, 0, 255).astype(np.uint8),
                          np.clip(c, 0, 255).astype(np.uint8),
                          np.clip(255 - c, 0, 255).astype(np.uint8)))
    return out


def _decode_both(stream):
    """(port frames, reference frames) of `stream`, asserted equal."""
    got = tdecoder.decode_annexb(stream)
    want = jdecoder.decode_annexb(stream)
    assert len(got.frames) == len(want.frames) > 0
    assert (got.meta.width, got.meta.height) == (want.meta.width,
                                                 want.meta.height)
    for i, (a, b) in enumerate(zip(got.frames, want.frames)):
        for plane in "yuv":
            np.testing.assert_array_equal(getattr(a, plane),
                                          getattr(b, plane),
                                          err_msg=f"frame {i} {plane}")
    return got.frames


def _assert_recon(frames, recon, w, h):
    """Decoded frames equal (F, H, W) recon planes cropped to display."""
    for i, f in enumerate(frames):
        for plane, r, (ph, pw) in zip("yuv", recon,
                                      ((h, w), (h // 2, w // 2),
                                       (h // 2, w // 2))):
            np.testing.assert_array_equal(
                getattr(f, plane), np.asarray(r[i])[:ph, :pw],
                err_msg=f"frame {i} {plane}")


@pytest.mark.parametrize("rd", ["off", "rd_all"])
def test_gop_stream_decodes_to_the_recon(rd):
    w, h, n = 80, 64, 6
    frames = _clip(n, w, h)
    meta = TMeta(width=w, height=h, fps_num=30, num_frames=n)
    cfg = trdo.RD_OFF if rd == "off" else trdo.RdConfig(
        mode_decision=True, pskip=True, deblock=True,
        aq_q=trdo.aq_from_strength(1.0))
    enc = tdispatch.GopShardEncoder(meta, qp=27, gop_frames=n, rd=cfg,
                                    device="cpu")
    stream = tconcat(enc.encode(frames))
    decoded = _decode_both(stream)
    assert len(decoded) == n
    ref_stream, recon = tencoder.encode_gop(frames, meta, qp=27,
                                            return_recon=True, rd=cfg,
                                            device="cpu")
    assert ref_stream == stream
    _assert_recon(decoded, recon, w, h)


def test_multi_slice_sfe_stream_decodes_to_the_recon():
    w, h, n = 64, 112, 5
    frames = _clip(n, w, h, seed=4)
    meta = TMeta(width=w, height=h, fps_num=30, num_frames=n)
    enc = tdispatch.SfeShardEncoder(meta, qp=27, gop_frames=n, bands=3,
                                    mesh=DeviceMesh(("cpu", "cpu")))
    enc.keep_recon = True
    stream = tconcat(enc.encode(frames))
    decoded = _decode_both(stream)
    assert len(decoded) == n
    for i, f in enumerate(decoded):
        for plane, r in zip("yuv", enc.recon_frames[i]):
            np.testing.assert_array_equal(getattr(f, plane), r,
                                          err_msg=f"frame {i} {plane}")
