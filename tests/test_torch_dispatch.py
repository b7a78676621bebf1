"""Port parity for the slice as a whole: the PyTorch GopShardEncoder on
the CPU must emit the same Annex-B bytes as the JAX GopShardEncoder on a
one-device mesh — frames in, closed-GOP H.264 out, through staging,
dispatch, the compact transfer (or the dense fallback), the host unpack
and the CAVLC pack.

conftest forces 8 virtual CPU devices for the JAX package; the
reference runs on one of them (the bytes do not depend on the count).
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.core import devices
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(2)


def _pan_clip(n, w, h, seed=0, grain=1.5):
    """(y, u, v) planes of a smooth sinusoidal scene panning (1, 2) pel
    per frame, with fresh grain every frame: motion-predictable, inside
    every sparse budget."""
    rng = np.random.default_rng(seed)
    clip = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        yy, xx = yy + i, xx + 2 * i
        y = (128 + 60 * np.sin(xx * 0.11) * np.cos(yy * 0.09)
             + 30 * np.sin((xx + yy) * 0.05) + rng.normal(0, grain, (h, w)))
        c = 128 + 40 * np.sin(xx[::2, ::2] * 0.07 + yy[::2, ::2] * 0.03)
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


#: the stage snapshot's keys that the port adds to the reference's: its
#: own stages (the driving thread's waits, the pack pool's CAVLC, the
#: split-frame walk's steps, the wait for a free GOP slot), the CPU time
#: of every stage, the count of blocking device→host points and the
#: counts of frames staged by each route
PORT_KEYS = ({"await_staged", "await_collect", "cavlc", "walk_intra",
              "walk_probe", "walk_p", "walk_link", "stage_slot_wait",
              "host_syncs", "staged_direct_frames", "staged_copied_frames"}
             | {f"cpu.{k}" for k in tdispatch.STAGE_NAMES})


def _encode_both(clip, w, h, qp, gop, gop_qp=None):
    n = len(clip)
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=qp, gop_frames=gop,
        mesh=jdispatch.default_mesh(jax.devices()[:1]))
    tenc = tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=qp, gop_frames=gop,
        device="cpu")
    if gop_qp:
        jenc.gop_qp.update(gop_qp)
        tenc.gop_qp.update(gop_qp)
    jsegs = jenc.encode([JFrame(*f) for f in clip])
    tsegs = tenc.encode([TFrame(*f) for f in clip])
    return (jsegs, jenc.stages.snapshot()), (tsegs, tenc.stages.snapshot())


def _assert_same_stream(want, got):
    """Same GOPs, frame sizes, bytes and fallback count; returns the
    port's (stream, stage snapshot)."""
    (jsegs, jsnap), (tsegs, tsnap) = want, got
    assert [dataclasses.astuple(s.gop) for s in tsegs] == [
        dataclasses.astuple(s.gop) for s in jsegs]
    assert [s.frame_sizes for s in tsegs] == [s.frame_sizes for s in jsegs]
    stream = tconcat(tsegs)
    assert stream == jconcat(jsegs)
    assert tsnap["dense_fallback_waves"] == jsnap["dense_fallback_waves"]
    assert set(tsnap) - PORT_KEYS == set(jsnap)
    assert PORT_KEYS <= set(tsnap)
    return stream, tsnap


def test_padded_height_clip_matches_jax():
    # 64x40 pads to 64x48: the bottom MB row is half edge replication
    w, h = 64, 40
    clip = _pan_clip(8, w, h, seed=1)
    stream, snap = _assert_same_stream(*_encode_both(clip, w, h, 27, 4))
    assert snap["dense_fallback_waves"] == 0
    assert snap["waves"] == 1 and snap["d2h_bytes"] > 0
    assert stream.startswith(b"\x00\x00\x00\x01\x67")


def test_tail_gop_clip_matches_jax():
    # 11 frames in GOPs of 4: the last GOP holds 3 frames and rides the
    # wave tail-repeated to F = 4; its padding frame is never coded
    w, h = 176, 144
    clip = _pan_clip(11, w, h, seed=2)
    want, got = _encode_both(clip, w, h, 30, 4)
    _, snap = _assert_same_stream(want, got)
    assert [len(s.frame_sizes) for s in got[0]] == [4, 4, 3]
    assert snap["dense_fallback_waves"] == 0


def test_gop_qp_override_matches_jax():
    w, h = 64, 40
    clip = _pan_clip(8, w, h, seed=1)
    want, got = _encode_both(clip, w, h, 27, 4, gop_qp={1: 36})
    _assert_same_stream(want, got)
    # the override re-quantized the second GOP only
    segs = got[0]
    plain = tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, num_frames=8), qp=27, gop_frames=4,
        device="cpu").encode([TFrame(*f) for f in clip])
    assert segs[0].payload == plain[0].payload
    assert segs[1].payload != plain[1].payload


def test_low_qp_noise_takes_dense_fallback_identically():
    w, h = 64, 48
    clip = _noise_clip(8, w, h, seed=23)
    stream, snap = _assert_same_stream(*_encode_both(clip, w, h, 8, 4))
    assert snap["dense_fallback_waves"] >= 1
    assert snap["dense_retry"] > 0


def test_stream_is_identical_across_waves_and_windows():
    # GOPs split over several waves and collected on several threads
    # give the bytes of one wave
    w, h = 64, 40
    clip = _pan_clip(9, w, h, seed=4)
    meta = TMeta(width=w, height=h, num_frames=9)
    one = tdispatch.GopShardEncoder(meta, qp=27, gop_frames=3,
                                    device="cpu")
    many = tdispatch.GopShardEncoder(meta, qp=27, gop_frames=3,
                                     gops_per_wave=1, pipeline_window=2,
                                     pack_workers=1, device="cpu")
    frames = [TFrame(*f) for f in clip]
    a = tconcat(one.encode(frames))
    b = tconcat(many.encode(frames))
    assert a == b
    assert one.stages.snapshot()["waves"] == 1
    assert many.stages.snapshot()["waves"] == 3


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    meta = TMeta(width=64, height=48, num_frames=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdispatch.GopShardEncoder(meta)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdispatch.GopShardEncoder(meta, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        devices.resolve_device()
    assert devices.resolve_device("cpu") == torch.device("cpu")


def test_me_cuda_wrapper_raises_on_cpu_tensors():
    from thinvids_tpu_torch.codecs.h264 import torchme

    z = torch.zeros((32, 32), dtype=torch.int16)
    zc = torch.zeros((16, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        torchme.me_search_cuda(z, z, zc, zc,
                               torch.zeros((3, 2), dtype=torch.int32),
                               torchme.lambda_for(27, "cpu"))
