"""Port parity for the job's file I/O: y4m written by one package reads
back identically in the other, the port's streaming ingest yields the
reference's frames, and the MP4 mux writes the reference's bytes for
the same stream and meta (the demux reads them back the same way).
"""

import numpy as np
import pytest

from thinvids_tpu.core import types as jtypes
from thinvids_tpu.ingest import decode as jdecode
from thinvids_tpu.io import mp4 as jmp4
from thinvids_tpu.io import y4m as jy4m
from thinvids_tpu_torch.core import types as ttypes
from thinvids_tpu_torch.ingest import decode as tdecode
from thinvids_tpu_torch.io import mp4 as tmp4
from thinvids_tpu_torch.io import y4m as ty4m

#: (chroma name, horizontal divisor, vertical divisor); None = no chroma
CHROMAS = [("YUV420", 2, 2), ("YUV422", 2, 1), ("YUV444", 1, 1),
           ("YUV400", None, None)]


def _planes(n, w, h, hdiv, vdiv, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if hdiv is None:
            out.append((y, None, None))
            continue
        ch, cw = -(-h // vdiv), -(-w // hdiv)
        out.append((y, rng.integers(0, 256, (ch, cw), dtype=np.uint8),
                    rng.integers(0, 256, (ch, cw), dtype=np.uint8)))
    return out


def _meta(types, w, h, n, chroma):
    return types.VideoMeta(width=w, height=h, fps_num=25, fps_den=1,
                           num_frames=n,
                           chroma=getattr(types.ChromaFormat, chroma))


def _same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        for p in "yuv":
            pa, pb = getattr(fa, p), getattr(fb, p)
            assert (pa is None) == (pb is None)
            if pa is not None:
                np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("chroma,hdiv,vdiv", CHROMAS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_y4m_crosses_packages(tmp_path, chroma, hdiv, vdiv, writer):
    w, h, n = 80, 48, 5
    planes = _planes(n, w, h, hdiv, vdiv, seed=3)
    wmod, wtypes, rmod, rtypes = (
        (ty4m, ttypes, jy4m, jtypes) if writer == "port"
        else (jy4m, jtypes, ty4m, ttypes))
    path = tmp_path / "clip.y4m"
    wmod.write_y4m(path, _meta(wtypes, w, h, n, chroma),
                   [wtypes.Frame(*p) for p in planes])
    # the bytes on disk are the same whichever package wrote them
    assert path.read_bytes() == ty4m.frames_to_bytes(
        _meta(ttypes, w, h, n, chroma), [ttypes.Frame(*p) for p in planes])
    meta, frames = rmod.read_y4m(path)
    assert (meta.width, meta.height, meta.num_frames, meta.chroma.name,
            meta.fps_num) == (w, h, n, chroma, 25)
    _same_frames(frames, [rtypes.Frame(*p) for p in planes])
    # the streaming range reader seeks to the same frames
    _same_frames(list(rmod.Y4MRangeReader(path).read_range(2, 4)),
                 frames[2:4])


def test_open_video_y4m_streams_the_reference_frames(tmp_path):
    w, h, n = 64, 48, 7
    planes = _planes(n, w, h, 2, 2, seed=5)
    path = tmp_path / "clip.y4m"
    jy4m.write_y4m(path, _meta(jtypes, w, h, n, "YUV420"),
                   [jtypes.Frame(*p) for p in planes])
    with tdecode.open_video(path) as tsrc, jdecode.open_video(path) as jsrc:
        assert tsrc.meta.width == jsrc.meta.width == w
        assert len(tsrc) == len(jsrc) == n
        _same_frames(list(tsrc), list(jsrc))
        _same_frames(list(tsrc[2:5]), list(jsrc[2:5]))
        _same_frames([tsrc[-1]], [jsrc[-1]])
        assert tsrc.frames_decoded == jsrc.frames_decoded
        assert tsrc.audio is None
    meta, frames, audio = tdecode.read_video(path)
    assert meta.num_frames == n and audio is None
    _same_frames(frames, list(jdecode.read_video(path)[1]))


def test_open_video_refuses_what_the_reference_refuses(tmp_path):
    bad = tmp_path / "clip.avi"
    bad.write_bytes(b"RIFF")
    with pytest.raises(tdecode.DecodeError, match="unsupported"):
        tdecode.open_video(bad)
    # a torn last frame record is dropped by both, not decoded short
    trunc = tmp_path / "clip.y4m"
    trunc.write_bytes(b"YUV4MPEG2 W64 H48 F25:1\nFRAME\n\x00\x01")
    assert [len(mod.read_video(trunc)[1]) for mod in (tdecode, jdecode)] \
        == [0, 0]
    notyuv = tmp_path / "junk.y4m"
    notyuv.write_bytes(b"not a y4m header\n")
    for mod in (tdecode, jdecode):
        with pytest.raises(mod.DecodeError):
            mod.open_video(notyuv)
    assert tdecode.supported_exts() == jdecode.supported_exts()


def _stream_and_meta():
    """A small real H.264 stream (two closed GOPs, IDR + P) from the
    reference encoder, and its meta."""
    from thinvids_tpu.codecs.h264.encoder import encode_gop

    w, h = 64, 48
    planes = _planes(6, w, h, 2, 2, seed=9)
    frames = [jtypes.Frame(*p) for p in planes]
    meta = jtypes.VideoMeta(width=w, height=h, fps_num=24000,
                            fps_den=1001, num_frames=6)
    stream = encode_gop(frames[:3], meta, qp=30, idr_pic_id=0) + \
        encode_gop(frames[3:], meta, qp=30, idr_pic_id=1)
    tmeta = ttypes.VideoMeta(width=w, height=h, fps_num=24000,
                             fps_den=1001, num_frames=6)
    return stream, meta, tmeta


@pytest.mark.parametrize("with_audio", [False, True])
def test_mux_mp4_bytes_match(tmp_path, with_audio):
    stream, jmeta, tmeta = _stream_and_meta()
    taudio = jaudio = None
    if with_audio:
        kw = dict(handler="soun", stsd_entry=b"\x00\x00\x00\x10mp4a" + 8 * b"\x07",
                  timescale=48000, stts=[(3, 1024), (1, 512)],
                  samples=[b"\x01\x02", b"\x03" * 7, b"", b"\x09" * 33])
        taudio, jaudio = tmp4.Mp4Track(**kw), jmp4.Mp4Track(**kw)
    data = tmp4.mux_mp4(stream, tmeta, audio=taudio)
    assert data == jmp4.mux_mp4(stream, jmeta, audio=jaudio)
    path = tmp_path / "out.mp4"
    assert tmp4.write_mp4(path, stream, tmeta, audio=taudio) == len(data)
    assert path.read_bytes() == data
    # demux: the port reads back what either package wrote, as the
    # reference does
    tm, jm = tmp4.read_mp4(path), jmp4.read_mp4(path)
    assert (tm.width, tm.height, tm.fps, tm.num_frames) == \
        (jm.width, jm.height, jm.fps, jm.num_frames)
    assert (tm.width, tm.height, tm.num_frames) == (64, 48, 6)
    assert tm.sync_samples() == jm.sync_samples() == [0, 3]
    assert tm.annexb_for(0, 6) == jm.annexb_for(0, 6)
    assert tmp4.probe_mp4_header(path) == jmp4.probe_mp4_header(path)
    if with_audio:
        assert tm.audio.samples == jm.audio.samples == kw["samples"]
        assert tm.audio.stts == kw["stts"]


def test_open_video_mp4_matches_the_reference(tmp_path):
    """The .mp4 source decodes through libavcodec in both packages; where
    no libavcodec loads, both refuse the file the same way."""
    from thinvids_tpu_torch.tools import oracle

    stream, jmeta, _ = _stream_and_meta()
    path = tmp_path / "clip.mp4"
    jmp4.write_mp4(path, stream, jmeta)
    if not oracle.oracle_available():
        for mod in (tdecode, jdecode):
            with pytest.raises(mod.DecodeError, match="libavcodec"):
                mod.open_video(path)
        return
    with tdecode.open_video(path) as tsrc, jdecode.open_video(path) as jsrc:
        assert (tsrc.meta.width, tsrc.meta.height, tsrc.meta.num_frames,
                tsrc.meta.fps_num, tsrc.meta.fps_den) == \
            (jsrc.meta.width, jsrc.meta.height, jsrc.meta.num_frames,
             jsrc.meta.fps_num, jsrc.meta.fps_den)
        _same_frames(list(tsrc), list(jsrc))
        _same_frames(list(tsrc[4:6]), list(jsrc[4:6]))
