"""External conformance oracle: decode H.264 via system libavcodec (ctypes).

No ffmpeg binary is needed, only the shared libavcodec.so.59. This module binds just enough of the C API to decode Annex-B elementary
streams into YUV planes, giving an *independent* decoder to conformance-
test the in-repo encoder against, and the decoder behind the ``.mp4``
ingest source (ingest/decode.py).

Only prefix fields of AVFrame/AVPacket are declared; layouts match
libavutil 57 / libavcodec 59 (checked at import via avcodec_version).
"""

from __future__ import annotations

import ctypes
from ctypes import POINTER, byref, c_int, c_int64, c_ubyte, c_void_p

import numpy as np

AV_CODEC_ID_H264 = 27
AVERROR_EAGAIN = -11
AVERROR_EOF = -0x20464F45  # 'EOF '


class AVFrame(ctypes.Structure):
    _fields_ = [
        ("data", c_void_p * 8),
        ("linesize", c_int * 8),
        ("extended_data", c_void_p),
        ("width", c_int),
        ("height", c_int),
        ("nb_samples", c_int),
        ("format", c_int),
    ]


class AVPacket(ctypes.Structure):
    _fields_ = [
        ("buf", c_void_p),
        ("pts", c_int64),
        ("dts", c_int64),
        ("data", POINTER(c_ubyte)),
        ("size", c_int),
        ("stream_index", c_int),
        ("flags", c_int),
    ]


class OracleUnavailable(RuntimeError):
    pass


_state: dict = {}


def _load():
    if _state:
        return _state
    try:
        avutil = ctypes.CDLL("libavutil.so.57")
        avcodec = ctypes.CDLL("libavcodec.so.59")
    except OSError as exc:
        raise OracleUnavailable(f"libavcodec not loadable: {exc}") from exc
    ver = avcodec.avcodec_version()
    if ver >> 16 != 59:
        raise OracleUnavailable(f"unexpected libavcodec major {ver >> 16}")
    avcodec.avcodec_find_decoder.restype = c_void_p
    avcodec.avcodec_alloc_context3.restype = c_void_p
    avcodec.av_packet_alloc.restype = POINTER(AVPacket)
    avutil.av_frame_alloc.restype = POINTER(AVFrame)
    avutil.av_log_set_level(16)  # AV_LOG_ERROR: quiet info spam, keep errors
    _state.update(avutil=avutil, avcodec=avcodec)
    return _state


def split_access_units(stream: bytes) -> list[bytes]:
    """Split an Annex-B stream into access units (one coded PICTURE
    each; a picture may span several slices — split-frame encoding
    emits one slice per MB-row band, and a VCL NAL with
    first_mb_in_slice == 0 is what OPENS a new access unit, §7.4.1.2.4).

    Parameter-set NALs travel with the following slice NAL.
    """
    import re

    from ..io.bits import slice_first_mb

    # start-code positions (3-byte form; 4-byte includes a leading zero)
    starts = [m.start() for m in re.finditer(b"\x00\x00\x01", stream)]
    if not starts:
        return []
    units = []
    for i, s in enumerate(starts):
        begin = s - 1 if s > 0 and stream[s - 1] == 0 else s
        end = starts[i + 1] if i + 1 < len(starts) else len(stream)
        if i + 1 < len(starts) and stream[end - 1] == 0:
            end -= 1
        nal_type = stream[s + 3] & 31
        first_mb = (slice_first_mb(stream[s + 3:end])
                    if nal_type in (1, 5) else None)
        units.append((nal_type, first_mb, stream[begin:end]))
    aus: list[bytes] = []
    pending = b""
    pending_vcl = False
    for nal_type, first_mb, chunk in units:
        # a completed AU (it has its VCL NALs) closes when the next
        # NAL can't extend it: a first_mb==0 VCL NAL opens the next
        # picture, and a non-VCL NAL (mid-stream SPS/PPS at a GOP
        # head) belongs WITH the following slice, not the previous AU
        if pending_vcl and (nal_type not in (1, 5) or first_mb == 0):
            aus.append(pending)
            pending, pending_vcl = b"", False
        pending += chunk
        pending_vcl = pending_vcl or nal_type in (1, 5)
    if pending:
        if pending_vcl or not aus:
            aus.append(pending)
        else:
            aus[-1] += pending              # trailing parameter sets
    return aus


def decode_h264(stream: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode an Annex-B H.264 stream → list of (y, u, v) uint8 planes."""
    s = _load()
    avcodec, avutil = s["avcodec"], s["avutil"]

    codec = avcodec.avcodec_find_decoder(AV_CODEC_ID_H264)
    if not codec:
        raise OracleUnavailable("libavcodec has no h264 decoder")
    ctx = avcodec.avcodec_alloc_context3(c_void_p(codec))
    if not ctx:
        raise OracleUnavailable("could not alloc codec context")
    if avcodec.avcodec_open2(c_void_p(ctx), c_void_p(codec), None) < 0:
        raise OracleUnavailable("could not open h264 decoder")

    pkt = avcodec.av_packet_alloc()
    frm = avutil.av_frame_alloc()
    frames: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def _drain():
        while True:
            ret = avcodec.avcodec_receive_frame(c_void_p(ctx), frm)
            if ret in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            if ret < 0:
                raise RuntimeError(f"avcodec_receive_frame failed: {ret}")
            f = frm.contents
            if f.format not in (0, 12):  # YUV420P / YUVJ420P
                raise RuntimeError(f"unexpected pix_fmt {f.format}")
            w, h = f.width, f.height
            planes = []
            for pi, (pw, ph) in enumerate(((w, h), (w // 2, h // 2), (w // 2, h // 2))):
                ls = f.linesize[pi]
                buf = ctypes.cast(f.data[pi], POINTER(c_ubyte * (ls * ph))).contents
                arr = np.frombuffer(buf, np.uint8).reshape(ph, ls)[:, :pw].copy()
                planes.append(arr)
            frames.append(tuple(planes))

    try:
        for au in split_access_units(stream):
            if avcodec.av_new_packet(pkt, len(au)) < 0:
                raise RuntimeError("av_new_packet failed")
            ctypes.memmove(pkt.contents.data, au, len(au))
            ret = avcodec.avcodec_send_packet(c_void_p(ctx), pkt)
            avcodec.av_packet_unref(pkt)
            if ret < 0:
                raise RuntimeError(f"avcodec_send_packet failed: {ret}")
            _drain()
        avcodec.avcodec_send_packet(c_void_p(ctx), None)  # flush
        _drain()
    finally:
        avcodec.avcodec_free_context(byref(c_void_p(ctx)))
        avcodec.av_packet_free(byref(pkt))
        avutil.av_frame_free(byref(frm))
    return frames


def oracle_available() -> bool:
    try:
        _load()
        return True
    except OracleUnavailable:
        return False
