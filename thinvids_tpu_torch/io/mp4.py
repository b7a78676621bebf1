"""Minimal ISO-BMFF (MP4) muxer + demuxer for H.264 streams.

A copy of the reference package's muxer, byte for byte in what it
writes: Annex-B in, faststart MP4 out (moov before
mdat), video track avc1 + avcC with stss sync samples, plus optional
bit-exact passthrough of one source audio track (the sample entry and
sample bytes are copied verbatim). The demuxer reads the same subset
back — enough to transcode MP4 inputs and carry their audio through.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterable

from ..core.types import VideoMeta

_NAL_SPS, _NAL_PPS, _NAL_SEI, _NAL_AUD = 7, 8, 6, 9
_NAL_IDR = 5

# Largest mdat payload a 32-bit box size can carry (8 header bytes, and
# the stco offsets must stay 32-bit too).
_MAX_MDAT = 2**32 - 9


def split_annexb(stream: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into raw NAL units (no start codes)."""
    nals = []
    i = 0
    n = len(stream)
    while i < n:
        # find next start code (3- or 4-byte)
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        start = j + 3
        k = stream.find(b"\x00\x00\x01", start)
        end = n if k < 0 else (k - 1 if k > 0 and stream[k - 1] == 0 else k)
        nal = stream[start:end]
        while nal.endswith(b"\x00"):        # trailing zero padding
            nal = nal[:-1]
        if nal:
            nals.append(nal)
        i = start if k < 0 else k
        if k < 0:
            break
    return nals


def annexb_to_samples(stream: bytes
                      ) -> tuple[bytes, bytes, list[bytes], list[bool]]:
    """(sps, pps, samples, keyflags): AVCC length-prefixed samples, one
    per coded PICTURE. A picture may span several slices (split-frame
    encoding codes one slice per MB-row band): a VCL NAL with
    first_mb_in_slice == 0 opens a new sample and the picture's later
    slices (first_mb != 0) ride in the same sample — one NAL per sample
    would split a frame across MP4 samples and desync every timestamp
    after it."""
    from .bits import slice_first_mb

    sps = b""
    pps = b""
    samples: list[bytes] = []
    keyflags: list[bool] = []
    cur: list[bytes] = []
    cur_key = False

    def flush() -> None:
        nonlocal cur, cur_key
        if cur:
            samples.append(b"".join(
                struct.pack(">I", len(n)) + n for n in cur))
            keyflags.append(cur_key)
            cur, cur_key = [], False

    for nal in split_annexb(stream):
        ntype = nal[0] & 0x1F
        if ntype == _NAL_SPS:
            sps = sps or nal
        elif ntype == _NAL_PPS:
            pps = pps or nal
        elif ntype in (_NAL_SEI, _NAL_AUD):
            continue
        elif ntype in (1, _NAL_IDR):
            if slice_first_mb(nal) == 0:
                flush()
            cur.append(nal)
            cur_key = cur_key or ntype == _NAL_IDR
    flush()
    if not sps or not pps:
        raise ValueError("stream has no SPS/PPS")
    return sps, pps, samples, keyflags


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _avcc(sps: bytes, pps: bytes) -> bytes:
    cfg = bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
    cfg += struct.pack(">H", len(sps)) + sps
    cfg += bytes([1]) + struct.pack(">H", len(pps)) + pps
    return _box(b"avcC", cfg)


def _matrix() -> bytes:
    return struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def avc1_sample_entry(w: int, h: int, sps: bytes, pps: bytes) -> bytes:
    """Complete avc1 VisualSampleEntry box (shared by the progressive
    muxer below and the fMP4 HLS packager, abr/hls.py)."""
    return _box(
        b"avc1",
        b"\x00" * 6, struct.pack(">H", 1),            # reserved + dref idx
        b"\x00" * 16,
        struct.pack(">HH", w, h),
        struct.pack(">II", 0x480000, 0x480000),       # 72 dpi
        b"\x00" * 4,
        struct.pack(">H", 1),                         # frame count
        b"\x00" * 32,                                 # compressor name
        struct.pack(">Hh", 0x18, -1),                 # depth, color table
        _avcc(sps, pps),
    )


@dataclasses.dataclass
class Mp4Track:
    """One demuxed track, carried losslessly enough to re-mux.

    `stsd_entry` is the raw sample-entry box (e.g. a complete mp4a/avc1
    box) copied verbatim — passthrough never re-interprets codec
    config. `stts` is [(count, delta), ...] in `timescale` units.
    """

    handler: str                 # "vide" | "soun" | ...
    stsd_entry: bytes
    timescale: int
    stts: list[tuple[int, int]]
    samples: list[bytes]

    @property
    def duration(self) -> int:
        return sum(c * d for c, d in self.stts)


def _track_boxes(track_id: int, handler: bytes, hdlr_name: bytes,
                 media_header: bytes, stsd_entry: bytes,
                 stts_entries: list[tuple[int, int]],
                 samples: list[bytes], sync: list[int] | None,
                 timescale: int, duration_ts: int, movie_timescale: int,
                 chunk_offset: int, tkhd_dims: bytes) -> bytes:
    """One complete trak box (single chunk at `chunk_offset`)."""
    n = len(samples)
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), stsd_entry)
    stts = _full(b"stts", 0, 0, struct.pack(">I", len(stts_entries)),
                 b"".join(struct.pack(">II", c, d)
                          for c, d in stts_entries))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                 b"".join(struct.pack(">I", len(s)) for s in samples))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    stbl_parts = [stsd, stts, stsc, stsz]
    if sync is not None:
        stbl_parts.append(
            _full(b"stss", 0, 0, struct.pack(">I", len(sync)),
                  b"".join(struct.pack(">I", i) for i in sync)))
    stbl_parts.append(stco)
    stbl = _box(b"stbl", *stbl_parts)
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                               _full(b"url ", 0, 1)))
    minf = _box(b"minf", media_header, dinf, stbl)
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale,
                                            duration_ts, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0), handler,
                 b"\x00" * 12, hdlr_name)
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    movie_dur = duration_ts * movie_timescale // max(1, timescale)
    # Spec layout (ISO 14496-12 §8.3.2, version 0; 92 bytes total):
    # creation/modification/track_ID/reserved/duration, reserved[8],
    # layer/alternate_group/volume/reserved, matrix, width/height.
    volume = 0x0100 if handler == b"soun" else 0
    tkhd = _full(b"tkhd", 0, 3,
                 struct.pack(">IIIII", 0, 0, track_id, 0, movie_dur),
                 struct.pack(">IIHHHH", 0, 0, 0, 0, volume, 0),
                 _matrix(), tkhd_dims)
    return _box(b"trak", tkhd, mdia)


def mux_mp4(stream: bytes, meta: VideoMeta,
            audio: Mp4Track | None = None) -> bytes:
    """Annex-B H.264 elementary stream → faststart MP4 bytes, with
    optional bit-exact audio-track passthrough (the source's default
    audio track)."""
    sps, pps, samples, keys = annexb_to_samples(stream)
    n = len(samples)
    if n == 0:
        raise ValueError("no coded pictures in stream")
    timescale = 90000
    sample_dur = timescale * meta.fps_den // max(1, meta.fps_num)
    duration = sample_dur * n
    w, h = meta.width, meta.height

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isomiso2avc1mp41")

    avc1 = avc1_sample_entry(w, h, sps, pps)
    sync = [i + 1 for i, k in enumerate(keys) if k]
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">4H", 0, 0, 0, 0))
    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))

    video_bytes = sum(len(s) for s in samples)
    audio_bytes = sum(len(s) for s in audio.samples) if audio else 0
    if video_bytes + audio_bytes > _MAX_MDAT:
        # All box sizes here are 32-bit; a largesize mdat would also need
        # co64 chunk offsets. Fail loudly (and before allocating the full
        # payload copy) rather than emit a broken file.
        raise ValueError(
            f"mdat payload {video_bytes + audio_bytes} bytes exceeds the "
            f"32-bit box-size limit (~4 GiB); split the clip into "
            f"segments")

    def build_moov(video_off: int, audio_off: int) -> bytes:
        traks = [_track_boxes(
            1, b"vide", b"VideoHandler\x00", vmhd, avc1,
            [(n, sample_dur)], samples, sync, timescale, duration,
            timescale, video_off, struct.pack(">II", w << 16, h << 16))]
        if audio is not None:
            traks.append(_track_boxes(
                2, b"soun", b"SoundHandler\x00", smhd, audio.stsd_entry,
                audio.stts, audio.samples, None, audio.timescale,
                audio.duration, timescale, audio_off,
                struct.pack(">II", 0, 0)))
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, timescale,
                                                duration),
                     struct.pack(">IH", 0x00010000, 0x0100), b"\x00" * 10,
                     _matrix(), b"\x00" * 24,
                     struct.pack(">I", len(traks) + 1))
        return _box(b"moov", mvhd, *traks)

    # moov size is offset-independent (fixed-width fields): measure with
    # zeros, then rebuild with the real chunk offsets.
    moov_len = len(build_moov(0, 0))
    video_off = len(ftyp) + moov_len + 8
    audio_off = video_off + video_bytes
    moov = build_moov(video_off, audio_off)
    assert len(moov) == moov_len
    mdat_payload = b"".join(samples) + (
        b"".join(audio.samples) if audio else b"")
    return ftyp + moov + _box(b"mdat", mdat_payload)


def write_mp4(path, stream: bytes, meta: VideoMeta,
              audio: Mp4Track | None = None) -> int:
    data = mux_mp4(stream, meta, audio=audio)
    with open(path, "wb") as fp:
        fp.write(data)
    return len(data)


# ---- demuxer ---------------------------------------------------------------

@dataclasses.dataclass
class Mp4Media:
    """Demux result: decoded-enough video + passthrough-ready audio."""

    width: int
    height: int
    timescale: int
    duration_ts: int
    keyflags: list[bool]
    video: Mp4Track
    audio: Mp4Track | None

    @property
    def annexb(self) -> bytes:
        """Whole-stream Annex-B (SPS+PPS+slices with start codes).

        LAZY and uncached: built from the samples on each access, so a
        long-lived Mp4Media (the streaming ingest's per-worker source
        cache) doesn't pin a second whole-clip copy it never reads —
        range decodes go through :meth:`annexb_for`. Callers that need
        the full stream repeatedly should hold the result."""
        return _avcc_to_annexb(self.video.stsd_entry,
                               self.video.samples)[0]

    @property
    def num_frames(self) -> int:
        return len(self.video.samples)

    @property
    def fps(self) -> tuple[int, int]:
        """(fps_num, fps_den) from the dominant stts delta."""
        stts = self.video.stts
        if not stts:
            return 30, 1
        delta = max(stts, key=lambda cd: cd[0])[1]
        return self.timescale, max(1, delta)

    def sync_samples(self) -> list[int]:
        """Sync-sample (keyframe) indices, 0-based, always containing 0
        (decode has to start at the stream head when nothing earlier is
        marked). The GOP-range decode grid for streaming ingest."""
        keys = [i for i, k in enumerate(self.keyflags) if k]
        return keys if keys and keys[0] == 0 else [0] + keys

    def annexb_for(self, start: int, stop: int) -> bytes:
        """Annex-B stream of the sample range [start, stop) with the
        parameter sets prepended — the GOP-range decode unit for
        streaming ingest (`start` should be a sync sample so the range
        opens on an IDR)."""
        return _avcc_to_annexb(self.video.stsd_entry,
                               self.video.samples[start:stop])[0]


def _iter_boxes(buf: bytes, start: int, end: int):
    """Yield (kind, payload_start, payload_end) for each box in range,
    handling 64-bit largesize."""
    i = start
    while i + 8 <= end:
        size = struct.unpack_from(">I", buf, i)[0]
        kind = buf[i + 4:i + 8]
        payload = i + 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, i + 8)[0]
            payload = i + 16
        elif size == 0:                # box extends to end of file
            size = end - i
        if size < 8 or i + size > end:
            raise ValueError(f"malformed box {kind!r} at {i}")
        yield kind, payload, i + size
        i += size


def _find_box(buf: bytes, start: int, end: int, kind: bytes
              ) -> tuple[int, int] | None:
    for k, s, e in _iter_boxes(buf, start, end):
        if k == kind:
            return s, e
    return None


def _parse_stts(buf, s, e) -> list[tuple[int, int]]:
    n = struct.unpack_from(">I", buf, s + 4)[0]
    return [struct.unpack_from(">II", buf, s + 8 + 8 * i) for i in range(n)]


def _parse_table(buf, s, e, fmt: str) -> list:
    n = struct.unpack_from(">I", buf, s + 4)[0]
    w = struct.calcsize(">" + fmt)
    return [struct.unpack_from(">" + fmt, buf, s + 8 + w * i)
            for i in range(n)]


def _track_samples(buf, stbl_s, stbl_e) -> tuple[bytes, list[bytes],
                                                 list[tuple[int, int]],
                                                 list[int]]:
    """(stsd_entry, samples, stts, sync_sample_numbers) for one track."""
    stsd = _find_box(buf, stbl_s, stbl_e, b"stsd")
    entry_s = stsd[0] + 8                       # version/flags + count
    entry_size = struct.unpack_from(">I", buf, entry_s)[0]
    stsd_entry = bytes(buf[entry_s:entry_s + entry_size])

    stts = _parse_stts(buf, *_find_box(buf, stbl_s, stbl_e, b"stts"))
    stsc = _parse_table(buf, *_find_box(buf, stbl_s, stbl_e, b"stsc"),
                        fmt="III")
    sz_s, sz_e = _find_box(buf, stbl_s, stbl_e, b"stsz")
    fixed, n_samples = struct.unpack_from(">II", buf, sz_s + 4)
    if fixed:
        sizes = [fixed] * n_samples
    else:
        sizes = [struct.unpack_from(">I", buf, sz_s + 12 + 4 * i)[0]
                 for i in range(n_samples)]
    co = _find_box(buf, stbl_s, stbl_e, b"stco")
    if co is not None:
        chunk_offs = [t[0] for t in _parse_table(buf, *co, fmt="I")]
    else:
        co = _find_box(buf, stbl_s, stbl_e, b"co64")
        chunk_offs = [t[0] for t in _parse_table(buf, *co, fmt="Q")]
    stss_box = _find_box(buf, stbl_s, stbl_e, b"stss")
    sync = ([t[0] for t in _parse_table(buf, *stss_box, fmt="I")]
            if stss_box else [])

    # expand stsc runs → samples-per-chunk, then walk chunks
    samples: list[bytes] = []
    n_chunks = len(chunk_offs)
    spc: list[int] = []
    for i, (first, count, _desc) in enumerate(stsc):
        last = (stsc[i + 1][0] - 1) if i + 1 < len(stsc) else n_chunks
        spc.extend([count] * (last - first + 1))
    si = 0
    for ci, off in enumerate(chunk_offs):
        pos = off
        for _ in range(spc[ci] if ci < len(spc) else 0):
            if si >= n_samples:
                break
            samples.append(bytes(buf[pos:pos + sizes[si]]))
            pos += sizes[si]
            si += 1
    return stsd_entry, samples, stts, sync


def _avcc_to_annexb(stsd_entry: bytes, samples: list[bytes]
                    ) -> tuple[bytes, int]:
    """avc1 sample entry + length-prefixed samples → Annex-B stream.
    Returns (annexb, nal_length_size)."""
    # the avcC box lives inside the avc1 entry after the 78-byte
    # VisualSampleEntry header
    inner = _find_box(stsd_entry, 8 + 78, len(stsd_entry), b"avcC")
    if inner is None:
        raise ValueError("avc1 entry has no avcC")
    s, e = inner
    cfg = stsd_entry[s:e]
    nal_len = (cfg[4] & 3) + 1
    n_sps = cfg[5] & 0x1F
    out = bytearray()
    i = 6
    for _ in range(n_sps):
        ln = struct.unpack_from(">H", cfg, i)[0]
        out += b"\x00\x00\x00\x01" + cfg[i + 2:i + 2 + ln]
        i += 2 + ln
    n_pps = cfg[i]
    i += 1
    for _ in range(n_pps):
        ln = struct.unpack_from(">H", cfg, i)[0]
        out += b"\x00\x00\x00\x01" + cfg[i + 2:i + 2 + ln]
        i += 2 + ln
    for sample in samples:
        j = 0
        while j + nal_len <= len(sample):
            ln = int.from_bytes(sample[j:j + nal_len], "big")
            out += b"\x00\x00\x00\x01" + sample[j + nal_len:
                                                j + nal_len + ln]
            j += nal_len + ln
    return bytes(out), nal_len


def demux_mp4(data: bytes) -> Mp4Media:
    """Parse an MP4: first avc1 video track → Annex-B, first audio
    track → passthrough Mp4Track. Raises ValueError on non-AVC video."""
    buf = memoryview(data)
    moov = _find_box(buf, 0, len(data), b"moov")
    if moov is None:
        raise ValueError("no moov box")
    video = audio = None
    vdims = (0, 0)
    vdur = 0
    for kind, ts_, te in _iter_boxes(buf, *moov):
        if kind != b"trak":
            continue
        mdia = _find_box(buf, ts_, te, b"mdia")
        hdlr = _find_box(buf, *mdia, kind=b"hdlr")
        handler = bytes(buf[hdlr[0] + 8:hdlr[0] + 12]).decode(
            "ascii", "replace")
        mdhd = _find_box(buf, *mdia, kind=b"mdhd")
        track_ts, track_dur = struct.unpack_from(">II", buf, mdhd[0] + 12)
        minf = _find_box(buf, *mdia, kind=b"minf")
        stbl = _find_box(buf, *minf, kind=b"stbl")
        if handler == "vide" and video is None:
            entry, samples, stts, sync = _track_samples(buf, *stbl)
            if entry[4:8] != b"avc1":
                raise ValueError(
                    f"unsupported video codec {entry[4:8]!r} (avc1 only)")
            vdims = struct.unpack_from(">HH", entry, 8 + 24)
            vdur = track_dur
            video = Mp4Track(handler="vide", stsd_entry=entry,
                             timescale=track_ts, stts=stts,
                             samples=samples)
            vsync = set(sync)
        elif handler == "soun" and audio is None:
            entry, samples, stts, _sync = _track_samples(buf, *stbl)
            audio = Mp4Track(handler="soun", stsd_entry=entry,
                             timescale=track_ts, stts=stts,
                             samples=samples)
    if video is None:
        raise ValueError("no video track")
    keyflags = [(i + 1 in vsync) if vsync else True
                for i in range(len(video.samples))]
    return Mp4Media(width=vdims[0], height=vdims[1],
                    timescale=video.timescale, duration_ts=vdur,
                    keyflags=keyflags, video=video, audio=audio)


def read_mp4(path) -> Mp4Media:
    with open(path, "rb") as fp:
        return demux_mp4(fp.read())


def probe_mp4_header(path) -> dict:
    """moov-only probe: stream facts without touching mdat (the watcher
    probes every new file; loading a multi-GB mp4 to read its header
    would stall the 1-core ingest host). Returns width, height,
    fps_num, fps_den, num_frames, duration_s, codec."""
    with open(path, "rb") as fp:
        moov_body = None
        while True:
            hdr = fp.read(8)
            if len(hdr) < 8:
                break
            size = struct.unpack(">I", hdr[:4])[0]
            kind = hdr[4:8]
            hdr_len = 8
            if size == 1:
                size = struct.unpack(">Q", fp.read(8))[0]
                hdr_len = 16
            elif size == 0:
                # ISO BMFF: size 0 = box extends to end of file. A
                # non-moov to-EOF box means no moov can follow (the old
                # 0-byte seek here re-parsed the box's own payload as
                # headers — a near-endless walk on multi-GB files).
                if kind != b"moov":
                    break
                size = None
            if kind == b"moov":
                moov_body = fp.read() if size is None \
                    else fp.read(size - hdr_len)
                break
            if size < hdr_len:          # malformed: would seek backwards
                break
            fp.seek(size - hdr_len, 1)
    if moov_body is None:
        raise ValueError("no moov box")
    buf = memoryview(moov_body)
    for kind, ts_, te in _iter_boxes(buf, 0, len(moov_body)):
        if kind != b"trak":
            continue
        mdia = _find_box(buf, ts_, te, b"mdia")
        hdlr = _find_box(buf, *mdia, kind=b"hdlr")
        if bytes(buf[hdlr[0] + 8:hdlr[0] + 12]) != b"vide":
            continue
        mdhd = _find_box(buf, *mdia, kind=b"mdhd")
        track_ts, track_dur = struct.unpack_from(">II", buf, mdhd[0] + 12)
        stbl = _find_box(buf, *_find_box(buf, *mdia, kind=b"minf"),
                         kind=b"stbl")
        stsd = _find_box(buf, *stbl, kind=b"stsd")
        entry_s = stsd[0] + 8
        codec = bytes(buf[entry_s + 4:entry_s + 8]).decode(
            "ascii", "replace")
        w, h = struct.unpack_from(">HH", buf, entry_s + 8 + 24)
        stts = _parse_stts(buf, *_find_box(buf, *stbl, kind=b"stts"))
        delta = max(stts, key=lambda cd: cd[0])[1] if stts else 0
        sz_s, _sz_e = _find_box(buf, *stbl, kind=b"stsz")
        _fixed, n_samples = struct.unpack_from(">II", buf, sz_s + 4)
        return {
            "width": w, "height": h,
            "fps_num": track_ts, "fps_den": max(1, delta),
            "num_frames": n_samples,
            "duration_s": track_dur / max(1, track_ts),
            "codec": "h264" if codec == "avc1" else codec,
        }
    raise ValueError("no video track")
