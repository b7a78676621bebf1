"""The video track of an MP4 (ISO/IEC 14496-12 and -15) as an H.264
Annex-B stream: the avcC parameter sets, then every sample's
length-prefixed NAL units behind start codes. Plain Python, for the
benchmark's check of the MP4s a job writes."""

from __future__ import annotations

import struct

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


def _boxes(buf: bytes, start: int, end: int):
    while start + 8 <= end:
        size, kind = struct.unpack_from(">I4s", buf, start)
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, start + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - start
        if size < hdr or start + size > end:
            raise ValueError(f"bad box {kind!r} at {start}")
        yield kind, start + hdr, start + size
        start += size


def _find(buf, start, end, path):
    for kind, s, e in _boxes(buf, start, end):
        if kind == path[0]:
            if len(path) == 1:
                return s, e
            found = _find(buf, s, e, path[1:])
            if found is not None:
                return found
    return None


def video_annexb(data: bytes) -> tuple[bytes, int]:
    """(Annex-B stream, number of samples) of the first avc1 track."""
    moov = _find(data, 0, len(data), [b"moov"])
    if moov is None:
        raise ValueError("no moov box")
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        stbl = _find(data, s, e, [b"mdia", b"minf", b"stbl"])
        if stbl is None:
            continue
        tables = {k: (a, b) for k, a, b in _boxes(data, *stbl)}
        stsd = tables.get(b"stsd")
        # stsd: full box (4) + entry count (4), then the sample entry
        if stsd is None or data[stsd[0] + 12:stsd[0] + 16] != b"avc1":
            continue
        entry = stsd[0] + 8
        esize = struct.unpack_from(">I", data, entry)[0]
        # visual sample entry: 8 header + 78 fields, then its boxes
        avcc = _find(data, entry + 86, entry + esize, [b"avcC"])
        if avcc is None:
            raise ValueError("avc1 without avcC")
        return _samples(data, avcc, tables)
    raise ValueError("no avc1 video track")


def _samples(data, avcc, tables):
    a = avcc[0]
    nal_len = (data[a + 4] & 3) + 1
    out = bytearray()
    p = a + 5
    for count_mask in (0x1F, 0xFF):            # SPS count, then PPS count
        n = data[p] & count_mask
        p += 1
        for _ in range(n):
            ln = struct.unpack_from(">H", data, p)[0]
            out += b"\x00\x00\x00\x01" + data[p + 2:p + 2 + ln]
            p += 2 + ln
    s, _ = tables[b"stsz"]
    fixed, count = struct.unpack_from(">II", data, s + 4)
    sizes = ([fixed] * count if fixed else
             list(struct.unpack_from(f">{count}I", data, s + 12)))
    if b"stco" in tables:
        s, _ = tables[b"stco"]
        n = struct.unpack_from(">I", data, s + 4)[0]
        offsets = struct.unpack_from(f">{n}I", data, s + 8)
    else:
        s, _ = tables[b"co64"]
        n = struct.unpack_from(">I", data, s + 4)[0]
        offsets = struct.unpack_from(f">{n}Q", data, s + 8)
    s, _ = tables[b"stsc"]
    n = struct.unpack_from(">I", data, s + 4)[0]
    runs = [struct.unpack_from(">III", data, s + 8 + 12 * k)
            for k in range(n)]
    k = 0
    for ci, off in enumerate(offsets):
        per = next(r[1] for r in reversed(runs) if r[0] <= ci + 1)
        for _ in range(per):
            if k >= count:
                break
            end = off + sizes[k]
            while off < end:
                ln = int.from_bytes(data[off:off + nal_len], "big")
                off += nal_len
                out += b"\x00\x00\x00\x01" + data[off:off + ln]
                off += ln
            k += 1
    if k != count:
        raise ValueError(f"chunks hold {k} of {count} samples")
    return bytes(out), count
