"""Media probing: header-only metadata extraction for ingest.

The reference probed sources by shelling out to ffprobe with a timeout;
here probing is native: parse the container header and derive stream
facts without reading frame payloads.
"""

from __future__ import annotations

import os

from ..core.types import VideoMeta


class ProbeError(ValueError):
    """File is not probeable media (unknown container or bad header)."""


def _probe_y4m(path: str) -> VideoMeta:
    from ..io.y4m import Y4MReader

    size = os.path.getsize(path)
    with open(path, "rb") as fp:
        reader = Y4MReader(fp)
        header_len = fp.tell()
    meta = reader.meta
    # Frame payload size is constant for 8-bit y4m; each frame is a
    # "FRAME\n" marker + planes. Frame-header parameters would break
    # this arithmetic, but Y4MWriter never emits them and the reader
    # rejects interlaced input already.
    plane_bytes = sum(h * w for (h, w) in reader._plane_shapes())
    per_frame = len(b"FRAME\n") + plane_bytes
    num_frames = max(0, (size - header_len) // per_frame)
    fps = meta.fps if meta.fps else 30.0
    return VideoMeta(
        width=meta.width, height=meta.height,
        fps_num=meta.fps_num, fps_den=meta.fps_den,
        num_frames=int(num_frames), chroma=meta.chroma,
        codec="rawvideo", duration_s=num_frames / fps,
        size_bytes=size,
    )


def _probe_mp4(path: str) -> VideoMeta:
    from ..io.mp4 import probe_mp4_header

    info = probe_mp4_header(path)       # moov-only: never loads mdat
    return VideoMeta(
        width=info["width"], height=info["height"],
        fps_num=info["fps_num"], fps_den=info["fps_den"],
        num_frames=info["num_frames"], codec=info["codec"],
        duration_s=info["duration_s"],
        size_bytes=os.path.getsize(path))


_PROBERS = {
    ".y4m": _probe_y4m,
    ".mp4": _probe_mp4,
}


def probe_video(path: str | os.PathLike) -> VideoMeta:
    """Probe a media file's metadata from its header.

    Raises :class:`ProbeError` for unsupported or malformed files —
    the watcher treats those as non-media and skips them.
    """
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    prober = _PROBERS.get(ext)
    if prober is None:
        raise ProbeError(f"unsupported media extension {ext!r}: {path}")
    try:
        return prober(path)
    except (OSError, ValueError, EOFError) as exc:
        raise ProbeError(f"cannot probe {path}: {exc}") from exc
