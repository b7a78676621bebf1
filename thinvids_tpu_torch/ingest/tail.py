"""Tail ingest: follow a GROWING media source for live encoding (a copy
of the reference package's module).

The reference's watch folder was batch-only — a file had to stop
changing before the watcher would submit it. A live origin inverts
that: the source is an append-only stream (a y4m file a capture
process is still writing, or a local socket spooled into one), and
the encoder follows the live edge GOP-by-GOP while the writer is
still appending (ROADMAP "Live ABR pipeline"; SURVEY §2.4
watch-folder-as-ingest, generalized to a file that never "settles").

:class:`TailFrameSource` wraps the same fixed-record y4m arithmetic
as :class:`io.y4m.Y4MRangeReader` — 8-bit y4m frames are constant-size
records, so the number of COMPLETE frames on disk is a pure function
of the file size, and a mid-frame partial append simply doesn't count
yet (floor division; the torn tail record becomes visible on a later
poll once the writer finishes it). End-of-stream is declared by a
stall timeout: when the file stops growing for `stall_timeout_s`
seconds (or the writer drops a ``<path>.eos`` marker for an explicit,
latency-free close), the stream ends CLEANLY — the live pipeline
finalizes its playlists instead of failing the job.

:func:`spool_stream` adapts any byte stream (a local socket's
makefile, a pipe) into the growing-file form, so socket ingest rides
the exact same tail path the file case uses.

torch- and jax-free by contract: tailing runs on executor threads and
in tests that never load a device backend.
"""

from __future__ import annotations

import os
import time
from typing import BinaryIO, Iterator

import numpy as np

from ..core.types import Frame, VideoMeta
from ..io.y4m import Y4MReader
from .decode import DecodeError, FrameSource

#: filename convention marking a watch-folder drop as a live stream
#: (`clip.live.y4m` → job_type "live"; mirrors the `.ladder` suffix)
LIVE_STEM_SUFFIX = ".live"

#: sidecar marker a writer may create to close the stream explicitly
#: (zero added latency vs waiting out the stall timeout)
EOS_SUFFIX = ".eos"


def is_live_name(path: str) -> bool:
    """True when the filename opts into live ingest (stem ends with
    ``.live``, e.g. ``game7.live.y4m`` — same stem-suffix contract as
    ``.ladder``, so derived names don't inherit it)."""
    stem = os.path.splitext(os.path.basename(path))[0].lower()
    return stem.endswith(LIVE_STEM_SUFFIX)


class TailFrameSource(FrameSource):
    """Follow a growing 8-bit y4m file frame-by-frame.

    `len()` / iteration cover the frames COMPLETE on disk right now;
    the live-specific surface is :meth:`wait_frames` (block until the
    file has grown past a frame count, a poll + EOF-retry loop) and
    :attr:`ended` (the stall timeout or `.eos` marker fired — no more
    frames will ever appear). `read_range` re-stats the file per call,
    so a reader thread and the appending writer never share a cursor.
    """

    def __init__(self, path: str | os.PathLike,
                 stall_timeout_s: float = 10.0,
                 poll_s: float = 0.05) -> None:
        super().__init__()
        self.path = os.fspath(path)
        self.stall_timeout_s = max(0.1, float(stall_timeout_s))
        self.poll_s = max(0.005, float(poll_s))
        self.audio = None
        self.ended = False
        self._wait_header()

    # -- header ---------------------------------------------------------

    def _wait_header(self) -> None:
        """Poll until the stream header is parseable — the writer may
        have created the file but not finished the header line yet. A
        header that never arrives within the stall budget is a
        DecodeError, not a hang."""
        deadline = time.monotonic() + self.stall_timeout_s
        last_err: Exception | None = None
        while True:
            try:
                with open(self.path, "rb") as fp:
                    header = Y4MReader(fp)
                    self._data_start = fp.tell()
                break
            except (FileNotFoundError, EOFError, ValueError) as exc:
                last_err = exc
                if time.monotonic() >= deadline:
                    raise DecodeError(
                        f"no parseable y4m header in {self.path} after "
                        f"{self.stall_timeout_s:.1f}s: {last_err}"
                    ) from last_err
                time.sleep(self.poll_s)
        self._header = header
        self._shapes = header._plane_shapes()
        self._marker = b"FRAME\n"
        payload = sum(h * w for h, w in self._shapes)
        self._record = len(self._marker) + payload

    @property
    def meta(self) -> VideoMeta:
        h = self._header
        n = self.available()
        return VideoMeta(
            width=h.width, height=h.height,
            fps_num=h.fps_num, fps_den=h.fps_den,
            num_frames=n, chroma=h.chroma, codec="rawvideo",
            duration_s=n / h.meta.fps if h.meta.fps else 0.0,
            size_bytes=self._size(),
        )

    # -- growth tracking -------------------------------------------------

    def _size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def available(self) -> int:
        """COMPLETE frames on disk right now. A torn tail record (the
        writer is mid-frame) is excluded by the floor division and
        becomes visible on a later call."""
        return max(0, (self._size() - self._data_start) // self._record)

    def _eos_marked(self) -> bool:
        return os.path.exists(self.path + EOS_SUFFIX)

    def wait_frames(self, count: int, stop_check=None) -> int:
        """Block until at least `count` complete frames exist, the
        writer closes the stream (`.eos` marker), or the file stops
        growing for `stall_timeout_s` (clean end-of-stream). Returns
        the frames available at return; after `ended` is True the
        count is final. `stop_check()` (optional) is polled each tick
        so a fenced/stopped job aborts the wait in ~`poll_s` instead
        of riding out the stall budget."""
        last_size = self._size()
        stall_deadline = time.monotonic() + self.stall_timeout_s
        while True:
            n = self.available()
            if n >= count:
                return n
            if self._eos_marked():
                self.ended = True
                return self.available()
            if stop_check is not None and stop_check():
                return n
            size = self._size()
            if size != last_size:
                last_size = size
                stall_deadline = time.monotonic() + self.stall_timeout_s
            elif time.monotonic() >= stall_deadline:
                self.ended = True
                return self.available()
            time.sleep(self.poll_s)

    # -- FrameSource surface ---------------------------------------------

    def __len__(self) -> int:
        return self.available()

    def iter_frames(self, start: int = 0,
                    stop: int | None = None) -> Iterator[Frame]:
        """Yield COMPLETE frames [start, stop) from their byte offsets
        (the Y4MRangeReader arithmetic, re-statted per call so the
        range never reads past the writer's last full record)."""
        n = self.available()
        stop = n if stop is None else min(stop, n)
        start = max(0, start)
        if stop <= start:
            return
        with open(self.path, "rb") as fp:
            fp.seek(self._data_start + start * self._record)
            for idx in range(start, stop):
                marker = fp.read(len(self._marker))
                if marker != self._marker:
                    raise ValueError(
                        f"{self.path}: frame {idx} marker {marker!r} is "
                        f"not a bare FRAME record (parameterized y4m "
                        f"frame headers are unsupported for tailing)")
                planes = []
                for h, w in self._shapes:
                    data = fp.read(h * w)
                    if len(data) != h * w:
                        raise EOFError("truncated y4m frame payload")
                    planes.append(
                        np.frombuffer(data, np.uint8).reshape(h, w))
                y = planes[0]
                u, v = ((planes[1], planes[2]) if len(planes) == 3
                        else (None, None))
                self.frames_decoded += 1
                yield Frame(y, u, v, pts=idx)


def spool_stream(stream: BinaryIO, path: str | os.PathLike,
                 chunk_bytes: int = 1 << 16,
                 mark_eos: bool = True) -> int:
    """Copy a byte stream (local socket makefile, pipe, stdin) into an
    append-only file so socket ingest reuses the growing-file tail
    path. Blocks until the stream EOFs; drops the ``.eos`` marker on
    completion so the tailer ends without waiting out the stall
    budget. Returns bytes spooled."""
    path = os.fspath(path)
    total = 0
    with open(path, "ab") as out:
        while True:
            chunk = stream.read(chunk_bytes)
            if not chunk:
                break
            out.write(chunk)
            out.flush()
            total += len(chunk)
    if mark_eos:
        with open(path + EOS_SUFFIX, "wb"):
            pass
    return total
