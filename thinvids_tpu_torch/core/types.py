"""Core video data types (the subset the GOP encode path uses).

Frames are numpy arrays of YUV planes padded to block-aligned shapes so
every downstream kernel sees static, tile-friendly shapes. Descriptor
dataclasses (GopSpec/SegmentPlan) are the typed analog of the
reference's job hash and its parts planning.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

import numpy as np


class ChromaFormat(enum.Enum):
    YUV400 = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3

    @property
    def has_chroma(self) -> bool:
        return self is not ChromaFormat.YUV400

    @property
    def subsampling(self) -> tuple[int, int]:
        """(horizontal, vertical) chroma divisors.

        YUV400 reports (1, 1) so generic ``dim // divisor`` callers never
        divide by zero; gate on :attr:`has_chroma` before touching chroma.
        """
        return {
            ChromaFormat.YUV400: (1, 1),
            ChromaFormat.YUV420: (2, 2),
            ChromaFormat.YUV422: (2, 1),
            ChromaFormat.YUV444: (1, 1),
        }[self]


class FrameType(enum.IntEnum):
    I = 0
    P = 1
    B = 2


@dataclasses.dataclass(frozen=True)
class VideoMeta:
    """Probe result for a source video (analog of the reference's ffprobe
    surface)."""

    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    num_frames: int = 0
    chroma: ChromaFormat = ChromaFormat.YUV420
    bit_depth: int = 8
    codec: str = "raw"
    duration_s: float = 0.0
    size_bytes: int = 0

    @property
    def fps(self) -> float:
        return self.fps_num / max(1, self.fps_den)

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16


def pad_to_multiple(plane: np.ndarray, mult: int, fill: str = "edge") -> np.ndarray:
    """Pad a 2-D plane up to a multiple of `mult` in both dims.

    Edge replication matches encoder convention (padding never introduces
    artificial gradients at the picture boundary).
    """
    h, w = plane.shape
    ph = (mult - h % mult) % mult
    pw = (mult - w % mult) % mult
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode=fill)


def pad_to_shape(plane: np.ndarray, h: int, w: int, fill: str = "edge") -> np.ndarray:
    """Pad a 2-D plane up to an exact (h, w) target with edge replication."""
    ch, cw = plane.shape
    if ch > h or cw > w:
        raise ValueError(f"plane {plane.shape} larger than target {(h, w)}")
    if (ch, cw) == (h, w):
        return plane
    return np.pad(plane, ((0, h - ch), (0, w - cw)), mode=fill)


@dataclasses.dataclass
class Frame:
    """One video frame as planar YUV arrays (uint8, full range of the
    8-bit studio swing is preserved; no normalization).

    Planes are stored UNpadded; kernels pad on ingest so the stored frame
    remains the ground truth for quality metrics.
    """

    y: np.ndarray
    u: np.ndarray | None = None
    v: np.ndarray | None = None
    pts: int = 0
    frame_type: FrameType = FrameType.I

    @property
    def width(self) -> int:
        return int(self.y.shape[1])

    @property
    def height(self) -> int:
        return int(self.y.shape[0])

    def _chroma_divisors(self) -> tuple[int, int]:
        """(horizontal, vertical) divisors inferred from u-plane shape via
        per-axis ceil-division ratios (robust to odd source dimensions).

        Each chroma axis must be exactly ceil(luma/2) or exactly luma —
        anything else is a malformed plane, not a subsampling format."""
        ch, cw = self.u.shape
        if cw == (self.width + 1) // 2:
            hdiv = 2
        elif cw == self.width:
            hdiv = 1
        else:
            raise ValueError(
                f"chroma width {cw} matches neither {self.width} (4:4:4) "
                f"nor {(self.width + 1) // 2} (4:2:x) for luma width "
                f"{self.width}")
        if ch == (self.height + 1) // 2:
            vdiv = 2
        elif ch == self.height:
            vdiv = 1
        else:
            raise ValueError(
                f"chroma height {ch} matches neither {self.height} nor "
                f"{(self.height + 1) // 2} for luma height {self.height}")
        if (hdiv, vdiv) == (1, 2):
            raise ValueError("4:4:0 chroma layout is not supported")
        return hdiv, vdiv

    @property
    def chroma(self) -> ChromaFormat:
        if self.u is None:
            return ChromaFormat.YUV400
        return {
            (2, 2): ChromaFormat.YUV420,
            (2, 1): ChromaFormat.YUV422,
            (1, 1): ChromaFormat.YUV444,
        }[self._chroma_divisors()]

    def padded(self, mult: int = 16) -> "Frame":
        """Pad planes so luma is a multiple of ``mult`` in both dims and each
        chroma plane is exactly padded_luma_dim // divisor per axis (the
        invariant every block kernel assumes)."""
        y = pad_to_multiple(self.y, mult)
        u = self.u
        v = self.v
        if (u is None) != (v is None):
            raise ValueError("frame must have both u and v planes, or neither")
        if u is not None:
            ph, pw = y.shape
            hdiv, vdiv = self._chroma_divisors()
            u = pad_to_shape(u, ph // vdiv, pw // hdiv)
            v = pad_to_shape(v, ph // vdiv, pw // hdiv)
        return Frame(y, u, v, self.pts, self.frame_type)


@dataclasses.dataclass(frozen=True)
class GopSpec:
    """A closed GOP: the unit of parallel work (the analog of a
    reference 'part')."""

    index: int            # GOP index within the job (concat order)
    start_frame: int      # first frame (inclusive) in source order
    num_frames: int       # frames in this GOP
    idr: bool = True      # closed GOP: leading frame is an IDR

    @property
    def end_frame(self) -> int:
        return self.start_frame + self.num_frames


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Full sharding plan for a job: GOP boundaries + device layout.

    Mirrors the reference parts-planner semantics: target work size per
    shard, rounded up to a multiple of the usable worker (device) count so
    waves fill the farm.
    """

    gops: tuple[GopSpec, ...]
    num_devices: int
    frames_per_gop: int

    @property
    def num_gops(self) -> int:
        return len(self.gops)

    @property
    def waves(self) -> int:
        return math.ceil(self.num_gops / max(1, self.num_devices))


@dataclasses.dataclass
class EncodedSegment:
    """One encoded GOP's bitstream + bookkeeping (the analog of an encoded
    part handed to the reference's stitcher)."""

    gop: GopSpec
    payload: bytes                    # Annex-B access units, concat-safe
    frame_sizes: tuple[int, ...] = ()
    distortion_sse: float = 0.0
    elapsed_s: float = 0.0

    @property
    def size_bytes(self) -> int:
        return len(self.payload)


def concat_segments(segments: Sequence[EncodedSegment]) -> bytes:
    """Order-restoring concat (the reference stitcher's frontier-ordered
    concat). Segments must be closed GOPs starting with IDR + parameter
    sets so the join is seamless."""
    ordered = sorted(segments, key=lambda s: s.gop.index)
    expect = 0
    for seg in ordered:
        if seg.gop.index < expect:
            raise ValueError(f"duplicate segment index {seg.gop.index}")
        if seg.gop.index > expect:
            raise ValueError(f"missing segment index {expect}")
        expect += 1
    return b"".join(s.payload for s in ordered)
