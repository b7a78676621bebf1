"""Frame-index watermark ("stamp") verification harness.

The reference's de-facto correctness check is its stamp() task: burn the
frame number into each frame with drawtext, run the distributed pipeline
on the stamped file, and visually step through the output looking for
drops/dups at segment joins.
Here the same idea is an *automated* harness (SURVEY.md §4): the stamp
is a machine-decodable block watermark, so a test can encode a stamped
clip through the sharded pipeline, decode it with the independent
libavcodec oracle, and assert the exact frame order/count across every
GOP seam.

Watermark format: `STAMP_BITS` bits of the frame index, one 16x16 luma
block per bit along the top-left of the frame (MSB first), value 192
for a 1-bit and 64 for a 0-bit. A block mean survives qp <= ~40
quantization with enormous margin (the decision threshold is 128 with
a +/-64 design distance).
"""

from __future__ import annotations

import numpy as np

from ..core.types import Frame, VideoMeta

STAMP_BITS = 16
_BLOCK = 16
_ONE, _ZERO = 192, 64


def stamp_width_px() -> int:
    return STAMP_BITS * _BLOCK


def stamp_frame(frame: Frame, index: int) -> Frame:
    """Return a copy of `frame` with `index` watermarked into the luma
    top row. Chroma is untouched. Requires width >= stamp_width_px()."""
    h, w = frame.y.shape
    if w < stamp_width_px() or h < _BLOCK:
        raise ValueError(
            f"frame {w}x{h} too small for a {STAMP_BITS}-bit stamp "
            f"(needs >= {stamp_width_px()}x{_BLOCK})")
    if not 0 <= index < (1 << STAMP_BITS):
        raise ValueError(f"index {index} exceeds {STAMP_BITS} stamp bits")
    y = frame.y.copy()
    for b in range(STAMP_BITS):
        bit = (index >> (STAMP_BITS - 1 - b)) & 1
        y[:_BLOCK, b * _BLOCK:(b + 1) * _BLOCK] = _ONE if bit else _ZERO
    return Frame(y=y, u=frame.u, v=frame.v)


def read_stamp(y_plane: np.ndarray) -> int:
    """Decode the frame index from a (possibly lossily coded) luma
    plane."""
    idx = 0
    for b in range(STAMP_BITS):
        block = y_plane[:_BLOCK, b * _BLOCK:(b + 1) * _BLOCK]
        idx = (idx << 1) | (1 if float(block.mean()) >= 128.0 else 0)
    return idx


def make_stamped_clip(n: int, w: int, h: int, seed: int = 0
                      ) -> tuple[list[Frame], VideoMeta]:
    """Synthetic moving-content clip with every frame index stamped —
    the standard input for seam tests."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base_u = np.full((h // 2, w // 2), 110, np.uint8)
    base_v = np.full((h // 2, w // 2), 140, np.uint8)
    frames = []
    for i in range(n):
        y = ((xx + 3 * i + (yy >> 1)) % 256).astype(np.uint8)
        y[h // 2:, :] = np.clip(
            y[h // 2:, :] + rng.integers(-8, 9, (h - h // 2, w)), 0, 255
        ).astype(np.uint8)
        frames.append(stamp_frame(Frame(y=y, u=base_u, v=base_v), i))
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    return frames, meta


def verify_frame_order(decoded_y_planes, expected_count: int
                       ) -> list[str]:
    """Check a decoded stamped clip for drops / dups / reorders.

    Returns a list of human-readable problems (empty = clean). This is
    the automated replacement for the reference's visual frame-stepping
    check (manager/templates/index.html:317-335).
    """
    problems: list[str] = []
    got = [read_stamp(y) for y in decoded_y_planes]
    if len(got) != expected_count:
        problems.append(
            f"frame count {len(got)} != expected {expected_count}")
    for pos, idx in enumerate(got):
        if idx != pos:
            problems.append(f"position {pos} carries stamp {idx}")
            if len(problems) > 8:
                problems.append("...")
                break
    return problems
