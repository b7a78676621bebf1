"""GOP segment planner — the parts-planner math.

Port of the reference's two-step plan: pick a target shard size, derive
the shard count, then round the count UP to a multiple of the usable
worker count so every dispatch wave fills the farm. Here "workers" are
devices and the unit is frames (closed GOPs), not bytes: a GOP boundary
is the only place an H.26x stream can be cut without cross-shard
prediction.
"""

from __future__ import annotations

import math

from ..core.types import BandPlan, BandSpec, GopSpec, SegmentPlan


def plan_segments(num_frames: int, gop_frames: int, num_devices: int,
                  max_segments: int = 200) -> SegmentPlan:
    """Plan closed-GOP shards for `num_frames` over `num_devices`.

    - `gop_frames` is the TARGET GOP length (the ~10 MB analog).
    - The GOP count is rounded up to a multiple of `num_devices` (when that
      doesn't push GOPs below 1 frame), mirroring the reference's wave
      balancing; bounded by `max_segments`.
    - Every frame is covered exactly once; all GOPs are closed (IDR-led).
    """
    if num_frames <= 0:
        raise ValueError("num_frames must be positive")
    if gop_frames <= 0 or num_devices <= 0:
        raise ValueError("gop_frames and num_devices must be positive")

    n = math.ceil(num_frames / gop_frames)
    # Round up to fill waves — only useful when there's at least one frame
    # per shard; tiny clips keep their natural count.
    rounded = math.ceil(n / num_devices) * num_devices
    if rounded <= num_frames:
        n = rounded
    n = min(n, max_segments, num_frames)

    base = num_frames // n
    extra = num_frames % n          # first `extra` GOPs get one more frame
    gops = []
    start = 0
    for i in range(n):
        length = base + (1 if i < extra else 0)
        gops.append(GopSpec(index=i, start_frame=start, num_frames=length))
        start += length
    assert start == num_frames
    return SegmentPlan(gops=tuple(gops), num_devices=num_devices,
                       frames_per_gop=gop_frames)


def plan_fixed_segments(num_frames: int, gop_frames: int,
                        num_devices: int = 1) -> SegmentPlan:
    """Fixed GOP grid: exactly `gop_frames` per GOP (short tail at the
    end), indices from 0 — boundaries a pure function of the frame
    index, never of device count or batch size. The split-frame path
    (parallel/dispatch.SfeShardEncoder) pins its latency-ordered GOP
    walk with it: the bands parallelize WITHIN a frame and must not
    reshape the GOP grid."""
    if num_frames <= 0:
        raise ValueError("num_frames must be positive")
    if gop_frames <= 0:
        raise ValueError("gop_frames must be positive")
    gops = []
    start = 0
    while start < num_frames:
        n = min(gop_frames, num_frames - start)
        gops.append(GopSpec(index=len(gops), start_frame=start,
                            num_frames=n))
        start += n
    return SegmentPlan(gops=tuple(gops), num_devices=num_devices,
                       frames_per_gop=gop_frames)


def plan_bands(mb_height: int, mb_width: int, num_bands: int) -> BandPlan:
    """Pin the split-frame-encoding band layout for one job.

    Each of the (at most) `num_bands` bands owns an EQUAL
    `band_mb_rows = ceil(mb_height / num_bands)` MB-row slab and
    entropy-codes only its REAL rows. When `band_mb_rows` covers
    `mb_height` in fewer than `num_bands` bands (short frames, many
    bands), the plan shrinks to the bands that hold at least one real
    MB row: a fully-padded band would have no real edge row to source
    halo pixels from, and would only ever encode discarded rows.

    Boundaries are MB-aligned by construction and a pure function of
    (mb_height, num_bands): the slice layout of a stream never depends
    on which frame or wave is being encoded.
    """
    if mb_height <= 0 or mb_width <= 0:
        raise ValueError("mb_height and mb_width must be positive")
    if num_bands <= 0:
        raise ValueError("num_bands must be positive")
    rows = math.ceil(mb_height / num_bands)
    n = math.ceil(mb_height / rows)          # bands with >= 1 real row
    bands = []
    for i in range(n):
        start = i * rows
        bands.append(BandSpec(index=i, start_mb_row=start,
                              mb_rows=min(rows, mb_height - start)))
    assert bands[-1].end_mb_row == mb_height
    return BandPlan(bands=tuple(bands), band_mb_rows=rows,
                    mb_width=mb_width)
