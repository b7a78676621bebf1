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

from ..core.types import GopSpec, SegmentPlan


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
