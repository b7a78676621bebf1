"""GOP segment planner — the parts-planner math.

Port of the reference's two-step plan: pick a target shard size, derive
the shard count, then round the count UP to a multiple of the usable
worker count so every dispatch wave fills the farm. Here "workers" are
devices and the unit is frames (closed GOPs), not bytes: a GOP boundary
is the only place an H.26x stream can be cut without cross-shard
prediction.
"""

from __future__ import annotations

import dataclasses
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


def plan_band_groups(num_bands: int, groups: int
                     ) -> tuple[tuple[int, int], ...]:
    """Partition a band layout into `groups` contiguous [lo, hi)
    slices — one per band shard / worker host (cluster/remote.py farm
    SFE). Near-equal sizes, first slices take the remainder; a pure
    function of (num_bands, groups) so a crash-resumed plan (and every
    peer's descriptor) reproduces the identical partition."""
    if num_bands <= 0:
        raise ValueError("num_bands must be positive")
    groups = max(1, min(int(groups), num_bands))
    base, extra = divmod(num_bands, groups)
    out = []
    lo = 0
    for i in range(groups):
        n = base + (1 if i < extra else 0)
        out.append((lo, lo + n))
        lo += n
    assert lo == num_bands
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """The unified, shape-tagged shard plan record every encode path
    keys off (the collapse of the GopShardEncoder / SfeShardEncoder /
    LadderShardEncoder dispatch seams): `shape` picks the executor
    form, `segments` pins the GOP grid, and the band fields pin the
    cross-host SFE layout when `shape == "band"`. The record is pure
    data — JSON-able via `record()` so the durable board checkpoint
    (cluster/partstore.py) can journal it and a crash-resumed
    coordinator re-plans deterministically from the record, never from
    the live farm width."""

    shape: str                        # "gop" | "band"
    segments: SegmentPlan
    total_bands: int = 0              # band shape: global layout width
    halo_rows: int = 0                # band shape: pinned halo depth
    band_groups: tuple[tuple[int, int], ...] = ()

    def record(self) -> dict:
        return {
            "shape": self.shape,
            "total_bands": int(self.total_bands),
            "halo_rows": int(self.halo_rows),
            "band_groups": [[int(lo), int(hi)]
                            for lo, hi in self.band_groups],
        }


def plan_encode(num_frames: int, settings, *, num_devices: int,
                shape: str | None = None, total_bands: int = 0,
                group_count: int = 1, mb_height: int = 0) -> EncodePlan:
    """Build the unified plan for one job. `shape=None` resolves from
    settings (`sfe_bands > 0` → band shape); the band shape uses the
    SFE fixed GOP grid (boundaries a pure function of the frame count,
    never of mesh or farm width) and partitions `total_bands` over
    `group_count` shards."""
    gop_frames = int(settings.gop_frames)
    max_segments = int(settings.max_segments)
    if shape is None:
        shape = "band" if int(settings.get("sfe_bands", 0) or 0) > 0 \
            else "gop"
    if shape == "gop":
        return EncodePlan(
            shape="gop",
            segments=plan_segments(num_frames, gop_frames, num_devices,
                                   max_segments))
    if shape != "band":
        raise ValueError(f"unknown plan shape {shape!r}")
    # the SFE grid: honor max_segments by growing the GOP once up
    # front (SfeShardEncoder.plan's cap semantics)
    gop = max(gop_frames, -(-num_frames // max(1, max_segments)))
    bands = plan_bands(max(1, mb_height), 1, max(1, total_bands))
    groups = plan_band_groups(bands.num_bands, group_count)
    halo = int(settings.get("sfe_halo_rows", 32) or 32)
    return EncodePlan(
        shape="band",
        segments=plan_fixed_segments(num_frames, gop, num_devices),
        total_bands=bands.num_bands,
        halo_rows=max(16, (halo // 16) * 16),
        band_groups=groups)
