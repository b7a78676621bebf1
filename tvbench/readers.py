"""Shared arithmetic of the metric readers (metrics/<name>.py): each
takes a run's record and returns a number, or None when the record holds
nothing to read (the harness then leaves the metric out of the line)."""

from __future__ import annotations

import numpy as np

from tvbench import roofline


def per_frame(rec: dict, stages, scale: float = 1.0):
    """Summed StageProfile deltas of `stages` over the window's frames."""
    frames = rec.get("frames") or 0
    delta = rec.get("stage_delta")
    if not frames or delta is None:
        return None
    return scale * sum(delta.get(s, 0) for s in stages) / frames


def idle_pct(rec: dict):
    """Share of the traced sub-window in which no device operation ran:
    100 (1 - union of device intervals / window)."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or not t["events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def idle_in_spans_pct(rec: dict, name: str):
    """Share of the time inside the traced sub-window's `name` spans in
    which no device operation ran; None when there are none."""
    t = rec.get("trace")
    if not t or not t["events"] or name not in t.get("in_spans", {}):
        return None
    busy, cover = t["in_spans"][name]
    return 100.0 * (1.0 - busy / cover) if cover > 0 else None


def percentile(rec: dict, q: float):
    lat = rec.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), q))


def _mean_launch(rec: dict, token: str):
    """Mean device seconds of the traced launches whose kernel name holds
    `token`; None when the trace holds none."""
    t = rec.get("trace")
    if not t:
        return None
    durs = [d for name, ds in t["kernels"].items() if token in name
            for d in ds]
    return sum(durs) / len(durs) if durs else None


def me_search_roofline(rec: dict):
    """Bound time of csrc/me_search.cu's search kernel at the cell's
    shape over its mean traced launch, in %."""
    t = _mean_launch(rec, "search_kernel")
    if t is None:
        return None
    bound, _ = roofline.bound_seconds(
        *roofline.me_search_bound(*rec["shapes"]["me_search"]))
    return 100.0 * bound / t


def intra_core_roofline(rec: dict):
    """Bound time of csrc/intra_core.cu's kernel pair at the cell's
    shape over the mean traced time of one row-0 and one column launch,
    in %."""
    row0 = _mean_launch(rec, "intra_row0_kernel")
    cols = _mean_launch(rec, "intra_cols_kernel")
    if row0 is None or cols is None:
        return None
    bound, _ = roofline.bound_seconds(
        *roofline.intra_pair_bound(*rec["shapes"]["intra_pair"]))
    return 100.0 * bound / (row0 + cols)
