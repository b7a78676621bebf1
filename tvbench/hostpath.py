"""Shared arithmetic of the host critical path's readers: the waits of
the thread that drives the card, the CPU time of each stage, the split-
frame walk's steps, the job layer's spans and the host syncs, as the
program's stage profile and job trace record them.

Each returns None when the record lacks what it reads, as a program that
does not record them gives: the metric is then left out of the line."""

from __future__ import annotations


def per_frame_of(rec: dict, keys) -> float | None:
    """Summed stage_delta of `keys` over the window's frames; None when
    any of the keys is absent."""
    frames = rec.get("frames") or 0
    delta = rec.get("stage_delta")
    if not frames or delta is None or any(k not in delta for k in keys):
        return None
    return sum(delta[k] for k in keys) / frames


def idle_in_names_pct(rec: dict, names) -> float | None:
    """Share of the time inside the traced sub-window's spans of any of
    `names` in which no device operation ran: 100 (1 - the device busy
    time inside them / the time they cover), summed over the names."""
    t = rec.get("trace")
    spans = (t or {}).get("in_spans", {})
    found = [spans[n] for n in names if n in spans]
    if not t or not t.get("events") or not found:
        return None
    busy = sum(b for b, _ in found)
    cover = sum(c for _, c in found)
    return 100.0 * (1.0 - busy / cover) if cover > 0 else None


def job_spans_ms(rec: dict, names) -> float | None:
    """Mean, over the traced jobs that finished, of the summed length
    of their `names` spans, in ms; None when no job recorded one."""
    out = []
    for job in rec.get("jobs", []):
        spans = job.get("spans")
        if not spans or not job.get("ok"):
            continue
        mine = [e - s for n, s, e in spans if n in names]
        if mine:
            out.append(sum(mine))
    return 1e3 * sum(out) / len(out) if out else None
