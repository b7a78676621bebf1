"""ABR rung planning + the multi-rendition encoder on one card.

The planner turns a source's dims + the `ladder_rungs` setting
(TVT_LADDER_RUNGS, e.g. "1080,720,480,360") into a rung list: the top
rung is ALWAYS the source resolution at the job's base QP (so a ladder
job's top rendition stays byte-identical to the plain single-rendition
encode of the same source), and each lower rung gets aspect-preserving
even dims plus a QP solved through parallel/rc.py's R ∝ 2^(−qp/6)
octave model (rc.ladder_rung_qps).

:class:`LadderShardEncoder` is the executor-facing piece: it quacks
like a GopShardEncoder (plan / stage_waves / dispatch_wave /
collect_wave / encode), but each wave is decoded + uploaded ONCE — by
the stager, at source resolution — and every lower rung's input is
derived ON THE CARD by abr/scale.py's two-product polyphase pass before
fanning into that rung's own encoder. collect_wave returns one
:class:`LadderGopBundle` per GOP carrying all rungs' EncodedSegments,
so an executor's wave retry / halt / progress machinery applies to the
whole rendition set at GOP granularity.

This module stays torch-free at MODULE scope: planning runs on the
coordinator's control plane and the HLS side never needs a device
backend; the torch-touching imports (dispatch, scale, rc) live inside
the functions that need them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..core.types import EncodedSegment, GopSpec, SegmentPlan, VideoMeta

#: default rung heights (pixels) — the classic 1080p ladder
DEFAULT_RUNGS = "1080,720,480,360"

#: bitrate-ladder exponent: R_rung = R_top * pixel_ratio^alpha. 0.75
#: is the middle of the published per-title ladders (bits per pixel
#: rise as resolution drops).
LADDER_ALPHA = 0.75


@dataclasses.dataclass(frozen=True)
class Rung:
    """One rendition of the ladder. `top` marks the source-resolution
    rung (never scaled — byte-identical to the plain encode path)."""

    name: str
    width: int
    height: int
    qp: int
    top: bool = False

    @property
    def pixels(self) -> int:
        return self.width * self.height


def parse_rung_heights(spec: Any) -> list[int]:
    """'1080,720,480' → [1080, 720, 480]; junk entries are dropped,
    duplicates collapse, order is tallest-first."""
    heights = []
    for part in str(spec or "").replace(";", ",").split(","):
        part = part.strip().lower().rstrip("p")
        if not part:
            continue
        try:
            h = int(part)
        except ValueError:
            continue
        if h > 0:
            heights.append(h)
    return sorted(set(heights), reverse=True)


def rung_width(src_w: int, src_h: int, dst_h: int) -> int:
    """Aspect-preserving width for a rung height, rounded to EVEN (4:2:0
    chroma siting + SPS cropping both need even dims)."""
    w = int(round(src_w * dst_h / src_h / 2.0)) * 2
    return max(2, w)


def plan_ladder(meta: VideoMeta, settings) -> list[Rung]:
    """Rung list for a source, top (source-resolution) rung first.

    Listed heights at or above the source collapse into the top rung
    (upscaling is never in scope); heights must be even to be
    representable (odd ones are rounded down). QPs come from the octave
    rate model (rc.ladder_rung_qps) anchored at the job's base QP.
    """
    from ..parallel.rc import ladder_rung_qps    # lazy: rc pulls torch

    base_qp = int(settings.qp)
    spec = settings.get("ladder_rungs", DEFAULT_RUNGS) or DEFAULT_RUNGS
    heights = [h - (h % 2) for h in parse_rung_heights(spec)]
    lower = sorted({h for h in heights if 2 <= h < meta.height},
                   reverse=True)
    dims = [(meta.width, meta.height)] + [
        (rung_width(meta.width, meta.height, h), h) for h in lower]
    top_px = max(1, meta.width * meta.height)
    qps = ladder_rung_qps(
        base_qp, [w * h / top_px for w, h in dims], alpha=LADDER_ALPHA)
    rungs = []
    for i, ((w, h), qp) in enumerate(zip(dims, qps)):
        rungs.append(Rung(name=f"{h}p", width=w, height=h, qp=int(qp),
                          top=(i == 0)))
    return rungs


@dataclasses.dataclass
class LadderGopBundle:
    """All renditions of one GOP — the ladder's unit of completed work
    (duck-typed like EncodedSegment where an executor cares: `.gop`)."""

    gop: GopSpec
    renditions: dict[str, EncodedSegment]


class _LadderStages:
    """Aggregating stage-profile view over every rung encoder (plus a
    dedicated stager): timing WRITES land on the stager's profile (the
    `scale` stage), while `snapshot()` SUMS all profiles so a ladder
    job's per-job breakdown carries the lower rungs' dispatch / fetch /
    pack host time too — not just the stager's. `waves` takes the max
    (every rung counts the same pipeline waves)."""

    def __init__(self, ladder: "LadderShardEncoder") -> None:
        self._ladder = ladder

    def stage(self, name: str):
        return self._ladder._stager.stages.stage(name)

    def bump(self, counter: str, n: int = 1) -> None:
        self._ladder._stager.stages.bump(counter, n)

    def set_tracer(self, recorder) -> None:
        """Propagate a span recorder (obs/trace) to every rung
        encoder's profile so the whole rendition set's stages land in
        ONE job trace."""
        for enc in self._ladder._all_encoders():
            enc.stages.set_tracer(recorder)

    def tracer(self):
        return self._ladder._stager.stages.tracer()

    def reset(self) -> None:
        for enc in self._ladder._all_encoders():
            enc.stages.reset()

    def snapshot(self) -> dict:
        out: dict = {}
        for enc in self._ladder._all_encoders():
            for key, val in enc.stages.snapshot().items():
                if key == "waves":
                    out[key] = max(out.get(key, 0), val)
                elif isinstance(val, float):
                    out[key] = round(out.get(key, 0.0) + val, 2)
                else:
                    out[key] = out.get(key, 0) + val
        return out


class LadderShardEncoder:
    """Encode one staged wave stream into N aligned renditions on one
    card.

    One GopShardEncoder per rung shares a single GOP plan (same frame
    count, gop_frames → identical boundaries, the seamless-switch
    invariant); the stager — the top encoder when the first rung is
    source-resolution, else a dedicated source-resolution encoder — owns
    decode + staging, so `h2d_bytes` accrues once per wave no matter how
    many rungs ride on it. On a device mesh the stager and every rung
    encoder share the one mesh: each entry scales its own run of the
    wave's GOPs on its card, one fixed-shape product per plane, so a
    frame's scaled bits do not depend on the split.
    """

    def __init__(self, meta: VideoMeta, rungs: list[Rung],
                 mesh=None, gop_frames: int = 32,
                 max_segments: int = 200, device="cuda") -> None:
        from ..core.devices import as_mesh
        from ..parallel.dispatch import GopShardEncoder   # lazy: torch
        from .scale import PlaneScaler

        mesh = as_mesh(mesh, device)
        if not rungs:
            raise ValueError("ladder needs at least one rung")
        self.meta = meta
        self.rungs = list(rungs)

        def build(m: VideoMeta, qp: int) -> GopShardEncoder:
            return GopShardEncoder(m, qp=qp, gop_frames=int(gop_frames),
                                   max_segments=int(max_segments),
                                   device=device, mesh=mesh)

        self.encoders: list = []
        self.scalers: list = []         # None for the unscaled rung
        for rung in self.rungs:
            scaled = (rung.width, rung.height) != (meta.width, meta.height)
            rmeta = dataclasses.replace(meta, width=rung.width,
                                        height=rung.height)
            self.encoders.append(build(rmeta, rung.qp))
            self.scalers.append(
                PlaneScaler(meta.width, meta.height, rung.width,
                            rung.height, device=mesh.devices[0])
                if scaled else None)
        if self.scalers[0] is None:
            # first rung IS the source resolution: it stages (and its
            # construction matches the executor's default encoder, the
            # byte-identity contract)
            self._stager = self.encoders[0]
        else:
            # every rung is scaled (remote single-rung shards): a
            # source-resolution encoder exists only to plan + stage
            self._stager = build(meta, self.rungs[0].qp)

    # -- GopShardEncoder-compatible surface ----------------------------

    @property
    def stages(self) -> _LadderStages:
        """Aggregated stage profile: decode/stage/h2d_bytes (once per
        wave) and `scale` accrue on the stager, per-rung dispatch /
        fetch / pack on each rung's encoder — snapshot() sums them all
        so per-job breakdowns see the whole ladder's host cost."""
        return _LadderStages(self)

    @property
    def num_devices(self) -> int:
        return self._stager.num_devices

    @property
    def mesh(self):
        return self._stager.mesh

    @property
    def decode_ahead(self) -> int:
        return self._stager.decode_ahead

    @property
    def gops_per_wave(self) -> int:
        return self._stager.gops_per_wave

    def _all_encoders(self) -> list:
        encs = list(self.encoders)
        if self._stager is not self.encoders[0]:
            encs.append(self._stager)
        return encs

    @property
    def plan_override(self) -> SegmentPlan | None:
        return self._stager.plan_override

    @plan_override.setter
    def plan_override(self, plan: SegmentPlan | None) -> None:
        for enc in self._all_encoders():
            enc.plan_override = plan

    @property
    def gop_index_offset(self) -> int:
        return self._stager.gop_index_offset

    @gop_index_offset.setter
    def gop_index_offset(self, value: int) -> None:
        for enc in self._all_encoders():
            enc.gop_index_offset = int(value)

    @property
    def frame_offset(self) -> int:
        return self._stager.frame_offset

    @frame_offset.setter
    def frame_offset(self, value: int) -> None:
        for enc in self._all_encoders():
            enc.frame_offset = int(value)

    def plan(self, num_frames: int) -> SegmentPlan:
        return self._stager.plan(num_frames)

    def stage_waves(self, frames):
        return self._stager.stage_waves(frames)

    def dispatch_wave(self, staged: tuple) -> tuple:
        """Fan one staged (source-resolution) wave across every rung:
        the unscaled rung dispatches the staged tensors directly; each
        scaled rung first derives its input on the card (two products
        per plane; on a mesh, each entry its own run) —
        no additional decode or upload."""
        from ..parallel.dispatch import _join, _parts

        wave, ysd, usd, vsd, qpsd = staged
        base_qp = self.rungs[0].qp
        handles = []
        ys, us, vs = _parts(ysd), _parts(usd), _parts(vsd)
        for rung, enc, scaler in zip(self.rungs, self.encoders,
                                     self.scalers):
            if scaler is None:
                handles.append(enc.dispatch_wave(staged))
                continue
            with self.stages.stage("scale"):
                runs = self._stager.on_entries(
                    lambda i, sc=scaler: sc.scale_wave(ys[i], us[i], vs[i]))
                sy, su, sv = (_join([r[k] for r in runs]) for k in range(3))
                # carry any per-GOP QP deltas across rungs relative to
                # this rung's base operating point (host (G,) int32)
                rqps = qpsd - base_qp + rung.qp
            handles.append(enc.dispatch_wave((wave, sy, su, sv, rqps)))
        return (wave, handles)

    def collect_wave(self, pending: tuple) -> list[LadderGopBundle]:
        wave, handles = pending
        per_rung = [enc.collect_wave(h)
                    for enc, h in zip(self.encoders, handles)]
        bundles = []
        for gi in range(len(per_rung[0])):
            gop = per_rung[0][gi].gop
            bundles.append(LadderGopBundle(
                gop=gop,
                renditions={rung.name: segs[gi] for rung, segs
                            in zip(self.rungs, per_rung)}))
        return bundles

    def encode(self, frames) -> list[LadderGopBundle]:
        """Stream-encode the whole ladder (worker shards / bench):
        staging on a background thread, depth-2 dispatch window."""
        from collections import deque

        from ..parallel.dispatch import background_stage

        feed = background_stage(self.stage_waves(frames),
                                self.decode_ahead)
        bundles: list[LadderGopBundle] = []
        pending: deque = deque()
        try:
            it = iter(feed)
            while True:
                while len(pending) < 2:
                    staged = next(it, None)
                    if staged is None:
                        break
                    pending.append(self.dispatch_wave(staged))
                if not pending:
                    break
                bundles.extend(self.collect_wave(pending.popleft()))
        finally:
            feed.close()
        bundles.sort(key=lambda b: b.gop.index)
        return bundles


def rung_segments(bundles: list[LadderGopBundle], name: str
                  ) -> list[EncodedSegment]:
    """One rung's ordered EncodedSegments out of a bundle list."""
    return [b.renditions[name] for b in
            sorted(bundles, key=lambda b: b.gop.index)]
