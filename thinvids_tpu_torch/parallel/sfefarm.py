"""Farm split-frame encoding: one frame's band layout spread across
WORKER HOSTS (the cross-host form of SfeShardEncoder; a copy of the
reference package's on the port's band stack).

Each band shard (cluster/remote.py, shape="band") owns a contiguous
slice [band_lo, band_hi) of the job's pinned GLOBAL band layout and
steps the SAME fixed GOP grid in lockstep with its peers. Within the
slice the card runs the local banded steps over its (hi − lo, Hb, W)
stack (halo slices and band sums inside the stack); ACROSS slices the
three collective flows move to the host and ride the
coordinator-relayed halo route (cluster/halo.py):

- neighbor reference rows: after each frame's step the slice's
  boundary recon rows ship to the adjacent groups and come back as
  injected halo inputs for the next frame's search;
- global-motion probe: a per-slice partial-cost step
  (dispatch._sfe_probe_step) + cross-host int32 sum + host argmin —
  bit-identical to the whole layout's sum + argmin;
- temporal median: the per-slice histogram partial leaves the card
  with the level streams, sums across hosts, and the host-side
  cumsum/argmax (torchme.median_from_counts) feeds the next frame's
  search center.

Because every cross-host reduction is an integer sum and the injected
halo rows are exactly the bytes a neighbour band would supply, a farm
of N slices emits THE SAME band slices a local N-band SfeShardEncoder
would — the coordinator's per-frame zip of the groups' slices is
byte-identical to the local SFE stream.

The GOP walk is synchronous here (a frame's step needs the previous
frame's exchange), so a "wave" = one GOP, fully encoded inside
dispatch_wave; escapes fall back to a host-LOCAL dense replay fed by
the cached per-frame injected inputs — peers never notice (recon,
halo and histogram flows are identical either way).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codecs.h264 import torchme
from ..core.types import EncodedSegment, VideoMeta
from ..codecs.h264.layout import unpack_compact_auto
from .dispatch import (SfeShardEncoder, _sfe_p_step, _sfe_probe_step,
                       _to_host)


class FarmBandEncoder(SfeShardEncoder):
    """SfeShardEncoder over a SLICE of a cross-host band layout."""

    def __init__(self, meta: VideoMeta, qp: int = 27, gop_frames: int = 32,
                 max_segments: int = 200, total_bands: int = 0,
                 band_range: tuple[int, int] | None = None,
                 halo_rows: int | None = None, session=None,
                 pack_workers: int | None = None, device="cuda",
                 mesh=None):
        from ..core.devices import DeviceMesh, as_mesh

        # the slice's lockstep walk steps one stack: on a mesh, it runs
        # on the first entry
        mesh = DeviceMesh(as_mesh(mesh, device).devices[:1])
        super().__init__(meta, qp=qp, gop_frames=gop_frames,
                         max_segments=max_segments, halo_rows=halo_rows,
                         pack_workers=pack_workers,
                         # synchronous GOP walk: the exchange serializes
                         # frames anyway, and window 1 bounds retained
                         # staged GOPs on worker hosts
                         pipeline_window=1,
                         total_bands=total_bands, band_range=band_range,
                         device=device, mesh=mesh)
        #: cluster/halo.HaloSession (or None for a single-group layout
        #: covering the whole frame — no peers to talk to)
        self.session = session
        self.edge_top = self.band_lo == 0
        self.edge_bot = self.band_hi == self.global_band_plan.num_bands
        self._edges = (self.edge_top, self.edge_bot)
        if session is None and not (self.edge_top and self.edge_bot):
            raise ValueError(
                "a band SLICE (neighbors exist) needs a halo session")

    # -- host<->card glue for the injected halo ------------------------

    def _ext_device(self, rows_h):
        """One injected edge block (host (rows, W) int16, or None at a
        true frame edge) → the card. Only the slice's first band reads
        the top block and only its last band the bottom one, so the
        upload is the edge rows alone, never a stack."""
        if rows_h is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(
            rows_h, np.int16)).to(self.device)

    def _ext_triplet(self, top_in, bot_in):
        out = []
        for name in ("y", "u", "v"):
            out.append(self._ext_device(top_in[name] if top_in else None))
            out.append(self._ext_device(bot_in[name] if bot_in else None))
        return tuple(out)           # ty, by, tu, bu, tv, bv

    def _edge_rows(self, carry3):
        """This slice's boundary recon rows (frame just stepped): what
        the neighbor groups splice in as their halo. None at true frame
        edges (nobody consumes them). One copy to the host per edge."""
        ry, ru, rv = carry3
        halo = self.halo_rows
        hc = halo // 2
        W = ry.shape[-1]

        def fetch(y, u, v) -> dict:
            with self.stages.stage("fetch"):
                flat = _to_host(torch.cat([y.reshape(-1), u.reshape(-1),
                                           v.reshape(-1)]))
            ny, nc = halo * W, hc * (W // 2)
            return {"y": flat[:ny].reshape(halo, W).astype(np.int16),
                    "u": flat[ny:ny + nc].reshape(hc, W // 2)
                    .astype(np.int16),
                    "v": flat[ny + nc:].reshape(hc, W // 2)
                    .astype(np.int16)}

        top = bot = None
        if not self.edge_top:
            top = fetch(ry[0, :halo], ru[0, :hc], rv[0, :hc])
        if not self.edge_bot:
            bot = fetch(ry[-1, -halo:], ru[-1, -hc:], rv[-1, -hc:])
        return top, bot

    # -- cross-host reductions -----------------------------------------

    def _global_probe(self, seq: int, cur_y, ref_y, ty, by) -> np.ndarray:
        with self.stages.stage("dispatch"):
            cost = _sfe_probe_step(cur_y, ref_y, self._real_rows, ty, by,
                                   self._edges)
        with self.stages.stage("device_wait"):
            cost_h = _to_host(cost).astype(np.int32)
        if self.session is not None:
            with self.stages.stage("halo"):
                cost_h = self.session.sum_probe(seq, cost_h)
        return torchme.probe_center_from_cost(cost_h)

    def _global_median(self, seq: int, hist_local) -> np.ndarray:
        cnt = np.asarray(hist_local[0], np.int64)
        n = int(hist_local[1])
        if self.session is not None:
            with self.stages.stage("halo"):
                peers = self.session.gather_hists(seq)
            for h in peers:
                cnt = cnt + np.asarray(h["cnt"], np.int64)
                n += int(np.asarray(h["n"]).reshape(-1)[0])
        return torchme.median_from_counts(cnt, n, 2 * torchme.SEARCH_RANGE)

    # -- the lockstep GOP walk -----------------------------------------

    def dispatch_wave(self, staged: tuple) -> tuple:
        """Encode ONE GOP of this band slice, frame by frame in lockstep
        with the peer groups. Returns (global GopSpec, per-frame NAL
        bytes) — collect_wave only assembles the segment."""
        import dataclasses as _dc

        gop, ys, us, vs, qp = staged
        bp = self.band_plan
        sess = self.session
        gop_g = _dc.replace(gop, index=gop.index + self.gop_index_offset,
                            start_frame=(gop.start_frame
                                         + self.frame_offset))
        idr_pic_id = gop_g.index % 65536
        F = gop.num_frames
        nals: list[bytes] = []
        #: cached per-P-frame injected inputs — the dense replay's feed
        replay: list[tuple] = []
        dense_from: int | None = None
        hist_local = None
        carry3 = None
        pred = np.zeros(2, np.int32)
        for fi in range(F):
            seq = gop_g.start_frame + fi
            if fi == 0:
                with self.stages.stage("dispatch"):
                    outs, carry3 = self._intra_step(ys[0], us[0], vs[0], qp)
                hist_local = None
            else:
                with self.stages.stage("halo"):
                    top_in, bot_in = sess.gather_edges(seq - 1) \
                        if sess is not None else (None, None)
                pred = self._global_median(seq - 1, hist_local) \
                    if fi >= 2 else np.zeros(2, np.int32)
                ext = self._ext_triplet(top_in, bot_in)
                probe = self._global_probe(seq, ys[fi], carry3[0], ext[0],
                                           ext[1])
                with self.stages.stage("dispatch"):
                    outs, (cnt, n), carry3, _ = _sfe_p_step(
                        ys[fi], us[fi], vs[fi], carry3,
                        self._host_vec(pred), self._host_vec(probe), ext,
                        qp, self._real_rows, self._edges, mbw=bp.mb_width,
                        mbh_band=bp.band_mb_rows,
                        halo_rows=self.halo_rows, rd=self.rd)
                with self.stages.stage("device_wait"):
                    cnt_h = _to_host(cnt)
                    n_h = int(_to_host(n).reshape(-1)[0])
                hist_local = (cnt_h.astype(np.int64), n_h)
                replay.append((pred, probe, top_in, bot_in))
            # unblock the peers FIRST: their next frame's search waits
            # on these rows, while our own pack work below is local
            if sess is not None and fi < F - 1:
                top_out, bot_out = self._edge_rows(carry3)
                hist_blob = None
                if hist_local is not None:
                    hist_blob = {
                        "cnt": hist_local[0].astype(np.int32),
                        "n": np.asarray([hist_local[1]], np.int64)}
                with self.stages.stage("halo"):
                    sess.publish_state(seq, top=top_out, bot=bot_out,
                                       hist=hist_blob)
            head, nblk, nval, n_esc, used, payload = outs
            with self.stages.stage("device_wait"):
                tiny = [_to_host(t) for t in (nblk, nval, n_esc, used)]
            self.stages.bump("d2h_bytes",
                             sum(int(a.nbytes) for a in tiny))
            nblk_h, nval_h, nesc_h, used_h = tiny
            if dense_from is None and int(nesc_h.max()) > 0:
                dense_from = fi     # escape: this slice replays dense
                                    # LOCALLY after the walk — the
                                    # exchange flows above continue
                                    # untouched (identical either way)
            if dense_from is not None:
                continue
            _, L = self._band_sizes(intra=(fi == 0))
            with self.stages.stage("fetch"):
                (head_h,) = self._fetch_bulk([head])
                rows = self._fetch_payload_rows(payload, used_h)
            with self.stages.stage("sfe"):
                nals.append(self._pack_band_frame(
                    fi, head_h, rows, nblk_h, nval_h, used_h, L, qp,
                    idr_pic_id))
            self._note_frame_done(seq)
        if dense_from is not None:
            nals = self._replay_dense(gop_g, staged, nals, dense_from,
                                      replay)
        return (gop_g, nals)

    def _host_vec(self, v) -> torch.Tensor:
        """A host-resolved (2,) int32 center → the card (the search's
        center input)."""
        return torch.as_tensor(np.asarray(v, np.int32), device=self.device)

    def _pack_band_frame(self, fi: int, head_h, rows, nblk_h, nval_h,
                         used_h, L: int, qp: int,
                         idr_pic_id: int) -> bytes:
        bp = self.band_plan
        thunks = []
        for bi in range(bp.num_bands):
            rest = functools.partial(
                unpack_compact_auto, rows[bi][:int(used_h[bi])],
                int(nblk_h[bi]), int(nval_h[bi]), L)
            if fi == 0:
                thunks.append(functools.partial(
                    lambda r, b: self._pack_intra_band(
                        head_h[b], r(), b, qp, idr_pic_id), rest, bi))
            else:
                thunks.append(functools.partial(
                    lambda r, b, fn: self._pack_p_band(
                        head_h[b], r(), b, qp, fn), rest, bi, fi % 256))
        return self._frame_nal(thunks, fi)

    def _replay_dense(self, gop_g, staged: tuple, nals: list[bytes],
                      dense_from: int, replay: list[tuple]
                      ) -> list[bytes]:
        """Escape fallback, host-LOCAL: rerun this slice's GOP through
        the dense-transfer farm steps, feeding the CACHED per-frame
        injected inputs (pred, probe, neighbor rows) — no re-exchange,
        bit-identical levels (the wave path's fallback contract)."""
        prof = self.stages
        bp = self.band_plan
        _, ys, us, vs, qp = staged
        idr_pic_id = gop_g.index % 65536
        prof.bump("dense_fallback_waves")
        with prof.stage("dense_retry"):
            carry3 = None
            for fi in range(gop_g.num_frames):
                if fi == 0:
                    (flat,), carry3 = self._intra_step(ys[0], us[0], vs[0],
                                                       qp, dense=True)
                    head = None
                else:
                    pred, probe, top_in, bot_in = replay[fi - 1]
                    (head, flat), _, carry3, _ = _sfe_p_step(
                        ys[fi], us[fi], vs[fi], carry3,
                        self._host_vec(pred), self._host_vec(probe),
                        self._ext_triplet(top_in, bot_in), qp,
                        self._real_rows, self._edges, mbw=bp.mb_width,
                        mbh_band=bp.band_mb_rows,
                        halo_rows=self.halo_rows, rd=self.rd, dense=True)
                if fi < dense_from:
                    continue        # already packed from sparse
                if head is None:
                    (flat_h,) = self._fetch_bulk([flat])
                else:
                    head_h, flat_h = self._fetch_bulk([head, flat])
                thunks = []
                for bi in range(bp.num_bands):
                    if fi == 0:
                        thunks.append(functools.partial(
                            self._pack_intra_band_dense, flat_h[bi], bi,
                            qp, idr_pic_id))
                    else:
                        thunks.append(functools.partial(
                            self._pack_p_band, head_h[bi], flat_h[bi], bi,
                            qp, fi % 256))
                nals.append(self._frame_nal(thunks, fi))
                self._note_frame_done(gop_g.start_frame + fi)
        return nals

    def collect_wave(self, pending: tuple) -> list[EncodedSegment]:
        gop_g, nals = pending
        with self.stages.stage("concat"):
            seg = EncodedSegment(gop=gop_g, payload=b"".join(nals),
                                 frame_sizes=tuple(len(n) for n in nals))
        self.stages.count_wave()
        return [seg]
