"""Farm split-frame encoding: one frame's band layout spread across
WORKER HOSTS (the cross-host form of SfeShardEncoder; a copy of the
reference package's on the port's runs of bands).

Each band shard (cluster/remote.py, shape="band") owns a contiguous
slice [band_lo, band_hi) of the job's pinned GLOBAL band layout and
steps the SAME fixed GOP grid in lockstep with its peers. Within the
slice the worker's cards run the walk of a whole-layout SfeShardEncoder
on a mesh (SfeShardEncoder._walk): one run of bands a mesh entry, the
runs' edge rows and integer sums moving between the cards by peer copy.
At the slice's outer edges the three collective flows move to the host
and ride the coordinator-relayed halo route (cluster/halo.py), through
the walk's seams (:class:`_Exchange`):

- neighbor reference rows: after each frame's step the slice's
  boundary recon rows (its first run's top, its last run's bottom) ship
  to the adjacent groups and come back as injected halo inputs for the
  next frame's search on the first and last entries;
- global-motion probe: the runs' partial-cost sum (dispatch.
  _sfe_probe_step) + cross-host int32 sum + argmin — bit-identical to
  the whole layout's sum + argmin;
- temporal median: the runs' histogram sum leaves the card, sums across
  hosts, and the cumsum/argmax (torchme.median_from_counts_t) feeds the
  next frame's search center.

Because every cross-host reduction is an integer sum and the injected
halo rows are exactly the bytes a neighbour band would supply, a farm
of N slices emits THE SAME band slices a local N-band SfeShardEncoder
would — the coordinator's per-frame zip of the groups' slices is
byte-identical to the local SFE stream.

The GOP walk is synchronous here (a frame's step needs the previous
frame's exchange), so a "wave" = one GOP, fully encoded inside
dispatch_wave; escapes fall back to a host-LOCAL dense replay of the
same walk fed by the recorded exchange — peers never notice (recon,
halo and histogram flows are identical either way).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..core.types import EncodedSegment, VideoMeta
from .dispatch import SfeShardEncoder, _to_host


class _Exchange:
    """One GOP's cross-host seams of a slice's walk (the `link` of
    SfeShardEncoder._walk), frames indexed within the GOP. Live, each
    seam asks the halo session and records what the peers sent;
    :meth:`replay` hands that record to the dense escape's walk, which
    then exchanges nothing. `spent` sums the host seconds the seams
    took (the caller keeps them out of its dispatch time)."""

    def __init__(self, enc: "FarmBandEncoder", seq0: int,
                 record: dict | None = None):
        self.enc = enc
        self.sess = enc.session
        self.seq0 = seq0
        self.live = record is None
        #: (seam, fi) → the peers' part for frame fi's search: the outer
        #: edge rows, the probe cost total, the histogram total
        self.record: dict = {} if record is None else record
        #: fi → this slice's histogram total of P frame fi, on the host
        self.local_hist: dict[int, tuple] = {}
        self.spent = 0.0

    def replay(self) -> "_Exchange":
        return _Exchange(self.enc, self.seq0, self.record)

    @contextlib.contextmanager
    def _timed(self, stage: str):
        t0 = time.perf_counter()
        with self.enc.stages.stage(stage):
            yield
        self.spent += time.perf_counter() - t0

    def publish(self, fi: int, carry, hist) -> None:
        """After frame fi's step: this slice's boundary recon rows and,
        for a P frame, its histogram total (one fetch) to the peers."""
        top, bot = self.enc._edge_rows(carry)
        blob = None
        if hist is not None:
            with self._timed("device_wait"):
                cnt, n = (_to_host(t) for t in hist)
            n = int(n.reshape(-1)[0])
            self.local_hist[fi] = (cnt.astype(np.int64), n)
            blob = {"cnt": cnt.astype(np.int32),
                    "n": np.asarray([n], np.int64)}
        with self._timed("halo"):
            self.sess.publish_state(self.seq0 + fi, top=top, bot=bot,
                                    hist=blob)

    def edges(self, fi: int) -> tuple:
        """The peers' rows at the slice's outer edges for frame fi's
        search (frame fi − 1's recon), on the entries that read them."""
        if self.live:
            with self._timed("halo"):
                self.record["edges", fi] = self.sess.gather_edges(
                    self.seq0 + fi - 1)
        return self.enc._ext_triplet(*self.record["edges", fi])

    def probe(self, fi: int, cost):
        """The runs' probe cost total plus the peers' (int32)."""
        if self.live:
            with self._timed("device_wait"):
                cost_h = _to_host(cost).astype(np.int32)
            with self._timed("halo"):
                self.record["probe", fi] = self.sess.sum_probe(
                    self.seq0 + fi, cost_h)
        return self.enc._upload(self.record["probe", fi])

    def median(self, fi: int, cnt, n) -> tuple:
        """The runs' histogram total (frame fi − 1's) plus the peers'.
        The runs' total `cnt`, `n` on the card is the one :meth:`publish`
        fetched already; its host copy is used."""
        if self.live:
            total, count = self.local_hist[fi - 1]
            with self._timed("halo"):
                peers = self.sess.gather_hists(self.seq0 + fi - 1)
            for h in peers:
                total = total + np.asarray(h["cnt"], np.int64)
                count += int(np.asarray(h["n"]).reshape(-1)[0])
            self.record["median", fi] = (total, count)
        total, count = self.record["median", fi]
        return (self.enc._upload(total),
                self.enc._upload(np.asarray([count], np.int64)))


class FarmBandEncoder(SfeShardEncoder):
    """SfeShardEncoder over a SLICE of a cross-host band layout, its
    bands in runs over the worker's `mesh`."""

    def __init__(self, meta: VideoMeta, qp: int = 27, gop_frames: int = 32,
                 max_segments: int = 200, total_bands: int = 0,
                 band_range: tuple[int, int] | None = None,
                 halo_rows: int | None = None, session=None,
                 pack_workers: int | None = None, device="cuda",
                 mesh=None):
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
        if session is None and not (self.edge_top and self.edge_bot):
            raise ValueError(
                "a band SLICE (neighbors exist) needs a halo session")

    # -- host<->card glue for the injected halo ------------------------

    def _ext_device(self, rows_h, entry: int):
        """One injected edge block (host (rows, W) int16, or None at a
        true frame edge) → mesh entry `entry`'s card. Only the slice's
        first band reads the top block and only its last band the bottom
        one, so the upload is the edge rows alone, never a stack."""
        if rows_h is None:
            return None
        return self._upload(np.ascontiguousarray(rows_h, np.int16), entry)

    def _ext_triplet(self, top_in, bot_in):
        """The peers' edge blocks as the walk's outer rows: (ty, by, tu,
        bu, tv, bv), the top ones on the first entry, the bottom ones on
        the last."""
        last = self.num_devices - 1
        out = []
        for name in ("y", "u", "v"):
            out.append(self._ext_device(top_in[name] if top_in else None,
                                        0))
            out.append(self._ext_device(bot_in[name] if bot_in else None,
                                        last))
        return tuple(out)

    def _edge_rows(self, carry):
        """This slice's boundary recon rows (frame just stepped; `carry`
        = each run's (ry, ru, rv)): what the neighbor groups splice in as
        their halo — the top from the first run, the bottom from the
        last. None at true frame edges (nobody consumes them). One copy
        to the host per edge."""
        halo = self.halo_rows
        hc = halo // 2
        W = carry[0][0].shape[-1]

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
            ry, ru, rv = carry[0]
            top = fetch(ry[0, :halo], ru[0, :hc], rv[0, :hc])
        if not self.edge_bot:
            ry, ru, rv = carry[-1]
            bot = fetch(ry[-1, -halo:], ru[-1, -hc:], rv[-1, -hc:])
        return top, bot

    # -- the lockstep GOP walk -----------------------------------------

    def dispatch_wave(self, staged: tuple) -> tuple:
        """Encode ONE GOP of this band slice, frame by frame in lockstep
        with the peer groups: the whole layout's walk over the slice's
        runs (SfeShardEncoder._walk), its outer seams on the relay
        (:class:`_Exchange`). Returns (global GopSpec, per-frame NAL
        bytes) — collect_wave only assembles the segment."""
        import dataclasses as _dc

        gop, ys, us, vs, qp = staged
        gop_g = _dc.replace(gop, index=gop.index + self.gop_index_offset,
                            start_frame=(gop.start_frame
                                         + self.frame_offset))
        idr_pic_id = gop_g.index % 65536
        F = gop.num_frames
        link = _Exchange(self, gop_g.start_frame) \
            if self.session is not None else None
        nals: list[bytes] = []
        dense_from: int | None = None
        t0 = time.perf_counter()
        for fi, (levels, carry, hist, _) in enumerate(
                self._walk(F, ys, us, vs, qp, link=link)):
            # the walk's enqueue time; its seams count as halo and
            # device_wait
            self.stages.add("dispatch", time.perf_counter() - t0
                            - (link.spent if link is not None else 0.0))
            # unblock the peers FIRST: their next frame's search waits
            # on these rows, while our own pack work below is local
            if link is not None and fi < F - 1:
                link.publish(fi, carry, hist)
            head, nblk, nval, n_esc, used, payload = levels
            with self.stages.stage("device_wait"):
                tiny = [_to_host(t) for t in (nblk, nval, n_esc, used)]
            self.stages.bump("d2h_bytes",
                             sum(int(a.nbytes) for a in tiny))
            if dense_from is None and int(tiny[2].max()) > 0:
                dense_from = fi     # escape: this slice replays dense
                                    # LOCALLY after the walk — the
                                    # exchange flows continue untouched
                                    # (identical either way)
            if dense_from is None:
                nals.append(self._pack_band_frame(fi, head, payload, tiny,
                                                  qp, idr_pic_id))
                self._note_frame_done(gop_g.start_frame + fi)
            if link is not None:
                link.spent = 0.0
            t0 = time.perf_counter()
        if dense_from is not None:
            nals = self._collect_dense(
                gop_g, staged, nals, dense_from,
                link.replay() if link is not None else None)
        return (gop_g, nals)

    def collect_wave(self, pending: tuple) -> list[EncodedSegment]:
        gop_g, nals = pending
        with self.stages.stage("concat"):
            seg = EncodedSegment(gop=gop_g, payload=b"".join(nals),
                                 frame_sizes=tuple(len(n) for n in nals))
        self.stages.count_wave()
        return [seg]
