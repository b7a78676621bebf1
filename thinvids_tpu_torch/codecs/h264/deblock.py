"""In-loop deblocking filter (H.264 §8.7) — shifted-plane form.

The spec orders filtering per macroblock in raster order (all vertical
edges of a MB, then its horizontal edges, each reading samples already
modified by earlier MBs) — an inherently wavefront-sequential schedule.
This module implements the standard filters and boundary-strength
derivation in a PLANE-PARALLEL pass order instead:

    1. luma vertical INTERNAL edges   (x % 16 in {4, 8, 12})
    2. luma vertical MB edges         (x % 16 == 0, x > 0)
    3. luma horizontal INTERNAL edges
    4. luma horizontal MB edges
    5. chroma vertical edges          (x % 8 in {0, 4}, x > 0)
    6. chroma horizontal edges

Within a pass every edge reads the PASS INPUT and writes disjoint
samples (internal luma edges write p1..q1 — 4-apart edges never
collide; MB edges are 16 apart so even the strong filter's p2/q2
writes stay disjoint; chroma edges write only p0/q0), so each pass is
one data-parallel plane operation. This deviates from the spec's
sample ordering only where one edge's write lands in a neighboring
edge's read window — rare (both filters must trigger adjacently). The
encoder and a decoder running EXACTLY this schedule agree bit for bit,
so P-frame prediction never drifts.

Boundary strength (§8.7.2.1, restricted to this codec's streams —
pictures are homogeneous: all-intra IDR or all-inter P, one reference):

    intra picture:  MB edge -> 4, internal edge -> 3
    P picture:      either side's 4x4 luma block coded -> 2,
                    |mv_p - mv_q| >= 1 integer pel (either comp) -> 1,
                    else 0

The module is written against a small ops shim (`_NumpyOps`) so
torchdeblock can run the SAME code on torch tensors — one semantics,
two backends, parity-tested. Every call whose spelling differs between
numpy and torch (dtype casts, `repeat`, `max` over an axis, `transpose`,
`zeros_like`, column gathers and scatters, index arrays) goes through
the shim; `xp` carries the element-wise functions both spell alike.
"""

from __future__ import annotations

import numpy as np

from .transform import CHROMA_QP_TABLE

# §8.7.2.2 threshold tables, filterOffsetA = filterOffsetB = 0.
ALPHA_TABLE = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32,
       36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162,
       182, 203, 226, 255, 255], np.int32)
BETA_TABLE = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
       11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18,
       18], np.int32)
# Table 8-17: tC0 by (bS - 1, indexA).
TC0_TABLE = np.array([
    [0] * 17 + [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,
                2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
    [0] * 17 + [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
                3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15,
                17],
    [0] * 17 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4,
                4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                23, 25],
], np.int32)

assert ALPHA_TABLE.shape == (52,) and BETA_TABLE.shape == (52,)
assert TC0_TABLE.shape == (3, 52)

_QPC_NP = np.asarray(CHROMA_QP_TABLE, np.int32)


class _NumpyOps:
    """Backend shim: numpy. torchdeblock provides the torch twin."""

    xp = np
    int32 = np.int32

    @staticmethod
    def scatter_cols(X, writes):
        """Return X with columns updated; writes = [(xs, vals)] where
        the xs sets of one pass are mutually disjoint."""
        out = X.copy()
        for xs, vals in writes:
            out[:, xs] = vals
        return out

    @staticmethod
    def gather_cols(X, xs):
        return X[:, xs]

    @staticmethod
    def asarray(a):
        return np.asarray(a)

    @staticmethod
    def astype(a, dtype):
        return a.astype(dtype)

    @staticmethod
    def repeat(a, n: int, axis: int):
        return np.repeat(a, n, axis=axis)

    @staticmethod
    def amax(a, axis: int):
        return np.max(a, axis=axis)

    @staticmethod
    def transpose(a, axes):
        return np.transpose(a, axes)

    @staticmethod
    def zeros_like(a):
        return np.zeros_like(a)


NUMPY_OPS = _NumpyOps()


# ---------------------------------------------------------------------------
# boundary strength + per-edge QP at 4x4 block granularity
# ---------------------------------------------------------------------------

def _block_grids(qp_map, intra: bool, nz4, mv, ops):
    """Per-4x4-block expansions of the MB-granular inputs: (qp_blk,
    nz_blk, mv_blk) with shapes (4*mbh, 4*mbw[, 2])."""
    qp_blk = ops.repeat(ops.repeat(qp_map, 4, axis=0), 4, axis=1)
    if intra:
        return qp_blk, None, None
    nz_blk = ops.astype(ops.asarray(nz4), ops.int32)
    mvg = ops.repeat(ops.repeat(mv, 4, axis=0), 4, axis=1)
    return qp_blk, nz_blk, mvg


def _edge_bs(qp_blk, nz_blk, mv_blk, edge_cols, intra: bool, ops):
    """(bS, qp_p, qp_q) for vertical edges at BLOCK columns `edge_cols`
    of the block grid — (rows, n_edges) each. Horizontal edges reuse
    this on the transposed grids."""
    xp = ops.xp
    e = edge_cols
    g = ops.gather_cols
    qp_p = g(qp_blk, e - 1)
    qp_q = g(qp_blk, e)
    is_mb_edge = (e % 4 == 0).astype(np.int32)[None, :]
    if intra:
        bs = xp.where(ops.asarray(is_mb_edge) > 0, 4, 3) \
            + ops.zeros_like(qp_p)
        return bs, qp_p, qp_q
    nzp = g(nz_blk, e - 1)
    nzq = g(nz_blk, e)
    coded = (nzp | nzq) > 0
    dmv = xp.abs(g(mv_blk, e - 1) - g(mv_blk, e))
    moved = ops.amax(dmv, axis=-1) >= 2        # >= 1 integer pel (half units)
    bs = xp.where(coded, 2, xp.where(moved, 1, 0))
    return bs, qp_p, qp_q


def _expand_rows(seg, n: int, ops):
    """(rows, E) per-4-sample-segment values → per-sample rows."""
    return ops.repeat(seg, n, axis=0)


# ---------------------------------------------------------------------------
# the edge filters (vertical form; horizontal = transpose outside)
# ---------------------------------------------------------------------------

def _clip3(lo, hi, x, xp):
    return xp.minimum(hi, xp.maximum(lo, x))


def _filter_luma_cols(X, xs, bs, qpav, ops):
    """Filter the vertical luma edges at sample columns `xs` of plane X
    (int32, (H, W)). bs/qpav: (H, len(xs)) int32 per-sample-row values.
    Returns the filtered plane; every read comes from the pass input."""
    xp = ops.xp
    g = ops.gather_cols
    p3, p2, p1, p0 = (g(X, xs - 4), g(X, xs - 3), g(X, xs - 2),
                      g(X, xs - 1))
    q0, q1, q2, q3 = g(X, xs), g(X, xs + 1), g(X, xs + 2), g(X, xs + 3)
    idx = _clip3(0, 51, qpav, xp)
    alpha = ops.asarray(ALPHA_TABLE)[idx]
    beta = ops.asarray(BETA_TABLE)[idx]
    filt = ((bs > 0)
            & (xp.abs(p0 - q0) < alpha)
            & (xp.abs(p1 - p0) < beta)
            & (xp.abs(q1 - q0) < beta))
    ap = xp.abs(p2 - p0) < beta
    aq = xp.abs(q2 - q0) < beta

    # -- normal filter (bS 1..3) --
    tc0 = ops.asarray(TC0_TABLE)[_clip3(0, 2, bs - 1, xp), idx]
    tc = tc0 + ops.astype(ap, ops.int32) + ops.astype(aq, ops.int32)
    delta = _clip3(-tc, tc,
                   (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, xp)
    np0 = _clip3(0, 255, p0 + delta, xp)
    nq0 = _clip3(0, 255, q0 - delta, xp)
    hp = (p0 + q0 + 1) >> 1
    np1 = p1 + _clip3(-tc0, tc0, (p2 + hp - (p1 << 1)) >> 1, xp)
    nq1 = q1 + _clip3(-tc0, tc0, (q2 + hp - (q1 << 1)) >> 1, xp)
    normal = filt & (bs < 4)
    out_p0 = xp.where(normal, np0, p0)
    out_q0 = xp.where(normal, nq0, q0)
    out_p1 = xp.where(normal & ap, np1, p1)
    out_q1 = xp.where(normal & aq, nq1, q1)
    out_p2, out_q2 = p2, q2

    # -- strong filter (bS == 4) --
    strong = filt & (bs == 4)
    close = xp.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = strong & ap & close
    sq = strong & aq & close
    sp0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    sp1 = (p2 + p1 + p0 + q0 + 2) >> 2
    sp2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    wp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
    sq1 = (q2 + q1 + q0 + p0 + 2) >> 2
    sq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    wq0 = (2 * q1 + q0 + p1 + 2) >> 2
    out_p0 = xp.where(strong, xp.where(sp, sp0, wp0), out_p0)
    out_p1 = xp.where(sp, sp1, out_p1)
    out_p2 = xp.where(sp, sp2, out_p2)
    out_q0 = xp.where(strong, xp.where(sq, sq0, wq0), out_q0)
    out_q1 = xp.where(sq, sq1, out_q1)
    out_q2 = xp.where(sq, sq2, out_q2)

    return ops.scatter_cols(X, [
        (xs - 3, out_p2), (xs - 2, out_p1), (xs - 1, out_p0),
        (xs, out_q0), (xs + 1, out_q1), (xs + 2, out_q2)])


def _filter_chroma_cols(C, xs, bs, qpav_c, ops):
    """Chroma vertical edge filter (writes p0/q0 only)."""
    xp = ops.xp
    g = ops.gather_cols
    p1, p0 = g(C, xs - 2), g(C, xs - 1)
    q0, q1 = g(C, xs), g(C, xs + 1)
    idx = _clip3(0, 51, qpav_c, xp)
    alpha = ops.asarray(ALPHA_TABLE)[idx]
    beta = ops.asarray(BETA_TABLE)[idx]
    filt = ((bs > 0)
            & (xp.abs(p0 - q0) < alpha)
            & (xp.abs(p1 - p0) < beta)
            & (xp.abs(q1 - q0) < beta))
    tc0 = ops.asarray(TC0_TABLE)[_clip3(0, 2, bs - 1, xp), idx]
    tc = tc0 + 1
    delta = _clip3(-tc, tc,
                   (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, xp)
    np0 = _clip3(0, 255, p0 + delta, xp)
    nq0 = _clip3(0, 255, q0 - delta, xp)
    sp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (2 * q1 + q0 + p1 + 2) >> 2
    normal = filt & (bs < 4)
    strong = filt & (bs == 4)
    out_p0 = xp.where(strong, sp0, xp.where(normal, np0, p0))
    out_q0 = xp.where(strong, sq0, xp.where(normal, nq0, q0))
    return ops.scatter_cols(C, [(xs - 1, out_p0), (xs, out_q0)])


# ---------------------------------------------------------------------------
# frame-level entry
# ---------------------------------------------------------------------------

def _luma_edge_sets(nblk: int):
    """(internal, mb) PLANE-LOCAL block rows/cols of the luma edges —
    static (from the plane shape only). Global liveness — frame/band-
    padding bounds for horizontal edges — is applied as a bS mask
    instead (:func:`_edge_live`)."""
    idx = np.arange(nblk)
    internal = idx[(idx > 0) & (idx % 4 != 0)]
    mb = idx[(idx > 0) & (idx % 4 == 0)]
    return internal, mb


def _edge_live(edge_blocks, blk0, blk_hi, ops):
    """(nE,) bool: does this plane-local edge exist in the PICTURE?"""
    g = ops.asarray(edge_blocks) + blk0
    return (g > 0) & (g < blk_hi)


def _deblock_luma(y32, qp_blk, nz_blk, mv_blk, intra: bool, ops,
                  blk_row0, total_blk_rows):
    """The four luma passes over one (possibly band-sliced) plane.
    `blk_row0` is the global 4x4-block row of plane row 0 and
    `total_blk_rows` the picture's real block-row count — horizontal
    edges outside (0, total) don't exist in the picture (band padding /
    frame boundary) and are masked to bS 0."""
    nbh, nbw = y32.shape[0] // 4, y32.shape[1] // 4

    def vpass(plane, qb, nb, mb_, edge_blocks, live):
        if len(edge_blocks) == 0:
            return plane
        bs, qp_p, qp_q = _edge_bs(qb, nb, mb_, edge_blocks, intra, ops)
        if live is not None:
            bs = ops.xp.where(live[None, :], bs, 0)
        qpav = (qp_p + qp_q + 1) >> 1
        return _filter_luma_cols(
            plane, edge_blocks * 4,
            _expand_rows(bs, 4, ops), _expand_rows(qpav, 4, ops), ops)

    internal, mb_cols = _luma_edge_sets(nbw)
    y32 = vpass(y32, qp_blk, nz_blk, mv_blk, internal, None)
    y32 = vpass(y32, qp_blk, nz_blk, mv_blk, mb_cols, None)

    # horizontal passes: transpose, reuse the vertical machinery
    yt = y32.T
    qbt = qp_blk.T
    nbt = None if intra else nz_blk.T
    mbt = None if intra else ops.transpose(mv_blk, (1, 0, 2))
    internal_h, mb_h = _luma_edge_sets(nbh)
    yt = vpass(yt, qbt, nbt, mbt, internal_h,
               _edge_live(internal_h, blk_row0, total_blk_rows, ops))
    yt = vpass(yt, qbt, nbt, mbt, mb_h,
               _edge_live(mb_h, blk_row0, total_blk_rows, ops))
    return yt.T


def _deblock_chroma(c32, qp_blk, nz_blk, mv_blk, intra: bool, ops,
                    blk_row0, total_blk_rows):
    """Both chroma passes for one chroma plane (u or v). Chroma edges
    at chroma x % 8 in {0, 4} take the bS of the corresponding luma
    edge (luma x = 2·chroma x); chroma qpav averages the two MBs'
    QP_C. Chroma rows map 2:1 onto luma rows, so the per-row bS/qp
    vectors are the luma block rows repeated twice."""
    xp = ops.xp
    nbh, nbw = c32.shape[0] // 4, c32.shape[1] // 4  # chroma 4x4 blocks

    def cpass(plane, qb, nb, mb_, edge_blocks, live):
        # edge_blocks: LUMA block columns of the corresponding luma
        # edges (chroma col 4c <-> luma col 8c: luma block col 2*eb)
        if len(edge_blocks) == 0:
            return plane
        bs, qp_p, qp_q = _edge_bs(qb, nb, mb_, edge_blocks, intra, ops)
        if live is not None:
            bs = xp.where(live[None, :], bs, 0)
        qpc_av = (ops.asarray(_QPC_NP)[_clip3(0, 51, qp_p, xp)]
                  + ops.asarray(_QPC_NP)[_clip3(0, 51, qp_q, xp)]
                  + 1) >> 1
        # luma 4-row segments -> luma rows -> chroma rows (2:1)
        bs_rows = _expand_rows(bs, 2, ops)
        qp_rows = _expand_rows(qpc_av, 2, ops)
        return _filter_chroma_cols(plane, edge_blocks * 2, bs_rows,
                                   qp_rows, ops)

    # vertical chroma edges: chroma x in {0 (x>0), 4} per MB = luma
    # block cols {0, 2} per MB (even luma block columns)
    cols = np.arange(2 * nbw)                 # luma block cols 0..2nbw
    vcols = cols[(cols % 2 == 0) & (cols > 0)]
    c32 = cpass(c32, qp_blk, nz_blk, mv_blk, vcols, None)

    ct = c32.T
    qbt = qp_blk.T
    nbt = None if intra else nz_blk.T
    mbt = None if intra else ops.transpose(mv_blk, (1, 0, 2))
    rows = np.arange(2 * nbh)                 # luma block rows, local
    hrows = rows[(rows % 2 == 0) & (rows > 0)]
    ct = cpass(ct, qbt, nbt, mbt, hrows,
               _edge_live(hrows, blk_row0, total_blk_rows, ops))
    return ct.T


def deblock_frame(y, u, v, qp_map, *, intra: bool, nz4=None, mv=None,
                  mb_row0: int = 0, total_mb_rows: int | None = None,
                  ops=NUMPY_OPS):
    """Deblock one (padded) frame or band slice.

    y: (16·mbh_p, 16·mbw) luma plane (any int dtype; uint8 ok);
    u/v: (8·mbh_p, 8·mbw); qp_map: (mbh_p, mbw) int QP_Y per MB;
    `intra` selects the picture-homogeneous bS rule. For P pictures,
    nz4: (4·mbh_p, 4·mbw) any-nonzero per 4x4 luma block and
    mv: (mbh_p, mbw, 2) half-pel MVs. `mb_row0`/`total_mb_rows`
    position a band slice inside the picture (horizontal edges outside
    the picture's real MB rows are skipped); the defaults describe a
    full frame. Returns filtered (y, u, v) in the input dtypes.
    """
    mbh_p, mbw = qp_map.shape[0], qp_map.shape[1]
    if total_mb_rows is None:
        total_mb_rows = mb_row0 + mbh_p
    y_dt, c_dt = y.dtype, u.dtype
    y32 = ops.astype(ops.asarray(y), ops.int32)
    u32 = ops.astype(ops.asarray(u), ops.int32)
    v32 = ops.astype(ops.asarray(v), ops.int32)
    qp_map = ops.astype(ops.asarray(qp_map), ops.int32)
    if not intra:
        if nz4 is None or mv is None:
            raise ValueError("P-frame deblock requires nz4 and mv")
        mv = ops.astype(ops.asarray(mv), ops.int32)
    qp_blk, nz_blk, mv_blk = _block_grids(qp_map, intra, nz4, mv, ops)
    blk_row0 = 4 * mb_row0
    total_blk = 4 * total_mb_rows
    y32 = _deblock_luma(y32, qp_blk, nz_blk, mv_blk, intra, ops,
                        blk_row0, total_blk)
    u32 = _deblock_chroma(u32, qp_blk, nz_blk, mv_blk, intra, ops,
                          blk_row0, total_blk)
    v32 = _deblock_chroma(v32, qp_blk, nz_blk, mv_blk, intra, ops,
                          blk_row0, total_blk)
    return (ops.astype(y32, y_dt), ops.astype(u32, c_dt),
            ops.astype(v32, c_dt))
