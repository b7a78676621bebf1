"""PyTorch intra encode core and device-side transfer pack.

Bit-exact port of the reference's intra compute (every RD config) and
of its two-tier sparse transfer pack. Structure follows the reference:

- with mode decision off (the fixed V/H/DC raster), macroblock ROW 0 is
  one chain along the row (DC-128, then horizontal prediction from the
  left neighbour's recon) and every MB column below it one chain down
  the rows (vertical prediction from the MB above). `intra_core_batch`
  runs that schedule over a batch of frames or split-frame bands: on
  the card as the hand kernels of csrc/intra_core.cu (torchintra), two
  launches a batch; on the CPU as its plain version
  `intra_core_batch_ref`, a left-to-right Python loop over row 0's MBs
  and one batched step per later row, every step over the whole batch.
- with ``rd.mode_decision`` a row runs the reference's two-stage
  schedule (vertical encode, then SATD-switched H/DC MBs), frame by
  frame in `_intra_core_md`; every per-MB choice stays on the device as
  `torch.where`.
- With ``rd.aq_q`` the quantizers take a per-MB QP vector (the
  variance-AQ map); the batched core always takes one per item.

Integer matrix products do not exist on CUDA in PyTorch, so every 4x4
transform and Hadamard is written as explicit butterflies (forward: rows
then columns; inverse: columns then rows — the order the ``>> 1``
rounding depends on).

The sequential entropy pack stays on the host (encoder.pack_slice or the
C++ packer); this module only produces level arrays, packs them for the
device→host transfer (the all-intra path's element-granular sparse pack,
the GOP path's two-tier block pack + compact stream), and holds the
all-intra frame encoder (`encode_intra` / `build_intra_encoder`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.devices import resolve_device
from . import rdo, torchintra
from .encoder import FrameLevels, _mode_policy
from .intra import LUMA_BLOCK_ORDER
from .rdo import RD_OFF
from .transform import CHROMA_QP_TABLE, MF_TABLE, V_TABLE, ZIGZAG_4x4

# raster (by*4+bx) index for each z-scan position
_ZSCAN_NP = np.asarray([by * 4 + bx for (bx, by) in LUMA_BLOCK_ORDER])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """Constant tables as tensors on `device` (uploaded once per device)."""
    return {
        "mf": torch.as_tensor(MF_TABLE, dtype=torch.int32, device=device),
        "v": torch.as_tensor(V_TABLE, dtype=torch.int32, device=device),
        "zz": torch.as_tensor(ZIGZAG_4x4, dtype=torch.int64, device=device),
        "izz": torch.as_tensor(np.argsort(ZIGZAG_4x4), dtype=torch.int64,
                               device=device),
        "zscan": torch.as_tensor(_ZSCAN_NP, dtype=torch.int64,
                                 device=device),
        "bitw": torch.as_tensor([128, 64, 32, 16, 8, 4, 2, 1],
                                dtype=torch.int32, device=device),
        "lanes": torch.as_tensor([1 << k for k in range(16)],
                                 dtype=torch.int32, device=device),
        "qpc": torch.as_tensor(CHROMA_QP_TABLE, dtype=torch.int32,
                               device=device),
        "act_thr": torch.as_tensor(
            [(1 << k) - 1 for k in range(1, rdo.AQ_ACT_BITS + 1)],
            dtype=torch.int64, device=device),
    }


def chroma_qp(qp: int) -> int:
    """Chroma QP of a luma QP (the reference's `_QPC[clip(qp)]`)."""
    return int(CHROMA_QP_TABLE[min(51, max(0, int(qp)))])


# ---------------------------------------------------------------------------
# 4x4 transforms as butterflies over the last two axes
# ---------------------------------------------------------------------------

def _fwd_rows(x):
    """CF applied along axis -2 (the einsum's `ij,...jk` factor)."""
    a, b, c, d = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    s0, s3 = a + d, a - d
    s1, s2 = b + c, b - c
    return torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-2)


def _fwd_cols(x):
    """CF^T applied along axis -1 (the einsum's `...jk,lk` factor)."""
    a, b, c, d = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0, s3 = a + d, a - d
    s1, s2 = b + c, b - c
    return torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-1)


def _fwd4(x):
    """W = CF @ x @ CF^T per (..., 4, 4) block."""
    return _fwd_cols(_fwd_rows(x))


def _inv4(d):
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0, g1, g2, g3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    h0, h1 = g0 + g2, g0 - g2
    h2, h3 = (g1 >> 1) - g3, g1 + (g3 >> 1)
    return torch.stack([h0 + h3, h1 + h2, h1 - h2, h0 - h3], dim=-2)


def _had4(x):
    """H4 @ x @ H4^T per (..., 4, 4) block (H4 is symmetric)."""
    def rows(v):
        a, b, c, d = v[..., 0, :], v[..., 1, :], v[..., 2, :], v[..., 3, :]
        return torch.stack([a + b + c + d, a + b - c - d,
                            a - b - c + d, a - b + c - d], dim=-2)

    def cols(v):
        a, b, c, d = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
        return torch.stack([a + b + c + d, a + b - c - d,
                            a - b - c + d, a - b + c - d], dim=-1)
    return cols(rows(x))


def _had2(x):
    """H2 @ x @ H2^T per (..., 2, 2) block."""
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    return torch.stack([torch.stack([a + b + c + d, a - b + c - d], -1),
                        torch.stack([a + b - c - d, a - b - c + d], -1)],
                       dim=-2)


def _quant(w, qp, skip_dc: bool):
    """Quantize (n, B, 4, 4) coefficient blocks (intra rounding bias
    f = (1 << qbits) / 3). `qp` is a host int, or an (n,) per-MB int32
    tensor (perceptual AQ); with an int the math and the launches are
    the historical ones."""
    if isinstance(qp, torch.Tensor):
        mf = _tables(w.device)["mf"][(qp % 6).long()][:, None]  # (n,1,4,4)
        qbits = (15 + qp // 6)[:, None, None, None]
    else:
        mf = _tables(w.device)["mf"][qp % 6]
        qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    z = (torch.abs(w) * mf + f) >> qbits
    z = torch.where(w < 0, -z, z)
    if skip_dc:
        z[..., 0, 0] = 0
    return z


def _dequant(z, qp):
    if isinstance(qp, torch.Tensor):
        v = _tables(z.device)["v"][(qp % 6).long()][:, None]
        return (z * v) << (qp // 6)[:, None, None, None]
    return (z * _tables(z.device)["v"][qp % 6]) << (qp // 6)


def _zigzag(b):
    return b.reshape(*b.shape[:-2], 16)[..., _tables(b.device)["zz"]]


def _inv_zigzag(seq):
    out = seq[..., _tables(seq.device)["izz"]]
    return out.reshape(*seq.shape[:-1], 4, 4)


def _dc_dims(qp, ndim: int):
    """(qbits, mf00, vls, qp_b) broadcastable over an (n, ...) DC array
    when `qp` is an (n,) tensor, plain host ints otherwise."""
    if isinstance(qp, torch.Tensor):
        shape = (qp.shape[0],) + (1,) * (ndim - 1)
        tb = _tables(qp.device)
        q6 = (qp % 6).long()
        return ((15 + qp // 6).reshape(shape),
                tb["mf"][q6, 0, 0].reshape(shape),
                (tb["v"][q6, 0, 0] * 16).reshape(shape),
                qp.reshape(shape))
    return (15 + qp // 6, int(MF_TABLE[qp % 6, 0, 0]),
            int(V_TABLE[qp % 6, 0, 0]) * 16, qp)


def _luma_dc_quant(wd, qp):
    qbits, mf00, _, _ = _dc_dims(qp, wd.dim())
    f = (1 << qbits) // 3
    z = (torch.abs(wd) * mf00 + 2 * f) >> (qbits + 1)
    return torch.where(wd < 0, -z, z)


def _luma_dc_dequant(z, qp):
    f = _had4(z)
    _, _, ls, qp_b = _dc_dims(qp, f.dim())
    if not isinstance(qp_b, torch.Tensor):
        if qp_b >= 36:
            return (f * ls) << max(qp_b // 6 - 6, 0)
        shift = max(6 - qp_b // 6, 1)
        return (f * ls + (1 << (shift - 1))) >> shift
    hi = (f * ls) << torch.clamp(qp_b // 6 - 6, min=0)
    shift = torch.clamp(6 - qp_b // 6, min=1)
    lo = (f * ls + (1 << (shift - 1))) >> shift
    return torch.where(qp_b >= 36, hi, lo)


def _chroma_dc_quant(wd, qp):
    qbits, mf00, _, _ = _dc_dims(qp, wd.dim())
    f = (1 << qbits) // 3
    z = (torch.abs(wd) * mf00 + 2 * f) >> (qbits + 1)
    return torch.where(wd < 0, -z, z)


def _chroma_dc_dequant(z, qp):
    f = _had2(z)
    _, _, ls, qp_b = _dc_dims(qp, f.dim())
    return ((f * ls) << (qp_b // 6)) >> 5


def _luma_mb_batch(src, pred, qp):
    """src/pred: (n, 16, 16) int32 → (dc_lev (n,16), ac_lev (n,16,15),
    recon (n,16,16))."""
    n = src.shape[0]
    resid = src - pred
    blocks = resid.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 16, 4, 4)
    w = _fwd4(blocks)
    dc = w[..., 0, 0].reshape(n, 4, 4)                      # [by, bx]
    wd = _had4(dc) // 2
    dc_lev = _zigzag(_luma_dc_quant(wd, qp))
    z = _quant(w, qp, skip_dc=True)
    ac_lev = _zigzag(z)[:, _tables(src.device)["zscan"]][:, :, 1:]
    # closed-loop recon from the signaled levels
    dcr = _luma_dc_dequant(_inv_zigzag(dc_lev), qp)         # (n, 4, 4)
    d = _dequant(z, qp)
    d[..., 0, 0] = dcr.reshape(n, 16)
    r = (_inv4(d) + 32) >> 6
    predb = pred.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 16, 4, 4)
    rec = torch.clamp(predb + r, 0, 255)
    rec = rec.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 16, 16)
    return dc_lev, ac_lev, rec


def _chroma_mb_batch(src, pred, qpc):
    """src/pred: (n, 8, 8) int32 → (dc_lev (n,4), ac_lev (n,4,15), recon)."""
    n = src.shape[0]
    resid = src - pred
    blocks = resid.reshape(n, 2, 4, 2, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 4, 4, 4)
    w = _fwd4(blocks)
    dc = w[..., 0, 0].reshape(n, 2, 2)
    wd = _had2(dc)
    dc_lev = _chroma_dc_quant(wd, qpc).reshape(n, 4)
    z = _quant(w, qpc, skip_dc=True)
    ac_lev = _zigzag(z)[..., 1:]
    dcr = _chroma_dc_dequant(dc_lev.reshape(n, 2, 2), qpc)
    d = _dequant(z, qpc)
    d[..., 0, 0] = dcr.reshape(n, 4)
    r = (_inv4(d) + 32) >> 6
    predb = pred.reshape(n, 2, 4, 2, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 4, 4, 4)
    rec = torch.clamp(predb + r, 0, 255)
    rec = rec.reshape(n, 2, 2, 4, 4).permute(0, 1, 3, 2, 4).reshape(n, 8, 8)
    return dc_lev, ac_lev, rec


def _satd16(resid):
    """(n, 16, 16) int32 residual → (n,) int32 SATD (sum |4x4 Hadamard|
    / 2; the intra mode-decision cost — rdo.satd16_np is the numpy
    twin)."""
    n = resid.shape[0]
    b = resid.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
    t = _had4(b)
    return (torch.abs(t).sum(dim=(1, 2, 3, 4)) // 2).to(torch.int32)


def _satd8(resid):
    """(n, 8, 8) int32 residual → (n,) int32 SATD."""
    n = resid.shape[0]
    b = resid.reshape(n, 2, 4, 2, 4).permute(0, 1, 3, 2, 4)
    t = _had4(b)
    return (torch.abs(t).sum(dim=(1, 2, 3, 4)) // 2).to(torch.int32)


def _mb_activity(y32, mbw: int, mbh: int):
    """(nmb,) int32 integer luma activity — the device twin of
    rdo.mb_activity_np. The reference works in uint32; V = 256·Σx² −
    (Σx)² reaches ~4.26e9, past int32, and torch's uint32 has no CUDA
    reductions, so this computes in int64 (exact either way)."""
    mb = y32[:16 * mbh, :16 * mbw].to(torch.int64)
    mb = mb.reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3)
    mb = mb.reshape(mbh * mbw, 256)
    s = mb.sum(dim=1)
    s2 = (mb * mb).sum(dim=1)
    v = 256 * s2 - s * s
    thr = _tables(y32.device)["act_thr"]          # 2^k - 1, k = 1..32
    return (v[:, None] >= thr).sum(dim=1).to(torch.int32)


def _aq_qp_map(y32, qp: int, aq_q: int, mbw: int, mbh: int):
    """(nmb,) int32 per-MB QP for one intra frame under perceptual AQ —
    integer mirror of rdo.aq_offsets_from_activity."""
    act = _mb_activity(y32, mbw, mbh)
    nmb = mbw * mbh
    total = act.sum(dtype=torch.int32)
    num = aq_q * (act * nmb - total)
    den = rdo.AQ_QUANT * nmb
    delta = (2 * num + den) // (2 * den)
    delta = torch.clamp(delta, -rdo.AQ_MAX_DELTA, rdo.AQ_MAX_DELTA)
    return torch.clamp(qp + delta, 0, 51).to(torch.int32)


def _greedy_allowed(desired):
    """Vectorized greedy left-to-right selection: allowed[c] =
    desired[c] & !allowed[c-1]. Within each run of consecutive desired
    MBs the sequential recurrence alternates starting True at the run
    head, so allowed = desired & (even offset from the run start) —
    cummax of the run-start indices replaces the scan."""
    n = desired.shape[0]
    idx = torch.arange(n, device=desired.device)
    prev = torch.cat([desired.new_zeros(1), desired[:-1]])
    run_start = desired & ~prev
    start_idx = torch.cummax(torch.where(run_start, idx, -1), dim=0).values
    return desired & (((idx - start_idx) % 2) == 0)


#: large finite cost for unavailable candidates (strict-< selection
#: keeps the earlier candidate on ties, so this never wins)
_COST_INF = 1 << 29


def _pick3(c0, m0, c1, m1, c2, m2):
    """Strict-< argmin over three (cost, mode) pairs, earlier wins."""
    best, mode = c0, torch.full_like(c0, m0)
    take = c1 < best
    best = torch.where(take, c1, best)
    mode = torch.where(take, m1, mode)
    take = c2 < best
    best = torch.where(take, c2, best)
    mode = torch.where(take, m2, mode)
    return best, mode


def _chroma_dc_pred_row(ts4, ls4, avail_left, avail_top):
    """(n, 8, 8) chroma DC predictions per §8.3.4 quadrant rules from
    per-MB quarter sums ts4 (n, 2) [top halves] and ls4 (n, 2) [left
    halves]; avail_* are (n,) bools. Matches intra.predict_chroma8's
    availability fallbacks for every (left, top) combination that
    occurs in a slice (at least one of them available)."""
    n = ts4.shape[0]
    t0, t1 = ts4[:, 0], ts4[:, 1]
    l0, l1 = ls4[:, 0], ls4[:, 1]
    both = avail_left & avail_top
    # quadrant (0,0): t0+l0 both; else the available one
    q00 = torch.where(both, (t0 + l0 + 4) >> 3,
                      torch.where(avail_top, (t0 + 2) >> 2, (l0 + 2) >> 2))
    # (1,0): prefers its own top quarter
    q10 = torch.where(avail_top, (t1 + 2) >> 2, (l0 + 2) >> 2)
    # (0,1): prefers its own left quarter
    q01 = torch.where(avail_left, (l1 + 2) >> 2, (t0 + 2) >> 2)
    # (1,1): both -> t1+l1; else the available one
    q11 = torch.where(both, (t1 + l1 + 4) >> 3,
                      torch.where(avail_top, (t1 + 2) >> 2, (l1 + 2) >> 2))
    top = torch.cat([q00[:, None, None].expand(n, 4, 4),
                     q10[:, None, None].expand(n, 4, 4)], dim=2)
    bot = torch.cat([q01[:, None, None].expand(n, 4, 4),
                     q11[:, None, None].expand(n, 4, 4)], dim=2)
    return torch.cat([top, bot], dim=1)


@functools.lru_cache(maxsize=None)
def _policy_side_channel(mbw: int, mbh: int, device: torch.device):
    """The fixed mode raster and an all-zero qp delta as device tensors
    (the side channel of a frame encoded without mode decision / AQ),
    uploaded once per shape: a copy per frame would stall the host."""
    luma, chroma = _mode_policy(mbw, mbh)
    return (torch.as_tensor(luma, dtype=torch.int32, device=device),
            torch.as_tensor(chroma, dtype=torch.int32, device=device),
            torch.zeros(mbw * mbh, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=256)
def _flat_qp(nmb: int, qp: int, device: torch.device):
    """(nmb,) int32 of one frame QP on `device`, made once per (shape,
    QP): the per-MB QP map of a frame without AQ. Never written to."""
    return torch.full((nmb,), int(qp), dtype=torch.int32, device=device)


def _mb_tiles(plane, size: int, rows: slice, mbw: int):
    """(B, h, W) plane rows → (B * mbw, size, size) MB tiles of those
    rows, MB-major within each item."""
    B = plane.shape[0]
    t = plane[:, rows].reshape(B, -1, size, mbw, size).permute(0, 1, 3, 2, 4)
    return t.reshape(-1, size, size)


def intra_core_batch_ref(ys, us, vs, qp_mb, *, mbw: int, mbh: int):
    """Plain PyTorch intra core of a batch with mode decision off — the
    version csrc/intra_core.cu is held to, and what CPU tensors take.

    ys (B, 16 mbh, 16 mbw), us / vs (B, 8 mbh, 8 mbw) padded planes (any
    integer dtype, samples in 0..255); qp_mb (B, mbh mbw) int32, each
    item's per-MB QP (its frame QP expanded, or its AQ map). Returns
    (luma_dc (B, nmb, 16), luma_ac (B, nmb, 16, 15), chroma_dc (B, nmb,
    2, 4), chroma_ac (B, nmb, 2, 4, 15), recon_y, recon_u, recon_v), all
    int32: `_intra_core`'s first seven outputs with a leading B.

    Schedule (the encoder's fixed raster): MB (0, 0) is DC-128, every
    later MB of row 0 horizontal from its left neighbour's recon, every
    MB of rows >= 1 vertical from the bottom recon row of the MB above.
    Row 0 runs MB by MB, the later rows one step each, both over the
    whole batch."""
    B = ys.shape[0]
    dev = ys.device
    ys, us, vs = (p.to(torch.int32) for p in (ys, us, vs))
    qp_mb = qp_mb.to(torch.int32).reshape(B, mbh, mbw)
    qpc_mb = _tables(dev)["qpc"][qp_mb.clamp(0, 51).long()]

    # --- row 0: left to right (left-only dependencies) ---
    sy0 = _mb_tiles(ys, 16, slice(0, 16), mbw).reshape(B, mbw, 16, 16)
    su0 = _mb_tiles(us, 8, slice(0, 8), mbw).reshape(B, mbw, 8, 8)
    sv0 = _mb_tiles(vs, 8, slice(0, 8), mbw).reshape(B, mbw, 8, 8)
    pred_y = torch.full((B, 16, 16), 128, dtype=torch.int32, device=dev)
    pred_u = pred_v = torch.full((B, 8, 8), 128, dtype=torch.int32,
                                 device=dev)
    r0 = []
    for mx in range(mbw):
        q, qc = qp_mb[:, 0, mx], qpc_mb[:, 0, mx]
        ydc, yac, yrec = _luma_mb_batch(sy0[:, mx], pred_y, q)
        udc, uac, urec = _chroma_mb_batch(su0[:, mx], pred_u, qc)
        vdc, vac, vrec = _chroma_mb_batch(sv0[:, mx], pred_v, qc)
        pred_y = yrec[:, :, -1:].expand(B, 16, 16)
        pred_u = urec[:, :, -1:].expand(B, 8, 8)
        pred_v = vrec[:, :, -1:].expand(B, 8, 8)
        r0.append((ydc, yac, udc, uac, vdc, vac, yrec, urec, vrec))
    rows = [tuple(torch.stack(parts, dim=1) for parts in zip(*r0))]

    # --- rows 1..mbh-1: one step per row over every MB of the batch ---
    for my in range(1, mbh):
        prev = rows[-1]
        pred_y = prev[6][:, :, -1:, :].reshape(B * mbw, 1, 16).expand(
            B * mbw, 16, 16)
        pred_u = prev[7][:, :, -1:, :].reshape(B * mbw, 1, 8).expand(
            B * mbw, 8, 8)
        pred_v = prev[8][:, :, -1:, :].reshape(B * mbw, 1, 8).expand(
            B * mbw, 8, 8)
        q = qp_mb[:, my].reshape(-1)
        qc = qpc_mb[:, my].reshape(-1)
        sy = _mb_tiles(ys, 16, slice(16 * my, 16 * my + 16), mbw)
        su = _mb_tiles(us, 8, slice(8 * my, 8 * my + 8), mbw)
        sv = _mb_tiles(vs, 8, slice(8 * my, 8 * my + 8), mbw)
        out = (_luma_mb_batch(sy, pred_y, q)
               + _chroma_mb_batch(su, pred_u, qc)
               + _chroma_mb_batch(sv, pred_v, qc))
        ydc, yac, yrec, udc, uac, urec, vdc, vac, vrec = (
            a.reshape((B, mbw) + tuple(a.shape[1:])) for a in out)
        rows.append((ydc, yac, udc, uac, vdc, vac, yrec, urec, vrec))

    (ydc, yac, udc, uac, vdc, vac, yrec, urec, vrec) = (
        torch.stack(parts, dim=1) for parts in zip(*rows))  # (B, mbh, mbw..)
    nmb = mbw * mbh
    return (ydc.reshape(B, nmb, 16),
            yac.reshape(B, nmb, 16, 15),
            torch.stack([udc.reshape(B, nmb, 4), vdc.reshape(B, nmb, 4)],
                        dim=2),
            torch.stack([uac.reshape(B, nmb, 4, 15),
                         vac.reshape(B, nmb, 4, 15)], dim=2),
            yrec.permute(0, 1, 3, 2, 4).reshape(B, 16 * mbh, 16 * mbw),
            urec.permute(0, 1, 3, 2, 4).reshape(B, 8 * mbh, 8 * mbw),
            vrec.permute(0, 1, 3, 2, 4).reshape(B, 8 * mbh, 8 * mbw))


def intra_core_batch(ys, us, vs, qp_mb, *, mbw: int, mbh: int):
    """The intra core of a batch with mode decision off (the contract of
    :func:`intra_core_batch_ref`): CUDA tensors go through the hand
    kernels (torchintra.intra_core_batch_cuda: two launches, whatever
    the batch), CPU tensors through the plain version. On the card the
    planes are taken as uint8 (their samples lie in 0..255)."""
    if ys.device.type != "cuda":
        return intra_core_batch_ref(ys, us, vs, qp_mb, mbw=mbw, mbh=mbh)
    ys, us, vs = (p.to(torch.uint8).contiguous() for p in (ys, us, vs))
    return torchintra.intra_core_batch_cuda(
        ys, us, vs, qp_mb.to(torch.int32).contiguous(), mbw=mbw, mbh=mbh)


def intra_core_frames(ys, us, vs, qps, *, mbw: int, mbh: int, rd=RD_OFF):
    """The intra core of B (padded) frames or bands, ys (B, H, W), each
    at its host-int QP in `qps`: `_intra_core`'s ten outputs with a
    leading B. With mode decision off the whole batch is one
    :func:`intra_core_batch` call (the QP map of each item its QP, or
    its AQ map with ``rd.aq_q``); with it each item runs
    :func:`_intra_core_md`."""
    qps = [int(q) for q in qps]
    if rd.mode_decision:
        outs = [_intra_core_md(ys[b], us[b], vs[b], qps[b], mbw=mbw,
                               mbh=mbh, rd=rd) for b in range(len(qps))]
        return tuple(torch.stack(parts) for parts in zip(*outs))
    B, dev, nmb = len(qps), ys.device, mbw * mbh
    luma_mode, chroma_mode, zeros = _policy_side_channel(mbw, mbh, dev)
    if rd.aq_q > 0:
        qp_mb = torch.stack([
            _aq_qp_map(ys[b].to(torch.int32), qps[b], rd.aq_q, mbw, mbh)
            for b in range(B)])
        base = torch.stack([_flat_qp(nmb, q, dev) for q in qps])
        qp_delta = (qp_mb - base).to(torch.int32)
    else:
        qp_mb = torch.stack([_flat_qp(nmb, q, dev) for q in qps])
        qp_delta = zeros.expand(B, nmb)
    core = intra_core_batch(ys, us, vs, qp_mb, mbw=mbw, mbh=mbh)
    return core + (luma_mode.expand(B, nmb), chroma_mode.expand(B, nmb),
                   qp_delta)


def _intra_core(y, u, v, qp: int, *, mbw: int, mbh: int, rd=RD_OFF):
    """Intra compute for one (padded) frame.

    Returns (luma_dc (nmb,16), luma_ac (nmb,16,15), chroma_dc (nmb,2,4),
    chroma_ac (nmb,2,4,15), recon_y, recon_u, recon_v, luma_mode (nmb,),
    chroma_mode (nmb,), qp_delta (nmb,)), all int32 — the reference's
    ten outputs. With mode decision off this is the B = 1 case of
    :func:`intra_core_frames` (the hand kernels on the card), the modes
    encoder._mode_policy's raster and qp_delta all-zero or the AQ
    map's; with it, :func:`_intra_core_md`."""
    if rd.mode_decision:
        return _intra_core_md(y, u, v, qp, mbw=mbw, mbh=mbh, rd=rd)
    out = intra_core_frames(y[None], u[None], v[None], [qp], mbw=mbw,
                            mbh=mbh, rd=rd)
    return tuple(o[0] for o in out)


def _intra_core_md(y, u, v, qp: int, *, mbw: int, mbh: int, rd):
    """Intra compute for one (padded) frame with ``rd.mode_decision``:
    the fixed V/H/DC raster becomes a per-MB SATD decision; rows stay
    data-parallel via a two-stage schedule: every MB of a row first
    encodes VERTICAL, then MBs whose H/DC candidate (predicted from the
    LEFT neighbor's vertical-mode recon) beats V by SATD are switched —
    greedily constrained so a switched MB's left neighbor always kept
    V, which makes the left-recon assumption exact. Row 0 decides H vs
    DC inside its left-to-right loop, where the true recon is
    available. With ``rd.aq_q`` the quantizer runs on a per-MB QP map
    (qp + variance-AQ offsets, _aq_qp_map). Every per-MB choice is a
    device-side `torch.where`: nothing here reads a value back to the
    host. Returns `_intra_core`'s ten outputs."""
    qp = int(qp)
    y = y.to(torch.int32)
    u = u.to(torch.int32)
    v = v.to(torch.int32)
    qpc = chroma_qp(qp)
    dev = y.device
    if rd.aq_q > 0:
        qp_mb = _aq_qp_map(y, qp, rd.aq_q, mbw, mbh)           # (nmb,)
        qp_rows = qp_mb.reshape(mbh, mbw)
        qpc_rows = _tables(dev)["qpc"][qp_mb.long()].reshape(mbh, mbw)
        qp_delta = (qp_mb - qp).to(torch.int32)
    else:
        qp_rows = qpc_rows = None
        qp_delta = _policy_side_channel(mbw, mbh, dev)[2]

    def row_qp(my, sl=slice(None)):
        """(luma, chroma) QP of row `my`'s MBs `sl`: the scalar frame
        QP, or the AQ map's (n,) vectors."""
        if qp_rows is None:
            return qp, qpc
        return qp_rows[my, sl], qpc_rows[my, sl]

    # --- row 0: sequential over MBs (left-only dependencies) ---
    y_row0 = y[:16].reshape(16, mbw, 16).permute(1, 0, 2)      # (mbw,16,16)
    u_row0 = u[:8].reshape(8, mbw, 8).permute(1, 0, 2)
    v_row0 = v[:8].reshape(8, mbw, 8).permute(1, 0, 2)
    dc_y = torch.full((1, 16, 16), 128, dtype=torch.int32, device=dev)
    dc_c = torch.full((1, 8, 8), 128, dtype=torch.int32, device=dev)
    left_only = (torch.ones(1, dtype=torch.bool, device=dev),
                 torch.zeros(1, dtype=torch.bool, device=dev))
    zero_ts = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    r0 = []
    r0_take, r0_ctake = [], []
    ly = lu = lv = None
    for idx in range(mbw):
        sy, su, sv = (y_row0[idx:idx + 1], u_row0[idx:idx + 1],
                      v_row0[idx:idx + 1])
        if idx == 0:
            pred_y, pred_u, pred_v = dc_y, dc_c, dc_c
        else:
            pred_y = ly[None, :, None].expand(1, 16, 16)
            pred_u = lu[None, :, None].expand(1, 8, 8)
            pred_v = lv[None, :, None].expand(1, 8, 8)
            # candidates: H vs DC (left-only), decided by SATD on the
            # device
            dcy = ((ly.sum(dtype=torch.int32) + 8) >> 4).expand(1, 16, 16)
            take_dc = _satd16(sy - dcy) < _satd16(sy - pred_y)
            lsum_u = torch.stack([lu[:4].sum(dtype=torch.int32),
                                  lu[4:].sum(dtype=torch.int32)])
            lsum_v = torch.stack([lv[:4].sum(dtype=torch.int32),
                                  lv[4:].sum(dtype=torch.int32)])
            dcu = _chroma_dc_pred_row(zero_ts, lsum_u[None], *left_only)
            dcv = _chroma_dc_pred_row(zero_ts, lsum_v[None], *left_only)
            cc_h = _satd8(su - pred_u) + _satd8(sv - pred_v)
            cc_dc = _satd8(su - dcu) + _satd8(sv - dcv)
            take_cdc = cc_dc < cc_h
            pred_y = torch.where(take_dc[:, None, None], dcy, pred_y)
            pred_u = torch.where(take_cdc[:, None, None], dcu, pred_u)
            pred_v = torch.where(take_cdc[:, None, None], dcv, pred_v)
            r0_take.append(take_dc)
            r0_ctake.append(take_cdc)
        q1, qc1 = row_qp(0, slice(idx, idx + 1))
        ydc, yac, yrec = _luma_mb_batch(sy, pred_y, q1)
        udc, uac, urec = _chroma_mb_batch(su, pred_u, qc1)
        vdc, vac, vrec = _chroma_mb_batch(sv, pred_v, qc1)
        ly, lu, lv = yrec[0, :, -1], urec[0, :, -1], vrec[0, :, -1]
        r0.append((ydc, yac, udc, uac, vdc, vac, yrec, urec, vrec))
    rows = [tuple(torch.cat(parts) for parts in zip(*r0))]
    # MB 0 keeps DC-128 (no neighbors): luma DC (2), chroma DC (0)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    take = torch.cat([first] + r0_take)
    ctake = torch.cat([first] + r0_ctake)
    modes = [(torch.where(take, 2, 1).to(torch.int32),
              torch.where(ctake, 0, 1).to(torch.int32))]
    by, bu, bv = (rows[0][6][:, -1, :].reshape(-1),
                  rows[0][7][:, -1, :].reshape(-1),
                  rows[0][8][:, -1, :].reshape(-1))
    has_left = torch.arange(mbw, device=dev) > 0
    avail_top = torch.ones(mbw, dtype=torch.bool, device=dev)
    zcol_y = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    zcol_c = torch.zeros((1, 8), dtype=torch.int32, device=dev)

    # --- rows 1..mbh-1: one batched step per row, vectorized over MBs ---
    for my in range(1, mbh):
        sy = y[16 * my:16 * my + 16].reshape(16, mbw, 16).permute(1, 0, 2)
        su = u[8 * my:8 * my + 8].reshape(8, mbw, 8).permute(1, 0, 2)
        sv = v[8 * my:8 * my + 8].reshape(8, mbw, 8).permute(1, 0, 2)
        pred_vy = by.reshape(mbw, 1, 16).expand(mbw, 16, 16)
        pred_vu = bu.reshape(mbw, 1, 8).expand(mbw, 8, 8)
        pred_vv = bv.reshape(mbw, 1, 8).expand(mbw, 8, 8)
        qp_v, qpc_v = row_qp(my)
        # stage 1: vertical encode of the whole row (candidate recon for
        # the neighbors' H/DC predictions)
        _, _, yrecv = _luma_mb_batch(sy, pred_vy, qp_v)
        _, _, urecv = _chroma_mb_batch(su, pred_vu, qpc_v)
        _, _, vrecv = _chroma_mb_batch(sv, pred_vv, qpc_v)

        # stage 2: candidate costs. Left columns come from the LEFT
        # neighbor's stage-1 (vertical) recon — exact for every switched
        # MB because the greedy constraint keeps its left neighbor
        # vertical. MB 0 reads zeros (masked).
        lcol_y = torch.cat([zcol_y, yrecv[:-1, :, -1]])
        lcol_u = torch.cat([zcol_c, urecv[:-1, :, -1]])
        lcol_v = torch.cat([zcol_c, vrecv[:-1, :, -1]])
        pred_hy = lcol_y[:, :, None].expand(mbw, 16, 16)
        pred_hu = lcol_u[:, :, None].expand(mbw, 8, 8)
        pred_hv = lcol_v[:, :, None].expand(mbw, 8, 8)
        tsum_y = by.reshape(mbw, 16).sum(dim=1, dtype=torch.int32)
        lsum_y = lcol_y.sum(dim=1, dtype=torch.int32)
        dcy = torch.where(has_left, (tsum_y + lsum_y + 16) >> 5,
                          (tsum_y + 8) >> 4)
        pred_dcy = dcy[:, None, None].expand(mbw, 16, 16)
        ts_u = bu.reshape(mbw, 2, 4).sum(dim=2, dtype=torch.int32)
        ts_v = bv.reshape(mbw, 2, 4).sum(dim=2, dtype=torch.int32)
        ls_u = lcol_u.reshape(mbw, 2, 4).sum(dim=2, dtype=torch.int32)
        ls_v = lcol_v.reshape(mbw, 2, 4).sum(dim=2, dtype=torch.int32)
        pred_dcu = _chroma_dc_pred_row(ts_u, ls_u, has_left, avail_top)
        pred_dcv = _chroma_dc_pred_row(ts_v, ls_v, has_left, avail_top)

        c_v = _satd16(sy - pred_vy)
        c_h = torch.where(has_left, _satd16(sy - pred_hy), _COST_INF)
        c_dc = _satd16(sy - pred_dcy)
        cc_v = _satd8(su - pred_vu) + _satd8(sv - pred_vv)
        cc_h = torch.where(has_left,
                           _satd8(su - pred_hu) + _satd8(sv - pred_hv),
                           _COST_INF)
        cc_dc = _satd8(su - pred_dcu) + _satd8(sv - pred_dcv)

        best_y, ymode_alt = _pick3(c_v, 0, c_h, 1, c_dc, 2)
        best_c, cmode_alt = _pick3(cc_v, 2, cc_h, 1, cc_dc, 0)
        desired = (best_y + best_c) < (c_v + cc_v)
        allowed = _greedy_allowed(desired)

        ymode = torch.where(allowed, ymode_alt, 0)
        cmode = torch.where(allowed, cmode_alt, 2)
        pred_y = torch.where((ymode == 0)[:, None, None], pred_vy,
                             torch.where((ymode == 1)[:, None, None],
                                         pred_hy, pred_dcy))
        pred_u = torch.where((cmode == 2)[:, None, None], pred_vu,
                             torch.where((cmode == 1)[:, None, None],
                                         pred_hu, pred_dcu))
        pred_v = torch.where((cmode == 2)[:, None, None], pred_vv,
                             torch.where((cmode == 1)[:, None, None],
                                         pred_hv, pred_dcv))

        ydc, yac, yrec = _luma_mb_batch(sy, pred_y, qp_v)
        udc, uac, urec = _chroma_mb_batch(su, pred_u, qpc_v)
        vdc, vac, vrec = _chroma_mb_batch(sv, pred_v, qpc_v)
        modes.append((ymode.to(torch.int32), cmode.to(torch.int32)))
        by = yrec[:, -1, :].reshape(-1)
        bu = urec[:, -1, :].reshape(-1)
        bv = vrec[:, -1, :].reshape(-1)
        rows.append((ydc, yac, udc, uac, vdc, vac, yrec, urec, vrec))

    (ydc, yac, udc, uac, vdc, vac, yrec, urec, vrec) = (
        torch.stack(parts) for parts in zip(*rows))          # (mbh, mbw, ..)
    luma_dc = ydc.reshape(-1, 16)
    luma_ac = yac.reshape(-1, 16, 15)
    chroma_dc = torch.stack([udc.reshape(-1, 4), vdc.reshape(-1, 4)], dim=1)
    chroma_ac = torch.stack([uac.reshape(-1, 4, 15),
                             vac.reshape(-1, 4, 15)], dim=1)
    recon_y = yrec.permute(0, 2, 1, 3).reshape(16 * mbh, 16 * mbw)
    recon_u = urec.permute(0, 2, 1, 3).reshape(8 * mbh, 8 * mbw)
    recon_v = vrec.permute(0, 2, 1, 3).reshape(8 * mbh, 8 * mbw)
    luma_mode = torch.cat([m[0] for m in modes])
    chroma_mode = torch.cat([m[1] for m in modes])
    return (luma_dc, luma_ac, chroma_dc, chroma_ac,
            recon_y, recon_u, recon_v, luma_mode, chroma_mode, qp_delta)


def _mode_tail(luma_mode, chroma_mode, qp_delta):
    """The per-MB side channel appended to intra transfer vectors when
    rd.ships_modes: [mode16 | dqp16], mode16 = luma | chroma << 4, along
    the last axis (a leading batch axis stays)."""
    return torch.cat([(luma_mode | (chroma_mode << 4)).to(torch.int16),
                      qp_delta.to(torch.int16)], dim=-1)


# ---------------------------------------------------------------------------
# device-side transfer pack (two-tier block sparse + compact byte stream)
# ---------------------------------------------------------------------------

_I8_MAX = 127
_BLOCK = 16
# Block-sparse budget: tolerated fraction of 16-coeff blocks with any
# nonzero coefficient is 1/_BLOCK_BUDGET_DIV; beyond that the caller
# falls back to the dense fetch (the GOP's intra frame is not sparse —
# most intra blocks carry at least a DC level — so the budget must absorb
# intra blocks + sparse P blocks).
_BLOCK_BUDGET_DIV = 4
# Value-stream budget: elementwise nonzero density beyond 1/div falls
# back dense.
_VAL_BUDGET_DIV = 24


def _bitmap(mask):
    """(N,) bool → ceil(N/8) uint8, big-endian within bytes (np.packbits
    order)."""
    pad = (-mask.shape[0]) % 8
    m = mask.to(torch.int32)
    if pad:
        m = torch.cat([m, m.new_zeros(pad)])
    w = _tables(mask.device)["bitw"]
    return (m.reshape(-1, 8) * w).sum(dim=-1).to(torch.uint8)


def _block_sparse_pack2(flat, budget_div: int = _BLOCK_BUDGET_DIV,
                        val_div: int = _VAL_BUDGET_DIV):
    """Two-tier device compaction: block-granular gather (tier 1) +
    within-block value compaction (tier 2).

    Returns (nblk, nval, n_esc, bitmap, bmask16, vals):
    - bitmap: 1 bit per 16-coeff block (any-nonzero), ceil(L/16)/8 bytes;
    - bmask16: per gathered block, its lane-occupancy mask (bit k =
      coeff k nonzero), fixed (NB//budget_div,) buffer — int32 here
      (values < 2**16; torch has no general uint16 arithmetic);
    - vals: the nonzero coeffs in (block, lane) order, int8-clipped,
      fixed (L//val_div,) buffer;
    - n_esc: COUNT of coeffs exceeding int8 (any escape forces the
      wave-wide dense fallback).
    The counts are 0-d int32 tensors. Caller falls back to a dense fetch
    iff they exceed their budgets (`block_sparse2_fits`).

    The reference scatters with mode="drop"; here every index past the
    buffer is clamped onto one dump slot that is sliced away, which is
    the same result without an out-of-range write."""
    L = flat.shape[0]
    NB = -(-L // _BLOCK)
    pad = NB * _BLOCK - L
    flat = flat.to(torch.int16)          # CAVLC levels fit int16
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    budget = NB // budget_div
    vbudget = L // val_div
    dev = flat.device
    blocks = flat.reshape(NB, _BLOCK)
    bmask = (blocks != 0).any(dim=1)
    bm32 = bmask.to(torch.int32)
    nblk = bm32.sum().to(torch.int32)
    pos = torch.cumsum(bm32, 0) - 1
    idx = torch.where(bmask, pos, budget).clamp(max=budget).to(torch.int64)
    blist = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    blist[idx] = torch.arange(NB, dtype=torch.int64, device=dev)
    blist = blist[:budget]
    gathered = blocks[blist]                                # (budget, 16)
    live = (torch.arange(budget, device=dev) < nblk)[:, None]
    gathered = torch.where(live, gathered, 0)
    bitmap = _bitmap(bmask)

    emask = gathered != 0                                   # (budget, 16)
    em32 = emask.to(torch.int32)
    bmask16 = (em32 * _tables(dev)["lanes"]).sum(dim=1).to(torch.int32)
    counts = em32.sum(dim=1).to(torch.int32)                # (budget,)
    offs = torch.cumsum(counts, 0) - counts
    within = torch.cumsum(em32, dim=1) - 1
    nval = counts.sum().to(torch.int32)
    vpos = torch.where(emask, offs[:, None] + within, vbudget)
    vpos = vpos.clamp(max=vbudget).to(torch.int64)
    clipped = torch.clamp(gathered, -_I8_MAX, _I8_MAX).to(torch.int8)
    vals = torch.zeros(vbudget + 1, dtype=torch.int8, device=dev)
    vals[vpos.reshape(-1)] = clipped.reshape(-1)
    vals = vals[:vbudget]
    n_esc = (torch.abs(gathered.to(torch.int32)) > _I8_MAX).sum().to(
        torch.int32)
    return (nblk, nval, n_esc, bitmap, bmask16, vals)


def block_sparse2_fits(nblk: int, nval: int, n_esc: int, L: int,
                       budget_div: int = _BLOCK_BUDGET_DIV,
                       val_div: int = _VAL_BUDGET_DIV) -> bool:
    return (int(nblk) <= (-(-L // _BLOCK)) // budget_div
            and int(nval) <= L // val_div
            and int(n_esc) == 0)


def _compact_stream(nblk, nval, bitmap, bmask16, vals):
    """Device-side stream compaction: concatenate the two-tier sparse
    streams into ONE dense uint8 payload per GOP.

    Layout (layout.split_compact is the host parser):

        [ bitmap (nb8 bytes) | bmask16 as little-endian byte pairs,
          first nblk live entries | vals, first nval entries ]

    The vals section lands RIGHT AFTER the live bmask16 entries, so the
    used prefix — ``used = nb8 + 2*nblk + nval`` bytes, returned
    alongside — is contiguous and the host fetches only that prefix.
    The write offset stays on the device (an index tensor, no host
    read); like the reference's dynamic_update_slice it is clamped so
    the vals section always fits the buffer.

    Returns (used int32, payload uint8[nb8 + 2*budget + vbudget])."""
    nb8 = bitmap.shape[0]
    budget = bmask16.shape[0]
    vb = vals.shape[0]
    dev = bitmap.device
    lo = (bmask16 & 0xFF).to(torch.uint8)
    hi = ((bmask16 >> 8) & 0xFF).to(torch.uint8)
    mb = torch.stack([lo, hi], dim=1).reshape(-1)           # (2*budget,)
    payload = torch.cat([bitmap, mb,
                         torch.zeros(vb, dtype=torch.uint8, device=dev)])
    # Live bmask16 entries occupy [nb8, nb8 + 2*nblk); the dead tail of
    # `mb` beyond that is all-zero (pack2 zeroes dead gathered rows), so
    # overwriting it with the vals stream loses nothing.
    start = torch.clamp(nb8 + 2 * nblk.to(torch.int64), max=nb8 + 2 * budget)
    payload[start + torch.arange(vb, device=dev)] = vals.view(torch.uint8)
    used = (nb8 + 2 * nblk + nval).to(torch.int32)
    return used, payload


# ---------------------------------------------------------------------------
# all-intra frames: flat levels, element-granular sparse transfer pack,
# host inverses and the frame encoder
# ---------------------------------------------------------------------------

def _flat_levels(y, u, v, qp: int, mbw: int, mbh: int, rd=RD_OFF):
    """One frame's intra levels as ONE flat int32 vector, layout
    [luma_dc | luma_ac | chroma_dc | chroma_ac], with the per-MB
    [mode16 | dqp16] side channel appended when rd.ships_modes (the
    reference's dispatch._flat_levels)."""
    return _flat_levels_batch(y[None], u[None], v[None], [qp], mbw, mbh,
                              rd)[0]


def _flat_levels_batch(ys, us, vs, qps, mbw: int, mbh: int, rd=RD_OFF):
    """:func:`_flat_levels` of B frames ys (B, H, W), each at its QP in
    `qps`, from one :func:`intra_core_frames` call: (B, L) int32."""
    out = intra_core_frames(ys, us, vs, qps, mbw=mbw, mbh=mbh, rd=rd)
    B = ys.shape[0]
    parts = [a.reshape(B, -1) for a in out[:4]]
    if rd.ships_modes:
        parts.append(_mode_tail(out[7], out[8], out[9]).to(torch.int32))
    return torch.cat(parts, dim=1)


def intra_flat_len(nmb: int, rd=RD_OFF) -> int:
    """Length of one frame's flat intra transfer vector."""
    return nmb * 384 + (2 * nmb if rd.ships_modes else 0)


# Sparse level-transfer budget: nonzero density above 1/div falls back
# to a dense fetch (typical all-intra density at qp 27 is ~10-15 %).
_SPARSE_BUDGET_DIV = 4
# Escape side-channel size: levels with |v| > 127 ride as (position,
# value) int32 pairs so vals stay int8.
_SPARSE_ESCAPES = 4096


def _sparse_pack(flat, budget_div: int = _SPARSE_BUDGET_DIV):
    """Compact a flat int32 level vector on device.

    Returns (nnz, n_esc, bitmap, vals, esc_pos, esc_val):
    - bitmap: 1 bit/coeff nonzero mask (big-endian within bytes, matching
      np.unpackbits), ceil(L/8) bytes;
    - vals: the nonzero levels in scan order, clipped to int8, in a fixed
      L // budget_div buffer;
    - esc_pos/esc_val: flat positions + true values of levels exceeding
      int8 (|v| > 127), in a fixed _SPARSE_ESCAPES buffer.
    The counts are 0-d int32 tensors. The caller falls back to a dense
    fetch iff nnz > budget or n_esc > _SPARSE_ESCAPES (`sparse_fits`).
    As in _block_sparse_pack2, the reference's mode="drop" scatters
    become clamps onto one dump slot that is sliced away."""
    L = flat.shape[0]
    budget = L // budget_div
    dev = flat.device
    flat = flat.to(torch.int32)
    mask = flat != 0
    m32 = mask.to(torch.int32)
    nnz = m32.sum().to(torch.int32)
    pos = torch.cumsum(m32, 0) - 1
    idx = torch.where(mask, pos, budget).clamp(max=budget).to(torch.int64)
    vals = torch.zeros(budget + 1, dtype=torch.int8, device=dev)
    vals[idx] = torch.clamp(flat, -_I8_MAX, _I8_MAX).to(torch.int8)
    bitmap = _bitmap(mask)
    esc = torch.abs(flat) > _I8_MAX
    e32 = esc.to(torch.int32)
    n_esc = e32.sum().to(torch.int32)
    epos = torch.cumsum(e32, 0) - 1
    eidx = torch.where(esc, epos, _SPARSE_ESCAPES).clamp(
        max=_SPARSE_ESCAPES).to(torch.int64)
    esc_pos = torch.zeros(_SPARSE_ESCAPES + 1, dtype=torch.int32,
                          device=dev)
    esc_pos[eidx] = torch.arange(L, dtype=torch.int32, device=dev)
    esc_val = torch.zeros(_SPARSE_ESCAPES + 1, dtype=torch.int32,
                          device=dev)
    esc_val[eidx] = flat
    return (nnz, n_esc, bitmap, vals[:budget], esc_pos[:_SPARSE_ESCAPES],
            esc_val[:_SPARSE_ESCAPES])


def sparse_fits(nnz: int, n_esc: int, L: int,
                budget_div: int = _SPARSE_BUDGET_DIV) -> bool:
    return (int(nnz) <= L // budget_div
            and int(n_esc) <= _SPARSE_ESCAPES)


def _sparse_unpack(nnz: int, n_esc: int, bitmap: np.ndarray,
                   vals: np.ndarray, esc_pos: np.ndarray,
                   esc_val: np.ndarray, L: int) -> np.ndarray:
    """Host inverse of _sparse_pack → flat int32 levels."""
    mask = np.unpackbits(bitmap)[:L].astype(bool)
    out = np.zeros(L, np.int32)
    out[mask] = vals[:nnz].astype(np.int32)
    if n_esc:
        out[esc_pos[:n_esc]] = esc_val[:n_esc]
    return out


def _unpack_levels(flat: np.ndarray, mbw: int, mbh: int,
                   rd=RD_OFF) -> FrameLevels:
    """Flat intra levels (host) → FrameLevels views: the mode raster
    and QP deltas from the shipped side channel when rd.ships_modes,
    the fixed raster otherwise. The transfer dtype is kept: int16 feeds
    the zero-copy native entry (cavlc_pack_islice16), int32 the
    original one."""
    nmb = mbw * mbh
    sizes = (nmb * 16, nmb * 16 * 15, nmb * 2 * 4, nmb * 2 * 4 * 15)
    offs = np.cumsum((0,) + sizes)
    flat = np.asarray(flat)
    if rd.ships_modes:
        mode16 = np.asarray(flat[offs[4]:offs[4] + nmb], np.int32)
        luma_mode = mode16 & 15
        chroma_mode = mode16 >> 4
        qp_delta = np.asarray(flat[offs[4] + nmb:offs[4] + 2 * nmb],
                              np.int32)
    else:
        luma_mode, chroma_mode = _mode_policy(mbw, mbh)
        qp_delta = None
    return FrameLevels(
        luma_mode=luma_mode,
        chroma_mode=chroma_mode,
        luma_dc=flat[offs[0]:offs[1]].reshape(nmb, 16),
        luma_ac=flat[offs[1]:offs[2]].reshape(nmb, 16, 15),
        chroma_dc=flat[offs[2]:offs[3]].reshape(nmb, 2, 4),
        chroma_ac=flat[offs[3]:offs[4]].reshape(nmb, 2, 4, 15),
        qp_delta=qp_delta,
    )


def encode_intra(y: np.ndarray, u: np.ndarray, v: np.ndarray, qp: int,
                 rd=RD_OFF, device="cuda") -> FrameLevels:
    """Run the intra compute on `device` and return host-side FrameLevels
    (the reference's encode_intra_jax): the sparse transfer, or the
    int16 dense fetch when the frame overflows its budgets."""
    dev = resolve_device(device)
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    yd, ud, vd = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in (y, u, v))
    L = intra_flat_len(mbw * mbh, rd)
    flat = _flat_levels(yd, ud, vd, int(qp), mbw, mbh, rd)
    nnz, n_esc, bitmap, vals, esc_pos, esc_val = (
        t.cpu().numpy() for t in _sparse_pack(flat))
    if sparse_fits(nnz, n_esc, L):
        return _unpack_levels(
            _sparse_unpack(int(nnz), int(n_esc), bitmap, vals,
                           esc_pos, esc_val, L), mbw, mbh, rd)
    # Rare (very dense content): fetch the levels wide, as int16.
    return _unpack_levels(flat.to(torch.int16).cpu().numpy(), mbw, mbh, rd)


def build_intra_encoder(y_shape: tuple[int, int], qp: int, rd=RD_OFF,
                        device="cuda"):
    """Encoder-facing factory: returns fn(y, u, v) -> FrameLevels."""
    dev = resolve_device(device)

    def fn(y, u, v):
        return encode_intra(y, u, v, qp, rd, device=dev)
    return fn
