"""PyTorch inter-frame (P) encode compute: residual transform/quant in
plane layout, closed-loop reconstruction, and the closed-GOP program.

- Motion estimation + compensation are one pass per frame
  (torchme.me_search: the CUDA kernel on the card, its plain version on
  the CPU); the kernel emits the prediction planes, so MC never runs as
  a separate pass. MVs are HALF-PEL units throughout.
- Residual DCT/quant/dequant/IDCT run in PLANE layout: 4x4 butterflies
  as strided slices along H then W of the full frame — no (n, 16, 4, 4)
  relayout in the hot loop, int16 storage.
- Frames chain through an explicit carry holding the recon planes and
  the previous frame's median MV (the temporal search centre).

The sequential P-slice entropy pack stays on the host:
codecs/h264/inter.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import torchme
from .torchcore import _intra_core, _tables, chroma_qp
from .transform import MF_TABLE, V_TABLE

SEARCH_RANGE = torchme.SEARCH_RANGE      # integer-pel, each direction


# ---------------------------------------------------------------------------
# plane-layout 4x4 transforms (applied to whole (H, W) planes via
# length-4 strided butterflies)
# ---------------------------------------------------------------------------

def _fwd4_axis0(x):
    """Forward core transform along H (rows of each 4x4 block)."""
    H, W = x.shape
    v = x.reshape(H // 4, 4, W)
    a, b, c, d = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    s0, s3 = a + d, a - d
    s1, s2 = b + c, b - c
    return torch.stack(
        [s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=1
    ).reshape(H, W)


def _fwd4_axis1(x):
    """Forward core transform along W (columns of each 4x4 block)."""
    H, W = x.shape
    v = x.reshape(H, W // 4, 4)
    a, b, c, d = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    s0, s3 = a + d, a - d
    s1, s2 = b + c, b - c
    return torch.stack(
        [s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-1
    ).reshape(H, W)


def _fwd4_plane(x):
    """W = CF @ x @ CF^T per 4x4 block, plane layout (H then W)."""
    return _fwd4_axis1(_fwd4_axis0(x))


def _inv4_axis1(d):
    H, W = d.shape
    v = d.reshape(H, W // 4, 4)
    d0, d1, d2, d3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3],
                       dim=-1).reshape(H, W)


def _inv4_axis0(f):
    H, W = f.shape
    v = f.reshape(H // 4, 4, W)
    g0, g1, g2, g3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    h0, h1 = g0 + g2, g0 - g2
    h2, h3 = (g1 >> 1) - g3, g1 + (g3 >> 1)
    return torch.stack([h0 + h3, h1 + h2, h1 - h2, h0 - h3],
                       dim=1).reshape(H, W)


def _inv4_plane(d):
    """Inverse core transform, plane layout (W then H — the stage order
    the >>1 rounding depends on)."""
    return _inv4_axis0(_inv4_axis1(d))


def _tile_plane(tbl, H, W):
    """Tile a (4, 4) per-coefficient table over an (H, W) plane."""
    return tbl.repeat(H // 4, W // 4)


def _quant_plane(w, mf_plane, qp: int):
    """Quantize an INTER coefficient plane with the f = (1 << qbits) / 6
    rounding bias (over-rounding inter residuals inflates levels and
    bitrate; the intra paths keep the standard 1/3)."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 6
    z = (torch.abs(w) * mf_plane + f) >> qbits
    return torch.where(w < 0, -z, z)


def _dequant_plane(z, v_plane, qp: int):
    return (z * v_plane) << (qp // 6)


@functools.lru_cache(maxsize=None)
def _dc_mask(H, W, device):
    """(H, W) int16 plane, 0 at every 4x4 block's DC position (cached:
    a host→device copy per frame would stall the stream)."""
    m = np.ones((4, 4), np.int16)
    m[0, 0] = 0
    return torch.as_tensor(np.tile(m, (H // 4, W // 4)), device=device)


def _dc_pos_expand(dcr_grid, h, wd_):
    """Place a (h/4, wd_/4) grid at the (0, 0) position of every 4x4
    block of an (h, wd_) zero plane — an outer-product broadcast, not a
    scatter."""
    m4 = torch.zeros((4, 4), dtype=dcr_grid.dtype, device=dcr_grid.device)
    m4[0, 0] = 1
    out = dcr_grid[:, None, :, None] * m4[None, :, None, :]
    return out.reshape(h, wd_)


# ---------------------------------------------------------------------------
# P-frame residual coding in plane layout
# ---------------------------------------------------------------------------

def _residual_p(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp: int,
                qpc: int, *, mbw: int, mbh: int):
    """Residual transform/quant/recon for one P frame given its
    prediction planes (RD off, plane layout). Per-MB local math only.

    Returns (luma_levels (H, W) int16, chroma_dc (2, nmb, 4) int16,
    chroma_ac (2, H/2, W/2) int16, recon_y, recon_u, recon_v int16)."""
    H, W = cy16.shape
    n = mbw * mbh
    dev = cy16.device
    tb = _tables(dev)
    mf_y = _tile_plane(tb["mf"][qp % 6], H, W)
    v_y = _tile_plane(tb["v"][qp % 6], H, W)
    mf_c = _tile_plane(tb["mf"][qpc % 6], H // 2, W // 2)
    v_c = _tile_plane(tb["v"][qpc % 6], H // 2, W // 2)

    # --- quantize: luma plane + both chroma planes -------------------
    resid = (cy16 - pred_y).to(torch.int32)
    w = _fwd4_plane(resid)
    z = _quant_plane(w, mf_y, qp)

    def chroma_quant(cplane16, pred):
        h, wd_ = cplane16.shape
        resid = (cplane16 - pred).to(torch.int32)
        wch = _fwd4_plane(resid)
        dc = wch[::4, ::4]                               # (2*mbh, 2*mbw)
        g = dc.reshape(mbh, 2, mbw, 2)
        a, b = g[:, 0, :, 0], g[:, 0, :, 1]
        c, dd = g[:, 1, :, 0], g[:, 1, :, 1]
        wd2 = torch.stack([a + b + c + dd, a - b + c - dd,
                           a + b - c - dd, a - b - c + dd], dim=-1)
        # chroma DC quant with the inter rounding bias
        qbits = 15 + qpc // 6
        f = (1 << qbits) // 6
        mf00 = int(MF_TABLE[qpc % 6, 0, 0])
        zdc = (torch.abs(wd2) * mf00 + 2 * f) >> (qbits + 1)
        zdc = torch.where(wd2 < 0, -zdc, zdc)            # (mbh, mbw, 4)
        # AC quant with DC positions zeroed
        zac = _quant_plane(wch, mf_c, qpc) * _dc_mask(h, wd_, dev)
        return zdc, zac

    u_zdc, u_zac = chroma_quant(cu16, pred_u)
    v_zdc, v_zac = chroma_quant(cv16, pred_v)

    # --- reconstruct from the levels ---------------------------------
    d = _dequant_plane(z, v_y, qp)
    recon_y = torch.clamp(((_inv4_plane(d) + 32) >> 6) + pred_y, 0, 255
                          ).to(torch.int16)
    luma_levels = z.to(torch.int16)                     # (H, W) coeff plane

    def chroma_recon(pred, zdc, zac):
        h, wd_ = pred.shape
        # recon: dequant AC, reinsert dequantized DC, inverse
        dac = _dequant_plane(zac, v_c, qpc)
        z00, z01 = zdc[..., 0], zdc[..., 1]
        z10, z11 = zdc[..., 2], zdc[..., 3]
        f00 = z00 + z01 + z10 + z11
        f01 = z00 - z01 + z10 - z11
        f10 = z00 + z01 - z10 - z11
        f11 = z00 - z01 - z10 + z11
        ls = int(V_TABLE[qpc % 6, 0, 0]) * 16
        fdc = torch.stack([torch.stack([f00, f01], -1),
                           torch.stack([f10, f11], -1)], -2)  # (mbh,mbw,2,2)
        dcr = ((fdc * ls) << (qpc // 6)) >> 5
        dcr_grid = dcr.permute(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
        # zac zeroes every DC position, so dequantized DC re-enters as
        # an add of an expanded grid — no scatter.
        dfull = dac + _dc_pos_expand(dcr_grid, h, wd_)
        rec = torch.clamp(((_inv4_plane(dfull) + 32) >> 6) + pred, 0, 255
                          ).to(torch.int16)
        return zdc.reshape(n, 4), zac.to(torch.int16), rec

    udc, uac, recon_u = chroma_recon(pred_u, u_zdc, u_zac)
    vdc, vac, recon_v = chroma_recon(pred_v, v_zdc, v_zac)
    chroma_dc = torch.stack([udc, vdc]).to(torch.int16)  # (2, n, 4)
    chroma_ac = torch.stack([uac, vac])                  # (2, H/2, W/2)
    return (luma_levels, chroma_dc, chroma_ac, recon_y, recon_u, recon_v)


def _encode_p_plane(cy, cu, cv, ry, ru, rv, pred_mv, qp: int, qpc: int, *,
                    mbw: int, mbh: int):
    """One P frame given the carry: the previous recon planes (int16)
    and `pred_mv`, the previous frame's median MV in half-pel units (a
    search centre). Every input is an explicit tensor, so a caller can
    feed any frame's carry.

    Returns (mv (nmb, 2) int32, luma plane, chroma_dc, chroma_ac,
    recon_y, recon_u, recon_v, med_mv (2,) int32)."""
    n = mbw * mbh
    cy16 = cy.to(torch.int16)
    cu16 = cu.to(torch.int16)
    cv16 = cv.to(torch.int16)
    mv, pred_y, pred_u, pred_v, med_mv = torchme.me_search(
        cy16, ry, ru, rv, pred_mv, qp)
    (luma_levels, chroma_dc, chroma_ac, recon_y, recon_u,
     recon_v) = _residual_p(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp,
                            qpc, mbw=mbw, mbh=mbh)
    return (mv.reshape(n, 2), luma_levels, chroma_dc, chroma_ac,
            recon_y, recon_u, recon_v, med_mv)


def _intra_frame_outputs(y, u, v, qp: int, *, mbw: int, mbh: int):
    """IDR half of the GOP program (RD off): intra core → the 4 blocked
    level arrays + the int16 recon carry."""
    out = _intra_core(y, u, v, qp, mbw=mbw, mbh=mbh)
    il_dc, il_ac, ic_dc, ic_ac, ry, ru, rv = out
    return ((il_dc, il_ac, ic_dc, ic_ac),
            (ry.to(torch.int16), ru.to(torch.int16), rv.to(torch.int16)))


def encode_gop_planes(ys, us, vs, qp: int, *, mbw: int, mbh: int,
                      emit_recon: bool = False):
    """Closed-GOP compute emitting PLANE-layout levels: frame 0 intra,
    frames 1..F-1 inter (P). ys: (F, H, W) uint8 (us/vs the chroma
    halves). Returns (mv (F-1, nmb, 2) int8, flat int16); with
    `emit_recon` also the per-frame reconstructed planes (recon_y,
    recon_u, recon_v), each (F, H, W) int32 (quality measurements).

    flat layout (all reshape(-1)):
      [ intra il_dc | il_ac | ic_dc | ic_ac          (nmb * 384)
      | luma coeff planes   (F-1, H, W)
      | u DC (F-1, nmb, 4) | v DC (F-1, nmb, 4)
      | u AC plane (F-1, H/2, W/2) | v AC plane (F-1, H/2, W/2) ]

    The host inverse is layout.unflatten_gop."""
    # The int8 MV transfer rides on search candidates being bounded by
    # construction: |mv| <= 2 * SEARCH_RANGE half-pel units per frame.
    if 2 * SEARCH_RANGE > 127:
        raise ValueError("SEARCH_RANGE exceeds the int8 MV transfer")
    qp = int(qp)
    qpc = chroma_qp(qp)
    intra, (ry, ru, rv) = _intra_frame_outputs(
        ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh)
    pred_mv = torch.zeros(2, dtype=torch.int32, device=ys.device)
    mvs, lps, cdcs, cacs = [], [], [], []
    recons = [(ry, ru, rv)]
    for i in range(1, ys.shape[0]):
        (mv, lp, cdc, cac, ry, ru, rv, pred_mv) = _encode_p_plane(
            ys[i], us[i], vs[i], ry, ru, rv, pred_mv, qp, qpc, mbw=mbw,
            mbh=mbh)
        if emit_recon:
            recons.append((ry, ru, rv))
        mvs.append(mv.to(torch.int8))
        lps.append(lp)
        cdcs.append(cdc)
        cacs.append(cac)
    if mvs:
        mv8 = torch.stack(mvs)
        cdcs = torch.stack(cdcs)                         # (F-1, 2, n, 4)
        cacs = torch.stack(cacs)                         # (F-1, 2, H/2, W/2)
        p_parts = [torch.stack(lps).reshape(-1),
                   cdcs[:, 0].reshape(-1), cdcs[:, 1].reshape(-1),
                   cacs[:, 0].reshape(-1), cacs[:, 1].reshape(-1)]
    else:
        mv8 = torch.zeros((0, mbw * mbh, 2), dtype=torch.int8,
                          device=ys.device)
        p_parts = []
    parts = [a.reshape(-1).to(torch.int16) for a in intra] + p_parts
    if emit_recon:
        recon = tuple(torch.stack(planes).to(torch.int32)
                      for planes in zip(*recons))
        return mv8, torch.cat(parts), recon
    return mv8, torch.cat(parts)
