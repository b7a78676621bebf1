"""PyTorch inter-frame (P) encode compute: residual transform/quant in
plane layout, closed-loop reconstruction, and the closed-GOP program.

- Motion estimation + compensation are one pass per frame
  (torchme.me_search: the CUDA kernel on the card, its plain version on
  the CPU); the kernel emits the prediction planes, so MC never runs as
  a separate pass. MVs are HALF-PEL units throughout.
- Residual DCT/quant/dequant/IDCT run in PLANE layout, int16 storage:
  on the card as one hand kernel a frame or band stack
  (csrc/p_residual.cu, torchresid), on the CPU as its plain version,
  4x4 butterflies as strided slices along H then W of the full frame.
- Frames chain through an explicit carry holding the recon planes and
  the previous frame's median MV (the temporal search centre).
- The RD features ride the same steps: the P_Skip bias in
  `_residual_p`, the §8.7 in-loop filter (torchdeblock) on the recon
  carried between frames, and the IDR's mode/QP side channel at the
  tail of the GOP's flat vector.

The sequential P-slice entropy pack stays on the host:
codecs/h264/inter.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import rdo, torchme, torchresid
from .rdo import RD_OFF
from .torchcore import (_intra_core, _mode_tail, _tables, chroma_qp,
                        intra_core_frames)
from .torchdeblock import deblock_frame_torch, nz4_from_luma_plane
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
    block of an (h, wd_) zero plane: a strided copy into the zero plane,
    on the card (a Python number stored into a one-element view would be
    a synchronous host→device copy)."""
    out = torch.zeros((h // 4, 4, wd_ // 4, 4), dtype=dcr_grid.dtype,
                      device=dcr_grid.device)
    out[:, 0, :, 0] = dcr_grid
    return out.reshape(h, wd_)


# ---------------------------------------------------------------------------
# P-frame residual coding in plane layout
# ---------------------------------------------------------------------------

def _residual_p(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp: int,
                qpc: int, *, mbw: int, mbh: int, rd=RD_OFF):
    """Residual transform/quant/recon for one P frame given its
    prediction planes: :func:`residual_p_ref`'s function and outputs.
    CUDA tensors go through the hand kernel (torchresid.residual_p_cuda,
    one launch a frame or band stack), CPU tensors through the plain
    version."""
    if cy16.device.type == "cuda":
        return torchresid.residual_p_cuda(
            *(t.contiguous() for t in (cy16, cu16, cv16, pred_y, pred_u,
                                       pred_v)),
            qp, qpc, mbw=mbw, mbh=mbh, pskip=rd.pskip, nz4=rd.deblock)
    return residual_p_ref(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp,
                          qpc, mbw=mbw, mbh=mbh, rd=rd)


def residual_p_ref(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp: int,
                   qpc: int, *, mbw: int, mbh: int, rd=RD_OFF):
    """Residual transform/quant/recon for one P frame given its
    prediction planes (plane layout). Per-MB local math only: the plain
    version of csrc/p_residual.cu's kernel, held to it bit for bit.

    With ``rd.pskip`` an MB whose quantized residual is negligible
    (sum |level| <= rdo.PSKIP_SUM across all planes, every |level| <=
    1) drops the residual entirely: its recon becomes pure prediction
    — exactly what a decoder reconstructs for a P_Skip MB — and the
    entropy packer's §8.4.1.1 inference turns it into a skip run
    whenever its MV matches the skip predictor.

    Returns (luma_levels (H, W) int16, chroma_dc (2, nmb, 4) int16,
    chroma_ac (2, H/2, W/2) int16, recon_y, recon_u, recon_v int16,
    nz4): nz4 is the (4·mbh, 4·mbw) any-nonzero map of the FINAL luma
    levels (the deblocking filter's bS=2 input) with ``rd.deblock``,
    None otherwise (nothing reads it, so the RD-off step does not
    compute it)."""
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

    if rd.pskip:
        # P_Skip bias: per-MB level mass across every plane
        az = torch.abs(z.reshape(mbh, 16, mbw, 16))

        def cmass(zac):
            c = torch.abs(zac.reshape(mbh, 8, mbw, 8))
            return c.sum(dim=(1, 3)), c.amax(dim=(1, 3))
        us, umx = cmass(u_zac)
        vs, vmx = cmass(v_zac)
        mb_sum = (az.sum(dim=(1, 3)) + us + vs
                  + torch.abs(u_zdc).sum(dim=-1)
                  + torch.abs(v_zdc).sum(dim=-1))
        mb_max = torch.maximum(
            torch.maximum(az.amax(dim=(1, 3)), torch.maximum(umx, vmx)),
            torch.maximum(torch.abs(u_zdc).amax(dim=-1),
                          torch.abs(v_zdc).amax(dim=-1)))
        drop = (mb_sum <= rdo.PSKIP_SUM) & (mb_max <= 1)   # (mbh, mbw)
        keep_y = ~torch.repeat_interleave(
            torch.repeat_interleave(drop, 16, dim=0), 16, dim=1)
        keep_c = ~torch.repeat_interleave(
            torch.repeat_interleave(drop, 8, dim=0), 8, dim=1)
        z = torch.where(keep_y, z, 0)
        u_zac = torch.where(keep_c, u_zac, 0)
        v_zac = torch.where(keep_c, v_zac, 0)
        u_zdc = torch.where(drop[..., None], 0, u_zdc)
        v_zdc = torch.where(drop[..., None], 0, v_zdc)

    nz4 = nz4_from_luma_plane(z, mbh, mbw) if rd.deblock else None

    # --- reconstruct from the (possibly zeroed) levels ---------------
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
    return (luma_levels, chroma_dc, chroma_ac, recon_y, recon_u, recon_v,
            nz4)


def _encode_p_plane(cy, cu, cv, ry, ru, rv, pred_mv, qp: int, qpc: int, *,
                    mbw: int, mbh: int, rd=RD_OFF):
    """One P frame given the carry: the previous recon planes (int16)
    and `pred_mv`, the previous frame's median MV in half-pel units (a
    search centre). Every input is an explicit tensor, so a caller can
    feed any frame's carry. With ``rd.deblock`` the returned recon is
    the §8.7-filtered plane (bS from the final levels and the search's
    MVs), the one the next frame predicts from.

    Returns (mv (nmb, 2) int32, luma plane, chroma_dc, chroma_ac,
    recon_y, recon_u, recon_v, med_mv (2,) int32)."""
    n = mbw * mbh
    cy16 = cy.to(torch.int16)
    cu16 = cu.to(torch.int16)
    cv16 = cv.to(torch.int16)
    mv, pred_y, pred_u, pred_v, med_mv = torchme.me_search(
        cy16, ry, ru, rv, pred_mv, qp)
    (luma_levels, chroma_dc, chroma_ac, recon_y, recon_u, recon_v,
     nz4) = _residual_p(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp, qpc,
                        mbw=mbw, mbh=mbh, rd=rd)
    if rd.deblock:
        qp_map = torch.full((mbh, mbw), qp, dtype=torch.int32,
                            device=cy.device)
        recon_y, recon_u, recon_v = deblock_frame_torch(
            recon_y, recon_u, recon_v, qp_map, intra=False, nz4=nz4,
            mv=mv)
    return (mv.reshape(n, 2), luma_levels, chroma_dc, chroma_ac,
            recon_y, recon_u, recon_v, med_mv)


def _intra_frame_outputs(y, u, v, qp: int, *, mbw: int, mbh: int,
                         rd=RD_OFF):
    """IDR half of the GOP program: intra core + (with rd.deblock) the
    filtered recon carry + the pack-facing intra tuple (4 blocked
    arrays, or 6 with the per-MB [mode16 | dqp16] side channel when
    rd.ships_modes)."""
    out = _intra_core(y, u, v, qp, mbw=mbw, mbh=mbh, rd=rd)
    il_dc, il_ac, ic_dc, ic_ac, ry, ru, rv = out[:7]
    luma_mode, chroma_mode, qp_delta = out[7:]
    ry = ry.to(torch.int16)
    ru = ru.to(torch.int16)
    rv = rv.to(torch.int16)
    if rd.deblock:
        qp_map = (int(qp) + qp_delta).reshape(mbh, mbw)
        ry, ru, rv = deblock_frame_torch(ry, ru, rv, qp_map, intra=True)
    if rd.ships_modes:
        tail = _mode_tail(luma_mode, chroma_mode, qp_delta)
        intra = (il_dc, il_ac, ic_dc, ic_ac,
                 tail[:mbw * mbh], tail[mbw * mbh:])
    else:
        intra = (il_dc, il_ac, ic_dc, ic_ac)
    return intra, (ry, ru, rv)


def encode_gop_planes(ys, us, vs, qp: int, *, mbw: int, mbh: int,
                      emit_recon: bool = False, rd=RD_OFF):
    """Closed-GOP compute emitting PLANE-layout levels: frame 0 intra,
    frames 1..F-1 inter (P). ys: (F, H, W) uint8 (us/vs the chroma
    halves). Returns (mv (F-1, nmb, 2) int8, flat int16); with
    `emit_recon` also the per-frame reconstructed planes (recon_y,
    recon_u, recon_v), each (F, H, W) int32 (quality measurements).
    With rd.deblock the recon chained between frames (and emitted) is
    the §8.7-filtered plane — exactly what a conformant decoder holds.

    flat layout (all reshape(-1)):
      [ intra il_dc | il_ac | ic_dc | ic_ac          (nmb * 384)
      | luma coeff planes   (F-1, H, W)
      | u DC (F-1, nmb, 4) | v DC (F-1, nmb, 4)
      | u AC plane (F-1, H/2, W/2) | v AC plane (F-1, H/2, W/2)
      | intra mode16 (nmb) | intra dqp16 (nmb)   — rd.ships_modes only ]

    The host inverse is layout.unflatten_gop."""
    # The int8 MV transfer rides on search candidates being bounded by
    # construction: |mv| <= 2 * SEARCH_RANGE half-pel units per frame.
    if 2 * SEARCH_RANGE > 127:
        raise ValueError("SEARCH_RANGE exceeds the int8 MV transfer")
    qp = int(qp)
    qpc = chroma_qp(qp)
    intra, (ry, ru, rv) = _intra_frame_outputs(
        ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh, rd=rd)
    pred_mv = torch.zeros(2, dtype=torch.int32, device=ys.device)
    mvs, lps, cdcs, cacs = [], [], [], []
    recons = [(ry, ru, rv)]
    for i in range(1, ys.shape[0]):
        (mv, lp, cdc, cac, ry, ru, rv, pred_mv) = _encode_p_plane(
            ys[i], us[i], vs[i], ry, ru, rv, pred_mv, qp, qpc, mbw=mbw,
            mbh=mbh, rd=rd)
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
    parts = ([a.reshape(-1).to(torch.int16) for a in intra[:4]] + p_parts
             + list(intra[4:]))
    if emit_recon:
        recon = tuple(torch.stack(planes).to(torch.int32)
                      for planes in zip(*recons))
        return mv8, torch.cat(parts), recon
    return mv8, torch.cat(parts)


# ---------------------------------------------------------------------------
# split-frame encoding (SFE): per-FRAME step cores over a band stack
#
# The GOP program above runs a whole GOP per call; the SFE path instead
# steps ONE frame at a time so the per-frame glass-to-bitstream latency
# is a single step + band fetch + band-slice pack
# (parallel/dispatch.SfeShardEncoder). A frame's B MB-row bands sit on
# one card as a (B, Hb, W) stack; every band is its own slice. Only
# MB-local work runs as one call over the stack (the search on its
# halo-extended planes, the residual's transform, quant and recon); the
# intra core restarts its slice-local first row per band, and the
# in-loop filter runs per band on its one-MB-row halo. The recon carry
# chains between steps on the device.
# ---------------------------------------------------------------------------


def sfe_deblock_edges(ry, ru, rv, nz4=None, mv=None, *, mbw: int,
                      mbh_band: int):
    """A run of bands' first and last MB rows of deblock input, as the
    runs above and below it read them for their halo: 16 luma / 8
    chroma recon rows, and for a P frame (`nz4`, `mv` given) the 4 rows
    of the 4x4 nz map and the MV row. Returns (top, bottom) dicts."""
    B = ry.shape[0]
    top = {"y": ry[0, :16], "u": ru[0, :8], "v": rv[0, :8]}
    bot = {"y": ry[-1, -16:], "u": ru[-1, -8:], "v": rv[-1, -8:]}
    if nz4 is not None:
        mvr = mv.reshape(B, mbh_band, 2 * mbw)
        top.update(nz=nz4[0, :4], mv=mvr[0, :1])
        bot.update(nz=nz4[-1, -4:], mv=mvr[-1, -1:])
    return top, bot


def _deblock_band(ry, ru, rv, qp: int, *, intra: bool, nz4, mv, mbw: int,
                  mbh_band: int, total_mb_rows: int, band0: int = 0,
                  above=None, below=None):
    """Deblock a band stack's recon with a ONE-MB-ROW cross-band halo.

    The §8.7 filter's vertical passes are row-local, and its horizontal
    passes read/write at most 4 rows across an MB edge — so extending
    each band by 16 raw recon rows of its neighbours (plus the
    neighbour MB row's bS metadata: nz map and MVs; QP is flat in SFE)
    and running the full shifted-plane schedule on the extended planes
    reproduces the FULL-FRAME filter exactly: halo rows V-filter to the
    same values the neighbour band computes for its own rows, the
    boundary H edge is computed identically on both sides, and each
    band's slice backs out byte-identical to the unbanded program.
    Frame edges and the last band's padding rows are masked via the
    global (mb_row0, total_mb_rows) coordinates of each band.

    A mesh entry's run of bands (`band0` = the global index of its first
    band) gets the rows beyond its run from the runs beside it: `above`
    is the bottom edge of the run above, `below` the top edge of the run
    below (:func:`sfe_deblock_edges`; None at a frame edge)."""
    B = ry.shape[0]

    def ext(stack, halo, key):
        return torchme.band_halo_exchange(
            stack, halo, None if above is None else above[key],
            None if below is None else below[key], above is None,
            below is None)

    ry_e = ext(ry, 16, "y")
    ru_e = ext(ru, 8, "u")
    rv_e = ext(rv, 8, "v")
    qp_map = torch.full((mbh_band + 2, mbw), int(qp), dtype=torch.int32,
                        device=ry.device)
    nz_e = mv_e = None
    if not intra:
        nz_e = ext(nz4.to(torch.int16), 4, "nz") != 0
        mv_e = ext(mv.reshape(B, mbh_band, 2 * mbw), 1, "mv").reshape(
            B, mbh_band + 2, mbw, 2)
    outs = []
    for b in range(B):
        y2, u2, v2 = deblock_frame_torch(
            ry_e[b], ru_e[b], rv_e[b], qp_map, intra=intra,
            nz4=None if intra else nz_e[b], mv=None if intra else mv_e[b],
            mb_row0=(band0 + b) * mbh_band - 1,  # extended: 1 MB row above
            total_mb_rows=total_mb_rows)
        outs.append((y2[16:16 + 16 * mbh_band], u2[8:8 + 8 * mbh_band],
                     v2[8:8 + 8 * mbh_band]))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def sfe_deblock(ry, ru, rv, qp: int, real_rows, *, nz4=None, mv=None,
                mbw: int, mbh_band: int, total_mb_rows: int, band0: int = 0,
                above=None, below=None):
    """The in-loop filter of a run of bands whose step was told to
    `defer_deblock`: :func:`_deblock_band` (an IDR frame when `nz4` is
    None) and the recon fixup, on the unfiltered carry."""
    return _fixup_carry(*_deblock_band(
        ry, ru, rv, qp, intra=nz4 is None, nz4=nz4, mv=mv, mbw=mbw,
        mbh_band=mbh_band, total_mb_rows=total_mb_rows, band0=band0,
        above=above, below=below), real_rows)


def _fixup_band_recon(stack, real_rows, scale: int = 1):
    """Maintain the SFE recon invariant on a band stack: rows at/past a
    band's real content (the last band's MB padding) are the
    edge-replication of its last REAL row. The full-frame search pads
    its reference with edge replication below the frame; without this
    fixup the padding rows would instead hold the recon of replicated
    SOURCE rows — close, but not the bits the full-frame program (or a
    conformant decoder's edge clamp) sees. `real_rows`: pixel rows per
    band (host ints), counted in units of `scale` rows."""
    H = stack.shape[1]
    reals = [max(int(r) // scale, 1) for r in real_rows]
    if all(r >= H for r in reals):
        return stack
    out = stack.clone()
    for b, r in enumerate(reals):
        if r < H:
            out[b, r:] = stack[b, r - 1:r]
    return out


def _fixup_carry(ry, ru, rv, real_rows):
    return (_fixup_band_recon(ry, real_rows),
            _fixup_band_recon(ru, real_rows, 2),
            _fixup_band_recon(rv, real_rows, 2))


def _sfe_intra_common(ys, us, vs, qp: int, real_rows, *, mbw: int,
                      mbh_band: int, rd, total_mb_rows: int,
                      defer_deblock: bool = False):
    """Shared intra compute of a band stack: the slice-local core per
    band + recon fixup + (with rd.deblock, unless `defer_deblock` leaves
    it to :func:`sfe_deblock`) the cross-band-halo in-loop filter on the
    carry. Returns (the core's ten outputs with a leading band
    dimension, (ry, ru, rv, zero_mv)): every band in ONE batched core
    (intra_core_frames; the hand kernels' two launches on the card with
    mode decision off), all bands at `qp`."""
    outs = intra_core_frames(ys, us, vs, [qp] * ys.shape[0], mbw=mbw,
                             mbh=mbh_band, rd=rd)
    ry, ru, rv = (o.to(torch.int16) for o in outs[4:7])
    ry, ru, rv = _fixup_carry(ry, ru, rv, real_rows)
    if rd.deblock and not defer_deblock:
        # SFE runs AQ-free (enforced at encoder construction), so the
        # band qp map is flat and no qp metadata crosses bands
        ry, ru, rv = sfe_deblock(ry, ru, rv, qp, real_rows, mbw=mbw,
                                 mbh_band=mbh_band,
                                 total_mb_rows=total_mb_rows)
    zero_mv = torch.zeros(2, dtype=torch.int32, device=ys.device)
    return outs, (ry, ru, rv, zero_mv)


def sfe_intra_band(ys, us, vs, qp: int, real_rows, *, mbw: int,
                   mbh_band: int, rd=RD_OFF, total_mb_rows: int = 0,
                   defer_deblock: bool = False):
    """The IDR step of a band stack: slice-local intra prediction — each
    band's first MB row predicts like a frame's row 0 because the MBs
    above live in ANOTHER slice and are unavailable to intra prediction
    (§8.3: exactly what a conformant decoder reconstructs), so no
    cross-band exchange is needed on intra frames (the in-loop filter,
    when enabled, is the one cross-band consumer — _deblock_band).

    Returns (dense (B, Ld), rest (B, Lr), (ry, ru, rv, pred_mv)): dense
    is each band's hadamard-DC prefix [il_dc | ic_dc] shipped
    uncompressed (the only levels that exceed int8 at practical QPs)
    plus, when rd.ships_modes, the per-MB [mode16 | dqp16] side channel;
    rest is [il_ac | ic_ac] for the sparse transfer, and the carry
    holds the fixed-up recon stack + a zero median MV (each GOP's
    temporal predictor restarts at its IDR)."""
    outs, carry = _sfe_intra_common(
        ys, us, vs, int(qp), real_rows, mbw=mbw, mbh_band=mbh_band, rd=rd,
        total_mb_rows=total_mb_rows, defer_deblock=defer_deblock)
    B = ys.shape[0]
    il_dc, il_ac, ic_dc, ic_ac = (o.reshape(B, -1).to(torch.int16)
                                  for o in outs[:4])
    dense = [il_dc, ic_dc]
    if rd.ships_modes:
        dense.append(_mode_tail(*outs[7:]))
    return (torch.cat(dense, dim=1), torch.cat([il_ac, ic_ac], dim=1),
            carry)


def sfe_intra_band_dense(ys, us, vs, qp: int, real_rows, *, mbw: int,
                         mbh_band: int, rd=RD_OFF, total_mb_rows: int = 0,
                         defer_deblock: bool = False):
    """Dense-transfer variant of :func:`sfe_intra_band`: one flat int16
    vector per band in the standard intra layout (layout.unflatten_intra's
    inverse, mode/dqp tail appended when rd.ships_modes) — the escape
    fallback path. Returns ((B, L), carry)."""
    outs, carry = _sfe_intra_common(
        ys, us, vs, int(qp), real_rows, mbw=mbw, mbh_band=mbh_band, rd=rd,
        total_mb_rows=total_mb_rows, defer_deblock=defer_deblock)
    B = ys.shape[0]
    parts = [a.reshape(B, -1).to(torch.int16) for a in outs[:4]]
    if rd.ships_modes:
        parts.append(_mode_tail(*outs[7:]))
    return torch.cat(parts, dim=1), carry


def sfe_p_band(ys, us, vs, carry, qp: int, real_rows, *, mbw: int,
               mbh_band: int, halo_rows: int, ext=None,
               edge_top: bool = True, edge_bot: bool = True, probe=None,
               return_hist: bool = False, rd=RD_OFF,
               total_mb_rows: int = 0, defer_deblock: bool = False):
    """The P step of a band stack: the banded motion search (halo
    exchange + band-summed global centers/median,
    torchme.me_search_banded) + the shared residual core over the whole
    stack at once (per-MB math, so the bands stacked as one tall plane
    give each band's own levels and recon), emitting PLANE-layout levels
    for the per-frame sparse transfer.

    Returns (mv8 (B, nmb_b, 2) int8, flat (B, L) int16 [luma plane | u
    dc | v dc | u ac | v ac] — per band a single-frame slice of
    encode_gop_planes' P layout, so layout.unflatten_p_planes(flat[b],
    mv8[b], 2, ...) is the host inverse), plus the chained (ry, ru, rv,
    med_mv) carry.

    Farm mode (a band slice of a cross-host layout, parallel/sfefarm.py):
    `ext` / `edge_top` / `edge_bot` inject the cross-HOST neighbour
    reference rows, `probe` the host-resolved global probe center, and
    `return_hist=True` returns the slice's histogram partial instead of
    the median (the host finishes it across the slices and feeds it back
    as the next frame's `pred_mv`): the tail is then (cnt, n, (ry, ru,
    rv, pred_mv)).

    A mesh entry's run of bands takes the same inputs from the entries
    beside it. Its in-loop filter needs the runs beside it too:
    `defer_deblock` leaves the carry unfiltered and appends the filter's
    (nz4, mv) to it, for :func:`sfe_deblock`."""
    if 2 * SEARCH_RANGE > 127:
        raise ValueError("SEARCH_RANGE exceeds the int8 MV transfer")
    if rd.deblock and not defer_deblock and (
            ext is not None or probe is not None or return_hist):
        # Farm band slices exchange halos over the host relay once per
        # frame; the in-loop filter would need a second (post-recon)
        # relay round. The remote planner falls back to GOP-range
        # shards for deblock-enabled jobs instead.
        raise ValueError("deblock is not supported on cross-host band "
                         "slices; use GOP sharding for this job")
    ry, ru, rv, pred_mv = carry
    qp = int(qp)
    qpc = chroma_qp(qp)
    B, Hb, W = ys.shape
    cy16 = ys.to(torch.int16)
    cu16 = us.to(torch.int16)
    cv16 = vs.to(torch.int16)
    out = torchme.me_search_banded(
        cy16, ry, ru, rv, pred_mv, qp, halo_rows=halo_rows,
        real_rows=real_rows, ext=ext, edge_top=edge_top,
        edge_bot=edge_bot, probe=probe, return_hist=return_hist)
    mv, py, pu, pv = out[:4]
    nmb = mbw * mbh_band
    (lp, cdc, cac, ry2, ru2, rv2, nz4) = _residual_p(
        cy16.reshape(B * Hb, W), cu16.reshape(B * Hb // 2, W // 2),
        cv16.reshape(B * Hb // 2, W // 2), py.reshape(B * Hb, W),
        pu.reshape(B * Hb // 2, W // 2), pv.reshape(B * Hb // 2, W // 2),
        qp, qpc, mbw=mbw, mbh=B * mbh_band, rd=rd)
    ry2, ru2, rv2 = _fixup_carry(ry2.reshape(B, Hb, W),
                                 ru2.reshape(B, Hb // 2, W // 2),
                                 rv2.reshape(B, Hb // 2, W // 2), real_rows)
    db_in = ()
    if rd.deblock:
        nz4 = nz4.reshape(B, 4 * mbh_band, 4 * mbw)
        if defer_deblock:
            db_in = (nz4, mv)
        else:
            ry2, ru2, rv2 = sfe_deblock(
                ry2, ru2, rv2, qp, real_rows, nz4=nz4, mv=mv, mbw=mbw,
                mbh_band=mbh_band, total_mb_rows=total_mb_rows)
    cdc = cdc.reshape(2, B, nmb * 4)
    cac = cac.reshape(2, B, -1)
    flat = torch.cat([lp.reshape(B, -1), cdc[0], cdc[1], cac[0], cac[1]],
                     dim=1)
    mv8 = mv.reshape(B, nmb, 2).to(torch.int8)
    if return_hist:
        # the host owns the median in farm mode: carry the INPUT pred
        # (ignored — the next step receives the cross-host median as a
        # fresh input) so the carry shape matches the local chain's
        cnt, n = out[4:]
        return mv8, flat, cnt, n, (ry2, ru2, rv2, pred_mv) + db_in
    return mv8, flat, (ry2, ru2, rv2, out[4]) + db_in
