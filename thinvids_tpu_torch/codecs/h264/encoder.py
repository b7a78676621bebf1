"""H.264 encoder: the codec surface and its host half.

The per-frame COMPUTE (prediction, forward transform, quantization,
closed-loop reconstruction) runs on the device (torchcore.py,
torchinter.py); this module is the sequential entropy PACK that turns
level arrays into conformant Annex-B slices on the host, the per-GOP
slice-thunk plumbing the dispatcher fans across its pack pool, and the
user-facing encoders: `H264Encoder` / `encode_frames` (all-intra, every
frame IDR) and `encode_gop` (one closed GOP, IDR + P). They take
``device="cuda"`` by default.

The intra compute also has a numpy specification here,
`encode_frame_arrays`: a per-MB loop over the spec's integer transforms
(transform.py, intra.py) that shares no code with the batched device
program and must match it bit-exactly. ``H264Encoder(...,
use_device=False)`` and ``encode_frames(..., use_device=False)`` run it
instead of the device (the reference's ``use_jax=False``): that path
imports no torch and resolves no device, and `device` is then ignored.

Device code is imported inside the functions that run it, so the pack
sidecars (parallel/packproc.py) and the numpy path import this module
without torch.

Mode policy (keeps macroblock rows data-parallel on the device):
- MB (0,0): DC prediction (no neighbors);
- row 0, col > 0: horizontal (left-only dependency);
- rows >= 1: vertical (depends only on the reconstructed row above).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ...core.types import Frame, VideoMeta, is_yuv420
from ...io.bits import BitWriter, annexb_nal
from . import cavlc
from .headers import (
    NAL_SLICE_IDR,
    PPS,
    SLICE_TYPE_I,
    SPS,
    SliceHeader,
)
from .intra import (
    CHROMA_BLOCK_ORDER,
    CHROMA_DC,
    CHROMA_H,
    CHROMA_V,
    LUMA_BLOCK_ORDER,
    LUMA_DC,
    LUMA_H,
    LUMA_V,
    predict_chroma8,
    predict_luma16,
    reconstruct_chroma8,
    reconstruct_luma16,
)
from .transform import (
    chroma_dc_forward,
    chroma_dc_quant,
    chroma_qp,
    forward_4x4,
    luma_dc_forward,
    luma_dc_quant,
    quant_4x4,
    zigzag,
)


@dataclasses.dataclass
class FrameLevels:
    """Quantized level arrays for one frame, MB raster order (nmb = mbw*mbh).

    This is the compute→pack interface. All zig-zag ordered as the packer
    expects. Level arrays may be int32 or int16 (CAVLC levels fit int16
    at every legal QP; the transfer paths hand the packer int16 views and
    the native layer packs them without a widening copy).
    """

    luma_mode: np.ndarray    # (nmb,) int32
    chroma_mode: np.ndarray  # (nmb,) int32
    luma_dc: np.ndarray      # (nmb, 16)
    luma_ac: np.ndarray      # (nmb, 16, 15), z-scan block order
    chroma_dc: np.ndarray    # (nmb, 2, 4), raster DC order (Cb, Cr)
    chroma_ac: np.ndarray    # (nmb, 2, 4, 15)
    #: per-MB qp - slice qp (perceptual AQ; None = flat QP, the
    #: historical layout). Packers emit it as mb_qp_delta.
    qp_delta: np.ndarray | None = None


def _mode_policy(mbw: int, mbh: int) -> tuple[np.ndarray, np.ndarray]:
    """The FIXED mode raster (rd.mode_decision off): rows >= 1
    vertical, row 0 horizontal with DC at the slice corner."""
    luma = np.full((mbh, mbw), LUMA_V, np.int32)
    luma[0, :] = LUMA_H
    luma[0, 0] = LUMA_DC
    chroma = np.full((mbh, mbw), CHROMA_V, np.int32)
    chroma[0, :] = CHROMA_H
    chroma[0, 0] = CHROMA_DC
    return luma.reshape(-1), chroma.reshape(-1)


def _greedy_allowed_np(desired: np.ndarray) -> np.ndarray:
    """Sequential mirror of torchcore._greedy_allowed: allowed[c] =
    desired[c] & !allowed[c-1]."""
    allowed = np.zeros_like(desired)
    prev = False
    for c in range(len(desired)):
        allowed[c] = bool(desired[c]) and not prev
        prev = allowed[c]
    return allowed


def _encode_luma_mb_np(src, pred, qp: int):
    """One MB's luma transform/quant/recon at `qp` → (dc_lev (16,),
    ac_lev (16, 15), recon (16, 16) uint8)."""
    resid = src.astype(np.int32) - pred.astype(np.int32)
    blocks = np.stack([
        resid[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        for bx, by in LUMA_BLOCK_ORDER
    ])                                             # (16,4,4) z-scan
    w = forward_4x4(blocks)
    dc_spatial = np.zeros((4, 4), np.int32)
    for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
        dc_spatial[by, bx] = w[bi, 0, 0]
    wd = luma_dc_forward(dc_spatial)
    dc_lev = zigzag(luma_dc_quant(wd, qp))
    z = quant_4x4(w, qp, intra=True, skip_dc=True)
    ac_lev = zigzag(z)[:, 1:]
    return dc_lev, ac_lev, reconstruct_luma16(pred, dc_lev, ac_lev, qp)


def _encode_chroma_mb_np(csrc, cpred, qpc: int):
    """One MB's single-plane chroma encode → (dc_lev (4,), ac_lev
    (4, 15), recon (8, 8) uint8)."""
    cres = csrc.astype(np.int32) - cpred.astype(np.int32)
    cblocks = np.stack([
        cres[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        for bx, by in CHROMA_BLOCK_ORDER
    ])                                             # (4,4,4)
    cw = forward_4x4(cblocks)
    cdc = np.array([[cw[0, 0, 0], cw[1, 0, 0]],
                    [cw[2, 0, 0], cw[3, 0, 0]]], np.int32)
    wd2 = chroma_dc_forward(cdc)
    dc_lev = chroma_dc_quant(wd2, qpc).reshape(-1)
    cz = quant_4x4(cw, qpc, intra=True, skip_dc=True)
    ac_lev = zigzag(cz)[:, 1:]
    return dc_lev, ac_lev, reconstruct_chroma8(cpred, dc_lev, ac_lev, qpc)


def encode_frame_arrays(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                        qp: int, rd=None
                        ) -> tuple[FrameLevels, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Numpy reference of the intra compute path.

    Inputs are padded planes (y: multiple of 16, chroma: half). Returns
    the level arrays and the reconstructed planes (the decoder's exact
    output). `rd` (rdo.RdConfig) enables the per-MB SATD mode decision
    and/or perceptual AQ; the decision follows torchcore._intra_core's
    two-stage row schedule EXACTLY (same candidates, same greedy
    left-neighbor constraint, same tie-breaks), so the device and
    reference paths stay bit-identical feature-on as well as off.
    """
    from . import rdo
    from .rdo import RD_OFF

    if rd is None:
        rd = RD_OFF
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    nmb = mbh * mbw
    if rd.aq_q > 0:
        qp_mb = rdo.clamp_qp_map(
            qp, rdo.aq_offsets_np(y, rd.aq_q, mbw, mbh))
    else:
        qp_mb = np.full(nmb, qp, np.int32)
    luma_mode, chroma_mode = _mode_policy(mbw, mbh)

    recon_y = np.zeros_like(y)
    recon_u = np.zeros_like(u)
    recon_v = np.zeros_like(v)
    levels = FrameLevels(
        luma_mode=luma_mode.copy(),
        chroma_mode=chroma_mode.copy(),
        luma_dc=np.zeros((nmb, 16), np.int32),
        luma_ac=np.zeros((nmb, 16, 15), np.int32),
        chroma_dc=np.zeros((nmb, 2, 4), np.int32),
        chroma_ac=np.zeros((nmb, 2, 4, 15), np.int32),
        qp_delta=(qp_mb - qp).astype(np.int32) if rd.ships_modes else None,
    )

    def store_mb(mi, my, mx, ymode, cmode, pred_y, pred_u, pred_v):
        q = int(qp_mb[mi])
        qc = chroma_qp(q)
        levels.luma_mode[mi] = ymode
        levels.chroma_mode[mi] = cmode
        dc, ac, rec = _encode_luma_mb_np(
            y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16], pred_y, q)
        levels.luma_dc[mi] = dc
        levels.luma_ac[mi] = ac
        recon_y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = rec
        for ci, (plane, recon, cpred) in enumerate(
                ((u, recon_u, pred_u), (v, recon_v, pred_v))):
            cdc, cac, crec = _encode_chroma_mb_np(
                plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8], cpred, qc)
            levels.chroma_dc[mi, ci] = cdc
            levels.chroma_ac[mi, ci] = cac
            recon[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = crec

    # --- row 0: sequential (left-only dependencies) ------------------
    for mx in range(mbw):
        mi = mx
        if mx == 0:
            store_mb(mi, 0, 0, LUMA_DC, CHROMA_DC,
                     np.full((16, 16), 128, np.uint8),
                     np.full((8, 8), 128, np.uint8),
                     np.full((8, 8), 128, np.uint8))
            continue
        left = recon_y[:16, 16 * mx - 1]
        cleft_u = recon_u[:8, 8 * mx - 1]
        cleft_v = recon_v[:8, 8 * mx - 1]
        pred_h = predict_luma16(LUMA_H, None, left, None)
        pred_hu = predict_chroma8(CHROMA_H, None, cleft_u, None)
        pred_hv = predict_chroma8(CHROMA_H, None, cleft_v, None)
        ymode, cmode = LUMA_H, CHROMA_H
        pred_y, pred_u, pred_v = pred_h, pred_hu, pred_hv
        if rd.mode_decision:
            src = y[:16, 16 * mx:16 * mx + 16].astype(np.int32)
            pred_dc = predict_luma16(LUMA_DC, None, left, None)
            c_h = rdo.satd16_np(src - pred_h.astype(np.int32))
            c_dc = rdo.satd16_np(src - pred_dc.astype(np.int32))
            if c_dc < c_h:
                ymode, pred_y = LUMA_DC, pred_dc
            pred_dcu = predict_chroma8(CHROMA_DC, None, cleft_u, None)
            pred_dcv = predict_chroma8(CHROMA_DC, None, cleft_v, None)
            su = u[:8, 8 * mx:8 * mx + 8].astype(np.int32)
            sv = v[:8, 8 * mx:8 * mx + 8].astype(np.int32)
            cc_h = (rdo.satd8_np(su - pred_hu.astype(np.int32))
                    + rdo.satd8_np(sv - pred_hv.astype(np.int32)))
            cc_dc = (rdo.satd8_np(su - pred_dcu.astype(np.int32))
                     + rdo.satd8_np(sv - pred_dcv.astype(np.int32)))
            if cc_dc < cc_h:
                cmode, pred_u, pred_v = CHROMA_DC, pred_dcu, pred_dcv
        store_mb(mi, 0, mx, ymode, cmode, pred_y, pred_u, pred_v)

    # --- rows >= 1: two-stage (vertical pass, then switched MBs) -----
    for my in range(1, mbh):
        top_y = recon_y[16 * my - 1]
        top_u = recon_u[8 * my - 1]
        top_v = recon_v[8 * my - 1]
        preds_v = []
        for mx in range(mbw):
            preds_v.append((
                predict_luma16(LUMA_V, top_y[16 * mx:16 * mx + 16],
                               None, None),
                predict_chroma8(CHROMA_V, top_u[8 * mx:8 * mx + 8],
                                None, None),
                predict_chroma8(CHROMA_V, top_v[8 * mx:8 * mx + 8],
                                None, None)))
        if not rd.mode_decision:
            for mx in range(mbw):
                py, pu, pv = preds_v[mx]
                store_mb(my * mbw + mx, my, mx, LUMA_V, CHROMA_V,
                         py, pu, pv)
            continue

        # stage 1: vertical candidate recon for the whole row
        vrec = []
        for mx in range(mbw):
            mi = my * mbw + mx
            q = int(qp_mb[mi])
            qc = chroma_qp(q)
            py, pu, pv = preds_v[mx]
            _, _, ry = _encode_luma_mb_np(
                y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16], py, q)
            _, _, ru = _encode_chroma_mb_np(
                u[8 * my:8 * my + 8, 8 * mx:8 * mx + 8], pu, qc)
            _, _, rv = _encode_chroma_mb_np(
                v[8 * my:8 * my + 8, 8 * mx:8 * mx + 8], pv, qc)
            vrec.append((ry, ru, rv))

        # stage 2: per-MB candidate costs against the left neighbor's
        # VERTICAL recon (exact for switched MBs — greedy constraint)
        INF = 1 << 29
        desired = np.zeros(mbw, bool)
        choice = []
        for mx in range(mbw):
            mi = my * mbw + mx
            src = y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] \
                .astype(np.int32)
            su = u[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].astype(np.int32)
            sv = v[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].astype(np.int32)
            py, pu, pv = preds_v[mx]
            left = vrec[mx - 1][0][:, 15] if mx > 0 else None
            lu = vrec[mx - 1][1][:, 7] if mx > 0 else None
            lv = vrec[mx - 1][2][:, 7] if mx > 0 else None
            top16 = top_y[16 * mx:16 * mx + 16]
            ph = predict_luma16(LUMA_H, None, left, None) \
                if mx > 0 else None
            pdc = predict_luma16(LUMA_DC, top16, left, None)
            c_v = rdo.satd16_np(src - py.astype(np.int32))
            c_h = rdo.satd16_np(src - ph.astype(np.int32)) \
                if mx > 0 else INF
            c_dc = rdo.satd16_np(src - pdc.astype(np.int32))
            tu8 = top_u[8 * mx:8 * mx + 8]
            tv8 = top_v[8 * mx:8 * mx + 8]
            phu = predict_chroma8(CHROMA_H, None, lu, None) \
                if mx > 0 else None
            phv = predict_chroma8(CHROMA_H, None, lv, None) \
                if mx > 0 else None
            pdcu = predict_chroma8(CHROMA_DC, tu8, lu, None)
            pdcv = predict_chroma8(CHROMA_DC, tv8, lv, None)
            cc_v = (rdo.satd8_np(su - pu.astype(np.int32))
                    + rdo.satd8_np(sv - pv.astype(np.int32)))
            cc_h = (rdo.satd8_np(su - phu.astype(np.int32))
                    + rdo.satd8_np(sv - phv.astype(np.int32))) \
                if mx > 0 else INF
            cc_dc = (rdo.satd8_np(su - pdcu.astype(np.int32))
                     + rdo.satd8_np(sv - pdcv.astype(np.int32)))
            # strict-< argmin, candidate order (V, H, DC)
            best_y, ymode_alt, pya = c_v, LUMA_V, py
            if c_h < best_y:
                best_y, ymode_alt, pya = c_h, LUMA_H, ph
            if c_dc < best_y:
                best_y, ymode_alt, pya = c_dc, LUMA_DC, pdc
            best_c, cmode_alt, pua, pva = cc_v, CHROMA_V, pu, pv
            if cc_h < best_c:
                best_c, cmode_alt, pua, pva = cc_h, CHROMA_H, phu, phv
            if cc_dc < best_c:
                best_c, cmode_alt, pua, pva = cc_dc, CHROMA_DC, pdcu, pdcv
            desired[mx] = (best_y + best_c) < (c_v + cc_v)
            choice.append((ymode_alt, cmode_alt, pya, pua, pva))
        allowed = _greedy_allowed_np(desired)

        # stage 3: final encode (switched MBs re-encode; the rest keep
        # their vertical prediction)
        for mx in range(mbw):
            mi = my * mbw + mx
            if allowed[mx]:
                ymode_alt, cmode_alt, pya, pua, pva = choice[mx]
                store_mb(mi, my, mx, ymode_alt, cmode_alt, pya, pua, pva)
            else:
                py, pu, pv = preds_v[mx]
                store_mb(mi, my, mx, LUMA_V, CHROMA_V, py, pu, pv)
    return levels, (recon_y, recon_u, recon_v)



def mb_cbp(levels: FrameLevels, mi: int) -> tuple[int, int]:
    """(cbp_luma in {0,15}, cbp_chroma in {0,1,2}) for MB `mi`."""
    cbp_luma = 15 if np.any(levels.luma_ac[mi]) else 0
    if np.any(levels.chroma_ac[mi]):
        cbp_chroma = 2
    elif np.any(levels.chroma_dc[mi]):
        cbp_chroma = 1
    else:
        cbp_chroma = 0
    return cbp_luma, cbp_chroma


def pack_slice(levels: FrameLevels, mbw: int, mbh: int, sps: SPS, pps: PPS,
               qp: int, frame_num: int = 0, idr: bool = True,
               idr_pic_id: int = 0, native: bool | None = None,
               first_mb: int = 0, deblock: bool = False) -> bytes:
    """Entropy-pack one I slice into an Annex-B NAL unit.

    `levels`/`mbw`/`mbh` describe the SLICE's macroblocks; with a
    nonzero `first_mb` the slice covers MB raster addresses
    [first_mb, first_mb + mbw*mbh) of a larger picture, and the CAVLC
    nC / intra-prediction neighbor logic below — which treats the
    band's first row as having no MBs above — is exactly the §7.4.3
    cross-slice unavailability a decoder applies.

    `native=None` auto-selects the C++ packer when buildable; False forces
    the pure-Python reference path (both produce identical bits — tested).
    """
    bw = BitWriter()
    header = SliceHeader(
        slice_type=SLICE_TYPE_I, frame_num=frame_num, idr=idr, qp=qp,
        idr_pic_id=idr_pic_id, first_mb=first_mb,
        deblock_idc=0 if deblock else 1,
    )
    header.write(bw, sps, pps)

    if native is not False:
        from ... import native as native_mod

        if native_mod.available():
            hdr_bytes, hdr_bits = bw.getvalue_unaligned()
            ebsp = native_mod.pack_islice(
                hdr_bytes, hdr_bits, levels.luma_mode, levels.chroma_mode,
                levels.luma_dc, levels.luma_ac, levels.chroma_dc,
                levels.chroma_ac, mbw, mbh, qp_delta=levels.qp_delta)
            start = b"\x00\x00\x00\x01"
            nal_header = bytes([(3 << 5) | (NAL_SLICE_IDR if idr else 1)])
            return start + nal_header + ebsp
        if native:
            raise RuntimeError("native packer requested but unavailable")

    # nC neighbor maps: total_coeff per 4x4 luma / chroma block.
    luma_counts = np.zeros((4 * mbh, 4 * mbw), np.int32)
    chroma_counts = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)

    # mb_qp_delta chains: each MB signals its qp relative to the
    # PREVIOUS MB's (§7.4.5); levels.qp_delta holds offsets vs the
    # slice qp, so the coded value is the successive difference.
    dqp = levels.qp_delta
    prev_off = 0
    for my in range(mbh):
        for mx in range(mbw):
            mi = my * mbw + mx
            cbp_luma, cbp_chroma = mb_cbp(levels, mi)
            mb_type = 1 + int(levels.luma_mode[mi]) + 4 * cbp_chroma \
                + 12 * (1 if cbp_luma else 0)
            bw.ue(mb_type)
            bw.ue(int(levels.chroma_mode[mi]))   # intra_chroma_pred_mode
            if dqp is None:
                bw.se(0)                         # mb_qp_delta
            else:
                bw.se(int(dqp[mi]) - prev_off)
                prev_off = int(dqp[mi])

            # Luma DC: nC from blkIdx 0 neighbors.
            by0, bx0 = 4 * my, 4 * mx
            na = int(luma_counts[by0, bx0 - 1]) if bx0 > 0 else None
            nb = int(luma_counts[by0 - 1, bx0]) if by0 > 0 else None
            cavlc.encode_residual(bw, levels.luma_dc[mi].tolist(),
                                  cavlc.luma_nc(na, nb))

            # Luma AC in z-scan block order.
            for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
                gy, gx = by0 + by, bx0 + bx
                if cbp_luma:
                    na = int(luma_counts[gy, gx - 1]) if gx > 0 else None
                    nb = int(luma_counts[gy - 1, gx]) if gy > 0 else None
                    tc = cavlc.encode_residual(
                        bw, levels.luma_ac[mi, bi].tolist(), cavlc.luma_nc(na, nb))
                    luma_counts[gy, gx] = tc
                else:
                    luma_counts[gy, gx] = 0

            # Chroma DC (both planes) then AC.
            if cbp_chroma > 0:
                for ci in range(2):
                    cavlc.encode_residual(
                        bw, levels.chroma_dc[mi, ci].tolist(), -1)
            cy0, cx0 = 2 * my, 2 * mx
            for ci in range(2):
                for bi, (bx, by) in enumerate(CHROMA_BLOCK_ORDER):
                    gy, gx = cy0 + by, cx0 + bx
                    if cbp_chroma == 2:
                        na = int(chroma_counts[ci, gy, gx - 1]) if gx > 0 else None
                        nb = int(chroma_counts[ci, gy - 1, gx]) if gy > 0 else None
                        tc = cavlc.encode_residual(
                            bw, levels.chroma_ac[mi, ci, bi].tolist(),
                            cavlc.luma_nc(na, nb))
                        chroma_counts[ci, gy, gx] = tc
                    else:
                        chroma_counts[ci, gy, gx] = 0

    bw.rbsp_trailing_bits()
    return annexb_nal(3, NAL_SLICE_IDR if idr else 1, bw.getvalue())


class H264Encoder:
    """Stateful per-job encoder: sequence headers + frame encode.

    Scope: intra-only (every frame IDR), 4:2:0, fixed qp, CAVLC, with
    the intra RD features (mode decision, AQ). The intra compute runs on
    `device` (torchcore.build_intra_encoder); pass `use_device=False`
    for the numpy reference implementation (`encode_frame_arrays`),
    which needs neither torch nor a device."""

    def __init__(self, meta: VideoMeta, qp: int = 27, rd=None,
                 device="cuda", use_device: bool = True):
        from .rdo import RD_OFF

        self.meta = meta
        self.qp = qp
        self.use_device = use_device
        self.rd = rd if rd is not None else RD_OFF
        if self.rd.deblock or self.rd.pskip:
            # all-intra scope: no recon chain to filter, no inter MBs to
            # skip — the GOP path carries those features.
            raise ValueError(
                "H264Encoder (all-intra) supports mode_decision/aq "
                "only; deblock/pskip need the GOP path")
        self.device = None
        if use_device:
            from ...core.devices import resolve_device

            self.device = resolve_device(device)
        self.sps = SPS(width=meta.width, height=meta.height,
                       fps_num=meta.fps_num, fps_den=meta.fps_den)
        self.pps = PPS(init_qp=qp)
        self._fn = None

    def _compute(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
                 ) -> FrameLevels:
        if self.use_device:
            from . import torchcore

            if self._fn is None:
                self._fn = torchcore.build_intra_encoder(
                    y.shape, self.qp, self.rd, device=self.device)
            return self._fn(y, u, v)
        levels, _ = encode_frame_arrays(y, u, v, self.qp, rd=self.rd)
        return levels

    def encode_frame(self, frame: Frame, frame_num: int = 0,
                     idr_pic_id: int = 0, with_headers: bool = True) -> bytes:
        if not is_yuv420(frame):
            # The MB geometry below hard-assumes 4:2:0 (8x8 chroma per MB);
            # feeding 4:2:2/4:4:4 would silently mis-encode.
            raise ValueError(
                f"H264Encoder supports only 4:2:0 input, got "
                f"{frame.chroma.name}; convert before encoding")
        padded = frame.padded(16)
        levels = self._compute(padded.y, padded.u, padded.v)
        mbh, mbw = padded.y.shape[0] // 16, padded.y.shape[1] // 16
        slice_nal = pack_slice(levels, mbw, mbh, self.sps, self.pps, self.qp,
                               frame_num=0, idr=True,
                               idr_pic_id=idr_pic_id % 65536)
        if with_headers:
            return self.sps.to_nal() + self.pps.to_nal() + slice_nal
        return slice_nal


def encode_frames(frames: list[Frame], meta: VideoMeta, qp: int = 27,
                  device="cuda", use_device: bool = True) -> bytes:
    """Encode a closed sequence of frames to one Annex-B byte stream
    (all-intra: every frame IDR); `use_device=False` runs the numpy
    reference instead of `device`."""
    enc = H264Encoder(meta, qp=qp, device=device, use_device=use_device)
    out = []
    for i, frame in enumerate(frames):
        out.append(enc.encode_frame(frame, idr_pic_id=i,
                                    with_headers=(i == 0)))
    return b"".join(out)


def encode_gop(frames: list[Frame], meta: VideoMeta, qp: int = 27,
               idr_pic_id: int = 0, with_headers: bool = True,
               return_recon: bool = False, rd=None, device="cuda"):
    """Encode a closed GOP: frame 0 IDR, frames 1..F-1 inter-coded (P).

    The GOP's compute (intra frame + motion search / compensation /
    transform chained through the recon carry) is one
    torchinter.encode_gop_planes call on `device`, with the RD features
    of `rd` (rdo.RdConfig; None = all off); this host half packs the
    I-slice and the P-slices from the plane-layout levels. With
    `return_recon` also returns the reconstructed planes (recon_y,
    recon_u, recon_v), each (F, H, W) int32 over the padded frame —
    deblocked when rd.deblock, as a decoder reconstructs them.
    """
    import torch

    from ...core.devices import resolve_device
    from . import torchinter
    from .layout import unflatten_gop
    from .rdo import RD_OFF

    if rd is None:
        rd = RD_OFF
    dev = resolve_device(device)
    if not frames:
        raise ValueError("empty GOP")
    bad = next((f for f in frames if not is_yuv420(f)), None)
    if bad is not None:
        raise ValueError(
            f"encode_gop supports only 4:2:0 input, got {bad.chroma.name}")
    padded = [f.padded(16) for f in frames]
    ph, pw = padded[0].y.shape
    mbh, mbw = ph // 16, pw // 16
    ys, us, vs = (torch.from_numpy(np.stack([getattr(p, c) for p in padded]))
                  .to(dev) for c in "yuv")
    out = torchinter.encode_gop_planes(ys, us, vs, qp, mbw=mbw, mbh=mbh,
                                       emit_recon=return_recon, rd=rd)
    intra, planes = unflatten_gop(out[1].cpu().numpy(), out[0].cpu().numpy(),
                                  len(frames), mbw, mbh,
                                  ships_modes=rd.ships_modes)
    sps = SPS(width=meta.width, height=meta.height,
              fps_num=meta.fps_num, fps_den=meta.fps_den)
    pps = PPS(init_qp=qp)
    stream = b"".join(run_slice_thunks(gop_slice_thunks_planes(
        intra, planes, len(frames), mbw, mbh, sps, pps, qp, idr_pic_id,
        with_headers=with_headers, rd=rd)))
    if return_recon:
        return stream, tuple(r.cpu().numpy() for r in out[2])
    return stream


def unpack_mode16(mode16: np.ndarray):
    """The transfer's packed per-MB mode word → (luma_mode,
    chroma_mode) int32 arrays."""
    m = np.asarray(mode16, np.int32)
    return m & 15, m >> 4


def _gop_slice_thunks(intra, pack_p, num_frames: int, mbw: int, mbh: int,
                      sps: SPS, pps: PPS, qp: int, idr_pic_id: int,
                      with_headers: bool, rd=None) -> list:
    """Per-slice pack closures for one GOP (IDR thunk first, then one
    per P frame). A GOP's slices are independent bit-strings until the
    final concat, so callers may run the thunks on a thread pool (the
    native packer releases the GIL for the C call); running them in
    order serially yields the same bytes.

    `intra` is the 4-tuple of blocked level arrays, or — when the
    encode shipped the per-MB side channel (rd.ships_modes) — a
    6-tuple with (mode16, dqp16) appended."""
    from .rdo import RD_OFF

    if rd is None:
        rd = RD_OFF
    if len(intra) == 6:
        il_dc, il_ac, ic_dc, ic_ac, mode16, dqp16 = intra
        luma_mode, chroma_mode = unpack_mode16(mode16)
        qp_delta = np.asarray(dqp16, np.int32)
        if not np.any(qp_delta):
            qp_delta = None
    else:
        il_dc, il_ac, ic_dc, ic_ac = intra
        luma_mode, chroma_mode = _mode_policy(mbw, mbh)
        qp_delta = None
    intra_levels = FrameLevels(
        luma_mode=luma_mode, chroma_mode=chroma_mode,
        luma_dc=il_dc, luma_ac=il_ac, chroma_dc=ic_dc, chroma_ac=ic_ac,
        qp_delta=qp_delta)
    head = sps.to_nal() + pps.to_nal() if with_headers else b""
    deblock = bool(rd.deblock)

    def pack_idr():
        return head + pack_slice(intra_levels, mbw, mbh, sps, pps, qp,
                                 frame_num=0, idr=True,
                                 idr_pic_id=idr_pic_id % 65536,
                                 deblock=deblock)

    thunks = [pack_idr]
    for i in range(num_frames - 1):
        thunks.append(functools.partial(pack_p, i, (i + 1) % 256))
    return thunks


def run_slice_thunks(thunks: list, pool=None) -> list[bytes]:
    """Evaluate slice-pack thunks in slice order; with `pool` (any
    Executor) the packs run concurrently, without it serially — the
    resulting bytes are identical either way."""
    if pool is None or len(thunks) <= 1:
        return [t() for t in thunks]
    return [f.result() for f in [pool.submit(t) for t in thunks]]


def gop_slice_thunks_planes(intra, planes, num_frames: int, mbw: int,
                            mbh: int, sps: SPS, pps: PPS, qp: int,
                            idr_pic_id: int,
                            with_headers: bool = True, rd=None) -> list:
    """Per-slice pack thunks for one PLANE-layout GOP: planes =
    (mv8 (F-1,nmb,2) int8, luma planes (F-1,H,W) int16, u_dc/v_dc
    (F-1,nmb,4) int16, u_ac/v_ac (F-1,H/2,W/2) int16); the intra frame
    stays blocked. dispatch.collect_wave submits these so slices from
    ALL of a wave's GOPs pack concurrently on the pack pool."""
    from . import inter as inter_mod

    deblock = bool(rd.deblock) if rd is not None else False
    mv8, lp, udc, vdc, uac, vac = planes
    return _gop_slice_thunks(
        intra,
        lambda i, fn: inter_mod.pack_p_slice_plane(
            mv8[i], lp[i], udc[i], vdc[i], uac[i], vac[i], mbw, mbh,
            sps, pps, qp, frame_num=fn, deblock=deblock),
        num_frames, mbw, mbh, sps, pps, qp, idr_pic_id, with_headers,
        rd=rd)


def _pack_gop_common(intra, pack_p, num_frames: int, mbw: int, mbh: int,
                     sps: SPS, pps: PPS, qp: int, idr_pic_id: int,
                     with_headers: bool, pool=None, rd=None) -> list[bytes]:
    """Shared host half of GOP entropy packing: IDR slice from blocked
    intra levels + one P slice per remaining frame via `pack_p(i,
    frame_num)`, optionally fanned across `pool` at slice granularity."""
    return run_slice_thunks(
        _gop_slice_thunks(intra, pack_p, num_frames, mbw, mbh, sps, pps,
                          qp, idr_pic_id, with_headers, rd=rd), pool)


def gop_slice_thunks_planes(intra, planes, num_frames: int, mbw: int,
                            mbh: int, sps: SPS, pps: PPS, qp: int,
                            idr_pic_id: int,
                            with_headers: bool = True, rd=None) -> list:
    """Per-slice pack thunks for one PLANE-layout GOP (see
    pack_gop_slices_planes for the array contract). dispatch.collect_wave
    submits these so slices from ALL of a wave's GOPs pack concurrently
    on the pack pool instead of GOP-by-GOP."""
    from . import inter as inter_mod

    deblock = bool(rd.deblock) if rd is not None else False
    mv8, lp, udc, vdc, uac, vac = planes
    return _gop_slice_thunks(
        intra,
        lambda i, fn: inter_mod.pack_p_slice_plane(
            mv8[i], lp[i], udc[i], vdc[i], uac[i], vac[i], mbw, mbh,
            sps, pps, qp, frame_num=fn, deblock=deblock),
        num_frames, mbw, mbh, sps, pps, qp, idr_pic_id, with_headers,
        rd=rd)


def pack_gop_slices_planes(intra, planes, num_frames: int, mbw: int,
                           mbh: int, sps: SPS, pps: PPS, qp: int,
                           idr_pic_id: int, with_headers: bool = True,
                           pool=None, rd=None) -> list[bytes]:
    """Entropy-pack one GOP whose P frames arrive as PLANE-layout level
    arrays (the sharded transfer format, torchinter.encode_gop_planes):
    planes = (mv8 (F-1,nmb,2) int8, luma planes (F-1,H,W) int16,
    u_dc/v_dc (F-1,nmb,4) int16, u_ac/v_ac (F-1,H/2,W/2) int16).
    The intra frame stays blocked (torchcore._intra_core emits blocked).
    Bit-identical to pack_gop_slices on the equivalent blocked arrays."""
    return run_slice_thunks(
        gop_slice_thunks_planes(intra, planes, num_frames, mbw, mbh, sps,
                                pps, qp, idr_pic_id, with_headers, rd=rd),
        pool)


def pack_gop_slices(intra, pouts, num_frames: int, mbw: int, mbh: int,
                    sps: SPS, pps: PPS, qp: int, idr_pic_id: int,
                    with_headers: bool = True, pool=None,
                    rd=None) -> list[bytes]:
    """Entropy-pack one GOP's slices from BLOCKED device level arrays
    (the blocked GOP layout the reference's single-device
    encode_gop ships).

    intra: (luma_dc, luma_ac, chroma_dc, chroma_ac[, mode16, dqp16]);
    pouts: the P frames' (mv, luma16, chroma_dc, chroma_ac), leading
    dim >= num frames - 1 (extra tail-padding entries are ignored).
    """
    from . import inter as inter_mod

    deblock = bool(rd.deblock) if rd is not None else False
    mv, l16, cdc, cac = pouts
    return _pack_gop_common(
        intra,
        lambda i, fn: inter_mod.pack_p_slice(
            mv[i], l16[i], cdc[i], cac[i], mbw, mbh, sps, pps, qp,
            frame_num=fn, deblock=deblock),
        num_frames, mbw, mbh, sps, pps, qp, idr_pic_id, with_headers,
        pool=pool, rd=rd)
