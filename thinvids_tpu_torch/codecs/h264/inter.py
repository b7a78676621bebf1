"""P-slice host-side coding: MV prediction, skip decision, entropy pack.

The device (torchinter.py) hands back per-MB motion vectors and quantized
levels; everything here is the sequential bitstream half: median MV
prediction (§8.4.1.3), P_Skip inference (§8.4.1.1), inter CBP mapping
(Table 9-4), and the CAVLC MB layer for P_L0_16x16 macroblocks.

Scope: one reference frame (the previous recon), whole-MB partitions,
half-pel MVs (quarter-pel mvd coding), all-inter P frames (no intra
refresh MBs yet).
"""

from __future__ import annotations

import numpy as np

from ...io.bits import BitWriter, annexb_nal
from . import cavlc
from .headers import (
    NAL_SLICE_NON_IDR,
    PPS,
    SLICE_TYPE_P,
    SPS,
    SliceHeader,
)
from .intra import CHROMA_BLOCK_ORDER, LUMA_BLOCK_ORDER

# Table 9-4, ChromaArrayType=1: coded_block_pattern → codeNum for Inter
# prediction modes (index = cbp_luma + 16*cbp_chroma).
CBP_INTER_TO_CODE = [0] * 48
_CODE_TO_CBP_INTER = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
]
for _code, _cbp in enumerate(_CODE_TO_CBP_INTER):
    CBP_INTER_TO_CODE[_cbp] = _code


def _median3(a, b, c):
    return max(min(a, b), min(c, max(a, b)))


def predict_mvs(mv: np.ndarray, mbw: int, mbh: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(mvp, skip_mv) per MB for an all-inter P frame, single reference.

    mv: (nmb, 2) chosen vectors in (dy, dx). Implements §8.4.1.3 median
    prediction with the C→D fallback and §8.4.1.1 P_Skip inference.
    """
    mvg = mv.reshape(mbh, mbw, 2)
    mvp = np.zeros_like(mvg)
    skip = np.zeros_like(mvg)
    for my in range(mbh):
        for mx in range(mbw):
            avail_a = mx > 0
            avail_b = my > 0
            mva = mvg[my, mx - 1] if avail_a else np.zeros(2, np.int32)
            mvb = mvg[my - 1, mx] if avail_b else np.zeros(2, np.int32)
            # C = top-right; when unavailable substitute D = top-left.
            if my > 0 and mx + 1 < mbw:
                avail_c, mvc = True, mvg[my - 1, mx + 1]
            elif my > 0 and mx > 0:
                avail_c, mvc = True, mvg[my - 1, mx - 1]
            else:
                avail_c, mvc = False, np.zeros(2, np.int32)

            n_avail = int(avail_a) + int(avail_b) + int(avail_c)
            if not avail_b and not avail_c and avail_a:
                p = mva
            elif n_avail == 1:
                p = mva if avail_a else (mvb if avail_b else mvc)
            else:
                p = np.array([
                    _median3(int(mva[0]), int(mvb[0]), int(mvc[0])),
                    _median3(int(mva[1]), int(mvb[1]), int(mvc[1])),
                ], np.int32)
            mvp[my, mx] = p

            # P_Skip: zero MV when an edge neighbor is missing or either
            # neighbor is a zero-MV ref-0 block (§8.4.1.1).
            if (not avail_a or not avail_b
                    or (mva[0] == 0 and mva[1] == 0)
                    or (mvb[0] == 0 and mvb[1] == 0)):
                skip[my, mx] = 0
            else:
                skip[my, mx] = p
    return mvp.reshape(-1, 2), skip.reshape(-1, 2)


def mb_cbp_inter(luma16: np.ndarray, chroma_dc: np.ndarray,
                 chroma_ac: np.ndarray) -> tuple[int, int]:
    """(cbp_luma 4-bit, cbp_chroma) for one inter MB.

    luma16: (16, 16) z-scan blocks × zig-zag coeffs; 8x8 group i covers
    z-scan blocks 4i..4i+3.
    """
    cbp_luma = 0
    for g in range(4):
        if np.any(luma16[4 * g:4 * g + 4]):
            cbp_luma |= 1 << g
    if np.any(chroma_ac):
        cbp_chroma = 2
    elif np.any(chroma_dc):
        cbp_chroma = 1
    else:
        cbp_chroma = 0
    return cbp_luma, cbp_chroma


def blocked_from_planes(luma_plane: np.ndarray, u_ac: np.ndarray,
                        v_ac: np.ndarray, mbw: int, mbh: int):
    """Plane-layout coeff planes → the packer's blocked/zigzag arrays
    (the pure-Python mirror of the native plane packer's internal scan;
    also the fallback path when no compiler is available)."""
    from .intra import LUMA_BLOCK_ORDER
    from .transform import ZIGZAG_4x4

    nmb = mbw * mbh
    zs = np.asarray([by * 4 + bx for (bx, by) in LUMA_BLOCK_ORDER])
    zz = np.asarray(ZIGZAG_4x4)
    x = luma_plane.reshape(mbh, 4, 4, mbw, 4, 4).transpose(0, 3, 1, 4, 2, 5)
    l16 = x.reshape(nmb, 16, 16)[:, zs][:, :, zz].astype(np.int32)
    def cblk(p):
        c = p.reshape(mbh, 2, 4, mbw, 2, 4).transpose(0, 3, 1, 4, 2, 5)
        return c.reshape(nmb, 4, 16)[..., zz][..., 1:]
    cac = np.stack([cblk(u_ac), cblk(v_ac)], axis=1).astype(np.int32)
    return l16, cac


def pack_p_slice_plane(mv: np.ndarray, luma_plane: np.ndarray,
                       u_dc: np.ndarray, v_dc: np.ndarray,
                       u_ac: np.ndarray, v_ac: np.ndarray,
                       mbw: int, mbh: int, sps: SPS, pps: PPS, qp: int,
                       frame_num: int, native: bool | None = None,
                       first_mb: int = 0, deblock: bool = False) -> bytes:
    """Entropy-pack one P slice straight from plane-layout levels.

    mv: (nmb, 2) int; luma_plane: (16*mbh, 16*mbw) int16 quantized
    coeffs in natural block positions; u_dc/v_dc: (nmb, 4) hadamard-
    domain DC levels; u_ac/v_ac: (8*mbh, 8*mbw) int16 with DC positions
    zero. This is the sharded path's pack entry — the device ships raw
    planes (torchinter.encode_gop_planes) and no relayout pass exists on
    either side when the native packer is available.

    With a nonzero `first_mb` the arrays describe one MB-row BAND of a
    larger picture coded as its own slice (split-frame encoding); the
    MV-prediction / skip / nC neighbor logic treating the band's first
    row as top-of-frame is exactly the decoder's cross-slice
    unavailability rule.
    """
    bw = BitWriter()
    header = SliceHeader(slice_type=SLICE_TYPE_P, frame_num=frame_num,
                         idr=False, qp=qp, first_mb=first_mb,
                         deblock_idc=0 if deblock else 1)
    header.write(bw, sps, pps)

    if native is not False:
        from ... import native as native_mod

        if native_mod.available():
            hdr_bytes, hdr_bits = bw.getvalue_unaligned()
            ebsp = native_mod.pack_pslice_plane(
                hdr_bytes, hdr_bits, np.asarray(mv, np.int8), luma_plane,
                u_dc, v_dc, u_ac, v_ac, mbw, mbh)
            start = b"\x00\x00\x00\x01"
            nal_header = bytes([(2 << 5) | NAL_SLICE_NON_IDR])
            return start + nal_header + ebsp
        if native:
            raise RuntimeError("native packer requested but unavailable")

    l16, cac = blocked_from_planes(luma_plane, u_ac, v_ac, mbw, mbh)
    cdc = np.stack([u_dc, v_dc], axis=1).astype(np.int32)
    return pack_p_slice(np.asarray(mv, np.int32), l16, cdc, cac, mbw, mbh,
                        sps, pps, qp, frame_num, native=False,
                        first_mb=first_mb, deblock=deblock)


def pack_p_slice(mv: np.ndarray, luma16: np.ndarray, chroma_dc: np.ndarray,
                 chroma_ac: np.ndarray, mbw: int, mbh: int, sps: SPS,
                 pps: PPS, qp: int, frame_num: int,
                 native: bool | None = None, first_mb: int = 0,
                 deblock: bool = False) -> bytes:
    """Entropy-pack one P slice into an Annex-B NAL unit.

    mv: (nmb, 2) half-pel (dy, dx); luma16: (nmb, 16, 16) z-scan
    blocks of 16 zig-zag coeffs; chroma_dc: (nmb, 2, 4);
    chroma_ac: (nmb, 2, 4, 15). `first_mb` as in
    :func:`pack_p_slice_plane`.

    `native=None` auto-selects the C++ packer when buildable; False
    forces the pure-Python reference path (identical bits — tested).
    """
    bw = BitWriter()
    header = SliceHeader(slice_type=SLICE_TYPE_P, frame_num=frame_num,
                         idr=False, qp=qp, first_mb=first_mb,
                         deblock_idc=0 if deblock else 1)
    header.write(bw, sps, pps)

    if native is not False:
        from ... import native as native_mod

        if native_mod.available():
            hdr_bytes, hdr_bits = bw.getvalue_unaligned()
            ebsp = native_mod.pack_pslice(
                hdr_bytes, hdr_bits, mv, luma16, chroma_dc, chroma_ac,
                mbw, mbh)
            start = b"\x00\x00\x00\x01"
            nal_header = bytes([(2 << 5) | NAL_SLICE_NON_IDR])
            return start + nal_header + ebsp
        if native:
            raise RuntimeError("native packer requested but unavailable")

    mvp, skip_mv = predict_mvs(mv, mbw, mbh)
    luma_counts = np.zeros((4 * mbh, 4 * mbw), np.int32)
    chroma_counts = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)

    skip_run = 0
    for my in range(mbh):
        for mx in range(mbw):
            mi = my * mbw + mx
            cbp_luma, cbp_chroma = mb_cbp_inter(
                luma16[mi], chroma_dc[mi], chroma_ac[mi])
            cbp = cbp_luma | (cbp_chroma << 4)
            is_skip = (cbp == 0
                       and mv[mi, 0] == skip_mv[mi, 0]
                       and mv[mi, 1] == skip_mv[mi, 1])
            if is_skip:
                skip_run += 1
                # neighbor counts stay 0 for this MB
                continue

            bw.ue(skip_run)                    # mb_skip_run
            skip_run = 0
            bw.ue(0)                           # mb_type = P_L0_16x16
            # mv is in half-pel units; mvd is coded in quarter-pel
            # units, horizontal component first (§7.3.5.1 compIdx
            # order); our mv layout is (dy, dx).
            bw.se(2 * int(mv[mi, 1] - mvp[mi, 1]))   # mvd_l0 x
            bw.se(2 * int(mv[mi, 0] - mvp[mi, 0]))   # mvd_l0 y
            bw.ue(CBP_INTER_TO_CODE[cbp])      # coded_block_pattern
            if cbp:
                bw.se(0)                       # mb_qp_delta

            by0, bx0 = 4 * my, 4 * mx
            for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
                gy, gx = by0 + by, bx0 + bx
                if cbp_luma & (1 << (bi // 4)):
                    na = int(luma_counts[gy, gx - 1]) if gx > 0 else None
                    nb = int(luma_counts[gy - 1, gx]) if gy > 0 else None
                    tc = cavlc.encode_residual(
                        bw, luma16[mi, bi].tolist(), cavlc.luma_nc(na, nb))
                    luma_counts[gy, gx] = tc
                else:
                    luma_counts[gy, gx] = 0

            if cbp_chroma > 0:
                for ci in range(2):
                    cavlc.encode_residual(
                        bw, chroma_dc[mi, ci].tolist(), -1)
            cy0, cx0 = 2 * my, 2 * mx
            for ci in range(2):
                for bi, (bx, by) in enumerate(CHROMA_BLOCK_ORDER):
                    gy, gx = cy0 + by, cx0 + bx
                    if cbp_chroma == 2:
                        na = (int(chroma_counts[ci, gy, gx - 1])
                              if gx > 0 else None)
                        nb = (int(chroma_counts[ci, gy - 1, gx])
                              if gy > 0 else None)
                        tc = cavlc.encode_residual(
                            bw, chroma_ac[mi, ci, bi].tolist(),
                            cavlc.luma_nc(na, nb))
                        chroma_counts[ci, gy, gx] = tc
                    else:
                        chroma_counts[ci, gy, gx] = 0

    if skip_run:
        bw.ue(skip_run)                        # trailing skipped MBs
    bw.rbsp_trailing_bits()
    return annexb_nal(2, NAL_SLICE_NON_IDR, bw.getvalue())
