"""H.264 baseline decoder (subset matching the encoder's profile): a copy
of the reference package's host numpy decoder over the port's own
cavlc, headers, inter, intra, transform, deblock, io.bits and
core.types.

Independent implementation of the decode direction — parses Annex-B
streams (SPS/PPS, IDR + non-IDR slices, CAVLC, I16x16 and P_L0_16x16,
multi-slice pictures) and reconstructs frames. Used by tests as the
in-repo conformance check of encoder output (alongside the libavcodec
ctypes oracle — which this container may not have) and by the
stamp/seam verification tooling to decode without external binaries.

Scope grows with the encoder: one reference frame (the previous
decoded picture), whole-MB partitions, half-pel MVs (quarter-pel mvd),
deblocking disabled, and pictures split into any number of slices —
the split-frame-encoding path emits one slice per MB-row band, and
this decoder applies the same §7.4.3 cross-slice neighbor
unavailability the encoder's band packers assume.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..h264 import cavlc
from ...core.types import ChromaFormat, Frame, VideoMeta
from ...io.bits import BitReader, split_annexb
from .headers import (
    NAL_PPS,
    NAL_SLICE_IDR,
    NAL_SLICE_NON_IDR,
    NAL_SPS,
    PPS,
    SLICE_TYPE_I,
    SLICE_TYPE_P,
    SPS,
    SliceHeader,
)
from .inter import _CODE_TO_CBP_INTER, _median3
from .intra import (
    CHROMA_BLOCK_ORDER,
    LUMA_BLOCK_ORDER,
    predict_chroma8,
    predict_luma16,
    reconstruct_chroma8,
    reconstruct_luma16,
)
from .transform import chroma_qp, dequant_4x4, inverse_4x4, inverse_zigzag

#: luma interpolation pad: |mv| <= 16 pel plus the 6-tap reach (3)
_MC_PAD = 24
_MC_PAD_C = 12


@dataclasses.dataclass
class DecodedStream:
    meta: VideoMeta
    frames: list[Frame]


class _Picture:
    """One picture being assembled from its (possibly many) slices."""

    def __init__(self, sps: SPS) -> None:
        self.mbw, self.mbh = sps.mb_width, sps.mb_height
        mbw, mbh = self.mbw, self.mbh
        self.y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
        self.u = np.zeros((8 * mbh, 8 * mbw), np.uint8)
        self.v = np.zeros((8 * mbh, 8 * mbw), np.uint8)
        # CAVLC nC neighbor state (total_coeff per 4x4 block), shared
        # across the picture's slices; cross-slice neighbors are never
        # CONSULTED (availability checks below), matching §7.4.3.
        self.luma_counts = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.chroma_counts = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)
        self.mv = np.zeros((mbh, mbw, 2), np.int32)     # (dy, dx) half-pel
        self.decoded = 0                                # MBs decoded so far
        # in-loop deblocking state: the effective QP_Y of every MB (the
        # running slice QP after mb_qp_delta; uncoded MBs keep the
        # running value — §8.7's QP for skipped MBs), the picture's
        # coding type, and whether ANY slice enabled the filter (all
        # slices of a picture carry the same idc in our streams).
        self.qp_mb = np.zeros((mbh, mbw), np.int32)
        self.intra = True
        self.deblock = False


def _tap6(x: np.ndarray, axis: int) -> np.ndarray:
    """6-tap §8.4.2.2.1 filter along `axis` with the same roll
    convention as torchme._tap6 (roll(x, k) moves element l to
    l + k): out[l] = x[l-2] -5x[l-1] +20x[l] +20x[l+1] -5x[l+2] +x[l+3].
    Wrapped edge rows/lanes stay inside the MC pad and are never read."""
    r = lambda k: np.roll(x, k, axis=axis)
    return r(2) - 5 * r(1) + 20 * x + 20 * r(-1) - 5 * r(-2) + r(-3)


def _halfpel_planes_np(ref_y: np.ndarray):
    """(R, B, H, J) int32 planes over an edge-padded reference — the
    numpy mirror of torchme._halfpel_planes (identical rounding)."""
    r32 = np.pad(ref_y.astype(np.int32), _MC_PAD, mode="edge")
    hb1 = _tap6(r32, axis=1)
    b = np.clip((hb1 + 16) >> 5, 0, 255)
    h = np.clip((_tap6(r32, axis=0) + 16) >> 5, 0, 255)
    j = np.clip((_tap6(hb1, axis=0) + 512) >> 10, 0, 255)
    return (r32, b, h, j)


class _RefFrame:
    """Previous decoded picture + lazily-built interpolation planes."""

    def __init__(self, pic: _Picture) -> None:
        self.y, self.u, self.v = pic.y, pic.u, pic.v
        self._planes = None
        self._cu = None
        self._cv = None

    def luma_pred(self, my: int, mx: int, mv) -> np.ndarray:
        if self._planes is None:
            self._planes = _halfpel_planes_np(self.y)
        dy, dx = int(mv[0]), int(mv[1])
        plane = self._planes[(dy & 1) * 2 + (dx & 1)]
        r0 = _MC_PAD + 16 * my + (dy >> 1)
        c0 = _MC_PAD + 16 * mx + (dx >> 1)
        return plane[r0:r0 + 16, c0:c0 + 16]

    def chroma_pred(self, my: int, mx: int, mv):
        """(pred_u, pred_v) via the §8.4.2.2.2 eighth-pel bilinear."""
        if self._cu is None:
            self._cu = np.pad(self.u.astype(np.int32), _MC_PAD_C,
                              mode="edge")
            self._cv = np.pad(self.v.astype(np.int32), _MC_PAD_C,
                              mode="edge")
        dy, dx = int(mv[0]), int(mv[1])
        oy, ox = dy >> 2, dx >> 2
        ey, ex = (dy & 3) * 2, (dx & 3) * 2
        r0 = _MC_PAD_C + 8 * my + oy
        c0 = _MC_PAD_C + 8 * mx + ox

        def bil(C):
            a = C[r0:r0 + 8, c0:c0 + 8]
            b = C[r0:r0 + 8, c0 + 1:c0 + 9]
            c = C[r0 + 1:r0 + 9, c0:c0 + 8]
            d = C[r0 + 1:r0 + 9, c0 + 1:c0 + 9]
            return ((8 - ex) * (8 - ey) * a + ex * (8 - ey) * b
                    + (8 - ex) * ey * c + ex * ey * d + 32) >> 6

        return bil(self._cu), bil(self._cv)


def _mvp_and_skip(pic: _Picture, my: int, mx: int, slice_first: int):
    """(mvp, skip_mv) for MB (my, mx) — §8.4.1.3 median prediction with
    the C→D fallback and §8.4.1.1 P_Skip inference, neighbors limited
    to the CURRENT slice (the decoder-side mirror of inter.predict_mvs,
    which the band packers apply in band-local coordinates)."""
    mbw = pic.mbw
    mi = my * mbw + mx
    zero = np.zeros(2, np.int32)
    avail_a = mx > 0 and mi - 1 >= slice_first
    avail_b = my > 0 and mi - mbw >= slice_first
    mva = pic.mv[my, mx - 1] if avail_a else zero
    mvb = pic.mv[my - 1, mx] if avail_b else zero
    if my > 0 and mx + 1 < mbw and mi - mbw + 1 >= slice_first:
        avail_c, mvc = True, pic.mv[my - 1, mx + 1]
    elif my > 0 and mx > 0 and mi - mbw - 1 >= slice_first:
        avail_c, mvc = True, pic.mv[my - 1, mx - 1]
    else:
        avail_c, mvc = False, zero
    n_avail = int(avail_a) + int(avail_b) + int(avail_c)
    if not avail_b and not avail_c and avail_a:
        p = mva
    elif n_avail == 1:
        p = mva if avail_a else (mvb if avail_b else mvc)
    else:
        p = np.array([_median3(int(mva[0]), int(mvb[0]), int(mvc[0])),
                      _median3(int(mva[1]), int(mvb[1]), int(mvc[1]))],
                     np.int32)
    if (not avail_a or not avail_b
            or (mva[0] == 0 and mva[1] == 0)
            or (mvb[0] == 0 and mvb[1] == 0)):
        skip = zero
    else:
        skip = p
    return np.asarray(p, np.int32), np.asarray(skip, np.int32)


def _decode_islice(br: BitReader, pic: _Picture,
                   header: SliceHeader) -> None:
    """Decode one I slice (any first_mb) into the picture state."""
    mbw, mbh = pic.mbw, pic.mbh
    nmb = mbw * mbh
    first = header.first_mb
    qp = header.qp
    y, u, v = pic.y, pic.u, pic.v
    luma_counts, chroma_counts = pic.luma_counts, pic.chroma_counts

    mi = first
    while mi < nmb and br.more_rbsp_data():
        my, mx = divmod(mi, mbw)
        mb_type = br.ue()
        if not 1 <= mb_type <= 24:
            raise ValueError(f"unsupported I mb_type {mb_type}")
        luma_mode = (mb_type - 1) % 4
        cbp_chroma = ((mb_type - 1) // 4) % 3
        cbp_luma = 15 if (mb_type - 1) >= 12 else 0
        chroma_mode = br.ue()
        qp += br.se()                       # mb_qp_delta
        pic.qp_mb[my, mx] = qp
        qpc = chroma_qp(qp)

        # in-slice neighbor availability (§7.4.3): an MB in another
        # slice is unavailable to prediction AND to nC derivation
        a_ok = mx > 0 and mi - 1 >= first
        b_ok = my > 0 and mi - mbw >= first
        d_ok = my > 0 and mx > 0 and mi - mbw - 1 >= first

        by0, bx0 = 4 * my, 4 * mx
        na = int(luma_counts[by0, bx0 - 1]) if a_ok else None
        nb = int(luma_counts[by0 - 1, bx0]) if b_ok else None
        luma_dc = np.array(
            cavlc.decode_residual(br, cavlc.luma_nc(na, nb), 16), np.int32)

        luma_ac = np.zeros((16, 15), np.int32)
        for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
            gy, gx = by0 + by, bx0 + bx
            if cbp_luma:
                na = (int(luma_counts[gy, gx - 1])
                      if gx > bx0 or a_ok else None) if gx > 0 else None
                nb = (int(luma_counts[gy - 1, gx])
                      if gy > by0 or b_ok else None) if gy > 0 else None
                coeffs = cavlc.decode_residual(br, cavlc.luma_nc(na, nb), 15)
                luma_ac[bi] = coeffs
                luma_counts[gy, gx] = sum(1 for c in coeffs if c)
            else:
                luma_counts[gy, gx] = 0

        chroma_dc = np.zeros((2, 4), np.int32)
        if cbp_chroma > 0:
            for ci in range(2):
                chroma_dc[ci] = cavlc.decode_residual(br, -1, 4)
        chroma_ac = np.zeros((2, 4, 15), np.int32)
        cy0, cx0 = 2 * my, 2 * mx
        for ci in range(2):
            for bi, (bx, by) in enumerate(CHROMA_BLOCK_ORDER):
                gy, gx = cy0 + by, cx0 + bx
                if cbp_chroma == 2:
                    na = (int(chroma_counts[ci, gy, gx - 1])
                          if gx > cx0 or a_ok else None) if gx > 0 else None
                    nb = (int(chroma_counts[ci, gy - 1, gx])
                          if gy > cy0 or b_ok else None) if gy > 0 else None
                    coeffs = cavlc.decode_residual(
                        br, cavlc.luma_nc(na, nb), 15)
                    chroma_ac[ci, bi] = coeffs
                    chroma_counts[ci, gy, gx] = sum(1 for c in coeffs if c)
                else:
                    chroma_counts[ci, gy, gx] = 0

        # Reconstruct.
        top = y[16 * my - 1, 16 * mx:16 * mx + 16] if b_ok else None
        left = y[16 * my:16 * my + 16, 16 * mx - 1] if a_ok else None
        tl = int(y[16 * my - 1, 16 * mx - 1]) if d_ok else None
        pred = predict_luma16(luma_mode, top, left, tl)
        y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = reconstruct_luma16(
            pred, luma_dc, luma_ac, qp)
        for ci, plane in enumerate((u, v)):
            ctop = plane[8 * my - 1, 8 * mx:8 * mx + 8] if b_ok else None
            cleft = plane[8 * my:8 * my + 8, 8 * mx - 1] if a_ok else None
            ctl = int(plane[8 * my - 1, 8 * mx - 1]) if d_ok else None
            cpred = predict_chroma8(chroma_mode, ctop, cleft, ctl)
            plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = reconstruct_chroma8(
                cpred, chroma_dc[ci], chroma_ac[ci], qpc)
        pic.decoded += 1
        mi += 1


def _recon_p_mb(pic: _Picture, ref: _RefFrame, my: int, mx: int, mv,
                luma16, chroma_dc, chroma_ac, qp: int) -> None:
    pred = ref.luma_pred(my, mx, mv)
    out = np.empty((16, 16), np.int32)
    for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
        z = inverse_zigzag(np.asarray(luma16[bi], np.int32))
        d = dequant_4x4(z, qp)                 # inter: no luma DC split
        r = (inverse_4x4(d) + 32) >> 6
        p = pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = p + r
    pic.y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = \
        np.clip(out, 0, 255).astype(np.uint8)
    qpc = chroma_qp(qp)
    pu, pv = ref.chroma_pred(my, mx, mv)
    for ci, (plane, cpred) in enumerate(((pic.u, pu), (pic.v, pv))):
        plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = reconstruct_chroma8(
            cpred, chroma_dc[ci], chroma_ac[ci], qpc)


def _decode_pslice(br: BitReader, pic: _Picture, header: SliceHeader,
                   ref: _RefFrame) -> None:
    """Decode one P slice (any first_mb): skip runs, P_L0_16x16 MBs."""
    mbw, mbh = pic.mbw, pic.mbh
    nmb = mbw * mbh
    first = header.first_mb
    qp = header.qp
    zero16 = np.zeros((16, 16), np.int32)
    zero_cdc = np.zeros((2, 4), np.int32)
    zero_cac = np.zeros((2, 4, 15), np.int32)

    mi = first
    while mi < nmb and br.more_rbsp_data():
        run = br.ue()                          # mb_skip_run
        for _ in range(run):
            if mi >= nmb:
                raise ValueError("mb_skip_run past end of picture")
            my, mx = divmod(mi, mbw)
            _, skip_mv = _mvp_and_skip(pic, my, mx, first)
            pic.mv[my, mx] = skip_mv
            pic.qp_mb[my, mx] = qp          # skip: running QP (§8.7)
            _recon_p_mb(pic, ref, my, mx, skip_mv, zero16, zero_cdc,
                        zero_cac, qp)
            pic.decoded += 1
            mi += 1
        if mi >= nmb or not br.more_rbsp_data():
            break                              # trailing skip run
        my, mx = divmod(mi, mbw)
        mb_type = br.ue()
        if mb_type != 0:
            raise ValueError(f"unsupported P mb_type {mb_type}")
        mvd_x = br.se()                        # quarter-pel, x first
        mvd_y = br.se()
        if (mvd_x | mvd_y) & 1:
            raise ValueError("quarter-pel mvd not supported (half-pel "
                             "encoder)")
        mvp, _ = _mvp_and_skip(pic, my, mx, first)
        mv = np.array([mvp[0] + mvd_y // 2, mvp[1] + mvd_x // 2], np.int32)
        pic.mv[my, mx] = mv
        cbp = _CODE_TO_CBP_INTER[br.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            qp += br.se()                      # mb_qp_delta
        pic.qp_mb[my, mx] = qp

        a_ok = mx > 0 and mi - 1 >= first
        b_ok = my > 0 and mi - mbw >= first
        by0, bx0 = 4 * my, 4 * mx
        luma16 = np.zeros((16, 16), np.int32)
        for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
            gy, gx = by0 + by, bx0 + bx
            if cbp_luma & (1 << (bi // 4)):
                na = (int(pic.luma_counts[gy, gx - 1])
                      if gx > bx0 or a_ok else None) if gx > 0 else None
                nb = (int(pic.luma_counts[gy - 1, gx])
                      if gy > by0 or b_ok else None) if gy > 0 else None
                coeffs = cavlc.decode_residual(br, cavlc.luma_nc(na, nb), 16)
                luma16[bi] = coeffs
                pic.luma_counts[gy, gx] = sum(1 for c in coeffs if c)
            else:
                pic.luma_counts[gy, gx] = 0

        chroma_dc = np.zeros((2, 4), np.int32)
        if cbp_chroma > 0:
            for ci in range(2):
                chroma_dc[ci] = cavlc.decode_residual(br, -1, 4)
        chroma_ac = np.zeros((2, 4, 15), np.int32)
        cy0, cx0 = 2 * my, 2 * mx
        for ci in range(2):
            for bi, (bx, by) in enumerate(CHROMA_BLOCK_ORDER):
                gy, gx = cy0 + by, cx0 + bx
                if cbp_chroma == 2:
                    na = (int(pic.chroma_counts[ci, gy, gx - 1])
                          if gx > cx0 or a_ok else None) if gx > 0 else None
                    nb = (int(pic.chroma_counts[ci, gy - 1, gx])
                          if gy > cy0 or b_ok else None) if gy > 0 else None
                    coeffs = cavlc.decode_residual(
                        br, cavlc.luma_nc(na, nb), 15)
                    chroma_ac[ci, bi] = coeffs
                    pic.chroma_counts[ci, gy, gx] = sum(
                        1 for c in coeffs if c)
                else:
                    pic.chroma_counts[ci, gy, gx] = 0

        _recon_p_mb(pic, ref, my, mx, mv, luma16, chroma_dc, chroma_ac, qp)
        pic.decoded += 1
        mi += 1


def decode_annexb(stream: bytes) -> DecodedStream:
    """Decode an Annex-B byte stream produced by this package's encoder."""
    sps: SPS | None = None
    pps: PPS | None = None
    frames: list[Frame] = []
    pic: _Picture | None = None
    ref: _RefFrame | None = None

    def finish_picture() -> None:
        nonlocal pic, ref
        if pic is None:
            return
        if pic.decoded != pic.mbw * pic.mbh:
            raise ValueError(
                f"picture ended with {pic.decoded} of "
                f"{pic.mbw * pic.mbh} MBs decoded (missing slice?)")
        if pic.deblock:
            # §8.7 in-loop filter over the whole decoded picture
            # (shifted-plane schedule, codecs/h264/deblock.py): the
            # filtered planes are both the output frame and the next
            # P picture's reference — exactly the encoder's recon
            # carry. Intra prediction inside the picture already ran
            # on unfiltered samples, as the spec requires.
            from .deblock import deblock_frame

            nz4 = None if pic.intra else (pic.luma_counts > 0)
            pic.y, pic.u, pic.v = deblock_frame(
                pic.y, pic.u, pic.v, pic.qp_mb, intra=pic.intra,
                nz4=nz4, mv=None if pic.intra else pic.mv)
        w, h = sps.width, sps.height
        frames.append(Frame(
            pic.y[:h, :w], pic.u[:h // 2, :w // 2],
            pic.v[:h // 2, :w // 2], pts=len(frames)))
        ref = _RefFrame(pic)                  # next P picture's reference
        pic = None

    for nal_ref_idc, nal_type, rbsp in split_annexb(stream):
        if nal_type == NAL_SPS:
            sps = SPS.parse_rbsp(rbsp)
        elif nal_type == NAL_PPS:
            pps = PPS.parse_rbsp(rbsp)
        elif nal_type in (NAL_SLICE_IDR, NAL_SLICE_NON_IDR):
            if sps is None or pps is None:
                raise ValueError("slice before parameter sets")
            br = BitReader(rbsp)
            header = SliceHeader.parse(br, sps, pps, nal_type, nal_ref_idc)
            if header.slice_type not in (SLICE_TYPE_I, SLICE_TYPE_P):
                raise ValueError(
                    f"unsupported slice type {header.slice_type}")
            if header.deblock_idc == 2:
                raise ValueError(
                    "disable_deblocking_filter_idc == 2 (slice-local "
                    "filtering) not supported; this codec emits 0 or 1")
            if header.first_mb == 0:
                finish_picture()              # new access unit
                pic = _Picture(sps)
            elif pic is None:
                raise ValueError("slice with first_mb != 0 opens a picture")
            pic.intra = header.slice_type == SLICE_TYPE_I
            pic.deblock = pic.deblock or header.deblock_idc == 0
            if header.slice_type == SLICE_TYPE_I:
                _decode_islice(br, pic, header)
            else:
                if ref is None:
                    raise ValueError("P slice without a reference frame")
                _decode_pslice(br, pic, header, ref)
    finish_picture()
    if sps is None:
        raise ValueError("no SPS in stream")
    meta = VideoMeta(width=sps.width, height=sps.height,
                     fps_num=sps.fps_num, fps_den=sps.fps_den,
                     num_frames=len(frames), chroma=ChromaFormat.YUV420,
                     codec="h264", size_bytes=len(stream))
    return DecodedStream(meta=meta, frames=frames)
