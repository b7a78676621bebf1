"""The plain reference that decides a run's `correct`.

It holds an H.264 stream to the source frames it was made from, at the
configuration's QP, and shares no code with the program under test: a
syntax parser for the subset the configurations use (CAVLC, I16x16 and
P_L0_16x16 macroblocks, P_Skip runs, any number of slices a picture), a
NumPy reconstruction (§8.3 intra prediction, §8.4.2.2 half-pel luma and
eighth-pel chroma motion compensation, §8.5 dequantisation and inverse
transform), and the encoder's quantiser as the configuration states it
(§8.5 forward core transform and Hadamards, the JM dead zone: 1/3 of a
step intra, 1/6 inter, at the configured QP).

For every checked picture it rebuilds the prediction the stream selects
from its own reconstruction of the earlier pictures, quantises source
minus prediction, and counts the coefficient levels that differ from the
stream's. The stream's own choices (modes, motion vectors) are free; the
levels given those choices are not. Macroblocks that hold rows or columns
below or right of the visible picture are reconstructed but not counted:
their padding is the encoder's to choose.

The source of the transform and VLC tables: thinvids_tpu_torch/codecs/
h264/transform.py:16-70 and tables.py at commit ae0a2c4, which state the
standard's tables.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .cavlc_tables import (CHROMA_DC_COEFF_TOKEN, COEFF_TOKEN, RUN_BEFORE,
                           TOTAL_ZEROS_4x4, TOTAL_ZEROS_CHROMA_DC)

# ---- §8.5 tables ---------------------------------------------------------

_MF = np.array([[13107, 8066, 5243], [11916, 7490, 4660],
                [10082, 6554, 4194], [9362, 5825, 3647],
                [8192, 5243, 3355], [7282, 4559, 2893]], np.int64)
_V = np.array([[10, 13, 16], [11, 14, 18], [13, 16, 20], [14, 18, 23],
               [16, 20, 25], [18, 23, 29]], np.int64)
_CLS = np.array([[0, 1, 0, 1], [1, 2, 1, 2], [0, 1, 0, 1], [1, 2, 1, 2]])
MF4 = _MF[:, _CLS]                       # (6, 4, 4)
V4 = _V[:, _CLS]
CHROMA_QP = np.array(list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35,
                                        35, 36, 36, 37, 37, 37, 38, 38, 38,
                                        39, 39, 39, 39])
ZIGZAG = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
              np.int64)
H2 = np.array([[1, 1], [1, -1]], np.int64)
#: (x, y) of the 4x4 luma blocks in decoding order (8x8 quadrants in z
#: order, then z order inside each)
LUMA_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
              (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]
CHROMA_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1)]
#: Table 9-4, ChromaArrayType 1, inter: codeNum -> coded_block_pattern
CBP_INTER = [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
             14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
             17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]
MC_PAD, MC_PAD_C = 24, 12
NAL_IDR, NAL_SLICE, NAL_SPS, NAL_PPS = 5, 1, 7, 8


def _lut(codes, width):
    """A lookup list over every `width`-bit window: (length, *key)."""
    out = [None] * (1 << width)
    for key, (ln, bits) in codes:
        start = bits << (width - ln)
        n = 1 << (width - ln)
        out[start:start + n] = [(ln,) + key] * n
    return out


_TOKEN = [_lut(t.items(), 16) for t in COEFF_TOKEN]
_TOKEN_CDC = _lut(CHROMA_DC_COEFF_TOKEN.items(), 16)
_TZ = {tc: _lut([((tz,), c) for tz, c in enumerate(v)], 9)
       for tc, v in TOTAL_ZEROS_4x4.items()}
_TZ_CDC = {tc: _lut([((tz,), c) for tz, c in enumerate(v)], 3)
           for tc, v in TOTAL_ZEROS_CHROMA_DC.items()}
_RB = {zl: _lut([((r,), c) for r, c in enumerate(v)], 11)
       for zl, v in RUN_BEFORE.items()}


#: bytes of a slice NAL that hold its header (a few dozen at most)
HEADER_BYTES = 64


class StreamError(ValueError):
    """The stream breaks the syntax or the configuration's subset."""


# ---- bits ------------------------------------------------------------------

_EMULATION = re.compile(rb"\x00\x00\x03(?=[\x00-\x03])")


def nal_units(stream: bytes) -> list[tuple[int, int, bytes]]:
    """(nal_ref_idc, nal_unit_type, rbsp) of each Annex-B NAL unit."""
    starts = []
    i = stream.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = stream.find(b"\x00\x00\x01", i + 3)
    out = []
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else len(stream)
        while k + 1 < len(starts) and e > s and stream[e - 1] == 0:
            e -= 1
        if e > s:
            h = stream[s]
            out.append(((h >> 5) & 3, h & 31,
                        _EMULATION.sub(b"\x00\x00", stream[s + 1:e])))
    return out


class Bits:
    """MSB-first reader over an RBSP held as a string of '0'/'1'."""

    def __init__(self, rbsp: bytes) -> None:
        n = 8 * len(rbsp)
        self.s = format(int.from_bytes(rbsp, "big"), f"0{n}b") + "0" * 64
        self.p = 0
        stop = self.s.rfind("1", 0, n)
        if stop < 0:
            raise StreamError("RBSP without a stop bit")
        self.stop = stop

    def u(self, n: int) -> int:
        p = self.p
        self.p = p + n
        return int(self.s[p:p + n], 2) if n else 0

    def ue(self) -> int:
        p = self.p
        q = self.s.find("1", p, p + 33)
        if q < 0:
            raise StreamError("Exp-Golomb code too long")
        z = q - p
        self.p = q + 1 + z
        return int(self.s[p:q + 1 + z], 2) - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def more(self) -> bool:
        return self.p < self.stop

    def residual(self, nc: int, maxc: int):
        """One CAVLC residual block (§9.2): (total_coeff, coefficients in
        scan order, or None when there are none)."""
        s, p = self.s, self.p
        if nc < 0:
            ent = _TOKEN_CDC[int(s[p:p + 16], 2)]
        else:
            ent = _TOKEN[0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8
                         else 3][int(s[p:p + 16], 2)]
        if ent is None:
            raise StreamError("invalid coeff_token")
        ln, tc, t1 = ent
        p += ln
        if tc == 0:
            self.p = p
            return 0, None
        if tc > maxc:
            raise StreamError("total_coeff beyond the block")
        levels = []
        for _ in range(t1):
            levels.append(-1 if s[p] == "1" else 1)
            p += 1
        sl = 1 if (tc > 10 and t1 < 3) else 0
        for i in range(tc - t1):
            q = s.find("1", p, p + 16)
            if q < 0:
                raise StreamError("level_prefix beyond 15")
            prefix = q - p
            p = q + 1
            if sl == 0:
                if prefix < 14:
                    code = prefix
                elif prefix == 14:
                    code = 14 + int(s[p:p + 4], 2)
                    p += 4
                else:
                    code = 30 + int(s[p:p + 12], 2)
                    p += 12
            elif prefix < 15:
                code = (prefix << sl) + int(s[p:p + sl], 2)
                p += sl
            else:
                code = (15 << sl) + int(s[p:p + 12], 2)
                p += 12
            if i == 0 and t1 < 3:
                code += 2
            lev = (code >> 1) + 1
            if code & 1:
                lev = -lev
            levels.append(lev)
            if sl == 0:
                sl = 1
            if abs(lev) > (3 << (sl - 1)) and sl < 6:
                sl += 1
        tz = 0
        if tc < maxc:
            ent = (_TZ_CDC[tc][int(s[p:p + 3], 2)] if nc < 0
                   else _TZ[tc][int(s[p:p + 9], 2)])
            if ent is None:
                raise StreamError("invalid total_zeros")
            p += ent[0]
            tz = ent[1]
        if tc + tz > maxc:
            raise StreamError("coefficients beyond the block")
        coeffs = [0] * maxc
        pos = tc + tz - 1
        zl = tz
        for i in range(tc):
            coeffs[pos] = levels[i]
            if i == tc - 1:
                break
            if zl > 0:
                ent = _RB[min(zl, 7)][int(s[p:p + 11], 2)]
                if ent is None or ent[1] > zl:
                    raise StreamError("invalid run_before")
                p += ent[0]
                zl -= ent[1]
                pos -= 1 + ent[1]
            else:
                pos -= 1
        self.p = p
        return tc, coeffs


# ---- parameter sets and slice headers (§7.3) ---------------------------------

@dataclasses.dataclass
class Sps:
    mbw: int
    mbh: int
    width: int
    height: int
    log2_max_frame_num: int
    poc_type: int
    log2_max_poc_lsb: int


def parse_sps(rbsp: bytes) -> Sps:
    b = Bits(rbsp)
    profile = b.u(8)
    b.u(16)
    b.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        if b.ue() != 1:
            raise StreamError("chroma format other than 4:2:0")
        b.ue()
        b.ue()
        b.u(1)
        if b.u(1):
            raise StreamError("scaling matrices")
    log2_mfn = b.ue() + 4
    poc_type = b.ue()
    log2_poc = 0
    if poc_type == 0:
        log2_poc = b.ue() + 4
    elif poc_type == 1:
        raise StreamError("pic_order_cnt_type 1")
    b.ue()
    b.u(1)
    mbw = b.ue() + 1
    mbh = b.ue() + 1
    if not b.u(1):
        raise StreamError("field coding")
    b.u(1)
    w, h = 16 * mbw, 16 * mbh
    if b.u(1):
        cl, cr, ct, cb = b.ue(), b.ue(), b.ue(), b.ue()
        w -= 2 * (cl + cr)
        h -= 2 * (ct + cb)
    return Sps(mbw, mbh, w, h, log2_mfn, poc_type, log2_poc)


def parse_pps(rbsp: bytes) -> dict:
    b = Bits(rbsp)
    b.ue()
    b.ue()
    if b.u(1):
        raise StreamError("CABAC")
    pic_order_present = b.u(1)
    if b.ue() != 0:
        raise StreamError("slice groups")
    if b.ue() != 0 or b.ue() != 0:
        raise StreamError("more than one reference index")
    if b.u(1) or b.u(2):
        raise StreamError("weighted prediction")
    init_qp = 26 + b.se()
    b.se()
    if b.se() != 0:
        raise StreamError("chroma_qp_index_offset")
    dbc = b.u(1)
    if b.u(1):
        raise StreamError("constrained intra prediction")
    if b.u(1):
        raise StreamError("redundant pictures")
    return {"init_qp": init_qp, "deblock_control": dbc,
            "pic_order_present": pic_order_present}


def parse_slice_header(b: Bits, sps: Sps, pps: dict, nal_type: int,
                       ref_idc: int) -> dict:
    first_mb = b.ue()
    st = b.ue() % 5
    if st not in (0, 2):
        raise StreamError(f"slice type {st}")
    b.ue()
    frame_num = b.u(sps.log2_max_frame_num)
    idr = nal_type == NAL_IDR
    if idr:
        b.ue()
    if sps.poc_type == 0:
        b.u(sps.log2_max_poc_lsb)
        if pps["pic_order_present"]:
            b.se()
    if st == 0:
        if b.u(1):
            if b.ue() != 0:
                raise StreamError("more than one reference")
        if b.u(1):
            raise StreamError("reference list modification")
    if ref_idc:
        if idr:
            b.u(2)
        elif b.u(1):
            raise StreamError("adaptive reference marking")
    qp = pps["init_qp"] + b.se()
    deblock = 0
    if pps["deblock_control"]:
        idc = b.ue()
        if idc != 1:
            b.se()
            b.se()
        deblock = int(idc != 1)
    return {"first_mb": first_mb, "intra": st == 2, "qp": qp,
            "frame_num": frame_num, "idr": idr, "deblock": deblock}


# ---- one picture's syntax ----------------------------------------------------

def _nc(counts, gy, gx, y0, x0, a_ok, b_ok):
    """nC of a block from its left and top neighbours (§9.2.1); a
    neighbour in another slice or outside the picture is unavailable."""
    na = counts[gy][gx - 1] if gx > x0 or (a_ok and gx > 0) else None
    nb = counts[gy - 1][gx] if gy > y0 or (b_ok and gy > 0) else None
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    return na if na is not None else (nb if nb is not None else 0)


class Picture:
    """The syntax of one coded picture: per macroblock its prediction
    (modes or motion), QP and levels, and the slice it lies in."""

    def __init__(self, sps: Sps) -> None:
        self.mbw, self.mbh = sps.mbw, sps.mbh
        n = sps.mbw * sps.mbh
        self.intra = None
        self.slice_first = np.full(n, -1, np.int64)
        self.qp = np.zeros(n, np.int64)
        self.luma_mode = np.zeros(n, np.int64)
        self.chroma_mode = np.zeros(n, np.int64)
        self.mv = [[0, 0] for _ in range(n)]            # (dy, dx) half-pel
        self.dc = np.zeros((n, 16), np.int64)           # I16x16 luma DC
        self.luma = np.zeros((n, 16, 16), np.int64)     # block order, scan
        self.cdc = np.zeros((n, 2, 4), np.int64)
        self.cac = np.zeros((n, 2, 4, 16), np.int64)    # scan, [0] unused
        self.lcount = [[0] * (4 * sps.mbw) for _ in range(4 * sps.mbh)]
        self.ccount = [[[0] * (2 * sps.mbw) for _ in range(2 * sps.mbh)]
                       for _ in range(2)]
        self.slices = []

    def add_slice(self, b: Bits, hdr: dict) -> None:
        if self.intra is None:
            self.intra = hdr["intra"]
        elif self.intra != hdr["intra"]:
            raise StreamError("I and P slices in one picture")
        if hdr["deblock"]:
            raise StreamError("deblocking filter on: the configuration "
                              "states it off")
        self.slices.append(hdr)
        (self._islice if hdr["intra"] else self._pslice)(b, hdr)

    def _residuals(self, b, mi, my, mx, first, luma_sizes, cbp_luma,
                   cbp_chroma):
        mbw = self.mbw
        a_ok = mx > 0 and mi - 1 >= first
        b_ok = my > 0 and mi - mbw >= first
        y0, x0 = 4 * my, 4 * mx
        lc = self.lcount
        for bi, (bx, by) in enumerate(LUMA_ORDER):
            gy, gx = y0 + by, x0 + bx
            if cbp_luma & (1 << (bi >> 2)):
                tc, co = b.residual(_nc(lc, gy, gx, y0, x0, a_ok, b_ok),
                                    luma_sizes)
                lc[gy][gx] = tc
                if co is not None:
                    self.luma[mi, bi, 16 - luma_sizes:] = co
            else:
                lc[gy][gx] = 0
        if cbp_chroma:
            for ci in range(2):
                _, co = b.residual(-1, 4)
                if co is not None:
                    self.cdc[mi, ci] = co
        cy0, cx0 = 2 * my, 2 * mx
        for ci in range(2):
            cc = self.ccount[ci]
            for bi, (bx, by) in enumerate(CHROMA_ORDER):
                gy, gx = cy0 + by, cx0 + bx
                if cbp_chroma == 2:
                    tc, co = b.residual(
                        _nc(cc, gy, gx, cy0, cx0, a_ok, b_ok), 15)
                    cc[gy][gx] = tc
                    if co is not None:
                        self.cac[mi, ci, bi, 1:] = co
                else:
                    cc[gy][gx] = 0

    def _islice(self, b: Bits, hdr: dict) -> None:
        mbw, n = self.mbw, self.mbw * self.mbh
        first, qp, mi = hdr["first_mb"], hdr["qp"], hdr["first_mb"]
        while mi < n and b.more():
            if self.slice_first[mi] >= 0:
                raise StreamError("macroblock coded twice")
            my, mx = divmod(mi, mbw)
            t = b.ue()
            if not 1 <= t <= 24:
                raise StreamError(f"I mb_type {t} outside I16x16")
            self.luma_mode[mi] = (t - 1) % 4
            cbp_chroma = ((t - 1) // 4) % 3
            cbp_luma = 15 if t >= 13 else 0
            self.chroma_mode[mi] = b.ue()
            qp += b.se()
            self.qp[mi] = qp
            self.slice_first[mi] = first
            a_ok = mx > 0 and mi - 1 >= first
            b_ok = my > 0 and mi - mbw >= first
            _, co = b.residual(_nc(self.lcount, 4 * my, 4 * mx, 4 * my,
                                   4 * mx, a_ok, b_ok), 16)
            if co is not None:
                self.dc[mi] = co
            self._residuals(b, mi, my, mx, first, 15, cbp_luma, cbp_chroma)
            mi += 1

    def _mvp(self, mi, my, mx, first):
        """(mvp, skip mv) of MB mi: §8.4.1.3 median prediction with the C
        to D fallback, and §8.4.1.1 P_Skip inference, inside the slice."""
        mbw, mv = self.mbw, self.mv
        zero = [0, 0]
        a = mx > 0 and mi - 1 >= first
        b = my > 0 and mi - mbw >= first
        mva = mv[mi - 1] if a else zero
        mvb = mv[mi - mbw] if b else zero
        if my > 0 and mx + 1 < mbw and mi - mbw + 1 >= first:
            c, mvc = True, mv[mi - mbw + 1]
        elif my > 0 and mx > 0 and mi - mbw - 1 >= first:
            c, mvc = True, mv[mi - mbw - 1]
        else:
            c, mvc = False, zero
        if a and not b and not c:
            p = mva
        elif a + b + c == 1:
            p = mva if a else (mvb if b else mvc)
        else:
            p = [sorted((mva[k], mvb[k], mvc[k]))[1] for k in (0, 1)]
        skip = zero if (not a or not b or mva == zero or mvb == zero) else p
        return list(p), list(skip)

    def _pslice(self, b: Bits, hdr: dict) -> None:
        mbw, n = self.mbw, self.mbw * self.mbh
        first, qp, mi = hdr["first_mb"], hdr["qp"], hdr["first_mb"]
        while mi < n and b.more():
            run = b.ue()
            for _ in range(run):
                if mi >= n or self.slice_first[mi] >= 0:
                    raise StreamError("mb_skip_run past the picture")
                my, mx = divmod(mi, mbw)
                self.mv[mi] = self._mvp(mi, my, mx, first)[1]
                self.qp[mi] = qp
                self.slice_first[mi] = first
                mi += 1
            if mi >= n or not b.more():
                break
            if self.slice_first[mi] >= 0:
                raise StreamError("macroblock coded twice")
            my, mx = divmod(mi, mbw)
            t = b.ue()
            if t != 0:
                raise StreamError(f"P mb_type {t} other than P_L0_16x16")
            mvd_x, mvd_y = b.se(), b.se()
            if (mvd_x | mvd_y) & 1:
                raise StreamError("quarter-pel motion")
            p, _ = self._mvp(mi, my, mx, first)
            self.mv[mi] = [p[0] + mvd_y // 2, p[1] + mvd_x // 2]
            code = b.ue()
            if code >= 48:
                raise StreamError("coded_block_pattern")
            cbp = CBP_INTER[code]
            if cbp:
                qp += b.se()
            self.qp[mi] = qp
            self.slice_first[mi] = first
            self._residuals(b, mi, my, mx, first, 16, cbp & 15, cbp >> 4)
            mi += 1


# ---- transforms, vectorised --------------------------------------------------

def _fwd1(x, axis):
    """The core transform's butterflies along one axis of (..., 4, 4)."""
    x0, x1, x2, x3 = (np.take(x, k, axis=axis) for k in range(4))
    s03, d03, s12, d12 = x0 + x3, x0 - x3, x1 + x2, x1 - x2
    return np.stack([s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12],
                    axis=axis)


def _fwd(x):
    """Forward core transform Cf X Cf^T over (..., 4, 4)."""
    return _fwd1(_fwd1(x, -2), -1)


def _inv(d):
    """§8.5.12.2 inverse core transform, then (r + 32) >> 6."""
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    g0, g1, g2, g3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    h0, h1 = g0 + g2, g0 - g2
    h2, h3 = (g1 >> 1) - g3, g1 + (g3 >> 1)
    return (np.stack([h0 + h3, h1 + h2, h1 - h2, h0 - h3], axis=-2) + 32) >> 6


def _quant4(w, qp, intra):
    """4x4 quantisation of w (n, k, 4, 4) at per-row QPs qp (n,)."""
    q = qp[:, None, None, None]
    qbits = 15 + q // 6
    f = (np.int64(1) << qbits) // (3 if intra else 6)
    z = (np.abs(w) * MF4[qp % 6][:, None] + f) >> qbits
    return np.where(w < 0, -z, z)


def _quant_dc(w, qp, intra):
    """DC quantisation (|W| MF00 + 2f) >> (qbits + 1) of w (n, ...)."""
    q = qp.reshape((-1,) + (1,) * (w.ndim - 1))
    qbits = 15 + q // 6
    f = (np.int64(1) << qbits) // (3 if intra else 6)
    z = (np.abs(w) * MF4[q % 6, 0, 0] + 2 * f) >> (qbits + 1)
    return np.where(w < 0, -z, z)


def _dequant4(z, qp):
    """z (n, k, 4, 4) * V << qp//6 at per-row QPs."""
    q = qp[:, None, None, None]
    return (z * V4[qp % 6][:, None]) << (q // 6)


def _unscan(seq):
    """(..., 16) in scan order -> (..., 4, 4)."""
    out = np.zeros_like(seq)
    out[..., ZIGZAG] = seq
    return out.reshape(seq.shape[:-1] + (4, 4))


def _scan(blk):
    return blk.reshape(blk.shape[:-2] + (16,))[..., ZIGZAG]


def _blocks(mb, size):
    """(n, size, size) -> (n, k, 4, 4) in LUMA_ORDER (16) or CHROMA_ORDER."""
    order = LUMA_ORDER if size == 16 else CHROMA_ORDER
    return np.stack([mb[:, 4 * y:4 * y + 4, 4 * x:4 * x + 4]
                     for x, y in order], axis=1)


def _unblocks(blk, size):
    order = LUMA_ORDER if size == 16 else CHROMA_ORDER
    out = np.empty((blk.shape[0], size, size), blk.dtype)
    for k, (x, y) in enumerate(order):
        out[:, 4 * y:4 * y + 4, 4 * x:4 * x + 4] = blk[:, k]
    return out


def _chroma_residual(cdc, cac, qpc):
    """(n, 8, 8) chroma residual of one plane from DC (n, 4) and AC
    (n, 4, 16) levels (§8.5.11)."""
    f = np.einsum("ij,njk,lk->nil", H2, cdc.reshape(-1, 2, 2), H2)
    q = qpc[:, None, None]
    dcr = ((f * 16 * V4[qpc % 6, 0, 0][:, None, None]) << (q // 6)) >> 5
    d = _dequant4(_unscan(cac), qpc)
    d[:, :, 0, 0] = dcr.reshape(-1, 4)
    return _unblocks(_inv(d), 8)


def _intra_luma_residual(dc, ac, qp):
    """(n, 16, 16) I16x16 luma residual from DC (n, 16) and AC (n, 16, 16)
    levels (§8.5.10)."""
    c = np.einsum("ij,njk,lk->nil", H4, _unscan(dc), H4)
    q = qp[:, None, None]
    ls = V4[qp % 6, 0, 0][:, None, None] * 16
    hi = (c * ls) << np.maximum(q // 6 - 6, 0)
    lo_shift = np.maximum(6 - q // 6, 1)
    lo = (c * ls + (np.int64(1) << (lo_shift - 1))) >> lo_shift
    dcr = np.where(q >= 36, hi, lo)                      # (n, 4, 4) [y, x]
    d = _dequant4(_unscan(ac), qp)
    for k, (x, y) in enumerate(LUMA_ORDER):
        d[:, k, 0, 0] = dcr[:, y, x]
    return _unblocks(_inv(d), 16)


# ---- prediction --------------------------------------------------------------

def _tap6(x, axis):
    r = lambda k: np.roll(x, k, axis=axis)  # noqa: E731
    return r(2) - 5 * r(1) + 20 * x + 20 * r(-1) - 5 * r(-2) + r(-3)


def _inter_pred(ref, mv, mbw, mbh):
    """(luma (n, 16, 16), u, v (n, 8, 8)) predictions of every MB of a P
    picture from the reference planes and half-pel vectors (n, 2)."""
    y, u, v = ref
    r = np.pad(y.astype(np.int64), MC_PAD, mode="edge")
    hb = _tap6(r, 1)
    planes = np.stack([r, np.clip((hb + 16) >> 5, 0, 255),
                       np.clip((_tap6(r, 0) + 16) >> 5, 0, 255),
                       np.clip((_tap6(hb, 0) + 512) >> 10, 0, 255)])
    my, mx = np.divmod(np.arange(mbw * mbh), mbw)
    dy, dx = mv[:, 0], mv[:, 1]
    idx = ((dy & 1) * 2 + (dx & 1))[:, None, None]
    ar16 = np.arange(16)
    rows = (MC_PAD + 16 * my + (dy >> 1))[:, None, None] + ar16[None, :, None]
    cols = (MC_PAD + 16 * mx + (dx >> 1))[:, None, None] + ar16[None, None, :]
    luma = planes[idx, rows, cols]
    ey, ex = ((dy & 3) * 2)[:, None, None], ((dx & 3) * 2)[:, None, None]
    ar8 = np.arange(8)
    r0 = (MC_PAD_C + 8 * my + (dy >> 2))[:, None, None] + ar8[None, :, None]
    c0 = (MC_PAD_C + 8 * mx + (dx >> 2))[:, None, None] + ar8[None, None, :]
    out = [luma]
    for c in (u, v):
        cp = np.pad(c.astype(np.int64), MC_PAD_C, mode="edge")
        out.append(((8 - ex) * (8 - ey) * cp[r0, c0]
                    + ex * (8 - ey) * cp[r0, c0 + 1]
                    + (8 - ex) * ey * cp[r0 + 1, c0]
                    + ex * ey * cp[r0 + 1, c0 + 1] + 32) >> 6)
    return tuple(out)


def _pred16(mode, top, left, tl):
    if mode == 0:
        if top is None:
            raise StreamError("vertical prediction without a top")
        return np.broadcast_to(top, (16, 16))
    if mode == 1:
        if left is None:
            raise StreamError("horizontal prediction without a left")
        return np.broadcast_to(left[:, None], (16, 16))
    if mode == 2:
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif top is not None or left is not None:
            dc = (int((top if top is not None else left).sum()) + 8) >> 4
        else:
            dc = 128
        return np.full((16, 16), dc, np.int64)
    if top is None or left is None or tl is None:
        raise StreamError("plane prediction without its neighbours")
    xs = np.arange(1, 9)
    h = int(xs @ (top[8:16] - np.concatenate(([tl], top[0:7]))[::-1]))
    v = int(xs @ (left[8:16] - np.concatenate(([tl], left[0:7]))[::-1]))
    a = 16 * (int(left[15]) + int(top[15]))
    b, c = (5 * h + 32) >> 6, (5 * v + 32) >> 6
    yy, xx = np.mgrid[0:16, 0:16]
    return np.clip((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5, 0, 255)


def _pred8(mode, top, left, tl):
    if mode == 2:
        if top is None:
            raise StreamError("vertical chroma prediction without a top")
        return np.broadcast_to(top, (8, 8))
    if mode == 1:
        if left is None:
            raise StreamError("horizontal chroma prediction without a left")
        return np.broadcast_to(left[:, None], (8, 8))
    if mode == 0:
        out = np.empty((8, 8), np.int64)
        for bx, by in CHROMA_ORDER:
            t = top[4 * bx:4 * bx + 4] if top is not None else None
            lf = left[4 * by:4 * by + 4] if left is not None else None
            own_top = (bx, by) == (1, 0)
            own_left = (bx, by) == (0, 1)
            if t is not None and lf is not None and not (own_top or
                                                         own_left):
                dc = (int(t.sum()) + int(lf.sum()) + 4) >> 3
            elif own_left and lf is not None:
                dc = (int(lf.sum()) + 2) >> 2
            elif t is not None:
                dc = (int(t.sum()) + 2) >> 2
            elif lf is not None:
                dc = (int(lf.sum()) + 2) >> 2
            else:
                dc = 128
            out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = dc
        return out
    if top is None or left is None or tl is None:
        raise StreamError("plane chroma prediction without its neighbours")
    xs = np.arange(1, 5)
    h = int(xs @ (top[4:8] - np.concatenate(([tl], top[0:3]))[::-1]))
    v = int(xs @ (left[4:8] - np.concatenate(([tl], left[0:3]))[::-1]))
    a = 16 * (int(left[7]) + int(top[7]))
    b, c = (34 * h + 32) >> 6, (34 * v + 32) >> 6
    yy, xx = np.mgrid[0:8, 0:8]
    return np.clip((a + b * (xx - 3) + c * (yy - 3) + 16) >> 5, 0, 255)


# ---- the check -----------------------------------------------------------------

def _mb_planes(plane, size):
    h, w = plane.shape
    return (plane.reshape(h // size, size, w // size, size).swapaxes(1, 2)
            .reshape(-1, size, size))


def _from_mbs(mbs, mbh, mbw, size):
    return (mbs.reshape(mbh, mbw, size, size).swapaxes(1, 2)
            .reshape(mbh * size, mbw * size))


def _pad_source(frame, mbh, mbw):
    """The source planes edge-replicated to the coded size."""
    y, u, v = frame
    return tuple(np.pad(np.asarray(p, np.int64),
                        ((0, s * mbh - p.shape[0]), (0, s * mbw - p.shape[1])),
                        mode="edge")
                 for p, s in ((y, 16), (u, 8), (v, 8)))


def _reconstruct_intra(pic: Picture, res_y, res_u, res_v):
    """Recon planes and per-MB predictions of an I picture: rows whose MBs
    all predict vertically from the same slice go at once, the rest MB by
    MB."""
    mbw, mbh = pic.mbw, pic.mbh
    Y = np.zeros((16 * mbh, 16 * mbw), np.int64)
    U = np.zeros((8 * mbh, 8 * mbw), np.int64)
    V = np.zeros_like(U)
    n = mbw * mbh
    pred_y = np.zeros((n, 16, 16), np.int64)
    pred_c = np.zeros((n, 2, 8, 8), np.int64)
    for my in range(mbh):
        row = slice(my * mbw, (my + 1) * mbw)
        mi0 = my * mbw
        fast = (my > 0 and np.all(pic.luma_mode[row] == 0)
                and np.all(pic.chroma_mode[row] == 2)
                and np.all(pic.slice_first[row] <= mi0 - mbw))
        if fast:
            top = Y[16 * my - 1].reshape(mbw, 16)
            pred_y[row] = top[:, None, :]
            for ci, P in enumerate((U, V)):
                pred_c[row, ci] = P[8 * my - 1].reshape(mbw, 8)[:, None, :]
            Y[16 * my:16 * my + 16] = _from_mbs(
                np.clip(pred_y[row] + res_y[row], 0, 255), 1, mbw, 16)
            for ci, (P, R) in enumerate(((U, res_u), (V, res_v))):
                P[8 * my:8 * my + 8] = _from_mbs(
                    np.clip(pred_c[row, ci] + R[row], 0, 255), 1, mbw, 8)
            continue
        for mx in range(mbw):
            mi = mi0 + mx
            first = pic.slice_first[mi]
            a = mx > 0 and mi - 1 >= first
            b = my > 0 and mi - mbw >= first
            d = a and b and mi - mbw - 1 >= first
            ys, xs = 16 * my, 16 * mx
            p = _pred16(int(pic.luma_mode[mi]),
                        Y[ys - 1, xs:xs + 16] if b else None,
                        Y[ys:ys + 16, xs - 1] if a else None,
                        int(Y[ys - 1, xs - 1]) if d else None)
            pred_y[mi] = p
            Y[ys:ys + 16, xs:xs + 16] = np.clip(p + res_y[mi], 0, 255)
            cs, cx = 8 * my, 8 * mx
            for ci, (P, R) in enumerate(((U, res_u), (V, res_v))):
                p = _pred8(int(pic.chroma_mode[mi]),
                           P[cs - 1, cx:cx + 8] if b else None,
                           P[cs:cs + 8, cx - 1] if a else None,
                           int(P[cs - 1, cx - 1]) if d else None)
                pred_c[mi, ci] = p
                P[cs:cs + 8, cx:cx + 8] = np.clip(p + R[mi], 0, 255)
    return (Y, U, V), pred_y, pred_c


def check_picture(pic: Picture, ref, source, qp_cfg: int, height: int,
                  width: int):
    """Reconstruct one parsed picture and count its levels that differ
    from the quantised source at `qp_cfg`. Returns (recon planes,
    mismatched levels, levels compared)."""
    n = pic.mbw * pic.mbh
    if np.any(pic.slice_first < 0):
        raise StreamError("picture with macroblocks in no slice")
    qpc = CHROMA_QP[np.clip(pic.qp, 0, 51)]
    res_u = _chroma_residual(pic.cdc[:, 0], pic.cac[:, 0], qpc)
    res_v = _chroma_residual(pic.cdc[:, 1], pic.cac[:, 1], qpc)
    if pic.intra:
        res_y = _intra_luma_residual(pic.dc, pic.luma, pic.qp)
        recon, pred_y, pred_c = _reconstruct_intra(pic, res_y, res_u, res_v)
        pred_u, pred_v = pred_c[:, 0], pred_c[:, 1]
    else:
        if ref is None:
            raise StreamError("P picture without a reference")
        mv = np.asarray(pic.mv, np.int64)
        pred_y, pred_u, pred_v = _inter_pred(ref, mv, pic.mbw, pic.mbh)
        d = _dequant4(_unscan(pic.luma), pic.qp)
        res_y = _unblocks(_inv(d), 16)
        recon = tuple(_from_mbs(np.clip(p + r, 0, 255), pic.mbh, pic.mbw, s)
                      for p, r, s in ((pred_y, res_y, 16), (pred_u, res_u, 8),
                                      (pred_v, res_v, 8)))
    src = _pad_source(source, pic.mbh, pic.mbw)
    q = np.full(n, qp_cfg, np.int64)
    qc = np.full(n, CHROMA_QP[qp_cfg], np.int64)
    intra = bool(pic.intra)
    w = _fwd(_blocks(_mb_planes(src[0], 16) - pred_y, 16))
    if intra:
        dcm = np.zeros((n, 4, 4), np.int64)
        for k, (x, y) in enumerate(LUMA_ORDER):
            dcm[:, y, x] = w[:, k, 0, 0]
        wd = np.einsum("ij,njk,lk->nil", H4, dcm, H4) // 2
        got = [(_scan(_quant_dc(wd, q, True)), pic.dc)]
        z = _quant4(w, q, True)
        z[:, :, 0, 0] = 0
        got.append((_scan(z), pic.luma))
    else:
        got = [(_scan(_quant4(w, q, False)), pic.luma)]
    for ci, (plane, pred) in enumerate(((src[1], pred_u), (src[2], pred_v))):
        wc = _fwd(_blocks(_mb_planes(plane, 8) - pred, 8))
        wdc = np.einsum("ij,njk,lk->nil", H2,
                        wc[:, :, 0, 0].reshape(-1, 2, 2), H2).reshape(-1, 4)
        got.append((_quant_dc(wdc, qc, intra), pic.cdc[:, ci]))
        z = _quant4(wc, qc, intra)
        z[:, :, 0, 0] = 0
        got.append((_scan(z), pic.cac[:, ci]))
    my, mx = np.divmod(np.arange(n), pic.mbw)
    inside = (16 * (my + 1) <= height) & (16 * (mx + 1) <= width)
    bad = sum(int(np.count_nonzero((a != b).reshape(n, -1)[inside]))
              for a, b in got)
    compared = sum(int(a.reshape(n, -1)[inside].size) for a, _ in got)
    return recon, bad, compared


@dataclasses.dataclass
class StreamCheck:
    pictures: int = 0
    checked: int = 0
    mismatched_levels: int = 0
    levels_compared: int = 0
    qp_off: int = 0
    errors: list = dataclasses.field(default_factory=list)


def check_stream(stream: bytes, sources, qp_cfg: int, first: int = 0,
                 count: int | None = None) -> StreamCheck:
    """Hold pictures first .. first + count - 1 of an Annex-B stream
    (picture `first` an IDR picture, as a GOP starts) to `sources`, a
    callable that gives the (y, u, v) planes of picture i, at the
    configuration's QP. The other pictures are counted, and their slices'
    QPs read, but not parsed; every slice's QP must be `qp_cfg`."""
    out = StreamCheck()
    sps = pps = None
    pic = ref = None
    last = None if count is None else first + count

    def finish():
        nonlocal pic, ref
        if pic is None:
            return
        recon, bad, cmp_ = check_picture(pic, ref,
                                         sources(out.pictures - 1), qp_cfg,
                                         sps.height, sps.width)
        ref = recon
        out.mismatched_levels += bad
        out.levels_compared += cmp_
        out.checked += 1
        pic = None

    try:
        for ref_idc, typ, rbsp in nal_units(stream):
            if typ == NAL_SPS:
                sps = parse_sps(rbsp)
            elif typ == NAL_PPS:
                pps = parse_pps(rbsp)
            elif typ in (NAL_IDR, NAL_SLICE):
                if sps is None or pps is None:
                    raise StreamError("slice before the parameter sets")
                # the header alone from a prefix: a picture that is not
                # checked is never turned into bits whole
                hdr = parse_slice_header(Bits(rbsp[:HEADER_BYTES]), sps, pps,
                                         typ, ref_idc)
                if hdr["first_mb"] == 0:
                    finish()
                    out.pictures += 1
                    if (first < out.pictures
                            and (last is None or out.pictures <= last)):
                        if out.checked == 0 and typ != NAL_IDR:
                            raise StreamError("the first checked picture "
                                              "is not an IDR picture")
                        pic = Picture(sps)
                if hdr["qp"] != qp_cfg:
                    out.qp_off += 1
                if pic is not None:
                    if typ == NAL_IDR and hdr["first_mb"] == 0:
                        ref = None
                    b = Bits(rbsp)
                    parse_slice_header(b, sps, pps, typ, ref_idc)
                    pic.add_slice(b, hdr)
        finish()
    except (StreamError, IndexError, KeyError, TypeError,
            ValueError) as exc:
        out.errors.append(f"{type(exc).__name__}: {exc}")
    return out


def picture_slices(stream: bytes) -> list[int]:
    """The number of slices of each coded picture of an Annex-B stream,
    in order (a picture starts at its slice with first_mb 0)."""
    out: list[int] = []
    for _, typ, rbsp in nal_units(stream):
        if typ not in (NAL_IDR, NAL_SLICE):
            continue
        if Bits(rbsp[:16]).ue() == 0:
            out.append(1)
        elif out:
            out[-1] += 1
        else:
            raise StreamError("a slice before the first picture's first")
    return out
