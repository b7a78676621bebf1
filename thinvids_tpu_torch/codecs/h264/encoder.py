"""H.264 encoder: the codec surface and its host half.

The per-frame COMPUTE (prediction, forward transform, quantization,
closed-loop reconstruction) runs on the device (torchcore.py,
torchinter.py); this module is the sequential entropy PACK that turns
level arrays into conformant Annex-B slices on the host, the per-GOP
slice-thunk plumbing the dispatcher fans across its pack pool, and the
user-facing encoders: `H264Encoder` / `encode_frames` (all-intra, every
frame IDR) and `encode_gop` (one closed GOP, IDR + P). They take
``device="cuda"`` by default; the reference's numpy compute path
(``use_jax=False``, `encode_frame_arrays`) is not ported.

Device code is imported inside the functions that run it, so the pack
sidecars (parallel/packproc.py) import this module without torch.

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
    `device` (torchcore.build_intra_encoder)."""

    def __init__(self, meta: VideoMeta, qp: int = 27, rd=None,
                 device="cuda"):
        from ...core.devices import resolve_device
        from .rdo import RD_OFF

        self.meta = meta
        self.qp = qp
        self.rd = rd if rd is not None else RD_OFF
        if self.rd.deblock or self.rd.pskip:
            # all-intra scope: no recon chain to filter, no inter MBs to
            # skip — the GOP path carries those features.
            raise ValueError(
                "H264Encoder (all-intra) supports mode_decision/aq "
                "only; deblock/pskip need the GOP path")
        self.device = resolve_device(device)
        self.sps = SPS(width=meta.width, height=meta.height,
                       fps_num=meta.fps_num, fps_den=meta.fps_den)
        self.pps = PPS(init_qp=qp)
        self._fn = None

    def _compute(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
                 ) -> FrameLevels:
        from . import torchcore

        if self._fn is None:
            self._fn = torchcore.build_intra_encoder(
                y.shape, self.qp, self.rd, device=self.device)
        return self._fn(y, u, v)

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
                  device="cuda") -> bytes:
    """Encode a closed sequence of frames to one Annex-B byte stream
    (all-intra: every frame IDR)."""
    enc = H264Encoder(meta, qp=qp, device=device)
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
