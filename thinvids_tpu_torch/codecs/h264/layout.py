"""Transfer-layout contract of the sharded GOP encode — host side.

torchinter.encode_gop_planes emits ONE flat int16 vector per GOP (intra
blocked levels followed by P coefficient planes); this module owns the
per-MB sizes of that layout, the zero-copy host inverses (flat transfer
segments → per-slice views), and the COMPACT payload format the device
compaction stage (torchcore._compact_stream) ships over the device→host
link.

Deliberately device-free: the host pack path imports it without
touching torch, and the numpy implementations double as the
no-compiler parity references for the native entries.

Compact payload format (all offsets in bytes, NB = ceil(L / 16) sparse
blocks, nb8 = ceil(NB / 8)):

    [ bitmap      nb8 bytes   1 bit per 16-coeff block (big-endian
                              within bytes, np.unpackbits order)
    | bmask16     2 * nblk    per live block, a little-endian uint16
                              lane-occupancy mask (bit k = coeff k != 0)
    | vals        nval        the nonzero coeffs in (block, lane)
                              order, int8 ]

`used = nb8 + 2 * nblk + nval` bytes carry the whole stream; everything
after is transfer padding (the device buffer is budget-sized, the host
fetches a quantized slice). nblk/nval ride as separate tiny count
arrays, fetched with the device-wait barrier.
"""

from __future__ import annotations

import numpy as np

# Per-MB flat sizes. Intra: luma DC 16 + luma AC 240 + chroma DC 8 +
# chroma AC 120. P plane layout: luma coeff plane 256 + u/v hadamard DC
# 4+4 + u/v AC planes 64+64 (MVs ride separately as int8).
_P_FLAT_MB = 256 + 4 + 4 + 64 + 64        # = 392
_INTRA_FLAT_MB = 384

#: 16-coeff granularity of the block-sparse transfer tiers
SPARSE_BLOCK = 16


def rest_len(num_frames: int, mbw: int, mbh: int) -> int:
    """Coefficient count of the SPARSE remainder of one GOP's flat
    vector: the full layout minus the dense-shipped hadamard DC prefix
    (luma DC nmb*16 + chroma DC nmb*8 — see dispatch._per_gop_sparse)."""
    nmb = mbw * mbh
    return (nmb * (_INTRA_FLAT_MB - 24)
            + (num_frames - 1) * nmb * _P_FLAT_MB)


# ---- compact payload parsing ----------------------------------------------

def split_compact(payload: np.ndarray, nblk: int, nval: int, L: int):
    """Parse one compact payload (>= `used` uint8 bytes) into its
    (bitmap, bmask16, vals) streams. Views where alignment allows; the
    bmask16 lane masks are re-assembled from byte pairs (the payload
    gives them no alignment guarantee — nb8 may be odd)."""
    NB = -(-L // SPARSE_BLOCK)
    nb8 = (NB + 7) // 8
    if L <= 0 or nblk < 0 or nval < 0:
        # fuzz-found (tools/fuzz_native.py): negative slice counts
        # must reject like the native parser, not quietly shrink the
        # streams into a zero decode
        raise ValueError("compact stream counts out of range")
    need = nb8 + 2 * int(nblk) + int(nval)
    payload = np.asarray(payload, np.uint8).reshape(-1)
    if payload.shape[0] < need:
        raise ValueError(
            f"compact payload truncated: {payload.shape[0]} bytes < "
            f"{need} needed for nblk={nblk} nval={nval}")
    bitmap = payload[:nb8]
    mb = payload[nb8:nb8 + 2 * int(nblk)].astype(np.uint16)
    bmask16 = (mb[0::2] | (mb[1::2] << 8)).astype(np.uint16)
    vals = payload[nb8 + 2 * int(nblk):need].view(np.int8)
    return bitmap, bmask16, vals


def block_sparse_unpack2_host(nblk: int, nval: int, bitmap: np.ndarray,
                              bmask16: np.ndarray, vals: np.ndarray,
                              L: int) -> np.ndarray:
    """Numpy inverse of torchcore._block_sparse_pack2 → flat int16 levels
    (the native scatter's parity reference).
    Rejects count/stream disagreement like the native core: corrupt
    counts must fail loudly, not decode as silent zeros."""
    NB = -(-L // SPARSE_BLOCK)
    if L <= 0 or nblk < 0 or nval < 0:
        raise ValueError("sparse stream counts out of range")
    if nblk > np.asarray(bmask16).reshape(-1).shape[0] \
            or nval > np.asarray(vals).reshape(-1).shape[0]:
        raise ValueError("sparse stream counts exceed buffer sizes")
    nb8 = (NB + 7) // 8
    bitmap = np.asarray(bitmap, np.uint8).reshape(-1)
    if bitmap.shape[0] < nb8:
        # fuzz-found: a truncated bitmap must reject like the native
        # wrapper's size validation, not decode short
        raise ValueError("sparse bitmap truncated")
    bits = np.unpackbits(bitmap[:nb8])
    if bits[NB:].any():
        # pack never sets the byte-padding bits past NB; a set one is
        # a corrupt bitmap (the native core's tail scan rejects it too
        # — fuzz-found asymmetry, tools/fuzz_native.py)
        raise ValueError("sparse bitmap padding bits set")
    bm = bits[:NB].astype(bool)
    masks = np.asarray(bmask16)[:nblk].astype(np.uint32)
    lane_bits = ((masks[:, None] >> np.arange(SPARSE_BLOCK, dtype=np.uint32))
                 & 1).astype(bool)                      # (nblk, 16)
    # Explicit count agreement, like the native core's bi/vi checks:
    # numpy's size-1 broadcasting otherwise lets a corrupt nval=1
    # stream silently replicate one value across every live lane
    # (fuzz-found, tools/fuzz_native.py)
    if int(bm.sum()) != int(nblk):
        raise ValueError("sparse bitmap disagrees with nblk")
    if int(lane_bits.sum()) != int(nval):
        raise ValueError("sparse lane masks disagree with nval")
    stream = np.asarray(vals)[:nval].astype(np.int16)
    rows = np.zeros((nblk, SPARSE_BLOCK), np.int16)
    rows[lane_bits] = stream        # row-major = (block, lane) order
    out = np.zeros((NB, SPARSE_BLOCK), np.int16)
    out[bm] = rows
    return out.reshape(-1)[:L]


def unpack_compact_host(payload: np.ndarray, nblk: int, nval: int,
                        L: int) -> np.ndarray:
    """Compact payload → flat int16 levels (numpy fallback for the
    native cavlc_unpack_compact; identical output — tested)."""
    bitmap, bmask16, vals = split_compact(payload, nblk, nval, L)
    return block_sparse_unpack2_host(int(nblk), int(nval), bitmap,
                                     bmask16, vals, L)


def unpack_compact_auto(payload: np.ndarray, nblk: int, nval: int,
                        L: int) -> np.ndarray:
    """Two-tier compact unpack: the native single-pass parse+scatter
    when a compiler exists, :func:`unpack_compact_host` otherwise
    (identical output — tested). The ONE dispatcher shared by the
    in-process collect path (parallel/dispatch) and the pack sidecars
    (parallel/packproc)."""
    from ... import native as native_mod

    if native_mod.available():
        return native_mod.unpack_compact(nblk, nval, payload, L)
    return unpack_compact_host(payload, nblk, nval, L)


# ---- zero-copy unflatten (flat transfer segments → slice views) ------------

def unflatten_intra(seg: np.ndarray, nmb: int):
    """Flat intra segment (nmb * 384, layout il_dc|il_ac|ic_dc|ic_ac) →
    blocked VIEWS. The int16 views feed cavlc_pack_islice16 directly —
    an astype(int32) chain here would allocate ~4 copies of the intra
    levels per GOP on the critical path."""
    o = nmb * 16
    il_dc = seg[:o].reshape(nmb, 16)
    il_ac = seg[o:o + nmb * 240].reshape(nmb, 16, 15)
    o += nmb * 240
    ic_dc = seg[o:o + nmb * 8].reshape(nmb, 2, 4)
    o += nmb * 8
    ic_ac = seg[o:o + nmb * 120].reshape(nmb, 2, 4, 15)
    return il_dc, il_ac, ic_dc, ic_ac


def unflatten_p_planes(seg: np.ndarray, mv8: np.ndarray, num_frames: int,
                       mbw: int, mbh: int):
    """Flat P segment → plane VIEWS (the plane->blocked scan happens
    inside the native packer, cavlc_pack_pslice_plane, so no relayout
    pass runs on the host)."""
    nmb = mbw * mbh
    H, W = mbh * 16, mbw * 16
    hw2 = (H // 2) * (W // 2)
    F1 = num_frames - 1
    o = 0
    lp = seg[o:o + F1 * H * W].reshape(F1, H, W)
    o += F1 * H * W
    udc = seg[o:o + F1 * nmb * 4].reshape(F1, nmb, 4)
    o += F1 * nmb * 4
    vdc = seg[o:o + F1 * nmb * 4].reshape(F1, nmb, 4)
    o += F1 * nmb * 4
    uac = seg[o:o + F1 * hw2].reshape(F1, H // 2, W // 2)
    o += F1 * hw2
    vac = seg[o:o + F1 * hw2].reshape(F1, H // 2, W // 2)
    return (np.asarray(mv8), lp, udc, vdc, uac, vac)


def unflatten_gop(flat: np.ndarray, mv8: np.ndarray, num_frames: int,
                  mbw: int, mbh: int, ships_modes: bool = False):
    """Host inverse of torchinter.encode_gop_planes: split the flat int16
    vector into (intra blocked arrays, P plane views). EVERY array is a
    zero-copy view into `flat`. With `ships_modes` the vector ends in
    the per-MB intra [mode16 | dqp16] side channel, appended to the
    returned intra tuple."""
    nmb = mbw * mbh
    flat = np.asarray(flat)
    o = nmb * _INTRA_FLAT_MB
    intra = unflatten_intra(flat[:o], nmb)
    p_end = flat.shape[0] - (2 * nmb if ships_modes else 0)
    planes = unflatten_p_planes(flat[o:p_end], mv8, num_frames, mbw, mbh)
    if ships_modes:
        intra = intra + (flat[p_end:p_end + nmb], flat[p_end + nmb:])
    return intra, planes


def unflatten_gop_parts(dense: np.ndarray, rest: np.ndarray,
                        mv8: np.ndarray, num_frames: int,
                        mbw: int, mbh: int, ships_modes: bool = False):
    """Sparse-path unflatten straight from the two transfer segments —
    dense = [il_dc | ic_dc] (the hadamard DC prefix, _per_gop_sparse;
    with `ships_modes` also the [mode16 | dqp16] tail, appended to the
    returned intra tuple), rest = [il_ac | ic_ac | P planes] — without
    first concatenating them back into the full flat layout (which
    copied ~25 MB per 1080p GOP). Views only."""
    nmb = mbw * mbh
    ndc, nlac = nmb * 16, nmb * 240
    dense = np.asarray(dense)
    rest = np.asarray(rest)
    il_dc = dense[:ndc].reshape(nmb, 16)
    ic_dc = dense[ndc:ndc + nmb * 8].reshape(nmb, 2, 4)
    il_ac = rest[:nlac].reshape(nmb, 16, 15)
    o = nlac + nmb * 120
    ic_ac = rest[nlac:o].reshape(nmb, 2, 4, 15)
    planes = unflatten_p_planes(rest[o:], mv8, num_frames, mbw, mbh)
    intra = (il_dc, il_ac, ic_dc, ic_ac)
    if ships_modes:
        t = ndc + nmb * 8
        intra = intra + (dense[t:t + nmb], dense[t + nmb:t + 2 * nmb])
    return intra, planes
