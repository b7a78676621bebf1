"""Intra prediction (H.264 §8.3) and shared macroblock reconstruction.

I16x16 luma modes (0=V, 1=H, 2=DC, 3=plane) and 8x8 chroma modes
(0=DC, 1=H, 2=V, 3=plane). The same reconstruction routines serve the
encoder (closed loop) and the decoder, so encoder recon is by construction
what a conformant decoder produces (deblocking disabled).
"""

from __future__ import annotations

import numpy as np

from .transform import (
    chroma_dc_dequant,
    dequant_4x4,
    inverse_4x4,
    inverse_zigzag,
    luma_dc_dequant,
)

# Luma 4x4 block z-scan order within a MB: (x, y) block coords.
LUMA_BLOCK_ORDER: list[tuple[int, int]] = [
    (0, 0), (1, 0), (0, 1), (1, 1),
    (2, 0), (3, 0), (2, 1), (3, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
    (2, 2), (3, 2), (2, 3), (3, 3),
]
# Raster order of the 2x2 luma-DC layout is separate: DC coeff (x,y) of
# block grid is scanned zig-zag as a 4x4 "block" itself.

CHROMA_BLOCK_ORDER: list[tuple[int, int]] = [(0, 0), (1, 0), (0, 1), (1, 1)]

LUMA_V, LUMA_H, LUMA_DC, LUMA_PLANE = 0, 1, 2, 3
CHROMA_DC, CHROMA_H, CHROMA_V, CHROMA_PLANE = 0, 1, 2, 3


def predict_luma16(mode: int, top: np.ndarray | None, left: np.ndarray | None,
                   topleft: int | None) -> np.ndarray:
    """16x16 luma prediction. `top`/`left` are length-16 uint8 vectors of
    reconstructed neighbors (None when unavailable)."""
    if mode == LUMA_V:
        if top is None:
            raise ValueError("vertical prediction requires top neighbors")
        return np.tile(top.astype(np.uint8), (16, 1))
    if mode == LUMA_H:
        if left is None:
            raise ValueError("horizontal prediction requires left neighbors")
        return np.tile(left.astype(np.uint8)[:, None], (1, 16))
    if mode == LUMA_DC:
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif left is not None:
            dc = (int(left.sum()) + 8) >> 4
        elif top is not None:
            dc = (int(top.sum()) + 8) >> 4
        else:
            dc = 128
        return np.full((16, 16), dc, np.uint8)
    if mode == LUMA_PLANE:
        if top is None or left is None or topleft is None:
            raise ValueError("plane prediction requires top+left+corner")
        t = top.astype(np.int32)
        l = left.astype(np.int32)
        tl = int(topleft)
        xs = np.arange(8)
        h = int((xs + 1) @ (t[8:16] - np.concatenate(([tl], t[0:7]))[::-1]))
        v = int((xs + 1) @ (l[8:16] - np.concatenate(([tl], l[0:7]))[::-1]))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        y, x = np.mgrid[0:16, 0:16]
        return np.clip((a + b * (x - 7) + c * (y - 7) + 16) >> 5, 0, 255).astype(np.uint8)
    raise ValueError(f"bad luma mode {mode}")


def predict_chroma8(mode: int, top: np.ndarray | None, left: np.ndarray | None,
                    topleft: int | None) -> np.ndarray:
    """8x8 chroma prediction for one plane."""
    if mode == CHROMA_V:
        if top is None:
            raise ValueError("vertical chroma prediction requires top")
        return np.tile(top.astype(np.uint8), (8, 1))
    if mode == CHROMA_H:
        if left is None:
            raise ValueError("horizontal chroma prediction requires left")
        return np.tile(left.astype(np.uint8)[:, None], (1, 8))
    if mode == CHROMA_DC:
        pred = np.empty((8, 8), np.uint8)
        for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
            t = top[4 * bx:4 * bx + 4].astype(np.int32) if top is not None else None
            l = left[4 * by:4 * by + 4].astype(np.int32) if left is not None else None
            if (bx, by) in ((0, 0), (1, 1)):
                if t is not None and l is not None:
                    dc = (int(t.sum()) + int(l.sum()) + 4) >> 3
                elif l is not None:
                    dc = (int(l.sum()) + 2) >> 2
                elif t is not None:
                    dc = (int(t.sum()) + 2) >> 2
                else:
                    dc = 128
            elif (bx, by) == (1, 0):  # prefers its own top quarter
                if t is not None:
                    dc = (int(t.sum()) + 2) >> 2
                elif l is not None:
                    dc = (int(l.sum()) + 2) >> 2
                else:
                    dc = 128
            else:                     # (0, 1): prefers its own left quarter
                if l is not None:
                    dc = (int(l.sum()) + 2) >> 2
                elif t is not None:
                    dc = (int(t.sum()) + 2) >> 2
                else:
                    dc = 128
            pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = dc
        return pred
    if mode == CHROMA_PLANE:
        if top is None or left is None or topleft is None:
            raise ValueError("plane chroma prediction requires top+left+corner")
        t = top.astype(np.int32)
        l = left.astype(np.int32)
        tl = int(topleft)
        xs = np.arange(4)
        h = int((xs + 1) @ (t[4:8] - np.concatenate(([tl], t[0:3]))[::-1]))
        v = int((xs + 1) @ (l[4:8] - np.concatenate(([tl], l[0:3]))[::-1]))
        a = 16 * (int(l[7]) + int(t[7]))
        b = (34 * h + 32) >> 6
        c = (34 * v + 32) >> 6
        y, x = np.mgrid[0:8, 0:8]
        return np.clip((a + b * (x - 3) + c * (y - 3) + 16) >> 5, 0, 255).astype(np.uint8)
    raise ValueError(f"bad chroma mode {mode}")


def reconstruct_luma16(pred: np.ndarray, dc_levels: np.ndarray,
                       ac_levels: np.ndarray, qp: int) -> np.ndarray:
    """Rebuild a 16x16 luma MB from signaled levels.

    dc_levels: (16,) zig-zag luma DC levels; ac_levels: (16, 15) per-block
    zig-zag AC levels in z-scan block order (all-zero when cbp_luma == 0).
    """
    dc_block = inverse_zigzag(dc_levels.astype(np.int32))     # (4,4) spatial
    dc_recon = luma_dc_dequant(dc_block, qp)                  # (4,4)
    out = np.empty((16, 16), np.int32)
    for bi, (bx, by) in enumerate(LUMA_BLOCK_ORDER):
        seq = np.zeros(16, np.int32)
        seq[1:] = ac_levels[bi]
        z = inverse_zigzag(seq)
        d = dequant_4x4(z, qp)
        d[0, 0] = dc_recon[by, bx]
        r = (inverse_4x4(d) + 32) >> 6
        p = pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4].astype(np.int32)
        out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = p + r
    return np.clip(out, 0, 255).astype(np.uint8)


def reconstruct_chroma8(pred: np.ndarray, dc_levels: np.ndarray,
                        ac_levels: np.ndarray, qpc: int) -> np.ndarray:
    """Rebuild one 8x8 chroma plane of a MB.

    dc_levels: (4,) raster-scan 2x2 DC levels; ac_levels: (4, 15) per-block
    zig-zag AC levels in CHROMA_BLOCK_ORDER.
    """
    dc_recon = chroma_dc_dequant(dc_levels.astype(np.int32).reshape(2, 2), qpc)
    out = np.empty((8, 8), np.int32)
    for bi, (bx, by) in enumerate(CHROMA_BLOCK_ORDER):
        seq = np.zeros(16, np.int32)
        seq[1:] = ac_levels[bi]
        z = inverse_zigzag(seq)
        d = dequant_4x4(z, qpc)
        d[0, 0] = dc_recon[by, bx]
        r = (inverse_4x4(d) + 32) >> 6
        p = pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4].astype(np.int32)
        out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = p + r
    return np.clip(out, 0, 255).astype(np.uint8)
