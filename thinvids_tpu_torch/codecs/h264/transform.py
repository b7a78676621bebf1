"""H.264 integer transforms and quantization (spec §8.5, numpy reference).

This module is the semantic ground truth for the codec's math; the torch
path (torchcore.py) must match it bit-exactly (tested). All functions
operate on int32 numpy arrays and follow the spec's integer arithmetic, so
encoder reconstruction equals what a conformant decoder produces.

Shapes: 4x4 blocks are the unit. Batched variants accept (..., 4, 4).
"""

from __future__ import annotations

import numpy as np

# Forward core transform matrix Cf (§8.5, encoder side per JM):
CF = np.array(
    [[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], np.int32
)
# 4x4 Hadamard (luma DC), and 2x2 Hadamard (chroma DC).
H4 = np.array(
    [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int32
)
H2 = np.array([[1, 1], [1, -1]], np.int32)

# Quant multiplier MF (Table derived from §8.5.9 normAdjust) by qp%6 and
# coefficient position class: class0 = (0,0),(0,2),(2,0),(2,2);
# class1 = remaining; class2 = (1,1),(1,3),(3,1),(3,3).
_MF_CLASSES = np.array(
    [
        [13107, 8066, 5243],
        [11916, 7490, 4660],
        [10082, 6554, 4194],
        [9362, 5825, 3647],
        [8192, 5243, 3355],
        [7282, 4559, 2893],
    ],
    np.int32,
)
# Dequant scale V (normAdjust4x4): same class layout.
_V_CLASSES = np.array(
    [
        [10, 13, 16],
        [11, 14, 18],
        [13, 16, 20],
        [14, 18, 23],
        [16, 20, 25],
        [18, 23, 29],
    ],
    np.int32,
)

_POS_CLASS = np.array(
    [[0, 1, 0, 1], [1, 2, 1, 2], [0, 1, 0, 1], [1, 2, 1, 2]], np.int32
)

# MF[qp%6] and V[qp%6] as full 4x4 matrices.
MF_TABLE = _MF_CLASSES[:, _POS_CLASS]          # (6, 4, 4)
V_TABLE = _V_CLASSES[:, _POS_CLASS]            # (6, 4, 4)

# Chroma qp mapping (§8.5.8 Table 8-15) for qPi in 0..51.
CHROMA_QP_TABLE = np.array(
    list(range(30))
    + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    np.int32,
)

# Zig-zag scan order for 4x4 blocks (§8.5.5, frame coding).
ZIGZAG_4x4 = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], np.int32
)


def chroma_qp(qp: int, offset: int = 0) -> int:
    return int(CHROMA_QP_TABLE[min(51, max(0, qp + offset))])


def forward_4x4(block: np.ndarray) -> np.ndarray:
    """Core forward transform W = Cf X CfT over (..., 4, 4) residuals."""
    x = block.astype(np.int32)
    return np.einsum("ij,...jk,lk->...il", CF, x, CF).astype(np.int32)


def inverse_4x4(coeffs: np.ndarray) -> np.ndarray:
    """Spec §8.5.12.2 inverse core transform (without the final shift).

    Input: dequantized coefficients d (..., 4, 4). Output: r' such that
    residual = (r' + 32) >> 6.
    """
    d = coeffs.astype(np.int32)
    # Horizontal (rows): e/f per spec
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    # Vertical (columns)
    g0, g1, g2, g3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    h0 = g0 + g2
    h1 = g0 - g2
    h2 = (g1 >> 1) - g3
    h3 = g1 + (g3 >> 1)
    return np.stack([h0 + h3, h1 + h2, h1 - h2, h0 - h3], axis=-2).astype(np.int32)


def quant_4x4(coeffs: np.ndarray, qp: int, intra: bool = True,
              skip_dc: bool = False) -> np.ndarray:
    """Scalar quantization |Z| = (|W|*MF + f) >> qbits with sign restore."""
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    mf = MF_TABLE[qp % 6]
    w = coeffs.astype(np.int64)
    z = ((np.abs(w) * mf + f) >> qbits).astype(np.int32)
    z = np.where(coeffs < 0, -z, z)
    if skip_dc:
        z = z.copy()
        z[..., 0, 0] = 0
    return z


def dequant_4x4(levels: np.ndarray, qp: int, skip_dc: bool = False) -> np.ndarray:
    """AC/full dequant d = z * V << (qp//6) (bit-exact vs spec §8.5.12.1)."""
    v = V_TABLE[qp % 6]
    d = (levels.astype(np.int32) * v) << (qp // 6)
    if skip_dc:
        d = d.copy()
        d[..., 0, 0] = 0
    return d


def luma_dc_forward(dc: np.ndarray) -> np.ndarray:
    """4x4 Hadamard of the 16 I16x16 luma DC coefficients, /2 (encoder)."""
    x = dc.astype(np.int32)
    return (np.einsum("ij,...jk,lk->...il", H4, x, H4) // 2).astype(np.int32)


def luma_dc_quant(wd: np.ndarray, qp: int) -> np.ndarray:
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf00 = int(MF_TABLE[qp % 6][0, 0])
    z = ((np.abs(wd.astype(np.int64)) * mf00 + 2 * f) >> (qbits + 1)).astype(np.int32)
    return np.where(wd < 0, -z, z)


def luma_dc_dequant(z: np.ndarray, qp: int) -> np.ndarray:
    """Spec §8.5.10: inverse Hadamard then DC-specific scaling."""
    f = np.einsum("ij,...jk,lk->...il", H4, z.astype(np.int32), H4)
    ls = int(V_TABLE[qp % 6][0, 0]) * 16  # LevelScale4x4(qp%6, 0, 0)
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    shift = 6 - qp // 6
    return (f * ls + (1 << (shift - 1))) >> shift


def chroma_dc_forward(dc: np.ndarray) -> np.ndarray:
    """2x2 Hadamard of chroma DC (..., 2, 2)."""
    return np.einsum(
        "ij,...jk,lk->...il", H2, dc.astype(np.int32), H2
    ).astype(np.int32)


def chroma_dc_quant(wd: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    mf00 = int(MF_TABLE[qp % 6][0, 0])
    z = ((np.abs(wd.astype(np.int64)) * mf00 + 2 * f) >> (qbits + 1)).astype(np.int32)
    return np.where(wd < 0, -z, z)


def chroma_dc_dequant(z: np.ndarray, qp: int) -> np.ndarray:
    """Spec §8.5.11: inverse 2x2 Hadamard, then ((f*LS) << (qp/6)) >> 5."""
    f = np.einsum("ij,...jk,lk->...il", H2, z.astype(np.int32), H2)
    ls = int(V_TABLE[qp % 6][0, 0]) * 16
    return ((f * ls) << (qp // 6)) >> 5


def reconstruct_4x4(pred: np.ndarray, dequant: np.ndarray) -> np.ndarray:
    """pred + inverse-transformed residual, rounded and clipped to uint8."""
    r = inverse_4x4(dequant)
    return np.clip(pred.astype(np.int32) + ((r + 32) >> 6), 0, 255).astype(np.uint8)


def zigzag(block: np.ndarray) -> np.ndarray:
    """4x4 block (..., 4, 4) → (..., 16) in zig-zag order."""
    flat = block.reshape(*block.shape[:-2], 16)
    return flat[..., ZIGZAG_4x4]


def inverse_zigzag(seq: np.ndarray) -> np.ndarray:
    """(..., 16) zig-zag sequence → (..., 4, 4) block."""
    out = np.empty_like(seq)
    out[..., ZIGZAG_4x4] = seq
    return out.reshape(*seq.shape[:-1], 4, 4)


def blocks_from_plane(plane: np.ndarray, size: int = 4) -> np.ndarray:
    """(H, W) → (H//size, W//size, size, size) tiling."""
    h, w = plane.shape
    return plane.reshape(h // size, size, w // size, size).swapaxes(1, 2)


def plane_from_blocks(blocks: np.ndarray) -> np.ndarray:
    """(bh, bw, size, size) → (H, W)."""
    bh, bw, s, _ = blocks.shape
    return blocks.swapaxes(1, 2).reshape(bh * s, bw * s)
