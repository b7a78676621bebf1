"""The chip's peaks and the operations and bytes each measured kernel
needs, frozen with the benchmark.

Copied from chip_smoke.py at commit ae0a2c4: `H100_INT32_OPS` and
`H100_BYTES_PER_S` (:354-356), `me_bounds` (:642), `INTRA_OPS_PER_BLOCK`
and `intra_bounds` (:1003, :1006), with the port's constants they read
(`torchme.ME_HALO` = 16, `len(torchme.OFFSET_TABLE)` = 227; a CPU test
holds these copies to the port). Bytes count each input read once and each
output written once; operations are counted in the instruction the kernel
uses (one VABSDIFF4 takes four pixel differences and their sum).

A roofline share is the bound time, the larger of operations over the
integer peak and bytes over the memory bandwidth, divided by the kernel's
measured time. The peaks are those of an H100 SXM at its full 700 W power
limit; a card set below it reaches less, so every run reports the card's
power limit beside the share.
"""

from __future__ import annotations

#: int32 lane operations a second: 132 SMs x 64 INT32 lanes x 1.98 GHz
#: boost clock (NVIDIA Hopper architecture white paper). An upper limit
#: on any per-lane integer instruction, VABSDIFF4 included.
H100_INT32_OPS = 132 * 64 * 1.98e9
#: HBM3 bytes a second of one H100 SXM (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12

#: margin, in luma samples on every side, of the half-pel planes the
#: search reads (torchme.ME_HALO)
ME_HALO = 16
#: candidates the search evaluates around its centres, each over a whole
#: MB (len(torchme.OFFSET_TABLE))
ME_CANDIDATES = 227
#: integer operations of one 4x4 block through the intra kernels: the
#: residual (16), the forward transform (64), quantisation (80),
#: dequantisation (32), the inverse transform (80) and the recon (80);
#: the DC Hadamards add under 1%
INTRA_OPS_PER_BLOCK = 16 + 64 + 80 + 32 + 80 + 80


def me_search_bound(h: int, w: int, b: int = 1) -> tuple[int, int]:
    """(operations, bytes) of csrc/me_search.cu's `search_kernel` over b
    planes of h x w (a band stack: each band a plane with its own
    margin): 227 candidates over every pixel, four pixels an operation;
    the four half-pel planes with their margins, the current luma and
    both chroma references read once, the MVs and the three prediction
    planes written once, the centres and lambda read once."""
    hp, wp = h + 2 * ME_HALO, w + 2 * ME_HALO
    planes = 4 * hp * wp
    chroma = 2 * (h // 2) * (w // 2) * 2
    rest = (h * w * 2 + chroma + (h // 16) * (w // 16) * 2 * 4 + h * w * 2
            + chroma)
    shared = 3 * 2 * 4 + 4
    return b * ME_CANDIDATES * h * w // 4, b * (planes + rest) + shared


def intra_pair_bound(b: int, mbh: int, mbw: int) -> tuple[int, int]:
    """(operations, bytes) of csrc/intra_core.cu's two kernels together
    (`intra_row0_kernel`, `intra_cols_kernel`) over b items of mbh x mbw
    MBs: 24 4x4 blocks an MB; the uint8 planes (384 B an MB) and the int32
    QP map read once, the int32 levels and recon (384 values each an MB)
    written once."""
    nmb = b * mbh * mbw
    return nmb * 24 * INTRA_OPS_PER_BLOCK, nmb * (384 + 4 + 2 * 384 * 4)


def bound_seconds(ops: int, nbytes: int) -> tuple[float, str]:
    """(least seconds, what bounds it) for this work on the chip."""
    t_ops = ops / H100_INT32_OPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
