"""CAVLC residual coding (H.264 §9.2) — encode and decode directions.

Both directions share tables.py, and the decoder is used to cross-check the
encoder in tests (plus libavcodec as the external oracle). Coefficients are
passed in zig-zag scan order, lowest frequency first, as plain int lists:
16 for luma DC / standalone 4x4, 15 for AC blocks, 4 for chroma DC.
"""

from __future__ import annotations

from ...io.bits import BitReader, BitWriter
from .tables import (
    CHROMA_DC_COEFF_TOKEN,
    COEFF_TOKEN,
    RUN_BEFORE,
    TOTAL_ZEROS_4x4,
    TOTAL_ZEROS_CHROMA_DC,
    coeff_token_context,
)


def luma_nc(na: int | None, nb: int | None) -> int:
    """nC from neighbor total_coeff counts (§9.2.1): A=left, B=top."""
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    if na is not None:
        return na
    if nb is not None:
        return nb
    return 0


def encode_residual(bw: BitWriter, coeffs: list[int], nc: int) -> int:
    """Write one residual block; returns its total_coeff (for nC maps).

    `nc` == -1 selects the chroma-DC (4:2:0) coeff_token table; otherwise
    the context is chosen from the neighbor-average nC.
    """
    max_coeff = len(coeffs)
    positions = [i for i, c in enumerate(coeffs) if c != 0]
    total_coeff = len(positions)

    # Trailing ones: up to three consecutive +-1 at the high-frequency end.
    trailing = 0
    for idx in reversed(positions):
        if trailing == 3 or abs(coeffs[idx]) != 1:
            break
        trailing += 1

    if nc == -1:
        length, bits = CHROMA_DC_COEFF_TOKEN[(total_coeff, trailing)]
    else:
        length, bits = COEFF_TOKEN[coeff_token_context(nc)][(total_coeff, trailing)]
    bw.write(bits, length)
    if total_coeff == 0:
        return 0

    # Trailing-one sign flags, highest frequency first (1 = negative).
    for idx in reversed(positions[total_coeff - trailing:]):
        bw.write_bit(1 if coeffs[idx] < 0 else 0)

    # Remaining levels, highest frequency first.
    suffix_length = 1 if (total_coeff > 10 and trailing < 3) else 0
    first = True
    for idx in reversed(positions[: total_coeff - trailing]):
        level = coeffs[idx]
        level_code = (abs(level) - 1) * 2 + (1 if level < 0 else 0)
        if first and trailing < 3:
            level_code -= 2  # |level| >= 2 guaranteed when < 3 trailing ones
        first = False
        if suffix_length == 0:
            if level_code < 14:
                bw.write(1, level_code + 1)          # unary
            elif level_code < 30:
                bw.write(1, 15)                      # prefix 14
                bw.write(level_code - 14, 4)
            else:
                bw.write(1, 16)                      # prefix 15 escape
                if level_code - 30 >= (1 << 12):
                    raise ValueError("level too large for baseline CAVLC")
                bw.write(level_code - 30, 12)
        else:
            prefix = level_code >> suffix_length
            if prefix < 15:
                bw.write(1, prefix + 1)
                bw.write(level_code & ((1 << suffix_length) - 1), suffix_length)
            else:
                bw.write(1, 16)
                escape = level_code - (15 << suffix_length)
                if escape >= (1 << 12):
                    raise ValueError("level too large for baseline CAVLC")
                bw.write(escape, 12)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    total_zeros = positions[-1] + 1 - total_coeff
    if total_coeff < max_coeff:
        table = TOTAL_ZEROS_CHROMA_DC if nc == -1 else TOTAL_ZEROS_4x4
        length, bits = table[total_coeff][total_zeros]
        bw.write(bits, length)

    # run_before for every coefficient except the lowest-frequency one.
    zeros_left = total_zeros
    for k in range(total_coeff - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = positions[k] - positions[k - 1] - 1
        length, bits = RUN_BEFORE[min(zeros_left, 7)][run]
        bw.write(bits, length)
        zeros_left -= run
    return total_coeff


# --- decode direction -------------------------------------------------------

def _build_decode_tree(table) -> dict[tuple[int, int], object]:
    return {(length, bits): key for key, (length, bits) in table.items()}


_DEC_COEFF_TOKEN = [_build_decode_tree(t) for t in COEFF_TOKEN]
_DEC_CHROMA_DC = _build_decode_tree(CHROMA_DC_COEFF_TOKEN)
_DEC_TOTAL_ZEROS = {
    tc: {code: tz for tz, code in enumerate(codes)}
    for tc, codes in TOTAL_ZEROS_4x4.items()
}
_DEC_TOTAL_ZEROS_CHROMA = {
    tc: {code: tz for tz, code in enumerate(codes)}
    for tc, codes in TOTAL_ZEROS_CHROMA_DC.items()
}
_DEC_RUN_BEFORE = {
    zl: {code: run for run, code in enumerate(codes)}
    for zl, codes in RUN_BEFORE.items()
}


def _read_vlc(br: BitReader, inverse: dict, what: str, max_len: int = 16):
    length, bits = 0, 0
    while length <= max_len:
        bits = (bits << 1) | br.read_bit()
        length += 1
        if (length, bits) in inverse:
            return inverse[(length, bits)]
    raise ValueError(f"invalid {what} codeword")


def decode_residual(br: BitReader, nc: int, max_coeff: int) -> list[int]:
    """Inverse of :func:`encode_residual`; returns `max_coeff` coefficients."""
    if nc == -1:
        total_coeff, trailing = _read_vlc(br, _DEC_CHROMA_DC, "chroma coeff_token", 8)
    else:
        ctx = coeff_token_context(nc)
        total_coeff, trailing = _read_vlc(br, _DEC_COEFF_TOKEN[ctx], "coeff_token")
    coeffs = [0] * max_coeff
    if total_coeff == 0:
        return coeffs

    levels = []
    for _ in range(trailing):
        levels.append(-1 if br.read_bit() else 1)

    suffix_length = 1 if (total_coeff > 10 and trailing < 3) else 0
    for i in range(total_coeff - trailing):
        prefix = 0
        while br.read_bit() == 0:
            prefix += 1
            if prefix > 15:
                raise ValueError("level_prefix too long for baseline")
        if suffix_length == 0:
            if prefix < 14:
                level_code = prefix
            elif prefix == 14:
                level_code = 14 + br.read(4)
            else:
                level_code = 30 + br.read(12)
        else:
            if prefix < 15:
                level_code = (prefix << suffix_length) + br.read(suffix_length)
            else:
                level_code = (15 << suffix_length) + br.read(12)
        if i == 0 and trailing < 3:
            level_code += 2
        level = (level_code >> 1) + 1
        if level_code & 1:
            level = -level
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if total_coeff < max_coeff:
        if nc == -1:
            total_zeros = _read_vlc(br, _DEC_TOTAL_ZEROS_CHROMA[total_coeff], "tz", 4)
        else:
            total_zeros = _read_vlc(br, _DEC_TOTAL_ZEROS[total_coeff], "total_zeros", 10)
    else:
        total_zeros = 0

    runs = []
    zeros_left = total_zeros
    for _ in range(total_coeff - 1):
        if zeros_left > 0:
            run = _read_vlc(br, _DEC_RUN_BEFORE[min(zeros_left, 7)], "run_before", 11)
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)  # lowest-frequency coeff absorbs the rest

    # levels[] is highest-frequency first; place into scan positions.
    pos = total_zeros + total_coeff - 1
    for i, level in enumerate(levels):
        coeffs[pos] = level
        pos -= 1 + runs[i]
    return coeffs
