"""Bit-level IO: MSB-first bit packing, Exp-Golomb codes, NAL framing.

These are the primitives under every H.26x bitstream the codecs emit. The
reference never wrote a bit itself (ffmpeg did); here the bit layer is
first-class and unit-tested against known codewords.

Performance note: the writer batches bits through a Python-int accumulator
and flushes whole bytes. The hot entropy pack runs through the optional C++
packer (``thinvids_tpu_torch.native``) when built; this module is the always-on
fallback and the semantic reference.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer with Exp-Golomb helpers (H.264 §9.1)."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0       # pending bits, MSB-first in the low `_nbits`
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        """Append `nbits` bits of `value` (unsigned, MSB first)."""
        if nbits < 0 or (nbits == 0 and value):
            raise ValueError("bad bit count")
        if value < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_bit(self, bit: int) -> None:
        self.write(1 if bit else 0, 1)

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb: codeNum → [zeros prefix] 1 [info]."""
        if value < 0:
            raise ValueError("ue() requires non-negative value")
        code = value + 1
        nbits = code.bit_length()
        self.write(0, nbits - 1)
        self.write(code, nbits)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb (H.264 §9.1.1): v>0 → 2v-1, v<=0 → -2v."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align(self, fill_bit: int = 0) -> None:
        if self._nbits % 8:
            pad = 8 - (self._nbits % 8)
            self.write((1 << pad) - 1 if fill_bit else 0, pad)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + zero alignment (H.264 §7.3.2.11)."""
        self.write_bit(1)
        self.byte_align(0)

    @property
    def bit_length(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def getvalue(self) -> bytes:
        if self._nbits:
            raise ValueError(
                f"{self._nbits} unflushed bits; call byte_align() or "
                "rbsp_trailing_bits() first"
            )
        return bytes(self._buf)

    def getvalue_unaligned(self) -> tuple[bytes, int]:
        """(zero-padded bytes, true bit length) — for splicing into another
        bit writer (e.g. the native packer continues after the header)."""
        total_bits = self.bit_length
        if self._nbits:
            pad = 8 - self._nbits
            data = bytes(self._buf) + bytes([(self._acc << pad) & 0xFF])
        else:
            data = bytes(self._buf)
        return data, total_bits


class BitReader:
    """MSB-first bit reader matching :class:`BitWriter`."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    @property
    def bits_left(self) -> int:
        return len(self._data) * 8 - self._pos

    @property
    def bit_position(self) -> int:
        return self._pos

    def read(self, nbits: int) -> int:
        if nbits > self.bits_left:
            raise EOFError("bitstream exhausted")
        value = 0
        pos = self._pos
        for _ in range(nbits):
            byte = self._data[pos >> 3]
            value = (value << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return value

    def read_bit(self) -> int:
        return self.read(1)

    def peek(self, nbits: int) -> int:
        """Read without consuming; short reads at EOF are zero-padded."""
        pos = self._pos
        avail = min(nbits, self.bits_left)
        value = self.read(avail)
        self._pos = pos
        return value << (nbits - avail)

    def ue(self) -> int:
        zeros = 0
        while self.read_bit() == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("corrupt exp-golomb code")
        return (1 << zeros) - 1 + (self.read(zeros) if zeros else 0)

    def se(self) -> int:
        code = self.ue()
        mag = (code + 1) >> 1
        return mag if code & 1 else -mag

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """True if payload bits remain before the rbsp trailing pattern."""
        if self.bits_left <= 0:
            return False
        # Trailing = stop bit '1' followed only by zeros to stream end.
        tail = self._pos
        data, pos = self._data, len(self._data) * 8
        while pos > tail:
            pos -= 1
            if (data[pos >> 3] >> (7 - (pos & 7))) & 1:
                return pos != tail
        return False  # degenerate: all zeros


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes (H.264 §7.4.1.1).

    Any 00 00 followed by a byte <= 03 gets 03 interposed so the start-code
    prefix 00 00 01 can never appear inside a NAL payload.
    """
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation-prevention 0x03 bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def slice_first_mb(nal: bytes) -> int:
    """first_mb_in_slice of a raw VCL NAL (header byte + EBSP payload)
    — the slice header's leading ue(v). Only a short prefix is
    unescaped: enough bits for any legal MB address. Used to group a
    picture's slices into ONE access unit (a multi-slice picture's
    later slices have first_mb != 0 and must ride with the slice that
    opened the picture — split-frame encoding emits one slice per
    MB-row band)."""
    return BitReader(ebsp_to_rbsp(nal[1:12])).ue()


def annexb_nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
               long_start_code: bool = True) -> bytes:
    """Wrap an RBSP payload as one Annex-B NAL unit.

    forbidden_zero_bit(0) | nal_ref_idc(2) | nal_unit_type(5), then the
    emulation-prevented payload, preceded by a start code.
    """
    if not 0 <= nal_ref_idc <= 3 or not 0 <= nal_unit_type <= 31:
        raise ValueError("bad NAL header fields")
    header = bytes([(nal_ref_idc << 5) | nal_unit_type])
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + header + rbsp_to_ebsp(rbsp)


def split_annexb(stream: bytes) -> list[tuple[int, int, bytes]]:
    """Split an Annex-B stream into (nal_ref_idc, nal_unit_type, rbsp) units."""
    units: list[tuple[int, int, bytes]] = []
    i = 0
    n = len(stream)
    starts: list[int] = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for idx, s in enumerate(starts):
        end = n if idx + 1 == len(starts) else starts[idx + 1]
        # back off the next start code (and its optional leading zero byte)
        if idx + 1 < len(starts):
            end -= 3
            while end > s and stream[end - 1] == 0:
                end -= 1
        payload = stream[s:end]
        if not payload:
            continue
        header = payload[0]
        units.append(((header >> 5) & 3, header & 31, ebsp_to_rbsp(payload[1:])))
    return units
