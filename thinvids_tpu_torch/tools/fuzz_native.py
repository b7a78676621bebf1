"""Corruption/truncation fuzz harness for the native entropy code (a
copy of the reference package's, driving the port's native/ library).

The native CAVLC parsers (`cavlc_unpack_compact`,
`cavlc_sparse_unpack2`) consume bytes that crossed the device→host
link, and `cavlc_pack_islice16` consumes the level arrays they
produce; none of them may ever read or write out of bounds, whatever a
torn transfer hands them. This harness drives all three with valid
payloads, then systematic mutations (byte flips, truncations, garbage
extension, count perturbation), asserting the contract:

- a VALID payload round-trips bit-identically through the native entry
  and the numpy reference (codecs/h264/layout.py);
- a CORRUPT payload either still decodes (both implementations, to the
  SAME levels) or is rejected by both (ValueError / IndexError) —
  never a crash, never a silent native/host divergence;
- the pack direction holds the same bar: the native and pure-Python
  slice packers emit identical NAL bytes on codeable levels and BOTH
  reject uncodeable ones (plus a raw-entry no-crash leg with garbage
  header bits).

Run it under the sanitizer builds to turn "never a crash" into a
machine-checked claim (tests/test_torch_tools.py, `slow`):

    TVT_NATIVE_SANITIZE=ubsan \
        UBSAN_OPTIONS=halt_on_error=1 python -m thinvids_tpu_torch.tools.fuzz_native
    TVT_NATIVE_SANITIZE=asan ASAN_OPTIONS=detect_leaks=0 \
        LD_PRELOAD=$(g++ -print-file-name=libasan.so) \
        python -m thinvids_tpu_torch.tools.fuzz_native

Deterministic: --seed fixes the whole corpus.
"""

from __future__ import annotations

import argparse

import numpy as np

#: rejections both sides may raise on corrupt input
_REJECT = (ValueError, IndexError)

#: shared count-perturbation corpus — BOTH entries (compact payload
#: and three-array sparse2) must face the same hostile counts
_COUNT_DELTAS = ((1, 0), (-1, 0), (0, 7), (0, -3), (1 << 20, 0),
                 (0, 1 << 20))


def build_valid_case(rng: np.random.Generator):
    """One consistent compact stream: (L, nblk, nval, payload,
    bitmap, bmask16, vals)."""
    NB = int(rng.integers(1, 260))
    L = NB * 16 - int(rng.integers(0, 16))      # ragged tail block
    NB = -(-L // 16)
    nblk = int(rng.integers(0, NB + 1))
    live = np.sort(rng.choice(NB, size=nblk, replace=False))
    bm = np.zeros(NB, np.uint8)
    bm[live] = 1
    bitmap = np.packbits(bm)
    masks = rng.integers(1, 1 << 16, size=nblk, dtype=np.uint32) \
        .astype(np.uint16)
    nval = int(sum(int(m).bit_count() for m in masks))
    vals = rng.integers(-128, 128, size=nval).astype(np.int8)
    payload = np.concatenate([
        bitmap.view(np.uint8),
        np.stack([(masks & 0xFF), (masks >> 8)], axis=1)
        .astype(np.uint8).reshape(-1) if nblk else
        np.zeros(0, np.uint8),
        vals.view(np.uint8)])
    return L, nblk, nval, payload, bitmap, masks, vals


def mutations(rng: np.random.Generator, L, nblk, nval, payload):
    """Corrupt variants of one case: (L, nblk, nval, payload)."""
    out = []
    for _ in range(3):                          # byte flips
        p = payload.copy()
        if p.size:
            i = int(rng.integers(0, p.size))
            p[i] ^= int(rng.integers(1, 256))
        out.append((L, nblk, nval, p))
    out.append((L, nblk, nval,
                payload[:int(rng.integers(0, payload.size + 1))]))
    out.append((L, nblk, nval, np.concatenate(
        [payload, rng.integers(0, 256,
                               size=int(rng.integers(1, 64)))
         .astype(np.uint8)])))
    for dblk, dval in _COUNT_DELTAS + ((-nblk - 1, 0), (0, -nval - 1)):
        out.append((L, nblk + dblk, nval + dval, payload))
    out.append((L + 16, nblk, nval, payload))
    out.append((max(1, L - 16), nblk, nval, payload))
    return out


def run_both_compact(native_mod, layout, L, nblk, nval, payload):
    try:
        got_n = ("ok", native_mod.unpack_compact(nblk, nval, payload, L))
    except _REJECT:
        got_n = ("reject", None)
    try:
        got_h = ("ok", layout.unpack_compact_host(payload, nblk, nval, L))
    except _REJECT:
        got_h = ("reject", None)
    return got_n, got_h


def run_both_sparse2(native_mod, layout, L, nblk, nval, bitmap, masks,
                     vals):
    try:
        got_n = ("ok", native_mod.block_sparse_unpack2(
            nblk, nval, bitmap, masks, vals, L))
    except _REJECT:
        got_n = ("reject", None)
    try:
        got_h = ("ok", layout.block_sparse_unpack2_host(
            nblk, nval, bitmap, masks, vals, L))
    except _REJECT:
        got_h = ("reject", None)
    return got_n, got_h


def fuzz_pack(native_mod, rng: np.random.Generator) -> None:
    """Drive the int16 I-slice packer with hostile level arrays. Two
    contracts, checked on the same arrays:

    - raw entry, garbage header bits: bytes out or a mapped error
      (ValueError for levels CAVLC cannot code, RuntimeError for cap
      overflow) — never UB;
    - full slice (`encoder.pack_slice`): the native and pure-Python
      packers agree — identical NAL bytes, or BOTH reject the levels
      with `ValueError` (bit parity for the pack direction, matching
      what the two unpack entries get above)."""
    from ..codecs.h264.encoder import FrameLevels, pack_slice
    from ..codecs.h264.headers import PPS, SPS

    mbw, mbh = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    nmb = mbw * mbh
    scale = int(rng.choice([8, 512, 4096, 32767]))
    levels = rng.integers(-scale, scale + 1, size=nmb * 384)
    mask = rng.random(nmb * 384) < float(rng.choice([0.02, 0.3, 0.9]))
    flat = np.where(mask, levels, 0).astype(np.int16)
    o = nmb * 16
    luma_dc = flat[:o].reshape(nmb, 16)
    luma_ac = flat[o:o + nmb * 240].reshape(nmb, 16, 15)
    o += nmb * 240
    chroma_dc = flat[o:o + nmb * 8].reshape(nmb, 2, 4)
    chroma_ac = flat[o + nmb * 8:].reshape(nmb, 2, 4, 15)
    modes = rng.integers(0, 4, size=nmb).astype(np.int32)
    try:
        out = native_mod.pack_islice(
            b"\xff\x80", 10, modes, modes % 4, luma_dc, luma_ac,
            chroma_dc, chroma_ac, mbw, mbh)
        assert isinstance(out, bytes)
    except (ValueError, RuntimeError):
        pass                                    # mapped error paths

    fl = FrameLevels(luma_mode=modes, chroma_mode=modes % 4,
                     luma_dc=luma_dc, luma_ac=luma_ac,
                     chroma_dc=chroma_dc, chroma_ac=chroma_ac)
    sps, pps = SPS(width=mbw * 16, height=mbh * 16), PPS(init_qp=27)
    try:
        nat = ("ok", pack_slice(fl, mbw, mbh, sps, pps, 27, native=True))
    except ValueError:
        nat = ("reject", None)
    try:
        py = ("ok", pack_slice(fl, mbw, mbh, sps, pps, 27, native=False))
    except ValueError:
        py = ("reject", None)
    assert nat == py, (
        f"pack parity divergence at {mbw}x{mbh} scale={scale}: "
        f"native={nat[0]} python={py[0]}")


def _check_pair(got_n, got_h, ctx: str):
    """The shared accept/reject + parity contract. Returns (accepted,
    rejected) increments."""
    if got_n[0] == "ok" and got_h[0] == "ok":
        assert np.array_equal(got_n[1], got_h[1]), (
            f"native/host divergence on {ctx}")
        return 1, 0
    # what one side rejects the other must reject too — a native
    # parser that silently accepts what the reference refuses is how
    # corrupt levels reach the packer (and vice versa)
    assert got_n[0] == got_h[0] == "reject", (
        f"accept/reject divergence on {ctx}: native={got_n[0]} "
        f"host={got_h[0]}")
    return 0, 1


def sparse2_mutations(rng: np.random.Generator, L, nblk, nval, bitmap,
                      masks, vals):
    """Corrupt variants for the three-array entry: count perturbation
    (exercises the wrapper bounds validation that keeps hostile counts
    inside the buffers), bitmap bit flips (incl. padding bits), mask
    corruption, and truncated streams."""
    out = []
    for dblk, dval in _COUNT_DELTAS + ((-nblk - 1, 0), (0, -nval - 1)):
        out.append((L, nblk + dblk, nval + dval, bitmap, masks, vals))
    b = bitmap.copy()
    if b.size:
        b[int(rng.integers(0, b.size))] ^= int(rng.integers(1, 256))
    out.append((L, nblk, nval, b, masks, vals))
    m = masks.copy()
    if m.size:
        m[int(rng.integers(0, m.size))] ^= int(rng.integers(1, 1 << 16))
    out.append((L, nblk, nval, bitmap, m, vals))
    out.append((L, nblk, nval, bitmap,
                masks[:int(rng.integers(0, masks.size + 1))], vals))
    out.append((L, nblk, nval, bitmap, masks,
                vals[:int(rng.integers(0, vals.size + 1))]))
    out.append((L, nblk, nval, bitmap[:max(0, bitmap.size - 1)],
                masks, vals))
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="fuzz_native")
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--seed", type=int, default=20260804)
    args = parser.parse_args(argv)

    from .. import native as native_mod
    from ..codecs.h264 import layout

    if not native_mod.available():
        print("fuzz_native: no compiler / native build failed — "
              "nothing to fuzz")
        return 0

    rng = np.random.default_rng(args.seed)
    cases = accepted = rejected = 0
    for _ in range(args.iterations):
        L, nblk, nval, payload, bitmap, masks, vals = \
            build_valid_case(rng)
        # valid case: both accept, bit-identical
        got_n, got_h = run_both_compact(native_mod, layout, L, nblk,
                                        nval, payload)
        assert got_n[0] == got_h[0] == "ok", "valid payload rejected"
        assert np.array_equal(got_n[1], got_h[1]), \
            "native/host divergence on a VALID payload"
        got_n, got_h = run_both_sparse2(native_mod, layout, L, nblk,
                                        nval, bitmap, masks, vals)
        assert got_n[0] == got_h[0] == "ok"
        assert np.array_equal(got_n[1], got_h[1])

        for mL, mblk, mval, mpayload in mutations(rng, L, nblk, nval,
                                                  payload):
            cases += 1
            pair = run_both_compact(native_mod, layout, mL, mblk,
                                    mval, mpayload)
            a, r = _check_pair(*pair,
                               ctx=f"compact L={mL} nblk={mblk} "
                                   f"nval={mval}")
            accepted += a
            rejected += r
        for mcase in sparse2_mutations(rng, L, nblk, nval, bitmap,
                                       masks, vals):
            cases += 1
            pair = run_both_sparse2(native_mod, layout, *mcase)
            a, r = _check_pair(*pair,
                               ctx=f"sparse2 L={mcase[0]} "
                                   f"nblk={mcase[1]} nval={mcase[2]}")
            accepted += a
            rejected += r
        fuzz_pack(native_mod, rng)
    print(f"fuzz_native: {args.iterations} valid cases, {cases} "
          f"mutations ({accepted} accepted, {rejected} rejected), "
          f"0 crashes, 0 divergences")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
