"""Native (C++) hot paths, built on demand and loaded via ctypes.

The reference's native layer was external ffmpeg binaries; here the
sequential entropy pack — the one part of the encoder that cannot be a
GPU kernel (bit-serial, data-dependent) — runs as compiled C++ while the
blockwise math stays on the GPU. Falls back to the pure-Python packer
when no compiler is available (same output bits, tested identical).

Build artifacts go to native/_build/ (gitignored).

Sanitizer builds: ``TVT_NATIVE_SANITIZE=asan|ubsan`` compiles the
library with AddressSanitizer / UndefinedBehaviorSanitizer (own .so
name per mode, so sanitized and production artifacts never clobber
each other). The corruption/truncation fuzz harness
(tools/fuzz_native.py, tests/test_native_fuzz.py `slow`) drives the
unpack/pack entry points with mutated compact payloads under these
builds. NOTE for asan: the ASan runtime must be in the process before
the .so loads — run ``LD_PRELOAD=$(g++ -print-file-name=libasan.so)
ASAN_OPTIONS=detect_leaks=0 python ...`` (the harness does this for
its subprocesses; detect_leaks=0 because CPython's arena allocator is
not leak-clean).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cavlc_pack.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")

#: sanitizer build mode, fixed at first build for the process' life
#: ("" = production; registered in analysis/manifest.py process_env)
_SANITIZE_MODES = {
    "": (),
    "asan": ("-fsanitize=address", "-fno-omit-frame-pointer", "-g"),
    "ubsan": ("-fsanitize=undefined", "-fno-sanitize-recover=undefined",
              "-fno-omit-frame-pointer", "-g"),
}


def _sanitize_mode() -> str:
    mode = os.environ.get("TVT_NATIVE_SANITIZE", "").strip().lower()
    return mode if mode in _SANITIZE_MODES else ""


def _so_path(mode: str) -> str:
    tag = f".{mode}" if mode else ""
    return os.path.join(_BUILD_DIR, f"cavlc_pack{tag}.so")


#: mode captured ONCE at import: flags and the .so name must come from
#: the same read, or an env flip between import and first build would
#: compile sanitized code over the production artifact
_MODE = _sanitize_mode()
_SO = _so_path(_MODE)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed: str | None = None


def _marshal_tables():
    from ..codecs.h264 import tables as t

    coeff = np.zeros((4, 17, 4, 2), np.int32)
    for ctx in range(4):
        for (tc, t1), (length, bits) in t.COEFF_TOKEN[ctx].items():
            coeff[ctx, tc, t1] = (length, bits)
    chroma = np.zeros((5, 4, 2), np.int32)
    for (tc, t1), (length, bits) in t.CHROMA_DC_COEFF_TOKEN.items():
        chroma[tc, t1] = (length, bits)
    tz = np.zeros((16, 16, 2), np.int32)
    for tc, codes in t.TOTAL_ZEROS_4x4.items():
        for z, (length, bits) in enumerate(codes):
            tz[tc, z] = (length, bits)
    tzc = np.zeros((4, 4, 2), np.int32)
    for tc, codes in t.TOTAL_ZEROS_CHROMA_DC.items():
        for z, (length, bits) in enumerate(codes):
            tzc[tc, z] = (length, bits)
    rb = np.zeros((8, 15, 2), np.int32)
    for zl, codes in t.RUN_BEFORE.items():
        for r, (length, bits) in enumerate(codes):
            rb[zl, r] = (length, bits)
    return coeff, chroma, tz, tzc, rb


def _build_and_load() -> ctypes.CDLL:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed is not None:
            raise RuntimeError(_load_failed)
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # pid-unique tmp: concurrent builders (spawned pack
                # sidecars racing a fresh checkout) each compile their
                # own file and atomically replace — last wins, every
                # one valid. A shared tmp let builder B keep writing
                # into the inode builder A had already renamed to _SO.
                tmp = _SO + f".tmp.{os.getpid()}"
                flags = list(_SANITIZE_MODES[_MODE])
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                         *flags, _SRC, "-o", tmp],
                        check=True, capture_output=True, timeout=120)
                    os.replace(tmp, _SO)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError) as exc:
            _load_failed = f"native packer unavailable: {exc}"
            raise RuntimeError(_load_failed) from exc

        lib.cavlc_init_tables.argtypes = [ctypes.c_void_p] * 5
        _islice_sig = [
            ctypes.c_void_p, ctypes.c_int32,            # header bytes, bitlen
            ctypes.c_void_p, ctypes.c_void_p,           # modes
            ctypes.c_void_p, ctypes.c_void_p,           # luma dc/ac
            ctypes.c_void_p, ctypes.c_void_p,           # chroma dc/ac
            ctypes.c_int32, ctypes.c_int32,             # mbw, mbh
            ctypes.c_void_p, ctypes.c_int64,            # out, cap
            ctypes.c_void_p,                            # qp_delta (or NULL)
        ]
        lib.cavlc_pack_islice.restype = ctypes.c_int64
        lib.cavlc_pack_islice.argtypes = _islice_sig
        lib.cavlc_pack_islice16.restype = ctypes.c_int64
        lib.cavlc_pack_islice16.argtypes = _islice_sig
        lib.cavlc_sparse_unpack2.restype = ctypes.c_int64
        lib.cavlc_sparse_unpack2.argtypes = [
            ctypes.c_int32, ctypes.c_int32,             # nblk, nval
            ctypes.c_void_p, ctypes.c_void_p,           # bitmap, bmask16
            ctypes.c_void_p,                            # vals
            ctypes.c_void_p, ctypes.c_int64,            # out, L
        ]
        lib.cavlc_unpack_compact.restype = ctypes.c_int64
        lib.cavlc_unpack_compact.argtypes = [
            ctypes.c_int32, ctypes.c_int32,             # nblk, nval
            ctypes.c_void_p, ctypes.c_int64,            # payload, len
            ctypes.c_void_p, ctypes.c_int64,            # out, L
        ]
        lib.cavlc_init_inter.argtypes = [ctypes.c_void_p]
        lib.cavlc_pack_pslice.restype = ctypes.c_int64
        lib.cavlc_pack_pslice.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,            # header bytes, bitlen
            ctypes.c_void_p,                            # mv
            ctypes.c_void_p,                            # luma16
            ctypes.c_void_p, ctypes.c_void_p,           # chroma dc/ac
            ctypes.c_int32, ctypes.c_int32,             # mbw, mbh
            ctypes.c_void_p, ctypes.c_int64,            # out, cap
        ]
        lib.cavlc_init_scan.argtypes = [ctypes.c_void_p]
        lib.cavlc_pack_pslice_plane.restype = ctypes.c_int64
        lib.cavlc_pack_pslice_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,            # header bytes, bitlen
            ctypes.c_void_p,                            # mv int8
            ctypes.c_void_p,                            # luma plane int16
            ctypes.c_void_p, ctypes.c_void_p,           # u/v DC int16
            ctypes.c_void_p, ctypes.c_void_p,           # u/v AC planes int16
            ctypes.c_int32, ctypes.c_int32,             # mbw, mbh
            ctypes.c_void_p, ctypes.c_int64,            # out, cap
        ]
        arrs = _marshal_tables()
        from ..codecs.h264.inter import CBP_INTER_TO_CODE
        from ..codecs.h264.transform import ZIGZAG_4x4

        cbp_inter = np.asarray(CBP_INTER_TO_CODE, np.int32)
        zz = np.asarray(ZIGZAG_4x4, np.int32)
        lib._table_refs = arrs + (cbp_inter, zz)  # keep alive
        lib.cavlc_init_tables(*(a.ctypes.data for a in arrs))
        lib.cavlc_init_inter(cbp_inter.ctypes.data)
        lib.cavlc_init_scan(zz.ctypes.data)
        _lib = lib
        return lib


def available() -> bool:
    try:
        _build_and_load()
        return True
    except RuntimeError:
        return False


def pack_islice(header_bytes: bytes, header_bit_len: int,
                luma_mode: np.ndarray, chroma_mode: np.ndarray,
                luma_dc: np.ndarray, luma_ac: np.ndarray,
                chroma_dc: np.ndarray, chroma_ac: np.ndarray,
                mbw: int, mbh: int,
                qp_delta: np.ndarray | None = None) -> bytes:
    """Pack one I-slice (header bits + MB layer) and return the EBSP payload.

    When all four level arrays arrive as int16 (the flat transfer layout's
    views, parallel/dispatch._unflatten_gop) they go to the zero-copy
    `cavlc_pack_islice16` entry; anything else is widened to int32 and
    packed through the original entry. Identical bits either way.
    `qp_delta` (per-MB qp offsets vs the slice qp, perceptual AQ) emits
    chained mb_qp_delta values instead of se(0).
    """
    lib = _build_and_load()
    nmb = mbw * mbh
    use16 = all(getattr(a, "dtype", None) == np.int16
                for a in (luma_dc, luma_ac, chroma_dc, chroma_ac))
    lvl = np.int16 if use16 else np.int32

    def prep(a, shape, dtype=np.int32):
        a = np.ascontiguousarray(a, dtype)
        if a.shape != shape:
            raise ValueError(f"bad array shape {a.shape}, want {shape}")
        return a

    luma_mode = prep(luma_mode, (nmb,))
    chroma_mode = prep(chroma_mode, (nmb,))
    luma_dc = prep(luma_dc, (nmb, 16), lvl)
    luma_ac = prep(luma_ac, (nmb, 16, 15), lvl)
    chroma_dc = prep(chroma_dc, (nmb, 2, 4), lvl)
    chroma_ac = prep(chroma_ac, (nmb, 2, 4, 15), lvl)
    dqp_ptr = None
    if qp_delta is not None:
        qp_delta = prep(qp_delta, (nmb,), np.int8)
        dqp_ptr = qp_delta.ctypes.data

    # CAVLC worst case ≈ 28 bits/coeff × 384 coeffs ≈ 1.4 KB per MB (plus
    # emulation-prevention expansion); 4 KB/MB is a safe ceiling.
    cap = max(8192, nmb * 4096)
    out = np.empty(cap, np.uint8)
    hdr = np.frombuffer(header_bytes, np.uint8)
    entry = lib.cavlc_pack_islice16 if use16 else lib.cavlc_pack_islice
    n = entry(
        hdr.ctypes.data, header_bit_len,
        luma_mode.ctypes.data, chroma_mode.ctypes.data,
        luma_dc.ctypes.data, luma_ac.ctypes.data,
        chroma_dc.ctypes.data, chroma_ac.ctypes.data,
        mbw, mbh, out.ctypes.data, cap, dqp_ptr)
    if n == -2:
        raise RuntimeError("native packer output buffer overflow")
    if n == -3:
        raise ValueError("level too large for baseline CAVLC")
    if n < 0:
        raise RuntimeError(f"native packer failed ({n})")
    return out[:n].tobytes()


def pack_pslice_plane(header_bytes: bytes, header_bit_len: int,
                      mv8: np.ndarray, luma_plane: np.ndarray,
                      u_dc: np.ndarray, v_dc: np.ndarray,
                      u_ac: np.ndarray, v_ac: np.ndarray,
                      mbw: int, mbh: int) -> bytes:
    """Pack one P-slice straight from plane-layout int16 level arrays
    (zigzag/z-scan happens inside the C++ via the shared scan table) —
    bit-identical to pack_pslice on the equivalent blocked arrays."""
    lib = _build_and_load()
    nmb = mbw * mbh

    def prep(a, shape, dtype):
        a = np.ascontiguousarray(a, dtype)
        if a.shape != shape:
            raise ValueError(f"bad array shape {a.shape}, want {shape}")
        return a

    mv8 = prep(mv8, (nmb, 2), np.int8)
    luma_plane = prep(luma_plane, (16 * mbh, 16 * mbw), np.int16)
    u_dc = prep(u_dc, (nmb, 4), np.int16)
    v_dc = prep(v_dc, (nmb, 4), np.int16)
    u_ac = prep(u_ac, (8 * mbh, 8 * mbw), np.int16)
    v_ac = prep(v_ac, (8 * mbh, 8 * mbw), np.int16)

    cap = max(8192, nmb * 4096)
    out = np.empty(cap, np.uint8)
    hdr = np.frombuffer(header_bytes, np.uint8)
    n = lib.cavlc_pack_pslice_plane(
        hdr.ctypes.data, header_bit_len,
        mv8.ctypes.data, luma_plane.ctypes.data,
        u_dc.ctypes.data, v_dc.ctypes.data,
        u_ac.ctypes.data, v_ac.ctypes.data,
        mbw, mbh, out.ctypes.data, cap)
    if n == -2:
        raise RuntimeError("native packer output buffer overflow")
    if n == -3:
        raise ValueError("level too large for baseline CAVLC")
    if n < 0:
        raise RuntimeError(f"native packer failed ({n})")
    return out[:n].tobytes()


def pack_pslice(header_bytes: bytes, header_bit_len: int, mv: np.ndarray,
                luma16: np.ndarray, chroma_dc: np.ndarray,
                chroma_ac: np.ndarray, mbw: int, mbh: int) -> bytes:
    """Pack one P-slice (header bits + MB layer) and return the EBSP
    payload. Mirrors codecs/h264/inter.pack_p_slice bit-for-bit."""
    lib = _build_and_load()
    nmb = mbw * mbh

    def prep(a, shape):
        a = np.ascontiguousarray(a, np.int32)
        if a.shape != shape:
            raise ValueError(f"bad array shape {a.shape}, want {shape}")
        return a

    mv = prep(mv, (nmb, 2))
    luma16 = prep(luma16, (nmb, 16, 16))
    chroma_dc = prep(chroma_dc, (nmb, 2, 4))
    chroma_ac = prep(chroma_ac, (nmb, 2, 4, 15))

    cap = max(8192, nmb * 4096)
    out = np.empty(cap, np.uint8)
    hdr = np.frombuffer(header_bytes, np.uint8)
    n = lib.cavlc_pack_pslice(
        hdr.ctypes.data, header_bit_len,
        mv.ctypes.data, luma16.ctypes.data,
        chroma_dc.ctypes.data, chroma_ac.ctypes.data,
        mbw, mbh, out.ctypes.data, cap)
    if n == -2:
        raise RuntimeError("native packer output buffer overflow")
    if n == -3:
        raise ValueError("level too large for baseline CAVLC")
    if n < 0:
        raise RuntimeError(f"native packer failed ({n})")
    return out[:n].tobytes()


def block_sparse_unpack2(nblk: int, nval: int, bitmap: np.ndarray,
                         bmask16: np.ndarray, vals: np.ndarray,
                         L: int) -> np.ndarray:
    """Native inverse of torchcore._block_sparse_pack2 → flat int16 levels.

    One memset + one O(nval) scatter instead of numpy's three boolean
    index passes over the full coefficient vector (layout keeps the
    pure-Python implementation as the no-compiler fallback and the
    parity reference)."""
    lib = _build_and_load()
    bitmap = np.ascontiguousarray(bitmap, np.uint8)
    bmask16 = np.ascontiguousarray(bmask16, np.uint16)
    vals = np.ascontiguousarray(vals, np.int8)
    NB = -(-L // 16)
    # Bounds hardening (fuzz-proven under ASan/UBSan,
    # tools/fuzz_native.py): the C scatter trusts the counts to stay
    # inside the caller's buffers — corrupt counts from a torn
    # transfer must fail HERE, not read past the arrays.
    if L <= 0 or nblk < 0 or nval < 0:
        raise ValueError("sparse stream counts out of range")
    if (nblk > bmask16.size or nval > vals.size
            or bitmap.size < -(-NB // 8)):
        raise ValueError("sparse stream counts exceed buffer sizes")
    # np.zeros = calloc: the native scatter relies on the buffer being
    # zeroed, and lazy OS zero-pages beat an explicit 50 MB/GOP memset
    out = np.zeros(NB * 16, np.int16)
    rc = lib.cavlc_sparse_unpack2(
        int(nblk), int(nval), bitmap.ctypes.data, bmask16.ctypes.data,
        vals.ctypes.data, out.ctypes.data, L)
    if rc != 0:
        raise ValueError("sparse level stream inconsistent with counts")
    return out[:L]


def unpack_compact(nblk: int, nval: int, payload: np.ndarray,
                   L: int) -> np.ndarray:
    """Native inverse of torchcore._compact_stream: ONE contiguous compact
    payload (bitmap | bmask16 byte pairs | int8 vals — format pinned in
    codecs/h264/layout.py) → flat int16 levels, parsed in C with no
    intermediate stream views (layout.unpack_compact_host is the
    no-compiler fallback and the parity reference)."""
    lib = _build_and_load()
    payload = np.ascontiguousarray(payload, np.uint8)
    NB = -(-L // 16)
    # Bounds hardening to match block_sparse_unpack2 (the C side also
    # checks payload_len against the counts and returns -2)
    if L <= 0 or nblk < 0 or nval < 0:
        raise ValueError("compact stream counts out of range")
    # np.zeros = calloc, same lazy-zero-page contract as above
    out = np.zeros(NB * 16, np.int16)
    rc = lib.cavlc_unpack_compact(
        int(nblk), int(nval), payload.ctypes.data, payload.nbytes,
        out.ctypes.data, L)
    if rc == -2:
        raise ValueError("compact payload truncated for its counts")
    if rc != 0:
        raise ValueError("compact level stream inconsistent with counts")
    return out[:L]
