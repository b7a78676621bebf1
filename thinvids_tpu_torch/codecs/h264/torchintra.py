"""The intra core of IDR frames as hand-written CUDA kernels
(csrc/intra_core.cu: `intra_row0_kernel` and `intra_cols_kernel`),
batched over frames or split-frame bands: build, bind and launch.

With mode decision off the encoder predicts MB (0, 0) DC-128, the rest
of MB row 0 horizontally and every later row vertically, so row 0 is one
chain along the row and each MB column below it a chain down the rows:
one launch walks row 0 of every item, the next every column of every
item. The plain version the kernels are held to, bit for bit, is
`torchcore.intra_core_batch_ref`; `torchcore.intra_core_batch` takes the
kernels for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import torchme
from .intra import LUMA_BLOCK_ORDER
from .transform import CHROMA_QP_TABLE, MF_TABLE, V_TABLE, ZIGZAG_4x4

INTRA_SOURCE = os.path.join(torchme._PKG, "csrc", "intra_core.cu")
_INTRA_SO = os.path.join(torchme._BUILD_DIR, "libintra_core.so")

#: launches of intra_row0_kernel / intra_cols_kernel in this process
#: (intra_core_batch_cuda adds one to each where it launches it, and
#: nowhere else); torchme.reset_launch_counts zeroes them with the ME
#: counts
INTRA_ROW0_LAUNCHES = 0
INTRA_COLS_LAUNCHES = 0
#: the same two counts per card: {device index: launches}
INTRA_ROW0_LAUNCHES_BY_DEVICE: dict[int, int] = {}
INTRA_COLS_LAUNCHES_BY_DEVICE: dict[int, int] = {}
_build_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_table_ready: set = set()
#: (seconds, compiler output) of this process' build, None if the
#: library was already built
BUILD_INFO: tuple[float, str] | None = None


def _table_blob() -> np.ndarray:
    """The kernels' constant tables as one int32 vector, in the layout
    csrc/intra_core.cu reads (kMfOff .. kQpcOff): MF and V by qp % 6 and
    raster position, the zig-zag scan and its inverse, the z-scan slot
    of each raster luma block, the chroma QP of qp 0..51. transform.py
    and intra.LUMA_BLOCK_ORDER are their one source."""
    zscan = np.asarray([by * 4 + bx for (bx, by) in LUMA_BLOCK_ORDER])
    return np.concatenate([
        np.asarray(MF_TABLE).reshape(-1), np.asarray(V_TABLE).reshape(-1),
        np.asarray(ZIGZAG_4x4), np.argsort(ZIGZAG_4x4), np.argsort(zscan),
        np.asarray(CHROMA_QP_TABLE)]).astype(np.int32)


def load_intra_library() -> ctypes.CDLL:
    """Build csrc/intra_core.cu with nvcc (first use, or when the source
    is newer than the library) and load it. Raises on any failure."""
    global _lib, BUILD_INFO
    with _build_lock:
        if _lib is not None:
            return _lib
        info = torchme.build_library(INTRA_SOURCE, _INTRA_SO)
        if info is not None:
            BUILD_INFO = info
        lib = ctypes.CDLL(_INTRA_SO)
        lib.intra_tables_len.restype = ctypes.c_int
        lib.intra_tables_len.argtypes = []
        lib.intra_set_tables.restype = ctypes.c_int
        lib.intra_set_tables.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for fn in (lib.intra_row0_launch, lib.intra_cols_launch):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4          # y, u, v, qp
                           + [ctypes.c_int] * 3           # B, mbh, mbw
                           + [ctypes.c_void_p] * 7        # levels, recon
                           + [ctypes.c_void_p])           # stream
        if lib.intra_tables_len() != len(_table_blob()):
            raise RuntimeError(
                f"{INTRA_SOURCE} reads {lib.intra_tables_len()} table "
                f"values, the wrapper packs {len(_table_blob())}")
        _lib = lib
        return lib


def zero_counts() -> None:
    """Zero the intra launch counts (torchme.reset_launch_counts calls
    this under its count lock)."""
    global INTRA_ROW0_LAUNCHES, INTRA_COLS_LAUNCHES
    INTRA_ROW0_LAUNCHES = INTRA_COLS_LAUNCHES = 0
    INTRA_ROW0_LAUNCHES_BY_DEVICE.clear()
    INTRA_COLS_LAUNCHES_BY_DEVICE.clear()


def _ensure_tables(lib, device: torch.device) -> None:
    """Copy the table blob into the kernels' constant memory once per
    card."""
    idx = device.index
    with _build_lock:
        if idx in _table_ready:
            return
        blob = _table_blob()
        with torch.cuda.device(idx):
            rc = lib.intra_set_tables(blob.ctypes.data, len(blob))
        if rc != 0:
            raise RuntimeError(f"intra_set_tables failed (cuda error {rc})")
        _table_ready.add(idx)


def intra_core_batch_cuda(ys, us, vs, qp_mb, *, mbw: int, mbh: int):
    """The intra kernel pair on CUDA tensors, with the contract of
    :func:`torchcore.intra_core_batch_ref`: ys uint8 (B, 16 mbh, 16 mbw),
    us / vs uint8 (B, 8 mbh, 8 mbw), qp_mb int32 (B, mbh mbw) with values
    in 0..51, all contiguous on one card. Returns (luma_dc (B, nmb, 16),
    luma_ac (B, nmb, 16, 15), chroma_dc (B, nmb, 2, 4), chroma_ac (B,
    nmb, 2, 4, 15), recon_y, recon_u, recon_v), all int32. Two launches
    on the current stream, whatever B; never synchronizes."""
    global INTRA_ROW0_LAUNCHES, INTRA_COLS_LAUNCHES
    if ys.dim() != 3:
        raise ValueError(f"ys: want a (B, H, W) stack, got "
                         f"{tuple(ys.shape)}")
    B = int(ys.shape[0])
    nmb = mbw * mbh
    for name, t, shape, dtype in (
            ("ys", ys, (B, 16 * mbh, 16 * mbw), torch.uint8),
            ("us", us, (B, 8 * mbh, 8 * mbw), torch.uint8),
            ("vs", vs, (B, 8 * mbh, 8 * mbw), torch.uint8),
            ("qp_mb", qp_mb, (B, nmb), torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor")
    if B <= 0 or nmb <= 0:
        raise ValueError(f"an empty batch: {B} items of {mbh} x {mbw} MBs")
    dev = ys.device
    for name, t in (("ys", ys), ("us", us), ("vs", vs), ("qp_mb", qp_mb)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the intra kernels need CUDA tensors, "
                             f"got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the frames are on "
                             f"{dev}")
    lib = load_intra_library()
    _ensure_tables(lib, dev)

    def new(*shape):
        return torch.empty((B,) + shape, dtype=torch.int32, device=dev)

    outs = (new(nmb, 16), new(nmb, 16, 15), new(nmb, 2, 4),
            new(nmb, 2, 4, 15), new(16 * mbh, 16 * mbw),
            new(8 * mbh, 8 * mbw), new(8 * mbh, 8 * mbw))
    args = ([t.data_ptr() for t in (ys, us, vs, qp_mb)] + [B, mbh, mbw]
            + [t.data_ptr() for t in outs]
            + [torch.cuda.current_stream(dev).cuda_stream])
    with torch.cuda.device(dev):
        rc = lib.intra_row0_launch(*args)
    if rc != 0:
        raise RuntimeError(f"intra row-0 launch failed (cuda error {rc})")
    with torchme._count_lock:
        INTRA_ROW0_LAUNCHES += 1
        INTRA_ROW0_LAUNCHES_BY_DEVICE[dev.index] = \
            INTRA_ROW0_LAUNCHES_BY_DEVICE.get(dev.index, 0) + 1
    with torch.cuda.device(dev):
        rc = lib.intra_cols_launch(*args)
    if rc != 0:
        raise RuntimeError(f"intra columns launch failed (cuda error {rc})")
    with torchme._count_lock:
        INTRA_COLS_LAUNCHES += 1
        INTRA_COLS_LAUNCHES_BY_DEVICE[dev.index] = \
            INTRA_COLS_LAUNCHES_BY_DEVICE.get(dev.index, 0) + 1
    return outs
