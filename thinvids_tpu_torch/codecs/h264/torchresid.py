"""The P step's residual core and the global-motion probe's window costs
as hand-written CUDA kernels (csrc/p_residual.cu: `p_residual_kernel`
and `probe_cost_kernel`): build, bind and launch.

The residual kernel runs one P frame, or a split-frame band stack as one
tall plane, in one launch: residual, forward transform, inter quant,
the chroma DC Hadamard, the optional P_Skip drop and 4x4 nonzero map,
dequant, inverse transform and recon. Its plain version, held to it bit
for bit, is `torchinter.residual_p_ref`; `torchinter._residual_p` takes
the kernel for CUDA tensors and the plain version for CPU tensors.

The probe kernel sums, for each of the 81 candidate windows, the masked
absolute differences between the quarter-res cells of the current frame
(or band stack) and the edge-padded reference. Its plain version is
`torchme.probe_cost_ref`; `torchme.coarse_probe` and
`torchme.banded_probe_cost` build its inputs and take the kernel on the
card.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import rdo, torchme
from .transform import MF_TABLE, V_TABLE

RESID_SOURCE = os.path.join(torchme._PKG, "csrc", "p_residual.cu")
_RESID_SO = os.path.join(torchme._BUILD_DIR, "libp_residual.so")

#: launches of p_residual_kernel / probe_cost_kernel in this process
#: (residual_p_cuda / probe_cost_cuda add one where they launch, and
#: nowhere else); torchme.reset_launch_counts zeroes them with the ME
#: counts
P_RESIDUAL_LAUNCHES = 0
PROBE_LAUNCHES = 0
#: the same two counts per card: {device index: launches}
P_RESIDUAL_LAUNCHES_BY_DEVICE: dict[int, int] = {}
PROBE_LAUNCHES_BY_DEVICE: dict[int, int] = {}
_build_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_table_ready: set = set()
#: (seconds, compiler output) of this process' build, None if the
#: library was already built
BUILD_INFO: tuple[float, str] | None = None


def _table_blob() -> np.ndarray:
    """The residual kernel's constant tables as one int32 vector, in the
    layout csrc/p_residual.cu reads (kMfOff, kVOff): MF and V by qp % 6
    and raster position, from transform.py."""
    return np.concatenate([np.asarray(MF_TABLE).reshape(-1),
                           np.asarray(V_TABLE).reshape(-1)]).astype(np.int32)


def load_resid_library() -> ctypes.CDLL:
    """Build csrc/p_residual.cu with nvcc (first use, or when the source
    is newer than the library) and load it. Raises on any failure."""
    global _lib, BUILD_INFO
    with _build_lock:
        if _lib is not None:
            return _lib
        info = torchme.build_library(RESID_SOURCE, _RESID_SO)
        if info is not None:
            BUILD_INFO = info
        lib = ctypes.CDLL(_RESID_SO)
        for fn in (lib.p_tables_len, lib.probe_qsr):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        lib.p_set_tables.restype = ctypes.c_int
        lib.p_set_tables.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.p_residual_launch.restype = ctypes.c_int
        lib.p_residual_launch.argtypes = (
            [ctypes.c_void_p] * 6                 # cur y/u/v, pred y/u/v
            + [ctypes.c_int] * 6      # mbh, mbw, qp, qpc, pskip, pskip_sum
            + [ctypes.c_void_p] * 7               # levels, recon, nz4
            + [ctypes.c_void_p])                  # stream
        lib.probe_cost_launch.restype = ctypes.c_int
        lib.probe_cost_launch.argtypes = (
            [ctypes.c_void_p] * 3                 # cq, rq_ext, mask
            + [ctypes.c_int] * 3                  # B, hc, wc
            + [ctypes.c_void_p] * 2)              # cost, stream
        if lib.p_tables_len() != len(_table_blob()):
            raise RuntimeError(
                f"{RESID_SOURCE} reads {lib.p_tables_len()} table values, "
                f"the wrapper packs {len(_table_blob())}")
        if lib.probe_qsr() != torchme.SEARCH_RANGE // torchme._COARSE:
            raise RuntimeError(
                f"{RESID_SOURCE} probes {lib.probe_qsr()} cells a side, "
                f"the search range is "
                f"{torchme.SEARCH_RANGE // torchme._COARSE}")
        _lib = lib
        return lib


def zero_counts() -> None:
    """Zero the residual and probe launch counts (torchme.
    reset_launch_counts calls this under its count lock)."""
    global P_RESIDUAL_LAUNCHES, PROBE_LAUNCHES
    P_RESIDUAL_LAUNCHES = PROBE_LAUNCHES = 0
    P_RESIDUAL_LAUNCHES_BY_DEVICE.clear()
    PROBE_LAUNCHES_BY_DEVICE.clear()


def _ensure_tables(lib, device: torch.device) -> None:
    """Copy the table blob into the kernel's constant memory once per
    card."""
    idx = device.index
    with _build_lock:
        if idx in _table_ready:
            return
        blob = _table_blob()
        with torch.cuda.device(idx):
            rc = lib.p_set_tables(blob.ctypes.data, len(blob))
        if rc != 0:
            raise RuntimeError(f"p_set_tables failed (cuda error {rc})")
        _table_ready.add(idx)


def residual_p_cuda(cy16, cu16, cv16, pred_y, pred_u, pred_v, qp: int,
                    qpc: int, *, mbw: int, mbh: int, pskip: bool = False,
                    nz4: bool = False):
    """The residual kernel on CUDA tensors, with the contract of
    :func:`torchinter.residual_p_ref` (``pskip`` and ``nz4`` as
    ``rd.pskip`` and ``rd.deblock``): cy16 / pred_y int16 (16 mbh,
    16 mbw), the chroma planes int16 (8 mbh, 8 mbw), contiguous, on one
    card, every sample in [0, 255]. Returns (luma levels (H, W),
    chroma_dc (2, nmb, 4), chroma_ac (2, H/2, W/2), recon_y, recon_u,
    recon_v) int16 and nz4 ((4 mbh, 4 mbw) bool, or None). One launch on
    the current stream; never synchronizes."""
    global P_RESIDUAL_LAUNCHES
    H, W = 16 * mbh, 16 * mbw
    if mbh <= 0 or mbw <= 0:
        raise ValueError(f"an empty frame: {mbh} x {mbw} MBs")
    named = (("cy16", cy16), ("cu16", cu16), ("cv16", cv16),
             ("pred_y", pred_y), ("pred_u", pred_u), ("pred_v", pred_v))
    for name, t in named:
        shape = (H, W) if name in ("cy16", "pred_y") else (H // 2, W // 2)
        torchme._check(name, t, shape, torch.int16)
        if t.data_ptr() % 8:
            raise ValueError(f"{name}: want a start aligned to 8 bytes")
    dev = torchme._on_card(*named)
    lib = load_resid_library()
    _ensure_tables(lib, dev)
    n = mbw * mbh

    def new(*shape, dtype=torch.int16):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = (new(H, W), new(2, n, 4), new(2, H // 2, W // 2), new(H, W),
            new(H // 2, W // 2), new(H // 2, W // 2))
    nz = new(4 * mbh, 4 * mbw, dtype=torch.bool) if nz4 else None
    args = ([t.data_ptr() for _, t in named]
            + [mbh, mbw, int(qp), int(qpc), int(bool(pskip)),
               rdo.PSKIP_SUM]
            + [t.data_ptr() for t in outs]
            + [None if nz is None else nz.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream])
    with torch.cuda.device(dev):
        rc = lib.p_residual_launch(*args)
    if rc != 0:
        raise RuntimeError(f"P residual launch failed (cuda error {rc})")
    with torchme._count_lock:
        P_RESIDUAL_LAUNCHES += 1
        P_RESIDUAL_LAUNCHES_BY_DEVICE[dev.index] = \
            P_RESIDUAL_LAUNCHES_BY_DEVICE.get(dev.index, 0) + 1
    return outs + (nz,)


def probe_cost_cuda(cq, rq_ext, mask):
    """The probe kernel on CUDA tensors, with the contract of
    :func:`torchme.probe_cost_ref`: cq int32 (B, hc, wc) quarter-res
    cells, rq_ext int32 (B, hc + 2 qsr, wc + 2 qsr) the padded or
    halo-extended reference cells (qsr = SEARCH_RANGE / 4), mask bool
    (B, hc) the rows that count, contiguous, on one card. Returns the
    ((2 qsr + 1)^2,) int32 cost summed over the stack, wrapping as an
    int32 sum. One launch on the current stream; never synchronizes."""
    global PROBE_LAUNCHES
    if cq.dim() != 3:
        raise ValueError(f"cq: want a (B, hc, wc) stack, got "
                         f"{tuple(cq.shape)}")
    B, hc, wc = (int(d) for d in cq.shape)
    if B <= 0 or hc <= 0 or wc <= 0:
        raise ValueError(f"cq: an empty stack {tuple(cq.shape)}")
    qsr = torchme.SEARCH_RANGE // torchme._COARSE
    torchme._check("cq", cq, (B, hc, wc), torch.int32)
    torchme._check("rq_ext", rq_ext, (B, hc + 2 * qsr, wc + 2 * qsr),
                   torch.int32)
    torchme._check("mask", mask, (B, hc), torch.bool)
    dev = torchme._on_card(("cq", cq), ("rq_ext", rq_ext), ("mask", mask))
    lib = load_resid_library()
    cost = torch.empty((2 * qsr + 1) ** 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.probe_cost_launch(
            cq.data_ptr(), rq_ext.data_ptr(), mask.data_ptr(), B, hc, wc,
            cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe cost launch failed (cuda error {rc})")
    with torchme._count_lock:
        PROBE_LAUNCHES += 1
        PROBE_LAUNCHES_BY_DEVICE[dev.index] = \
            PROBE_LAUNCHES_BY_DEVICE.get(dev.index, 0) + 1
    return cost
