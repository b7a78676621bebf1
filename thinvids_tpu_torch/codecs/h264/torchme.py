"""Half-pel motion search + compensation: a hand-written CUDA kernel
(csrc/me_search.cu) and its plain PyTorch version.

For one P frame and every 16x16 macroblock the search scores the 227
candidates of OFFSET_TABLE around three even-pel centres (the coarse
global-motion probe, the previous frame's median MV, zero), keeps the
first strictly lower cost (luma SAD + LAMBDA_H[qp] * (|mvy| + |mvx|),
half-pel units) and emits the winning luma prediction — H.264 6-tap
b/h/j planes (§8.4.2.2.1), j from the unrounded horizontal
intermediates — and the eighth-pel bilinear chroma prediction
(§8.4.2.2.2). Motion search and compensation are one pass.

`me_search_ref` is the plain version: it takes the CPU path and is what
the kernel is held against on the card. `me_search` launches the kernel
for CUDA tensors and never falls back to the plain version there.

MV units are HALF-PEL throughout (the entropy packers scale mvd by 2
to quarter-pel units).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np
import torch

SEARCH_RANGE = 16          # max |mv| in integer pel
_WR = 4                    # integer window radius (pel) around each center
_HR = 3                    # fine half-pel window radius (half units)
_ZR = 2                    # zero-window radius (half units)
_CLIM = SEARCH_RANGE - _WR     # center clamp (pel)

# MV-cost lambda per half-pel unit of |mv|, indexed by QP. Scales with
# the quantizer like x264's lambda (2^((qp-12)/6) per bit, ~2.5 bits
# per half unit of mvd): without QP scaling, half-pel candidates
# "denoise" the reference's quant error on static content and beat the
# zero vector, killing P_Skip runs.
LAMBDA_H = np.maximum(
    3, np.round(2.5 * 2.0 ** ((np.arange(52) - 12) / 6.0))).astype(np.int32)

# Edge-padding halos of the plain version: generous enough that center
# roll + window offset + 6-tap reach never leaves real samples (the
# kernel reads with clamped coordinates instead, which is the same).
_PV = 32                   # luma top pad rows
_PH = 24                   # luma left pad lanes
_PVC = 16                  # chroma top pad rows
_PHC = 16                  # chroma left pad lanes


# ---------------------------------------------------------------------------
# offset tables (static; shared by the kernel and the plain version)
# ---------------------------------------------------------------------------

def _window_classes(int_rad_pel: int, fine_rad_half: int
                    ) -> list[tuple[tuple[int, int], list[int], list[int]]]:
    """[(parity (py, px), wys, wxs)] — the ± `int_rad_pel` integer grid
    plus the ± `fine_rad_half` fine grid's non-integer parities, all in
    half-pel units."""
    ir, fr = int_rad_pel, fine_rad_half
    evens = [w for w in range(-fr, fr + 1) if w % 2 == 0]
    odds = [w for w in range(-fr, fr + 1) if abs(w) % 2 == 1]
    return [
        ((0, 0), [2 * d for d in range(-ir, ir + 1)],
         [2 * d for d in range(-ir, ir + 1)]),
        ((0, 1), evens, odds),      # horizontal half (b plane)
        ((1, 0), odds, evens),      # vertical half (h plane)
        ((1, 1), odds, odds),       # diagonal half (j plane)
    ]


CENTER_CLASSES = _window_classes(_WR, _HR)
#: the temporal-median center keeps only its integer window
CENTER_B_CLASSES = CENTER_CLASSES[:1]
ZERO_CLASSES = _window_classes(_ZR // 2, _ZR)


def _class_offsets(classes) -> list[tuple[int, int]]:
    return [(wy, wx) for (_par, wys, wxs) in classes
            for wy in wys for wx in wxs]


#: (center_index, wy, wx) in selection order; strict '<' keeps the first
#: best, so earlier entries win ties. Center 2 is the zero vector.
OFFSET_TABLE: list[tuple[int, int, int]] = (
    [(0,) + o for o in _class_offsets(CENTER_CLASSES)]
    + [(1,) + o for o in _class_offsets(CENTER_B_CLASSES)]
    + [(2,) + o for o in _class_offsets(ZERO_CLASSES)]
)


# ---------------------------------------------------------------------------
# H.264 6-tap half-pel interpolation (§8.4.2.2.1)
# ---------------------------------------------------------------------------

def _tap6(x, roll):
    """6-tap: out[l] = x[l-2] -5x[l-1] +20x[l] +20x[l+1] -5x[l+2]
    +x[l+3]. `roll(x, k)` must move element l to l+k."""
    return (roll(x, 2) - 5 * roll(x, 1) + 20 * x + 20 * roll(x, -1)
            - 5 * roll(x, -2) + roll(x, -3))


def _halfpel_planes(r32):
    """(R, B, H, J) planes from an int32 full-pel plane. B = horizontal
    half (b), H = vertical half (h), J = diagonal (j, from the
    unrounded horizontal intermediates). Edge lanes/rows hold garbage
    within the pad halo — callers never slice them."""
    def roll_rows(x, k):
        return torch.roll(x, k, dims=0)

    def roll_lanes(x, k):
        return torch.roll(x, k, dims=1)
    hb1 = _tap6(r32, roll_lanes)
    b = torch.clamp((hb1 + 16) >> 5, 0, 255)
    vb1 = _tap6(r32, roll_rows)
    h = torch.clamp((vb1 + 16) >> 5, 0, 255)
    j1 = _tap6(hb1, roll_rows)
    j = torch.clamp((j1 + 512) >> 10, 0, 255)
    return (r32, b, h, j)


def _edge_pad(x, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of a 2-D tensor (any dtype), as a gather of
    clamped coordinates."""
    H, W = x.shape
    rows = torch.arange(-top, H + bottom, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=x.device).clamp(0, W - 1)
    return x[rows][:, cols]


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def me_search_ref(cur_y, ref_y, ref_u, ref_v, centers, lam):
    """Plain PyTorch motion search + compensation: same OFFSET_TABLE,
    same strict-< selection, same interpolation as the kernel. cur_y
    int16 (H, W), H and W multiples of 16; ref planes int16; centers
    (3, 2) int32 even-pel, |c| <= 12; lam 0-d int32. Returns (mv (mbh,
    mbw, 2) int32 half-pel, pred_y, pred_u, pred_v int16).

    The centers are read on the host (the shifts they drive are
    Python ints), so this version synchronizes with the device; it is
    never the CUDA main path."""
    H, W = cur_y.shape
    mbh, mbw = H // 16, W // 16
    dev = cur_y.device
    cur = cur_y.to(torch.int32)
    ry = _edge_pad(ref_y, _PV, _PV, _PH, _PH).to(torch.int32)
    ru = _edge_pad(ref_u, _PVC, _PVC + 8, _PHC, _PHC + 8).to(torch.int32)
    rv = _edge_pad(ref_v, _PVC, _PVC + 8, _PHC, _PHC + 8).to(torch.int32)
    lam = lam.to(torch.int32)
    cents = [(int(c[0]), int(c[1])) for c in centers.cpu().tolist()]

    bestc = torch.full((mbh, mbw), 2**30, dtype=torch.int32, device=dev)
    bmy = torch.zeros((mbh, mbw), dtype=torch.int32, device=dev)
    bmx = torch.zeros((mbh, mbw), dtype=torch.int32, device=dev)
    py = torch.zeros((H, W), dtype=torch.int32, device=dev)
    pu = torch.zeros((H // 2, W // 2), dtype=torch.int32, device=dev)
    pv = torch.zeros((H // 2, W // 2), dtype=torch.int32, device=dev)
    h2, w2 = H // 2, W // 2

    for ci in range(3):
        cy, cx = cents[ci]
        Rc = torch.roll(ry, (-cy, -cx), dims=(0, 1))
        planes = _halfpel_planes(Rc)
        CUc = torch.roll(ru, (-(cy >> 1), -(cx >> 1)), dims=(0, 1))
        CVc = torch.roll(rv, (-(cy >> 1), -(cx >> 1)), dims=(0, 1))
        for (c, wy, wx) in OFFSET_TABLE:
            if c != ci:
                continue
            my, mx = wy >> 1, wx >> 1
            plane = planes[(wy & 1) * 2 + (wx & 1)]
            cand = plane[_PV + my:_PV + my + H, _PH + mx:_PH + mx + W]
            sad = torch.abs(cur - cand).reshape(mbh, 16, mbw, 16).sum(
                dim=(1, 3)).to(torch.int32)
            mvy = 2 * cy + wy
            mvx = 2 * cx + wx
            cost = sad + lam * (abs(mvy) + abs(mvx))
            take = cost < bestc
            bestc = torch.where(take, cost, bestc)
            bmy = torch.where(take, mvy, bmy)
            bmx = torch.where(take, mvx, bmx)
            tly = take[:, None, :, None].expand(mbh, 16, mbw, 16).reshape(
                H, W)
            py = torch.where(tly, cand, py)
            # §8.4.2.2.2 bilinear; weights (8-ex)(8-ey) etc. with
            # eighth-pel fracs (w & 3) * 2 — exact for frac 0 too.
            ey = (wy & 3) * 2
            ex = (wx & 3) * 2
            oy, ox = _PVC + (wy >> 2), _PHC + (wx >> 2)

            def cpred(C):
                a = C[oy:oy + h2, ox:ox + w2]
                b = C[oy:oy + h2, ox + 1:ox + 1 + w2]
                c_ = C[oy + 1:oy + 1 + h2, ox:ox + w2]
                d = C[oy + 1:oy + 1 + h2, ox + 1:ox + 1 + w2]
                return ((8 - ex) * (8 - ey) * a + ex * (8 - ey) * b
                        + (8 - ex) * ey * c_ + ex * ey * d + 32) >> 6

            tlc = take[:, None, :, None].expand(mbh, 8, mbw, 8).reshape(
                h2, w2)
            pu = torch.where(tlc, cpred(CUc), pu)
            pv = torch.where(tlc, cpred(CVc), pv)

    mv = torch.stack([bmy, bmx], dim=-1)
    return (mv, py.to(torch.int16), pu.to(torch.int16), pv.to(torch.int16))


# ---------------------------------------------------------------------------
# centers: coarse global-motion probe + carried median
# ---------------------------------------------------------------------------

_COARSE = 4


def _box_sum(x, s: int):
    H, W = x.shape
    return x.reshape(H // s, s, W // s, s).sum(dim=(1, 3)).to(torch.int32)


def coarse_probe(cur16, ref16, sr: int = SEARCH_RANGE):
    """Global-motion probe on box-summed quarter-res planes. Returns a
    (2,) int32 center in pel, multiple of _COARSE (hence even)."""
    qs = _COARSE
    cq = _box_sum(cur16, qs)
    rq = _box_sum(ref16, qs)
    qsr = sr // qs
    rq_pad = _edge_pad(rq, qsr, qsr, qsr, qsr)
    qh, qw = cq.shape
    n = 2 * qsr + 1
    wins = torch.stack([rq_pad[oy:oy + qh, ox:ox + qw]
                        for oy in range(n) for ox in range(n)])
    cost = torch.abs(cq[None] - wins).sum(dim=(1, 2))
    bi = torch.argmin(cost).to(torch.int32)      # first minimum
    return torch.stack([bi // n - qsr, bi % n - qsr]) * qs


def hist_median(mv_flat, lim: int):
    """Per-component median of an (n, 2) int field via histogram +
    cumsum."""
    n = mv_flat.shape[0]
    bins = torch.arange(-lim, lim + 1, device=mv_flat.device)
    cnt = (mv_flat[:, None, :] == bins[None, :, None]).sum(dim=0)
    cum = torch.cumsum(cnt, dim=0)
    hit = (cum >= (n + 1) // 2).to(torch.int32)
    return (torch.argmax(hit, dim=0) - lim).to(torch.int32)


def centers_from(cur16, ref16, pred_mv_h):
    """(3, 2) even-pel centers: probe, carried-median, zero.
    pred_mv_h is the previous frame's median MV in half units."""
    probe = coarse_probe(cur16, ref16)
    med_pel = torch.clamp((pred_mv_h.to(torch.int32) + 2) >> 2,
                          -(_CLIM // 2), _CLIM // 2) * 2
    probe = torch.clamp(probe, -_CLIM, _CLIM)
    zero = torch.zeros(2, dtype=torch.int32, device=cur16.device)
    return torch.stack([probe, med_pel, zero]).to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ME_SOURCE = os.path.join(_PKG, "csrc", "me_search.cu")
_BUILD_DIR = os.path.join(_PKG, "csrc", "_build")
_ME_SO = os.path.join(_BUILD_DIR, "libme_search.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: number of ME kernel launches in this process (me_search_cuda adds one
#: per launch and nowhere else)
ME_KERNEL_LAUNCHES = 0
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_table_ready: set = set()
#: (seconds, compiler output) of this process' build, None if the
#: library was already built
BUILD_INFO: tuple[float, str] | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no nvcc); the ME "
                           "kernel cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_me_library() -> ctypes.CDLL:
    """Build csrc/me_search.cu with nvcc (first use, or when the source
    is newer than the library) and load it. Raises on any failure."""
    global _lib, BUILD_INFO
    with _build_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_ME_SO)
                or os.path.getmtime(_ME_SO) < os.path.getmtime(ME_SOURCE)):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = _ME_SO + f".tmp.{os.getpid()}"
            t0 = time.perf_counter()
            try:
                res = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, ME_SOURCE, "-o", tmp],
                    capture_output=True, text=True, timeout=600)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}):\n{res.stderr}")
                os.replace(tmp, _ME_SO)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            BUILD_INFO = (time.perf_counter() - t0,
                          res.stdout + res.stderr)
        lib = ctypes.CDLL(_ME_SO)
        lib.me_search_set_table.restype = ctypes.c_int
        lib.me_search_set_table.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.me_search_launch.restype = ctypes.c_int
        lib.me_search_launch.argtypes = (
            [ctypes.c_void_p] * 6                 # cur, ry, ru, rv, cent, lam
            + [ctypes.c_int, ctypes.c_int]        # H, W
            + [ctypes.c_void_p] * 4               # mv, py, pu, pv
            + [ctypes.c_void_p])                  # stream
        _lib = lib
        return lib


def _ensure_table(lib, device: torch.device) -> None:
    """Copy OFFSET_TABLE into the kernel's constant memory once per
    device (the table's single source of truth is this module)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _build_lock:
        if idx in _table_ready:
            return
        tab = np.asarray(OFFSET_TABLE, np.int8).reshape(-1)
        with torch.cuda.device(idx):
            rc = lib.me_search_set_table(tab.ctypes.data, len(OFFSET_TABLE))
        if rc != 0:
            raise RuntimeError(f"me_search_set_table failed (cuda error "
                               f"{rc})")
        _table_ready.add(idx)


def me_search_cuda(cur_y, ref_y, ref_u, ref_v, centers, lam):
    """The ME kernel (csrc/me_search.cu) on CUDA tensors: same contract
    as :func:`me_search_ref`. Launches on the current stream and never
    synchronizes: centers and lam stay on the device."""
    global ME_KERNEL_LAUNCHES
    if cur_y.device.type != "cuda":
        raise ValueError("me_search_cuda needs CUDA tensors, got "
                         f"{cur_y.device}")
    H, W = cur_y.shape
    if H % 16 or W % 16 or H <= 0 or W <= 0:
        raise ValueError(f"frame {H}x{W} is not a multiple of 16")
    want = (("cur_y", cur_y, (H, W), torch.int16),
            ("ref_y", ref_y, (H, W), torch.int16),
            ("ref_u", ref_u, (H // 2, W // 2), torch.int16),
            ("ref_v", ref_v, (H // 2, W // 2), torch.int16),
            ("centers", centers, (3, 2), torch.int32))
    for name, t, shape, dtype in want:
        if (t.device != cur_y.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{cur_y.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if (lam.device != cur_y.device or lam.dtype != torch.int32
            or lam.numel() != 1):
        raise ValueError("lam: want one int32 value on the frame's device")
    lib = load_me_library()
    _ensure_table(lib, cur_y.device)
    dev = cur_y.device
    mv = torch.empty((H // 16, W // 16, 2), dtype=torch.int32, device=dev)
    py = torch.empty((H, W), dtype=torch.int16, device=dev)
    pu = torch.empty((H // 2, W // 2), dtype=torch.int16, device=dev)
    pv = torch.empty((H // 2, W // 2), dtype=torch.int16, device=dev)
    lam = lam.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.me_search_launch(
            cur_y.data_ptr(), ref_y.data_ptr(), ref_u.data_ptr(),
            ref_v.data_ptr(), centers.data_ptr(), lam.data_ptr(), H, W,
            mv.data_ptr(), py.data_ptr(), pu.data_ptr(), pv.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"ME kernel launch failed (cuda error {rc})")
    with _count_lock:
        ME_KERNEL_LAUNCHES += 1
    return mv, py, pu, pv


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def lambda_for(qp: int, device) -> torch.Tensor:
    """LAMBDA_H[clip(qp)] as a 0-d int32 tensor on `device`."""
    return torch.full((), int(LAMBDA_H[min(51, max(0, int(qp)))]),
                      dtype=torch.int32, device=device)


def me_search(cur_y16, ref_y16, ref_u16, ref_v16, pred_mv_h, qp: int):
    """Full ME+MC for one P frame. Inputs int16 planes (H, W multiples
    of 16); pred_mv_h (2,) int32 half-pel (previous frame's median);
    qp the frame's quantizer (drives the MV-cost lambda).
    Returns (mv (mbh, mbw, 2) int32 half-pel, pred_y, pred_u, pred_v
    int16, med_mv_h (2,) int32). CUDA tensors go through the kernel,
    CPU tensors through the plain version."""
    centers = centers_from(cur_y16, ref_y16, pred_mv_h)
    lam = lambda_for(qp, cur_y16.device)
    if cur_y16.device.type == "cuda":
        mv, pred_y, pred_u, pred_v = me_search_cuda(
            cur_y16.contiguous(), ref_y16.contiguous(),
            ref_u16.contiguous(), ref_v16.contiguous(), centers, lam)
    else:
        mv, pred_y, pred_u, pred_v = me_search_ref(
            cur_y16, ref_y16, ref_u16, ref_v16, centers, lam)
    med = hist_median(mv.reshape(-1, 2), 2 * SEARCH_RANGE)
    return mv, pred_y, pred_u, pred_v, med
