"""Half-pel motion search + compensation: hand-written CUDA kernels
(csrc/me_search.cu: a per-frame half-pel prepass and the search) and
their plain PyTorch versions.

For one P frame and every 16x16 macroblock the search scores the 227
candidates of OFFSET_TABLE around three even-pel centres (the coarse
global-motion probe, the previous frame's median MV, zero), keeps the
first strictly lower cost (luma SAD + LAMBDA_H[qp] * (|mvy| + |mvx|),
half-pel units) and emits the winning luma prediction — H.264 6-tap
b/h/j planes (§8.4.2.2.1), j from the unrounded horizontal
intermediates — and the eighth-pel bilinear chroma prediction
(§8.4.2.2.2). Motion search and compensation are one pass.

`me_search_ref` is the plain version: it takes the CPU path and is what
the kernels are held against on the card (`halfpel_planes_ref` is the
prepass's own, for the tests). `me_search` launches the kernels for
CUDA tensors and never falls back to the plain version there.

Split-frame encoding searches B MB-row bands of one frame at once
(`me_search_banded`): the bands sit in a (B, Hb, W) stack on one card,
each is extended by `halo_rows` reference rows of its neighbours
(`band_halo_exchange`: slices of the stack where the reference moves
rows between devices with `lax.ppermute`), the global-motion probe and
the carried median sum their per-band parts over the band dimension
(the reference's `lax.psum`), and both kernels run once over the whole
stack. Every plain and kernel entry takes a (H, W) frame or a (B, H, W)
stack.

MV units are HALF-PEL throughout (the entropy packers scale mvd by 2
to quarter-pel units).
"""

from __future__ import annotations

import ctypes
import functools
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

#: margin, in luma samples on every side, of the per-frame half-pel
#: planes the CUDA kernel searches: a centre reaches _CLIM pel, the
#: integer window _WR pel further, and the fine grid's -2..+1 pel stays
#: inside that. The 6-tap's -2..+3 reach beyond it goes through clamped
#: reads. It sizes the wrapper's scratch; the kernel's kHalo must agree.
ME_HALO = _CLIM + _WR


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


def halfpel_planes_ref(ref_y):
    """Plain version of the kernel's prepass: the full-pel, b, h and j
    planes of `ref_y` (int16 (H, W), values in [0, 255]) as uint8
    (4, H + 2 ME_HALO, W + 2 ME_HALO); [p, r, c] is the value at pel
    (r - ME_HALO, c - ME_HALO), reads outside the frame clamped. Same
    roundings as `_halfpel_planes`, written without rolls. A (B, H, W)
    band stack gives (B, 4, ...), band by band."""
    if ref_y.dim() == 3:
        return torch.stack([halfpel_planes_ref(b) for b in ref_y])
    h = ME_HALO
    r = _edge_pad(ref_y, h + 2, h + 3, h + 2, h + 3).to(torch.int32)

    def tap(x, dim):     # out[l] = 6-tap centred between l + 2 and l + 3
        n = x.shape[dim] - 5
        s = [x.narrow(dim, k, n) for k in range(6)]
        return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]

    hb1 = tap(r, 1)                       # rows still carry the 2/3 reach
    f = r[2:-3, 2:-3]
    b = torch.clamp((hb1[2:-3] + 16) >> 5, 0, 255)
    hh = torch.clamp((tap(r[:, 2:-3], 0) + 16) >> 5, 0, 255)
    j = torch.clamp((tap(hb1, 0) + 512) >> 10, 0, 255)
    return torch.stack([f, b, hh, j]).to(torch.uint8)


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
    never the CUDA main path. (B, H, W) band stacks (chroma (B, H/2,
    W/2)) search band by band, every band at the same centers and lam,
    and give each output with a leading band dimension."""
    if cur_y.dim() == 3:
        outs = [me_search_ref(*band, centers, lam)
                for band in zip(cur_y, ref_y, ref_u, ref_v)]
        return tuple(torch.stack(parts) for parts in zip(*outs))
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

#: number of search-kernel launches in this process
#: (me_search_planes_cuda adds one per launch and nowhere else)
ME_KERNEL_LAUNCHES = 0
#: number of half-pel prepass launches in this process
#: (halfpel_planes_cuda adds one per launch and nowhere else)
ME_PREPASS_LAUNCHES = 0
#: the same two counts per card: {device index: launches}. A mesh
#: launches the kernels of each entry on the entry's card.
ME_KERNEL_LAUNCHES_BY_DEVICE: dict[int, int] = {}
ME_PREPASS_LAUNCHES_BY_DEVICE: dict[int, int] = {}
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
        lib.me_search_halo.restype = ctypes.c_int
        lib.me_search_halo.argtypes = []
        lib.me_halfpel_launch.restype = ctypes.c_int
        lib.me_halfpel_launch.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3         # ref, B, H, W
            + [ctypes.c_void_p] * 2)                        # planes, stream
        lib.me_search_launch.restype = ctypes.c_int
        lib.me_search_launch.argtypes = (
            [ctypes.c_void_p] * 6            # cur, planes, ru, rv, cent, lam
            + [ctypes.c_int] * 3                  # B, H, W
            + [ctypes.c_void_p] * 4               # mv, py, pu, pv
            + [ctypes.c_void_p])                  # stream
        if lib.me_search_halo() != ME_HALO:
            raise RuntimeError(
                f"{ME_SOURCE} has a plane margin of {lib.me_search_halo()}, "
                f"the wrapper allocates {ME_HALO}")
        _lib = lib
        return lib


def reset_launch_counts() -> None:
    """Zero every launch count, the process totals and the per-card
    maps."""
    global ME_KERNEL_LAUNCHES, ME_PREPASS_LAUNCHES
    with _count_lock:
        ME_KERNEL_LAUNCHES = ME_PREPASS_LAUNCHES = 0
        ME_KERNEL_LAUNCHES_BY_DEVICE.clear()
        ME_PREPASS_LAUNCHES_BY_DEVICE.clear()


def _ensure_table(lib, device: torch.device) -> None:
    """Copy OFFSET_TABLE into the kernel's device table once per device
    (the table's single source of truth is this module). `device` is a
    tensor's device, which always names its card."""
    idx = device.index
    if idx is None:
        raise ValueError("_ensure_table needs a device with an index")
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


def _frame_shape(name: str, t) -> tuple[int, int, int, bool]:
    """(B, H, W, banded) of a (H, W) frame plane (B = 1) or a (B, H, W)
    band stack."""
    if t.dim() not in (2, 3):
        raise ValueError(f"{name}: want a (H, W) plane or a (B, H, W) band "
                         f"stack, got {tuple(t.shape)}")
    banded = t.dim() == 3
    B = int(t.shape[0]) if banded else 1
    H, W = (int(d) for d in t.shape[-2:])
    if H % 16 or W % 16 or H <= 0 or W <= 0 or B <= 0:
        raise ValueError(f"{name}: {B} x {H}x{W} is not a stack of planes "
                         "whose sides are multiples of 16")
    return B, H, W, banded


def _check(name: str, t, shape, dtype) -> None:
    """`t` must be a contiguous `dtype` tensor of `shape`; a band stack's
    count and stride are named when they are what is wrong."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        if (t.dim() == len(shape) and t.dim() >= 3
                and tuple(t.shape[1:]) == tuple(shape[1:])):
            raise ValueError(f"{name}: {t.shape[0]} bands, the stack has "
                             f"{shape[0]}")
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous tensor (strides "
                         f"{t.stride()}: a band stack's planes must lie one "
                         "after another, band stride = one plane)")


def _on_card(*named) -> torch.device:
    """The one CUDA device every (name, tensor) pair lives on."""
    dev = named[0][1].device
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the ME kernels need CUDA tensors, "
                             f"got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the frame is on {dev}")
    return dev


def halfpel_planes_cuda(ref_y):
    """The prepass kernel (csrc/me_search.cu, halfpel_kernel) on a CUDA
    int16 (H, W) plane: same result as :func:`halfpel_planes_ref`, into
    a new uint8 (4, H + 2 ME_HALO, W + 2 ME_HALO) tensor; a (B, H, W)
    band stack gives (B, 4, ...) from ONE launch. Launches on the
    current stream and never synchronizes."""
    global ME_PREPASS_LAUNCHES
    B, H, W, banded = _frame_shape("ref_y", ref_y)
    _check("ref_y", ref_y, tuple(ref_y.shape), torch.int16)
    dev = _on_card(("ref_y", ref_y))
    lib = load_me_library()
    shape = (4, H + 2 * ME_HALO, W + 2 * ME_HALO)
    planes = torch.empty(((B,) if banded else ()) + shape,
                         dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.me_halfpel_launch(ref_y.data_ptr(), B, H, W,
                                   planes.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ME prepass launch failed (cuda error {rc})")
    with _count_lock:
        ME_PREPASS_LAUNCHES += 1
        ME_PREPASS_LAUNCHES_BY_DEVICE[dev.index] = \
            ME_PREPASS_LAUNCHES_BY_DEVICE.get(dev.index, 0) + 1
    return planes


def me_search_planes_cuda(cur_y, planes, ref_u, ref_v, centers, lam):
    """The search kernel (csrc/me_search.cu, search_kernel) on CUDA
    tensors, over `planes`, the :func:`halfpel_planes_cuda` output of the
    frame's reference luma: same outputs as :func:`me_search_ref` on that
    reference. A (B, H, W) band stack (planes (B, 4, ...), chroma (B,
    H/2, W/2)) searches every band in ONE launch, at the same centers
    and lam. Launches on the current stream and never synchronizes:
    centers and lam stay on the device.

    Precondition, as for the TPU kernel: every sample of cur_y lies in
    [0, 255] (the search packs four samples a 32-bit word; a value
    outside gives wrong SADs, not an error)."""
    global ME_KERNEL_LAUNCHES
    B, H, W, banded = _frame_shape("cur_y", cur_y)
    lead = (B,) if banded else ()
    for name, t, shape, dtype in (
            ("cur_y", cur_y, lead + (H, W), torch.int16),
            ("planes", planes,
             lead + (4, H + 2 * ME_HALO, W + 2 * ME_HALO), torch.uint8),
            ("ref_u", ref_u, lead + (H // 2, W // 2), torch.int16),
            ("ref_v", ref_v, lead + (H // 2, W // 2), torch.int16),
            ("centers", centers, (3, 2), torch.int32)):
        _check(name, t, shape, dtype)
    if lam.dtype != torch.int32 or lam.numel() != 1:
        raise ValueError("lam: want one int32 value")
    dev = _on_card(("cur_y", cur_y), ("planes", planes), ("ref_u", ref_u),
                   ("ref_v", ref_v), ("centers", centers), ("lam", lam))
    if cur_y.data_ptr() % 8:
        raise ValueError("cur_y: want a start aligned to 8 bytes")
    lib = load_me_library()
    _ensure_table(lib, dev)
    mv = torch.empty(lead + (H // 16, W // 16, 2), dtype=torch.int32,
                     device=dev)
    py = torch.empty(lead + (H, W), dtype=torch.int16, device=dev)
    pu = torch.empty(lead + (H // 2, W // 2), dtype=torch.int16, device=dev)
    pv = torch.empty(lead + (H // 2, W // 2), dtype=torch.int16, device=dev)
    lam = lam.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.me_search_launch(
            cur_y.data_ptr(), planes.data_ptr(), ref_u.data_ptr(),
            ref_v.data_ptr(), centers.data_ptr(), lam.data_ptr(), B, H, W,
            mv.data_ptr(), py.data_ptr(), pu.data_ptr(), pv.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"ME kernel launch failed (cuda error {rc})")
    with _count_lock:
        ME_KERNEL_LAUNCHES += 1
        ME_KERNEL_LAUNCHES_BY_DEVICE[dev.index] = \
            ME_KERNEL_LAUNCHES_BY_DEVICE.get(dev.index, 0) + 1
    return mv, py, pu, pv


def me_search_cuda(cur_y, ref_y, ref_u, ref_v, centers, lam):
    """Both ME kernels on CUDA tensors, with the contract of
    :func:`me_search_ref` (a frame or a band stack): the prepass on
    `ref_y`, then the search over its planes — one launch each.
    Precondition: every sample of cur_y and ref_y lies in [0, 255], as
    for the TPU kernel."""
    _frame_shape("cur_y", cur_y)
    return me_search_planes_cuda(cur_y, halfpel_planes_cuda(ref_y), ref_u,
                                 ref_v, centers, lam)


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


# ---------------------------------------------------------------------------
# split-frame encoding (SFE): the banded search over a band stack
#
# One frame is split into B horizontal MB-row bands of equal padded height
# (parallel/planner.plan_bands), held on one card as a (B, Hb, W) stack.
# The search is the SAME kernel pair as the full-frame path, run once over
# the stack of bands extended by `halo` reference rows from each
# neighbour; the global-motion probe and the carried median sum their
# per-band parts over the band dimension, so every band searches exactly
# the centres the full-frame search would. With a halo that covers the
# candidate reach (SEARCH_RANGE + window + 6-tap interpolation =
# halo_clamp's bound) the per-MB (mv, pred) results are bit-identical to
# full-frame `me_search`; a smaller halo clamps the VERTICAL centre
# magnitude so no candidate reads past the halo.
# ---------------------------------------------------------------------------

def halo_clamp(halo_rows: int) -> int:
    """Largest even vertical center magnitude (pel) whose candidate
    window (± _WR pel) plus 6-tap interpolation reach (3 rows) stays
    inside a `halo_rows`-row halo. >= _CLIM means the banded search is
    unclamped (bit-identical to full-frame)."""
    return max(0, min(_CLIM, ((halo_rows - _WR - 3) // 2) * 2))


def band_halo_exchange(stack, halo: int, top_ext=None, bot_ext=None,
                       edge_top: bool = True, edge_bot: bool = True):
    """(B, Hb, W) band stack → (B, Hb + 2 halo, W): each band extended
    with `halo` REAL rows of its neighbour bands (slices of the stack);
    the first band's top and the last band's bottom edge-replicate their
    own boundary row, exactly matching the full-frame search's edge
    padding. One band is pure edge replication.

    Farm mode (cross-HOST bands, parallel/sfefarm.py): when the stack is
    a CONTIGUOUS SLICE of a larger band layout, the rows above its first
    band and below its last band live on another host and arrive as
    host-injected (halo, W) `top_ext` / `bot_ext`. `edge_top=False`
    means the layout continues above this slice — the first band's top
    halo is `top_ext` instead of edge replication — and symmetrically
    for `edge_bot`. With the defaults the function is the local-stack
    exchange."""
    B, H, W = stack.shape
    if halo > H and B > 1:
        # a neighbour band holds H rows: a deeper halo would need rows
        # from two bands away (SfeShardEncoder caps halo_rows at the
        # band height, shrinking the vertical search bound instead)
        raise ValueError(f"halo {halo} exceeds band height {H}")
    first = stack[:1, :1].expand(1, halo, W)
    last = stack[-1:, H - 1:].expand(1, halo, W)
    if not edge_top:
        if top_ext is None:
            raise ValueError("a slice with a band above needs top_ext")
        first = top_ext.reshape(1, halo, W).to(stack.dtype)
    if not edge_bot:
        if bot_ext is None:
            raise ValueError("a slice with a band below needs bot_ext")
        last = bot_ext.reshape(1, halo, W).to(stack.dtype)
    top, bot = first, last
    if B > 1:
        # band b's top halo = band b-1's bottom rows; bottom halo = band
        # b+1's top rows
        top = torch.cat([first, stack[:-1, H - halo:]])
        bot = torch.cat([stack[1:, :halo], last])
    return torch.cat([top, stack, bot], dim=1)


@functools.lru_cache(maxsize=64)
def _band_row_masks(real_rows: tuple, rows: int, scale: int, device):
    """(B, rows) bool, True on rows below each band's real content
    (`real_rows` pixel rows, counted in units of `scale` rows), and the
    (B, rows) int64 index of each row clamped to its band's last real
    row — device tensors cached by shape, so no frame copies them to the
    card."""
    real = np.maximum(np.asarray(real_rows, np.int64) // scale, 1)
    r = np.arange(rows)[None]
    return (torch.as_tensor(r < real[:, None], device=device),
            torch.as_tensor(np.minimum(r, real[:, None] - 1),
                            device=device))


def banded_probe_cost(cur_stack, ref_stack, real_rows,
                      sr: int = SEARCH_RANGE, top_ext=None, bot_ext=None,
                      edge_top: bool = True, edge_bot: bool = True):
    """The global-motion probe's per-window cost vector, summed over
    the bands: each band contributes the partial SAD of its REAL rows
    for every candidate window (halo cells come from the neighbour
    bands at quarter-res granularity, so the window slices see exactly
    the full-frame probe's padded plane). `real_rows` (one int per band,
    pixel rows) masks the last band's padding rows out of the cost,
    keeping the sum equal to the full-frame probe's. int32, wrapping as
    the reference's int32 sums do.

    Split mode: `top_ext` / `bot_ext` are injected neighbour reference
    PIXEL rows (≥ 16 a side, (rows, W)) from the adjacent run of bands
    (on another mesh entry, or a farm slice on another host), with
    `edge_top` / `edge_bot` as in :func:`band_halo_exchange`; their
    quarter-res cells stand in for the neighbour bands' halo cells at
    the run's edges, so the partial sums of every run add up to exactly
    the whole layout's cost. The caller finishes the sum and the argmin
    (:func:`probe_center_t`, or :func:`probe_center_from_cost` on the
    host)."""
    qs = _COARSE
    qsr = sr // qs
    B, H, W = cur_stack.shape
    cq = _box_sum(cur_stack.reshape(B * H, W), qs).reshape(B, H // qs, -1)
    rq = _box_sum(ref_stack.reshape(B * H, W), qs).reshape(B, H // qs, -1)
    hc, wc = cq.shape[1:]
    mask, clamp = _band_row_masks(tuple(real_rows), hc, qs, cq.device)
    # cells at/past a band's real content hold padding: clamp them to
    # the last real cell row so (a) this band's cost rows are masked
    # anyway and (b) the halo cells it lends (and its own bottom edge
    # replication) equal the full-frame probe's bottom edge padding
    rq = torch.gather(rq, 1, clamp[:, :, None].expand(B, hc, wc))
    # the injected neighbour rows are raw recon pixels (never a padded
    # band — only the layout's last band pads, and it has no neighbour
    # below), so their box sums equal the neighbour's own unclamped
    # cells bit for bit
    top_cells = _box_sum(top_ext, qs)[-qsr:] if top_ext is not None \
        else None
    bot_cells = _box_sum(bot_ext, qs)[:qsr] if bot_ext is not None \
        else None
    rq_ext = band_halo_exchange(rq, qsr, top_ext=top_cells,
                                bot_ext=bot_cells, edge_top=edge_top,
                                edge_bot=edge_bot)
    cols = torch.arange(-qsr, wc + qsr, device=rq.device).clamp(0, wc - 1)
    rq_ext = rq_ext[:, :, cols]
    n = 2 * qsr + 1
    wins = torch.stack([rq_ext[:, oy:oy + hc, ox:ox + wc]
                        for oy in range(n) for ox in range(n)], dim=1)
    diff = torch.abs(cq[:, None] - wins) * mask[:, None, :, None]
    return diff.sum(dim=(0, 2, 3), dtype=torch.int32)


def banded_coarse_probe(cur_stack, ref_stack, real_rows,
                        sr: int = SEARCH_RANGE):
    """`coarse_probe` decomposed over the bands: the summed per-window
    cost (banded_probe_cost) argmin'd (first minimum) — the SAME
    global-motion center for every band."""
    qs = _COARSE
    qsr = sr // qs
    n = 2 * qsr + 1
    cost = banded_probe_cost(cur_stack, ref_stack, real_rows, sr=sr)
    return probe_center_t(cost, sr)


def probe_center_t(cost, sr: int = SEARCH_RANGE):
    """The probe's tail on the device: argmin (the first minimum) of the
    summed per-window cost → the (2,) int32 pel center."""
    qs = _COARSE
    qsr = sr // qs
    n = 2 * qsr + 1
    bi = torch.argmin(cost).to(torch.int32)
    return torch.stack([bi // n - qsr, bi % n - qsr]) * qs


def probe_center_from_cost(cost, sr: int = SEARCH_RANGE):
    """Host-side tail of a split probe (numpy): argmin the summed
    per-window costs into the (2,) pel center — the exact mirror of
    banded_coarse_probe's device argmin (both resolve ties to the first
    minimum)."""
    qs = _COARSE
    qsr = sr // qs
    n = 2 * qsr + 1
    bi = int(np.argmin(np.asarray(cost)))
    return np.asarray([bi // n - qsr, bi % n - qsr], np.int32) * qs


def banded_centers_from(cur_stack, ref_stack, pred_mv_h, real_rows,
                        halo_rows: int, probe=None):
    """(3, 2) even-pel centers shared by every band: the summed probe,
    the carried global median, zero — the banded mirror of
    `centers_from`, with the vertical component additionally clamped to
    `halo_clamp(halo_rows)` so every candidate read stays inside the
    halo. `probe` injects a pre-computed (unclamped) global center as a
    (2,) int32 tensor — a split layout's path, where the probe's sum over
    the runs (and a farm's hosts) resolves before the search."""
    if probe is None:
        probe = banded_coarse_probe(cur_stack, ref_stack, real_rows)
    med_pel = torch.clamp((pred_mv_h.to(torch.int32) + 2) >> 2,
                          -(_CLIM // 2), _CLIM // 2) * 2
    lims = (min(halo_clamp(halo_rows), _CLIM), _CLIM)
    probe = torch.stack([torch.clamp(probe[i], -lims[i], lims[i])
                         for i in range(2)])
    med_pel = torch.stack([torch.clamp(med_pel[i], -lims[i], lims[i])
                           for i in range(2)])
    zero = torch.zeros(2, dtype=torch.int32, device=cur_stack.device)
    return torch.stack([probe, med_pel, zero]).to(torch.int32)


def hist_counts_banded(mv, mb_mask, lim: int):
    """MV histogram counts over the REAL macroblocks of every band,
    summed over the bands: mv (B, n, 2), mb_mask (B, n) bool →
    ((2 lim + 1, 2) counts, the masked MB count)."""
    bins = torch.arange(-lim, lim + 1, device=mv.device)
    hit = ((mv[:, :, None, :] == bins[None, None, :, None])
           & mb_mask[:, :, None, None])
    return hit.sum(dim=(0, 1)), mb_mask.sum()


def hist_median_banded(mv, mb_mask, lim: int):
    """`hist_median` decomposed over the bands: the per-band histogram
    counts over the REAL macroblocks sum before the cumsum/argmax, so
    every band carries the same global median (the next frame's
    temporal search center)."""
    cnt, n = hist_counts_banded(mv, mb_mask, lim)
    return median_from_counts_t(cnt, n, lim)


def median_from_counts_t(cnt, n, lim: int):
    """The median's tail on the device: cumsum/argmax over (summed)
    histogram counts → the (2,) int32 half-pel median."""
    cum = torch.cumsum(cnt, dim=0)
    hit = (cum >= (n + 1) // 2).to(torch.int32)
    return (torch.argmax(hit, dim=0) - lim).to(torch.int32)


def median_from_counts(cnt, n, lim: int):
    """Host-side tail of a split median (numpy): the exact mirror of
    hist_median_banded's cumsum/argmax over summed counts."""
    cum = np.cumsum(np.asarray(cnt, np.int64), axis=0)
    return (np.argmax(cum >= (int(n) + 1) // 2, axis=0)
            - lim).astype(np.int32)


def extend_bands(cur_y16, ref_y16, ref_u16, ref_v16, halo: int, ext=None,
                 edge_top: bool = True, edge_bot: bool = True):
    """The kernels' inputs for a band stack: each plane extended by
    `halo` rows a side (chroma halo / 2), the references with their
    neighbour bands' rows (:func:`band_halo_exchange`; `ext`, `edge_top`
    and `edge_bot` inject a band slice's cross-host neighbour rows as
    there), cur by edge replication — its halo rows only feed the
    discarded extension MBs' SADs and stay in range. Contiguous
    (B, Hb + 2 halo, W) stacks."""
    B, Hb, W = cur_y16.shape
    ty, by, tu, bu, tv, bv = ext if ext is not None else (None,) * 6
    cur_ext = torch.cat([cur_y16[:, :1].expand(B, halo, W), cur_y16,
                         cur_y16[:, Hb - 1:].expand(B, halo, W)], dim=1)
    return (cur_ext,
            band_halo_exchange(ref_y16, halo, ty, by, edge_top, edge_bot),
            band_halo_exchange(ref_u16, halo // 2, tu, bu, edge_top,
                               edge_bot),
            band_halo_exchange(ref_v16, halo // 2, tv, bv, edge_top,
                               edge_bot))


def me_search_banded(cur_y16, ref_y16, ref_u16, ref_v16, pred_mv_h,
                     qp: int, *, halo_rows: int, real_rows, ext=None,
                     edge_top: bool = True, edge_bot: bool = True,
                     probe=None, return_hist: bool = False):
    """Full ME+MC for one P frame of a band stack (the SFE search).

    cur/ref planes are (B, Hb, W) stacks (Hb a multiple of 16), chroma
    (B, Hb/2, W/2); `halo_rows` (a multiple of 16) reference rows per
    side come from the neighbour bands (:func:`band_halo_exchange`);
    `real_rows` holds each band's count of real pixel rows (the last
    band may carry padding rows — masked out of the probe and median;
    the host never entropy-codes their MBs). The search runs the
    UNCHANGED kernels on the extended stack — one launch of each for all
    bands — and slices each band's MB rows back out; per-MB selection is
    independent, so the extension rows' results are simply discarded.
    CUDA tensors go through the kernels, CPU tensors through the plain
    version, band by band.

    Split mode (a run of bands of a larger layout: a mesh entry's, or a
    farm slice's): `ext` = (top_y, bot_y, top_u, bot_u, top_v, bot_v)
    injected neighbour reference rows for the run's edges, each (rows,
    W) or None, with `edge_top` / `edge_bot` marking which edges are
    true frame edges; `probe` = the global probe center ((2,) int32
    tensor: the summed banded_probe_cost of every run →
    probe_center_t); and `return_hist=True` swaps the median for this
    stack's histogram partial (cnt, n), which the caller sums across
    runs (median_from_counts_t). With identical injected values the
    per-MB (mv, pred) results equal the whole layout's.

    Returns (mv (B, Hb/16, mbw, 2) int32 half-pel, pred_y, pred_u,
    pred_v int16 band stacks, med_mv_h (2,) int32 — the GLOBAL
    median), or with `return_hist` (mv, py, pu, pv, cnt, n)."""
    B, Hb, _ = cur_y16.shape
    if halo_rows <= 0 or halo_rows % 16:
        raise ValueError("halo_rows must be a positive multiple of 16")
    if len(real_rows) != B:
        raise ValueError(f"{len(real_rows)} real-row counts for {B} bands")
    halo = halo_rows
    planes = extend_bands(cur_y16, ref_y16, ref_u16, ref_v16, halo,
                          ext=ext, edge_top=edge_top, edge_bot=edge_bot)
    centers = banded_centers_from(cur_y16, ref_y16, pred_mv_h, real_rows,
                                  halo, probe=probe)
    lam = lambda_for(qp, cur_y16.device)
    if cur_y16.device.type == "cuda":
        mv_e, py_e, pu_e, pv_e = me_search_cuda(*planes, centers, lam)
    else:
        mv_e, py_e, pu_e, pv_e = me_search_ref(*planes, centers, lam)
    hm = halo // 16
    mbh_b = Hb // 16
    mv = mv_e[:, hm:hm + mbh_b]
    py = py_e[:, halo:halo + Hb]
    pu = pu_e[:, halo // 2:(halo + Hb) // 2]
    pv = pv_e[:, halo // 2:(halo + Hb) // 2]
    mb_rows, _ = _band_row_masks(tuple(real_rows), mbh_b, 16, mv.device)
    mb_mask = mb_rows.repeat_interleave(mv.shape[2], dim=1)
    if return_hist:
        cnt, n = hist_counts_banded(mv.reshape(B, -1, 2), mb_mask,
                                    2 * SEARCH_RANGE)
        return mv, py, pu, pv, cnt, n
    med = hist_median_banded(mv.reshape(B, -1, 2), mb_mask,
                             2 * SEARCH_RANGE)
    return mv, py, pu, pv, med
