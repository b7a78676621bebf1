"""Device-side separable polyphase downscaler (Lanczos-3).

The Lanczos-3 tap set for a (src → dst) axis pair is precomputed ON
HOST as one small resampling matrix per axis (polyphase weights + edge
clamping folded into the matrix rows), and the device applies vertical
and horizontal passes as TWO float32 matrix products per YUV420 plane —
over tensors that are already on the card from wave staging, so deriving
a lower ladder rung never re-decodes or re-uploads the source
(parallel/dispatch.py's `h2d_bytes` counter proves it).

Matrices absorb the codec's macroblock padding on both sides: input
rows/cols beyond the true source dims are never sampled (taps clamp to
the valid range — edge replication, matching Frame.padded), and output
rows/cols beyond the true target dims repeat the last valid row/col, so
a scaled plane is ALREADY padded for the encoder. Output parity with
the pure-numpy apply (`scale_plane_np`) is ≤1 LSB, from float summation
order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.devices import resolve_device

#: Lanczos window half-width (3 lobes — the classic high-quality
#: downscale kernel; the JND-ladder literature's default resampler).
LANCZOS_A = 3


def lanczos_kernel(t: np.ndarray, a: int = LANCZOS_A) -> np.ndarray:
    """Windowed sinc L(t) = sinc(t)·sinc(t/a) for |t| < a, else 0."""
    t = np.asarray(t, np.float64)
    out = np.sinc(t) * np.sinc(t / a)
    out[np.abs(t) >= a] = 0.0
    return out


def resample_matrix(src: int, dst: int, src_valid: int | None = None,
                    dst_valid: int | None = None,
                    a: int = LANCZOS_A) -> np.ndarray:
    """(dst, src) float32 polyphase resampling matrix for one axis.

    `src`/`dst` are the PADDED lengths the device tensors carry;
    `src_valid`/`dst_valid` the true picture dims. The kernel is scaled
    by the downscale ratio (anti-aliasing support grows with it), taps
    are normalized per output sample, out-of-range taps clamp to the
    edge (replication), and padded output rows repeat the last valid
    row so the result is encoder-ready without a second pad pass.
    """
    src_valid = src if src_valid is None else int(src_valid)
    dst_valid = dst if dst_valid is None else int(dst_valid)
    if not (0 < dst_valid <= src_valid <= src) or dst_valid > dst:
        raise ValueError(
            f"bad resample geometry src={src}/{src_valid} "
            f"dst={dst}/{dst_valid} (downscale only)")
    ratio = src_valid / dst_valid
    fscale = max(ratio, 1.0)            # kernel stretch (anti-alias)
    support = a * fscale
    m = np.zeros((dst, src), np.float64)
    for i in range(dst):
        iv = min(i, dst_valid - 1)      # padded rows repeat the edge
        center = (iv + 0.5) * ratio - 0.5
        lo = int(np.floor(center - support)) + 1
        hi = int(np.ceil(center + support))
        taps = np.arange(lo, hi)
        w = lanczos_kernel((taps - center) / fscale, a)
        s = w.sum()
        if s <= 0:                      # pragma: no cover - degenerate
            w = np.ones_like(w) / len(w)
        else:
            w = w / s
        for j, wj in zip(taps, w):
            m[i, min(max(int(j), 0), src_valid - 1)] += wj
    return m.astype(np.float32)


def scale_plane_np(plane: np.ndarray, mv: np.ndarray,
                   mh: np.ndarray) -> np.ndarray:
    """Host-side reference apply: mv @ plane @ mh.T, round-half-up to
    uint8 — the same arithmetic the device path runs, in numpy."""
    out = mv.astype(np.float32) @ plane.astype(np.float32) \
        @ mh.astype(np.float32).T
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _apply_separable(x: torch.Tensor, mv: torch.Tensor,
                     mh: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 planes → (..., H', W') uint8 via the two
    resampling products in float32. Full float32 precision: a TF32
    product (10-bit mantissa) would cost visible banding on 8-bit video,
    so this refuses to run on a card with TF32 matmuls allowed rather
    than change that process-wide switch itself.

    The cheaper of the two products runs first (multiply-adds per
    plane), the order the reference's einsum contracts in: the float
    rounding of a sample that lands on a half then rounds the same way
    more often.

    One plane at a time: a product batched over the leading dims lets
    the BLAS pick its kernel (and so its summation order) by how many
    frames the wave holds, and on a card a sample on a half then rounds
    differently in a one-GOP live batch than in a four-GOP wave. With
    one fixed-shape product per plane a frame scales to the same bits
    whatever wave it rides in."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the Lanczos scaler needs full float32 products; "
            "torch.backends.cuda.matmul.allow_tf32 is on")
    (dh, h), (dw, w) = mv.shape, mh.shape
    vertical_first = dh * h * w + dh * w * dw <= h * w * dw + dh * h * dw
    planes = x.reshape(-1, h, w)
    out = torch.empty((planes.shape[0], dh, dw), dtype=torch.uint8,
                      device=x.device)
    for i in range(planes.shape[0]):
        xf = planes[i].to(torch.float32)
        if vertical_first:
            o = torch.matmul(torch.matmul(mv, xf), mh.T)
        else:
            o = torch.matmul(mv, torch.matmul(xf, mh.T))
        out[i] = torch.clamp(torch.floor(o + 0.5), 0, 255)
    return out.reshape(*x.shape[:-2], dh, dw)


def _pad16(n: int) -> int:
    return -(-int(n) // 16) * 16


class PlaneScaler:
    """Bundled luma + chroma resampling matrices for one 4:2:0 rung.

    Construction builds the four small matrices on the host (numpy) and
    places them on `device` once; :meth:`scale_wave` scales staged wave
    tensors there. Geometry contract: inputs are macroblock-padded
    source planes (luma `pad16(src)` with chroma at exactly half),
    outputs are macroblock-padded target planes — i.e. both ends match
    what GopShardEncoder stages and dispatches.
    """

    def __init__(self, src_w: int, src_h: int, dst_w: int,
                 dst_h: int, device="cuda") -> None:
        if dst_w % 2 or dst_h % 2:
            raise ValueError(
                f"rung dims {dst_w}x{dst_h} must be even for 4:2:0")
        dev = resolve_device(device)
        self.src_w, self.src_h = int(src_w), int(src_h)
        self.dst_w, self.dst_h = int(dst_w), int(dst_h)
        spw, sph = _pad16(src_w), _pad16(src_h)
        dpw, dph = _pad16(dst_w), _pad16(dst_h)
        self.y_v = resample_matrix(sph, dph, src_h, dst_h)
        self.y_h = resample_matrix(spw, dpw, src_w, dst_w)
        # chroma planes ride at exactly half the padded luma dims with
        # ceil(dim/2) valid samples (Frame.padded's invariant)
        self.c_v = resample_matrix(sph // 2, dph // 2,
                                   (src_h + 1) // 2, dst_h // 2)
        self.c_h = resample_matrix(spw // 2, dpw // 2,
                                   (src_w + 1) // 2, dst_w // 2)
        self._dev = tuple(torch.from_numpy(m).to(dev) for m in
                          (self.y_v, self.y_h, self.c_v, self.c_h))

    def scale_wave(self, ys, us, vs) -> tuple:
        """Scale staged (…, H, W) uint8 plane tensors (any leading
        batch dims — (G, F, H, W) wave stacks included) on the
        scaler's device."""
        y_v, y_h, c_v, c_h = self._dev
        return (_apply_separable(ys, y_v, y_h),
                _apply_separable(us, c_v, c_h),
                _apply_separable(vs, c_v, c_h))

    def scale_frame_np(self, y: np.ndarray, u: np.ndarray,
                       v: np.ndarray) -> tuple:
        """Pure-numpy apply of the same matrices (tools / parity
        tests); expects padded planes like the device path."""
        return (scale_plane_np(y, self.y_v, self.y_h),
                scale_plane_np(u, self.c_v, self.c_h),
                scale_plane_np(v, self.c_v, self.c_h))
