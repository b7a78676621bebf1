"""Objective quality metrics: PSNR and SSIM (numpy, host-side).

VMAF itself needs its trained model files, so the harness reports PSNR
+ SSIM — the standard proxies VMAF correlates with — computed against
the source, plus a VMAF-proxy figure derived from them. The same
functions as the reference package's tools/metrics.py (numpy only), so a
quality number measured on the port reads the same as the reference's.
"""

from __future__ import annotations

import numpy as np


def psnr(ref: np.ndarray, dist: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical planes)."""
    ref = ref.astype(np.float64)
    dist = dist.astype(np.float64)
    mse = np.mean((ref - dist) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter via cumulative sums ('same' shape for any
    window size, edge-padded) — keeps the module dependency-free on a
    1-core host."""
    pad_l = size // 2
    pad_r = size - 1 - pad_l
    out = x
    for axis in (0, 1):
        xs = np.swapaxes(out, 0, axis)
        padded = np.pad(xs, ((pad_l, pad_r), (0, 0)), mode="edge")
        c = np.cumsum(padded, axis=0, dtype=np.float64)
        c = np.vstack([np.zeros((1, c.shape[1])), c])
        xs = (c[size:] - c[:-size]) / size
        out = np.swapaxes(xs, 0, axis)
    return out


def ssim(ref: np.ndarray, dist: np.ndarray, peak: float = 255.0,
         window: int = 8) -> float:
    """Mean structural similarity (Wang et al. 2004, uniform window —
    the same simplification x264's ssim tuning uses)."""
    ref = ref.astype(np.float64)
    dist = dist.astype(np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_x = _uniform_filter(ref, window)
    mu_y = _uniform_filter(dist, window)
    sxx = _uniform_filter(ref * ref, window) - mu_x * mu_x
    syy = _uniform_filter(dist * dist, window) - mu_y * mu_y
    sxy = _uniform_filter(ref * dist, window) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return float(np.mean(num / den))


def vmaf_proxy(psnr_y: float, ssim_y: float) -> float:
    """VMAF-PROXY score on VMAF's 0..100 scale — NOT VMAF.

    Real VMAF needs its trained model files; the bench still has to
    track a perceptual 0..100 figure (the north
    star's acceptance metric), so this maps the two metrics VMAF
    correlates with most strongly onto its scale: a logistic of luma
    PSNR (saturating like VMAF does at high fidelity — another dB past
    ~45 buys almost nothing perceptually) blended with a power curve
    of SSIM (structure loss hurts faster than MSE suggests). Monotone
    in both inputs, so RD comparisons ON THE SAME CLIP order the same
    way VMAF would for quality changes of this codec's kind; absolute
    values are only proxy-comparable."""
    if not np.isfinite(psnr_y):
        return 100.0
    p = 1.0 / (1.0 + np.exp(-(psnr_y - 32.0) / 4.0))
    s = min(1.0, max(0.0, (ssim_y - 0.6) / 0.4))
    return float(round(100.0 * (0.5 * p + 0.5 * s ** 1.5), 2))


def clip_quality(ref_frames, dist_y_planes) -> dict[str, float]:
    """Mean luma PSNR/SSIM (+ the VMAF-proxy figure derived from them)
    of a decoded clip vs its source frames.

    ref_frames: list of core.types.Frame; dist_y_planes: decoded luma
    planes (same count/geometry — the caller crops any codec padding).
    """
    n = min(len(ref_frames), len(dist_y_planes))
    ps, ss = [], []
    for i in range(n):
        ry = ref_frames[i].y
        dy = dist_y_planes[i][:ry.shape[0], :ry.shape[1]]
        ps.append(psnr(ry, dy))
        ss.append(ssim(ry, dy))
    finite = [p for p in ps if np.isfinite(p)]
    psnr_mean = float(np.mean(finite)) if finite else float("inf")
    ssim_mean = float(np.mean(ss)) if ss else 1.0
    return {
        "psnr_y": psnr_mean,
        "ssim_y": ssim_mean,
        "vmaf_proxy": vmaf_proxy(psnr_mean, ssim_mean),
        "frames_compared": n,
    }
