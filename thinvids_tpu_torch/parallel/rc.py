"""Rate control: complexity-adaptive QP + two-pass VBR on a card or a
device mesh.

Per-GOP complexity stats come from a device analysis program over the
luma planes (`GopShardEncoder.stage_luma_waves`); the host then solves
per-GOP QPs against the bitrate target using the standard
R ∝ 2^(-qp/6) H.264 rate model. The reference exchanges the wave total
with a `psum` over its ``gop`` mesh axis; here each mesh entry computes
its GOPs' stats from exact int64 sums on its own card, and the host sums
the per-GOP values once (an exactly rounded sum, so the shares do not
depend on how the GOPs were split over the entries).

Two-pass flow (`encode_vbr2pass`):
  pass 1: encode at the base QP → exact per-GOP byte counts (the
          entropy pack is the true bit counter) + the normalized
          complexity shares from the device analysis program;
  solve:  global log2 shift from total bits vs target, per-GOP delta
          from its complexity share (busy GOPs get bits first);
  pass 2: encode with the per-GOP QP vector (GopShardEncoder.gop_qp),
          slice headers carry the deltas.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import EncodedSegment, Frame, VideoMeta
from .dispatch import GopShardEncoder, _parts

QP_MIN, QP_MAX = 10, 48
#: bits halve roughly every 6 QP steps (H.264 quantizer step doubles)
_QP_PER_OCTAVE = 6.0


def _abs_diff_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean |a - b| of two int16 tensors as an exact int64 sum over its
    count (float64): the same value on every device."""
    total = (a - b).abs().sum(dtype=torch.int64)
    return total.to(torch.float64) / a.numel()


def _complexity_stats(ys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, F, H, W) uint8 luma → ((G,) complexity, (G,) wave total).

    Complexity = mean |frame diff| over the GOP (zero-MV residual
    energy — the dominant bit driver for P frames) + half the mean
    horizontal + vertical gradient of the first frame (the IDR's bit
    driver). The wave total is the sum over the wave's GOPs (the
    reference's `psum` over its mesh, on one card)."""
    y16 = ys.to(torch.int16)
    local = []
    for y in y16:
        temporal = (_abs_diff_mean(y[1:], y[:-1]) if y.shape[0] > 1
                    else torch.zeros((), dtype=torch.float64,
                                     device=y.device))
        g0 = y[0]
        grad = (_abs_diff_mean(g0[:, 1:], g0[:, :-1])
                + _abs_diff_mean(g0[1:], g0[:-1]))
        local.append(temporal + 0.5 * grad)
    local_t = torch.stack(local)
    return local_t, local_t.sum().expand(local_t.shape)


def analyze_complexity(enc: GopShardEncoder, frames) -> np.ndarray:
    """Per-GOP complexity shares for a clip (sums to 1). Each mesh entry
    computes its run of the wave's GOPs on its own card; the host joins
    them in GOP order and divides by their exact sum."""
    comp: list[float] = []
    for wave, ysd in enc.stage_luma_waves(frames):
        ys = _parts(ysd)
        local = np.concatenate(enc.on_entries(
            lambda i: _complexity_stats(ys[i])[0].cpu().numpy()))
        # pad GOPs at the wave tail repeat a real GOP: drop them
        comp.extend(local[:len(wave)].astype(np.float64))
    arr = np.asarray(comp, np.float64)
    return arr / max(math.fsum(comp), 1e-9)


def jnd_masked_shares(shares: np.ndarray, aq_strength: float
                      ) -> np.ndarray:
    """Perceptual (JND/masking) weighting of complexity shares for the
    octave-model solve: a busy GOP masks its own coding error (Weber —
    the same activity-masking premise as the per-MB variance AQ in
    codecs/h264/rdo), so its effective bit DEMAND grows sublinearly
    with measured complexity. shares^(1/(1+s/2)), renormalized; s = 0
    returns the input — the historical allocation — exactly."""
    s = np.asarray(shares, np.float64)
    if aq_strength <= 0 or s.size == 0:
        return s
    exponent = 1.0 / (1.0 + float(aq_strength) / 2.0)
    out = np.power(np.maximum(s, 1e-12), exponent)
    return out / out.sum()


def solve_gop_qps(base_qp: int, pass1_bytes: np.ndarray,
                  shares: np.ndarray, target_bits_total: float,
                  modulation: float = 2.0) -> np.ndarray:
    """Per-GOP QPs hitting `target_bits_total` under the octave model.

    Global shift: bits scale as 2^(-Δqp/6), so
    Δqp = 6·log2(actual/target). Per-GOP modulation nudges QP down for
    GOPs whose complexity share exceeds their bit share (they are
    under-served at flat QP) and up for over-served ones, bounded by
    ±`modulation` — the classic 2-pass allocation shape without a full
    lagrangian solve.
    """
    actual = float(pass1_bytes.sum()) * 8.0
    if actual <= 0 or target_bits_total <= 0:
        return np.full(len(pass1_bytes), base_qp, np.int32)
    shift = _QP_PER_OCTAVE * math.log2(actual / target_bits_total)
    bit_share = pass1_bytes / max(pass1_bytes.sum(), 1)
    ratio = np.clip(shares / np.maximum(bit_share, 1e-9), 0.25, 4.0)
    nudge = np.clip(_QP_PER_OCTAVE * np.log2(ratio) / 2.0,
                    -modulation, modulation)
    qps = np.rint(base_qp + shift - nudge).astype(np.int32)
    return np.clip(qps, QP_MIN, QP_MAX)


def ladder_rung_qps(base_qp: int, pixel_ratios, alpha: float = 0.75
                    ) -> np.ndarray:
    """Per-rung QPs for an ABR ladder under the octave model.

    At a fixed QP the model says R ∝ pixels · 2^(-qp/6); a good ladder
    spends MORE bits per pixel as resolution drops (the classic
    bitrate ladders follow R_rung ≈ R_top · ratio^alpha with
    alpha < 1), so the QP shift that hits that target is

        Δqp = 6 · (1 − alpha) · log2(pixel_ratio)     (ratio ≤ 1 → Δ ≤ 0)

    i.e. lower rungs encode slightly FINER than the top rung.
    `pixel_ratios` are rung_pixels / top_pixels (1.0 for the top rung,
    which therefore keeps `base_qp` exactly — the byte-identity
    invariant with the single-rendition path).
    """
    ratios = np.clip(np.asarray(pixel_ratios, np.float64), 1e-6, 1.0)
    shift = _QP_PER_OCTAVE * (1.0 - float(alpha)) * np.log2(ratios)
    qps = np.rint(base_qp + shift).astype(np.int32)
    qps[ratios >= 1.0] = base_qp        # top rung: no rounding drift
    return np.clip(qps, QP_MIN, QP_MAX)


def refine_gop_qps(prev_qps: np.ndarray, actual_bits: float,
                   target_bits: float) -> np.ndarray:
    """One fixed-point step: shift every GOP's QP by the octave-model
    correction for the measured total. Monotone in the shared shift, so
    iterating converges even when flat GOPs are QP-insensitive (the
    busy GOPs absorb the correction)."""
    shift = _QP_PER_OCTAVE * math.log2(max(actual_bits, 1.0)
                                       / max(target_bits, 1.0))
    return np.clip(np.rint(prev_qps + shift).astype(np.int32),
                   QP_MIN, QP_MAX)


def encode_vbr2pass(frames: list[Frame], meta: VideoMeta,
                    target_bitrate_kbps: float, base_qp: int = 27,
                    mesh=None, gop_frames: int = 32,
                    gops_per_wave: int = 4, tolerance: float = 0.08,
                    max_refine: int = 3, enc: GopShardEncoder | None = None,
                    encode_fn=None, on_pass=None,
                    aq_strength: float = 0.0, device="cuda",
                    ) -> tuple[list[EncodedSegment], dict]:
    """Two-pass VBR encode (+ up to `max_refine` correction passes when
    the octave model misses — e.g. clips whose flat stretches are
    QP-insensitive). Returns (segments, stats): pass1_bits, pass2_bits,
    target_bits, gop_qps, complexity_shares, passes.

    This is THE solve/refine loop — an executor reuses it by injecting
    its own `enc` (settings-built) and `encode_fn(enc) -> segments`
    (its retry/halt/progress wrapper); `on_pass(pass_no, gop_qps|None)`
    is a progress hook (heartbeat notes). The encoder it builds when
    `enc` is None runs on `mesh` (a DeviceMesh), or on `device` when
    there is none.
    """
    fps = meta.fps_num / max(1, meta.fps_den)
    duration_s = len(frames) / max(fps, 1e-9)
    target_bits = target_bitrate_kbps * 1000.0 * duration_s

    if enc is None:
        enc = GopShardEncoder(meta, qp=base_qp, gop_frames=gop_frames,
                              gops_per_wave=gops_per_wave, device=device,
                              mesh=mesh)
    if encode_fn is None:
        def encode_fn(e):
            return e.encode_waves(e.stage_waves(frames))

    if on_pass is not None:
        on_pass(1, None)
    # aq_strength > 0 also masks the GOP-level allocation: the octave
    # model serves perceptual demand, not raw residual energy
    shares = jnd_masked_shares(analyze_complexity(enc, frames),
                               aq_strength)
    pass1 = encode_fn(enc)
    pass1_bytes = np.asarray([len(s.payload) for s in pass1], np.float64)

    gop_qps = solve_gop_qps(base_qp, pass1_bytes, shares, target_bits)
    passes = 1
    while True:
        enc.gop_qp = {i: int(q) for i, q in enumerate(gop_qps)}
        if on_pass is not None:
            on_pass(passes + 1, gop_qps)
        segments = encode_fn(enc)
        passes += 1
        bits = float(sum(len(s.payload) for s in segments)) * 8.0
        err = abs(bits - target_bits) / max(target_bits, 1.0)
        at_floor = (bits > target_bits
                    and (gop_qps >= QP_MAX).all())       # can't go coarser
        at_ceil = (bits < target_bits
                   and (gop_qps <= QP_MIN).all())        # can't go finer
        if err <= tolerance or passes - 1 > max_refine or at_floor \
                or at_ceil:
            break
        gop_qps = refine_gop_qps(gop_qps, bits, target_bits)
    stats = {
        "pass1_bits": float(pass1_bytes.sum()) * 8.0,
        "pass2_bits": bits,
        "target_bits": target_bits,
        "gop_qps": gop_qps.tolist(),
        "complexity_shares": shares.tolist(),
        "passes": passes,
    }
    return segments, stats
