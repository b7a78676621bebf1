"""Rate-distortion operating point of the encoder core.

One frozen, hashable config rides through every encode program
(torchcore/torchinter/parallel.dispatch) and through the host packers,
so a feature toggle is a Python-level specialization, never a
data-dependent branch on the device:

- ``mode_decision``: per-MB intra mode decision — SATD (4x4 Hadamard)
  cost over the candidate I16x16/chroma predictors instead of the
  fixed V/H/DC raster policy (encoder._mode_policy stays the
  feature-off layout).
- ``pskip``: P_Skip bias — inter MBs whose quantized residual is
  near-zero (sum |level| <= PSKIP_SUM, max |level| <= 1) drop the
  residual entirely, so the entropy packer's §8.4.1.1 skip inference
  turns them into mb_skip_run entries and the recon stays closed-loop.
- ``deblock``: §8.7 in-loop deblocking applied to the recon carried
  between frames (and signaled in the slice headers), as the
  shifted-plane schedule of codecs/h264/deblock.py.
- ``aq_strength``: perceptual (variance) per-MB QP modulation on INTRA
  frames around the same average QP. P frames keep the slice QP.

Device-free on purpose: the pack sidecars and the host packers import
it without torch. The numpy SATD and AQ helpers below are the integer
twins of torchcore's device code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: AQ quantization of the strength knob: the continuous setting is
#: snapped to 1/AQ_QUANT steps (aq_q is in 1/AQ_QUANT QP units)
AQ_QUANT = 4
#: AQ per-MB offset clamp (QP steps either side of the frame QP).
AQ_MAX_DELTA = 6
#: P_Skip bias: an inter MB whose quantized levels sum to <= this (in
#: absolute value, all planes) with every |level| <= 1 drops its
#: residual.
PSKIP_SUM = 2


@dataclasses.dataclass(frozen=True)
class RdConfig:
    """Static RD feature set of one encode. Hashable."""

    mode_decision: bool = False
    pskip: bool = False
    deblock: bool = False
    #: aq strength in 1/AQ_QUANT QP units (0 = off)
    aq_q: int = 0

    @property
    def aq_strength(self) -> float:
        return self.aq_q / AQ_QUANT

    @property
    def aq(self) -> bool:
        return self.aq_q > 0

    @property
    def ships_modes(self) -> bool:
        """True when the transfer layouts carry a per-MB intra mode
        (+ qp-delta) side channel."""
        return self.mode_decision or self.aq_q > 0


#: the feature-off config: every existing path's behavior, bit for bit
RD_OFF = RdConfig()


def aq_from_strength(strength: float) -> int:
    """Quantize the float aq_strength knob to the static aq_q field."""
    return max(0, min(3 * AQ_QUANT,
                      int(round(float(strength) * AQ_QUANT))))


def rd_from_settings(settings) -> RdConfig:
    """Build the static RD config from a Settings snapshot (the four
    knobs registered in core/config.DEFAULT_SETTINGS)."""
    from ...core.config import as_bool, as_float

    return RdConfig(
        mode_decision=as_bool(settings.get("mode_decision", False), False),
        pskip=as_bool(settings.get("pskip", False), False),
        deblock=as_bool(settings.get("deblock", False), False),
        aq_q=aq_from_strength(as_float(settings.get("aq_strength", 0.0),
                                       0.0)),
    )


# ---------------------------------------------------------------------------
# SATD (4x4 Hadamard) — the intra mode-decision cost, numpy reference.
# torchcore implements the same transform on the device; both must agree
# exactly (integer math only).
# ---------------------------------------------------------------------------

_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                [1, -1, -1, 1], [1, -1, 1, -1]], np.int32)


def satd16_np(resid: np.ndarray) -> int:
    """Sum of |Hadamard4x4| over a (16, 16) int32 residual block,
    divided by 2 (the standard SATD normalization — integer exact
    because the Hadamard doubles parity)."""
    total = 0
    r = resid.astype(np.int64)
    for by in range(4):
        for bx in range(4):
            b = r[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
            t = _H4 @ b @ _H4
            total += int(np.abs(t).sum())
    return total // 2


def satd8_np(resid: np.ndarray) -> int:
    """SATD of an (8, 8) chroma residual (four 4x4 Hadamards)."""
    total = 0
    r = resid.astype(np.int64)
    for by in range(2):
        for bx in range(2):
            b = r[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
            t = _H4 @ b @ _H4
            total += int(np.abs(t).sum())
    return total // 2


# ---------------------------------------------------------------------------
# perceptual AQ map — per-MB intra QP offsets from luma activity.
# ---------------------------------------------------------------------------

#: activity ceiling: 256·Σx² − (Σx)² <= 256·255²·256 < 2^32 for a
#: 16x16 uint8 block — 32 power-of-two thresholds cover every ilog2
#: value.
AQ_ACT_BITS = 32


def mb_activity_np(y: np.ndarray, mbw: int, mbh: int) -> np.ndarray:
    """(nmb,) int32 integer activity per MB: floor(log2(1 + V)) where
    V = 256·Σx² − (Σx)² (= 256² · variance of the MB's luma). ALL
    integer math — the device twin (torchcore._mb_activity) must agree
    bit for bit, which float32 log2/variance cannot guarantee at
    rounding boundaries. floor(log2(1+v)) = |{k in 1..32 : v >= 2^k-1}|
    (the 2^k−1 form keeps every threshold inside uint32)."""
    y64 = y[:16 * mbh, :16 * mbw].astype(np.int64)
    mb = y64.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
    mb = mb.reshape(mbh * mbw, 256)
    s = mb.sum(axis=1)
    s2 = (mb * mb).sum(axis=1)
    v = 256 * s2 - s * s                       # >= 0, < 2^32
    act = np.zeros(mbh * mbw, np.int64)
    for k in range(1, AQ_ACT_BITS + 1):
        act += v >= ((1 << k) - 1)
    return act.astype(np.int32)


def aq_offsets_from_activity(act: np.ndarray, aq_q: int) -> np.ndarray:
    """(nmb,) int32 per-MB QP offsets from the integer activity map:
    round(strength · (act − mean(act))) via pure integer arithmetic
    (floor-division rounding), clamped to ±AQ_MAX_DELTA — the
    x264-style variance-AQ shape: busy MBs (texture masks quantization
    error) move UP in QP, flat MBs down, ~zero-mean over the frame so
    the frame QP stays the rate operating point."""
    act = np.asarray(act, np.int64)
    nmb = act.shape[0]
    if aq_q <= 0 or nmb == 0:
        return np.zeros(nmb, np.int32)
    total = act.sum()
    num = aq_q * (act * nmb - total)           # strength·diff · (Q·nmb)
    den = AQ_QUANT * nmb
    delta = (2 * num + den) // (2 * den)       # floor-based round
    return np.clip(delta, -AQ_MAX_DELTA, AQ_MAX_DELTA).astype(np.int32)


def aq_offsets_np(y: np.ndarray, aq_q: int, mbw: int, mbh: int
                  ) -> np.ndarray:
    """(nmb,) int32 per-MB QP offsets for one INTRA frame."""
    return aq_offsets_from_activity(mb_activity_np(y, mbw, mbh), aq_q)


def clamp_qp_map(base_qp, offsets) -> np.ndarray:
    """Per-MB QP = base + offset, clamped to the legal H.264 range."""
    return np.clip(np.asarray(base_qp) + np.asarray(offsets), 0, 51
                   ).astype(np.int32)
