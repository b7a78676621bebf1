"""Rate-distortion operating point of the encoder core.

One frozen, hashable config rides through the encode programs and the
host packers. The port's device programs run with every feature off
(``RD_OFF``); settings-built encoders resolve the config from the four
RD knobs (``rd_from_settings``) and refuse anything else, since the RD
features themselves are not ported yet (ROADMAP A7). The fields keep
the reference's names so the host packers' `rd.deblock` /
`rd.ships_modes` checks read the same.
"""

from __future__ import annotations

import dataclasses

#: AQ quantization of the strength knob: the continuous setting is
#: snapped to 1/AQ_QUANT steps (aq_q is in 1/AQ_QUANT QP units)
AQ_QUANT = 4


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


def require_rd_off(rd: RdConfig) -> None:
    """Refuse any RD feature: the port's device programs implement none
    yet, and encoding feature-off in their place would be a different
    result, not the asked-for one."""
    if rd != RD_OFF:
        raise NotImplementedError(
            f"RD features {rd} are not ported yet (ROADMAP A7); set "
            "mode_decision/pskip/deblock off and aq_strength 0")


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
