"""Rate-distortion operating point of the encoder core (the subset the
RD-off GOP path needs).

One frozen, hashable config rides through the encode programs and the
host packers. This port runs with every feature off (``RD_OFF``); the
fields exist so the host packers' `rd.deblock` / `rd.ships_modes`
checks read the same names as the reference's.
"""

from __future__ import annotations

import dataclasses

#: AQ quantization of the strength knob (aq_q is in 1/AQ_QUANT QP units)
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
