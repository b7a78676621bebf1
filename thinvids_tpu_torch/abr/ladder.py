"""ABR ladder helpers (the part of the reference's abr/ladder.py that the
settings layer needs: the canonical rung-spec parser behind the
``ladder_rungs`` clamp). The ladder encoder itself is not ported yet."""

from __future__ import annotations

from typing import Any

#: the default rung heights (``ladder_rungs``), tallest first
DEFAULT_RUNGS = "1080,720,480,360"


def parse_rung_heights(spec: Any) -> list[int]:
    """'1080,720,480' → [1080, 720, 480]; junk entries are dropped,
    duplicates collapse, order is tallest-first."""
    heights = []
    for part in str(spec or "").replace(";", ",").split(","):
        part = part.strip().lower().rstrip("p")
        if not part:
            continue
        try:
            h = int(part)
        except ValueError:
            continue
        if h > 0:
            heights.append(h)
    return sorted(set(heights), reverse=True)
