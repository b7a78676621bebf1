"""Live LL-HLS: encode while the source arrives, serve viewers during
ingest (a copy of the reference package's subsystem).

`ingest/tail.py` follows a growing source GOP-by-GOP,
`cluster/executor.run_live` feeds completed GOPs through the ladder (or
split-frame) encoder batch by batch, and :class:`LiveLadderPackager`
here writes + announces each segment the moment the GOP clears every
rung: rolling live/EVENT playlists (no EXT-X-ENDLIST until the stream
closes), EXT-X-PART partial segments with preload hints, and a sliding
DVR window. The headline metric is glass-to-playlist latency, not fps.
"""

from .packager import LiveLadderPackager

__all__ = ["LiveLadderPackager"]
