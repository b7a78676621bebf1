"""Ingest layer: streaming decode of media files into frames, and the
tail source that follows a growing live file."""

from .decode import (DecodeError, FrameSource, open_video, read_video,
                     supported_exts)
from .tail import TailFrameSource, is_live_name, spool_stream

__all__ = ["DecodeError", "FrameSource", "open_video", "read_video",
           "supported_exts", "TailFrameSource", "is_live_name",
           "spool_stream"]
