"""Ingest layer: streaming decode of media files into frames."""

from .decode import (DecodeError, FrameSource, open_video, read_video,
                     supported_exts)

__all__ = ["DecodeError", "FrameSource", "open_video", "read_video",
           "supported_exts"]
