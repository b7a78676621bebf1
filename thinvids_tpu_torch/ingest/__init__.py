"""Ingest layer: streaming decode of media files into frames, the tail
source that follows a growing live file, the native probe, and the
watch-folder ingester with its processed-file ledger."""

from .decode import (DecodeError, FrameSource, open_video, read_video,
                     supported_exts)
from .probe import ProbeError, probe_video
from .tail import TailFrameSource, is_live_name, spool_stream
from .watcher import FileLedger, WatchIngester, coordinator_submitter

__all__ = ["DecodeError", "FrameSource", "open_video", "read_video",
           "supported_exts", "ProbeError", "probe_video",
           "TailFrameSource", "is_live_name", "spool_stream",
           "FileLedger", "WatchIngester", "coordinator_submitter"]
