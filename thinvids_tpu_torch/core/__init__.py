"""Core video types, settings, status and device resolution.

The package root exports the reference's 13 names; none of them pulls
torch (device resolution lives in `core.devices`, imported on its own).
"""

from .status import Status
from .types import (
    ChromaFormat,
    FrameType,
    VideoMeta,
    Frame,
    GopSpec,
    SegmentPlan,
    EncodedSegment,
)
from .config import Settings, get_settings, DEFAULT_SETTINGS
from .events import ActivityLog
from .log import get_logging

__all__ = [
    "Status",
    "ChromaFormat",
    "FrameType",
    "VideoMeta",
    "Frame",
    "GopSpec",
    "SegmentPlan",
    "EncodedSegment",
    "Settings",
    "get_settings",
    "DEFAULT_SETTINGS",
    "ActivityLog",
    "get_logging",
]
