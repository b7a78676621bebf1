"""Bit-level IO and NAL framing, y4m frame IO, and the MP4 mux/demux."""

from .bits import BitReader, BitWriter, annexb_nal, ebsp_to_rbsp, rbsp_to_ebsp
from .y4m import Y4MReader, Y4MWriter, read_y4m, write_y4m

__all__ = [
    "BitReader",
    "BitWriter",
    "annexb_nal",
    "ebsp_to_rbsp",
    "rbsp_to_ebsp",
    "Y4MReader",
    "Y4MWriter",
    "read_y4m",
    "write_y4m",
]
