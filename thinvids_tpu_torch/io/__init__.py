"""Bit-level IO and NAL framing, y4m frame IO, and the MP4 mux/demux."""
