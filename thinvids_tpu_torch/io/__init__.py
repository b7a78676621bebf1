"""Bit-level IO and NAL framing."""
