"""Host tools: the libavcodec decode oracle."""
