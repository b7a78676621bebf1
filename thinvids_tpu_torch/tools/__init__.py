"""Host tools: the libavcodec decode oracle and the quality metrics."""
