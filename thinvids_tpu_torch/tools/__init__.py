"""Host tools: the libavcodec decode oracle, the quality metrics, the
player-session load harness, the media import CLI and the native-code
fuzz harness."""
