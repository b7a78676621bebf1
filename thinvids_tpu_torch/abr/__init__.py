"""ABR ladder subsystem: on-card downscale, multi-rendition encode, HLS
packaging.

Three pieces, split along the torch boundary:

- :mod:`.scale` — separable polyphase Lanczos-3 downscaler. Taps
  precompute on host as two small resampling matrices per plane; the
  card applies them as two float32 products, so every lower ladder rung
  is derived from the ALREADY-STAGED wave tensors (decode + upload
  happens once per wave regardless of rung count — proven by the
  `h2d_bytes` stage counter).
- :mod:`.ladder` — rung planner (source → e.g. 1080/720/480/360 with
  per-rung QPs from the R ∝ 2^(−qp/6) rate model) and
  :class:`~.ladder.LadderShardEncoder`, the multi-rendition encoder
  `parallel.dispatch.make_shard_encoder(rungs=)` returns. torch-free at
  module scope.
- :mod:`.hls` — closed-GOP-aligned fMP4 segmenter + media/master
  playlist writer + conformance lint. torch-free entirely, so packaging
  runs on processes that never load a device backend.

This package intentionally has NO module-scope imports: `ladder` and
`hls` must stay importable without torch, and importing `scale` here
would drag torch into both.
"""
