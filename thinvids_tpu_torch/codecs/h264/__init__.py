"""H.264 baseline encoder (CAVLC, I16x16 intra + P frames): torch device
compute, host entropy pack.

The surface mirrors the reference package's: `H264Encoder` /
`encode_frames` (all-intra) and `encode_gop` (one closed GOP), each
taking ``device="cuda"`` by default.
"""

__all__ = ["H264Encoder", "encode_frames", "encode_gop", "SPS", "PPS"]


def __getattr__(name):  # lazy: keep table/transform imports light
    if name in __all__:
        from . import encoder, headers

        return {
            "H264Encoder": encoder.H264Encoder,
            "encode_frames": encoder.encode_frames,
            "encode_gop": encoder.encode_gop,
            "SPS": headers.SPS,
            "PPS": headers.PPS,
        }[name]
    raise AttributeError(name)
