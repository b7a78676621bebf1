"""thinvids_tpu_torch — the PyTorch/CUDA port of thinvids_tpu's encoder.

The closed-GOP H.264 encode (IDR + P frames, RD features off, compact
level transfer, threaded CAVLC pack) runs on an NVIDIA GPU: plain
PyTorch for the intra core, the P-frame residual and the transfer
packing, and one hand-written CUDA kernel (csrc/me_search.cu) for motion
search + compensation. Entry points take ``device="cuda"`` by default and
raise when no card is present; ``device="cpu"`` runs the same code on
the CPU with each kernel's plain PyTorch version.

Layout:
    core/      video types, device resolution
    io/        bit writer / NAL framing
    codecs/    H.264 host half (tables, CAVLC, headers, slice packers,
               transfer layout) + the torch device compute
               (torchcore, torchme, torchinter)
    csrc/      CUDA sources, built with nvcc at first use
    native/    C++ CAVLC packer, built with g++ at first use
    parallel/  segment planner + GopShardEncoder (wave dispatch/collect)
"""

__version__ = "0.1.0"
