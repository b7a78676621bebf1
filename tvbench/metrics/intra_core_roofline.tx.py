"""The intra kernel pair (csrc/intra_core.cu) on one 1080p IDR frame:
bound time over the mean traced row-0 plus column launch."""

from tvbench.readers import intra_core_roofline


def read(rec):
    return intra_core_roofline(rec)
