"""The intra kernel pair (csrc/intra_core.cu) on the 4-band stack of
an IDR step (4 x 34 x 240 MBs): bound time over the mean traced row-0
plus column launch."""

from tvbench.readers import intra_core_roofline


def read(rec):
    return intra_core_roofline(rec)
