"""search_kernel (csrc/me_search.cu) over the 4-band stack of
608 x 3840 planes: bound time over its mean traced launch."""

from tvbench.readers import me_search_roofline


def read(rec):
    return me_search_roofline(rec)
