"""search_kernel (csrc/me_search.cu) at 1088 x 1920: bound time over
its mean traced launch."""

from tvbench.readers import me_search_roofline


def read(rec):
    return me_search_roofline(rec)
