"""StageProfile sparse_unpack + unflatten + pack over the window, per
frame: the host collect and CAVLC pack (host busy time, summed over the
pack threads)."""

from tvbench.readers import per_frame


def read(rec):
    return per_frame(rec, ("sparse_unpack", "unflatten", "pack"))
