"""The d2h_bytes counter over the window, per frame: what the transfer
pack brings back from the card."""

from tvbench.readers import per_frame


def read(rec):
    return per_frame(rec, ("d2h_bytes",))
