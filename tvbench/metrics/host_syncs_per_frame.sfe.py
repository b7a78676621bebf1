"""The host_syncs counter over the window, per frame: each blocking
device to host point (a copy to the host, a done event waited on) of
the live edge serialises the card behind the host."""

from tvbench.hostpath import per_frame_of


def read(rec):
    return per_frame_of(rec, ("host_syncs",))
