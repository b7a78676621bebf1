"""StageProfile await_staged over the window, per frame: the time the
thread that drives the card sat blocked on the staging queue, waiting
for a decoded and uploaded wave (the part of ingest that sets the
pace)."""

from tvbench.hostpath import per_frame_of


def read(rec):
    return per_frame_of(rec, ("await_staged",))
