"""StageProfile await_staged over the window, per frame: the time the
live edge's thread waited for each GOP's band stacks to be staged (a
batch of one GOP cannot overlap its own staging)."""

from tvbench.hostpath import per_frame_of


def read(rec):
    return per_frame_of(rec, ("await_staged",))
