"""StageProfile walk_intra + walk_probe + walk_p + walk_link over the
window, per frame: the host time to enqueue the split-frame walk's
steps (the IDR step, the global-motion probe, the P step, the next
frame's edge rows and median prediction), inside dispatch."""

from tvbench.hostpath import per_frame_of

#: the walk's steps, one stage each
STEPS = ("walk_intra", "walk_probe", "walk_p", "walk_link")


def read(rec):
    return per_frame_of(rec, STEPS)
