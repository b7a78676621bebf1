"""StageProfile fetch + sfe over the window, per frame: the SFE
collect (the fetch of each frame's bands and their per-frame pack)."""

from tvbench.readers import per_frame


def read(rec):
    return per_frame(rec, ("fetch", "sfe"))
