"""StageProfile stage over the window, per frame: SfeShardEncoder.
stage_waves (pad, stack and upload of each GOP's bands)."""

from tvbench.readers import per_frame


def read(rec):
    return per_frame(rec, ("stage",))
