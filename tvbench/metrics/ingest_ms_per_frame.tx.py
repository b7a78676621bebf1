"""StageProfile decode + stage over the window, per frame: the y4m
read and the staging of waves onto the card (host busy time, summed
over threads)."""

from tvbench.readers import per_frame


def read(rec):
    return per_frame(rec, ("decode", "stage"))
