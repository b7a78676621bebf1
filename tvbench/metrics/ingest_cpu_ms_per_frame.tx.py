"""CPU time of the decode and stage stages over the window, per frame
(cpu.decode + cpu.stage): the y4m read and the staging of waves, as the
staging thread's CPU clock counts them, without its waits."""

from tvbench.hostpath import per_frame_of


def read(rec):
    return per_frame_of(rec, ("cpu.decode", "cpu.stage"))
