"""Source frames of every job that finished, over the time from the
window's start to the last job's finish (the job in flight at the end
runs to completion and counts)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["frames_done"] / rec["window_s"]
