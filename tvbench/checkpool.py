"""Hold the sampled GOPs of a run to the plain reference, one process a
GOP.

Every sampled GOP is closed (it starts at an IDR picture), so each is
checked on its own: the reference parses and reconstructs it picture by
picture from its IDR picture to its last. Each GOP runs in a fresh Python
process (`python -m tvbench.checkpool`, the task in on stdin and the
result out on stdout, both pickled), so a child imports NumPy and the
reference alone, never torch or the program, and rebuilds the GOP's
source frames from the seeded scene. The run waits for every child to
end before it reports.

A task is a dict: `stream` (Annex-B bytes), `first` (the index in the
stream of the GOP's IDR picture) and `count` (pictures to follow),
`scene` (the Scene seed), `width`, `height`, `offset` (the scene frame of
stream picture 0) and `qp` (the configured QP).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def check_gop(task: dict) -> dict:
    """One GOP's check: mismatched levels, slices off the QP, errors and
    pictures checked."""
    from tvbench.content import Scene
    from tvbench.reference import h264

    scene = Scene(task["scene"], task["width"], task["height"])
    offset = task["offset"]
    r = h264.check_stream(task["stream"], lambda i: scene.planes(offset + i),
                          task["qp"], first=task["first"],
                          count=task["count"])
    return {"mismatched_levels": r.mismatched_levels, "qp_off": r.qp_off,
            "errors": r.errors, "checked": r.checked}


def run(tasks: list[dict]) -> list[dict]:
    """check_gop over the tasks, in order, one child process each."""
    if not tasks:
        return []
    import concurrent.futures as cf

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-m", "tvbench.checkpool"],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              env=env)
             for _ in tasks]

    def one(proc, task):
        out, _ = proc.communicate(pickle.dumps(task))
        if proc.returncode != 0:
            raise RuntimeError(f"the check of a GOP exited {proc.returncode}")
        return pickle.loads(out)

    with cf.ThreadPoolExecutor(len(tasks)) as pool:
        futures = [pool.submit(one, p, t) for p, t in zip(procs, tasks)]
        return [f.result() for f in futures]


if __name__ == "__main__":
    sys.stdout.buffer.write(pickle.dumps(check_gop(pickle.load(
        sys.stdin.buffer))))
