"""Single chip_smoke.py points on one card, for a quick chip call or a
comparison of two checkouts.

    python3 scripts/chip_points.py manager
    python3 scripts/chip_points.py farm
    python3 scripts/chip_points.py daemon-jobs
    python3 scripts/chip_points.py mesh
    python3 scripts/chip_points.py check
    python3 scripts/chip_points.py spec
    python3 scripts/chip_points.py ab PARENT_DIR CHANGE_DIR

- `manager`: phase 14 alone — builds the kernels, makes phase 6's MP4
  (`chip_smoke._run_job`) and phase 12's ladder job tree
  (`chip_smoke.ladder_job`), then runs `chip_smoke.manager_phase`.
- `farm`: phase 16 and phase 17d — builds the kernels, holds them at
  the farm slice's stacks (`chip_smoke.check_farm_slice_kernels`), makes
  phase 6's MP4 (`chip_smoke._run_job`), runs `chip_smoke.farm_phase`,
  then `chip_smoke.mesh_farm_point`: the 4-band farm SFE job on two
  workers with two-entry meshes (aliased on one card), against a local
  one-card 4-band encode that must equal the JAX package's stream.
- `daemon-jobs`: job times through the manager daemon beside the job
  path in this process: phase 6's job twice here, then `cli coordinator
  --device cuda` in a subprocess and the same clip posted to /add_job
  four times (unprofiled, unprofiled, with a per-job `profile_dir`,
  unprofiled); each job's run and submit-to-done seconds and job fps.
- `mesh`: phase 17 alone — builds the kernels, then runs
  `chip_smoke.mesh_phase` (the kernels at a mesh entry's run, the 1080p
  GOP point on the mesh against MESH_POINT_JAX, the 4K split-frame point
  spread over the mesh against phase 10's stream, the 4-band farm on two
  workers' meshes), without phase 4's, phase 10's and phase 16's figures
  beside it.
- `check`: phase 18 alone — builds the kernels, runs phase 4's main
  path (`chip_smoke.main_path`, for its stream), then
  `chip_smoke.check_phase`: `cli check --json` with no torch in its
  process, the runtime sync audit of the main path and of one IDR and
  one P frame, and the pack_workers resize.
- `spec`: phase 19 alone, after the farm slices' stacks — builds the
  kernels, holds and times them at the farm slice's stacks
  (`chip_smoke.check_farm_slice_kernels`), then runs
  `chip_smoke.spec_phase`: the card's intra program against the numpy
  specification at 352x288 and 1080p, and the 8-entry aliased mesh's
  all-intra stream against it.
- `ab`: phase 4's main path (`chip_smoke.main_path`) and phase 10's SFE
  point (`chip_smoke.sfe_point`) in two checkouts in turns (parent,
  change, change, parent), each in its own process, printing each
  run's figures.

Every line that carries a time names the card and its power limit.
Needs a CUDA card; run from the repository root.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def manager() -> None:
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job1080.y4m")
        cs._write_clip(path, cs.make_frames(16, 1920, 1080), 1920, 1080)
        stream, mp4 = cs._run_job(path, "cuda")
        tree = cs.ladder_job(tmp, stream)
    t0 = time.perf_counter()
    out = cs.manager_phase(mp4, tree, card)
    print(f"manager phase launches {out}, "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)


def farm() -> None:
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all()
    dev = cs.torch.device("cuda", 0)
    cs.check_farm_slice_kernels([dev, dev])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job1080.y4m")
        cs._write_clip(path, cs.make_frames(16, 1920, 1080), 1920, 1080)
        _, mp4 = cs._run_job(path, "cuda")
    t0 = time.perf_counter()
    out = cs.farm_phase(mp4, card)
    print(f"farm phase {out}, {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    t0 = time.perf_counter()
    cs.mesh_farm_point(card, out)
    print(f"mesh farm point {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)


def daemon_jobs(n: int = 16, w: int = 1920, h: int = 1080,
                device: str = "cuda") -> None:
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.y4m")
        cs._write_clip(clip, cs.make_frames(n, w, h), w, h)
        for i in range(2):
            t0 = time.perf_counter()
            _, mp4 = cs._run_job(clip, device)
            t = time.perf_counter() - t0
            print(f"in-process job {i}: {t:.3f} s ({n / t:.3f} job fps); "
                  f"{card}", flush=True)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        env = dict(os.environ, PYTHONPATH=ROOT, TVT_MIN_IDLE_WORKERS="0",
                   TVT_GOP_FRAMES="8", TVT_QP="27")
        with open(os.path.join(tmp, "coordinator.log"), "wb") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "thinvids_tpu_torch.cli",
                 "coordinator", "--host", "127.0.0.1", "--port", str(port),
                 "--state-dir", os.path.join(tmp, "state"),
                 "--output-dir", os.path.join(tmp, "library"),
                 "--device", device],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            while not cs._http_up(base):
                cs.check(proc.poll() is None, "the daemon exited")
                time.sleep(0.1)
            runs = [("unprofiled", ""), ("unprofiled", ""),
                    ("profiled", os.path.join(tmp, "profile")),
                    ("unprofiled", "")]
            for i, (kind, profile_dir) in enumerate(runs):
                path = os.path.join(tmp, f"job{i}.y4m")
                os.link(clip, path)
                code, raw = cs._http(base, "/add_job", {
                    "input_path": path,
                    "settings": {"profile_dir": profile_dir}})
                cs.check(code == 201, f"/add_job answered {code}")
                job = cs._await_job(base, path, proc, 180.0)
                with open(job["output_path"], "rb") as fp:
                    cs.check(fp.read() == mp4,
                             "the daemon's MP4 differs from this process's")
                run = job["finished_at"] - job["started_at"]
                print(f"daemon job {i} ({kind}): run {run:.3f} s "
                      f"({n / run:.3f} job fps), submit to done "
                      f"{job['finished_at'] - job['created_at']:.3f} s; "
                      f"{card}", flush=True)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=40)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)


def mesh() -> None:
    print(f"card: {cs.card_line()}", flush=True)
    cs.build_all()
    t0 = time.perf_counter()
    out = cs.mesh_phase({}, {})
    print(f"mesh phase {time.perf_counter() - t0:.1f} s: {out['mesh']}",
          flush=True)


def check_point() -> None:
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all()
    main = cs.main_path()
    cs.check_phase(main, card)


def spec() -> None:
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.build_all()
    dev = cs.torch.device("cuda", 0)
    cs.check_farm_slice_kernels([dev, dev])
    cs.spec_phase(dev, card)


def ab(parent: str, change: str) -> None:
    print(f"card: {cs.card_line()}", flush=True)
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke as cs; "
            "cs.build_all(); cs.main_path(); cs.sfe_point()")
    trees = {"parent": parent, "change": change}
    for name in ("parent", "change", "change", "parent"):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
                             capture_output=True, text=True, timeout=400)
        print(f"== {name} rc={res.returncode} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in res.stdout.splitlines():
            if line.startswith(("main path", "stage_ms", "sfe point",
                                "sfe stage_ms")):
                print(line, flush=True)
        cs.check(res.returncode == 0, f"{name}: {res.stderr[-2000:]}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("manager")
    sub.add_parser("farm")
    sub.add_parser("daemon-jobs")
    sub.add_parser("mesh")
    sub.add_parser("check")
    sub.add_parser("spec")
    two = sub.add_parser("ab")
    two.add_argument("parent")
    two.add_argument("change")
    args = p.parse_args()
    if not cs.torch.cuda.is_available():
        raise SystemExit("chip_points: CUDA is not available")
    if args.cmd == "manager":
        manager()
    elif args.cmd == "farm":
        farm()
    elif args.cmd == "daemon-jobs":
        daemon_jobs()
    elif args.cmd == "mesh":
        mesh()
    elif args.cmd == "check":
        check_point()
    elif args.cmd == "spec":
        spec()
    else:
        ab(os.path.abspath(args.parent), os.path.abspath(args.change))


if __name__ == "__main__":
    main()
