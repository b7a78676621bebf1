"""Media import CLI: scan a source tree and queue transcodes (a copy of
the reference package's, over the port's ingest.probe, ingest.decode
and API).

Analog of the reference's acquisition tooling
(the upstream project's rips/dvd_rip_queue.py): that tool ripped a disc with
makemkvcon, auto-titled via TMDb, remuxed, normalized the name to
``Title (Year) <res>p h264.mkv`` and dropped the file into the watch
root (or POSTed /add_job). The disc-drive and TMDb halves are hardware/
network-bound and out of scope here; this tool keeps the pipeline-facing
half: discover source media, probe it natively, normalize names the
same way, and queue it — by watch-root drop (the watcher's ledger picks
it up) or directly against the coordinator API. `--dry-run` prints the
plan, as the reference's tooling did (dvd_rip_queue.py:1947).

Usage:
    python -m thinvids_tpu_torch.tools.import_media SRC_DIR \
        --watch-root /srv/watch [--movies-subdir movies] [--dry-run]
    python -m thinvids_tpu_torch.tools.import_media SRC_DIR \
        --api http://manager:5005 [--dry-run]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import urllib.request

from ..ingest.decode import supported_exts
from ..ingest.probe import ProbeError, probe_video


def normalized_name(path: str, height: int, codec: str) -> str:
    """``Title (Year) <res>p <codec>.<ext>`` when a year is present in
    the source name, else ``Title <res>p <codec>.<ext>`` — the
    reference's final-name scheme (dvd_rip_queue.py:1761-1814)."""
    base, ext = os.path.splitext(os.path.basename(path))
    year = None
    # a parenthesized/bracketed year wins; otherwise take the LAST bare
    # year-like token so titles containing a year keep it
    # ("Blade Runner 2049 (2017)" → year 2017, not 2049)
    m = re.search(r"[(\[](19\d{2}|20\d{2})[)\]]", base)
    if m is None:
        bare = list(re.finditer(r"[.\s](19\d{2}|20\d{2})(?=[.\s]|$)",
                                base))
        m = bare[-1] if bare else None
    if m:
        year = m.group(1)
        base = base[:m.start()]
    title = re.sub(r"[._]+", " ", base).strip(" -_.")
    title = re.sub(r"\s{2,}", " ", title) or "Untitled"
    title = " ".join(w if w.isupper() else w.capitalize()
                     for w in title.split())
    res = f"{height}p"
    tail = f"({year}) {res}" if year else res
    return f"{title} {tail} {codec}{ext.lower()}"


def discover(src_dir: str) -> list[str]:
    exts = supported_exts()
    found = []
    for root, _dirs, files in os.walk(src_dir):
        for name in sorted(files):
            if name.lower().endswith(exts) and not name.startswith("."):
                found.append(os.path.join(root, name))
    return found


def plan_imports(src_dir: str) -> list[dict]:
    """[{src, name, width, height, codec, duration_s} | {src, error}]"""
    plans = []
    for src in discover(src_dir):
        try:
            meta = probe_video(src)
        except ProbeError as exc:
            plans.append({"src": src, "error": str(exc)})
            continue
        plans.append({
            "src": src,
            "name": normalized_name(src, meta.height, meta.codec),
            "width": meta.width, "height": meta.height,
            "codec": meta.codec,
            "duration_s": round(meta.duration_s, 3),
        })
    return plans


def import_to_watch(plan: dict, watch_root: str, subdir: str = "") -> str:
    """Copy one planned file into the watch root under its normalized
    name (atomic: temp + rename, so the watcher's size-stabilization
    never sees a half-copied file as stable)."""
    dest_dir = os.path.join(watch_root, subdir) if subdir else watch_root
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, plan["name"])
    tmp = dest + ".importing"
    shutil.copyfile(plan["src"], tmp)
    os.replace(tmp, dest)
    return dest


def submit_to_api(plan: dict, api_base: str, timeout_s: float = 30.0
                  ) -> dict:
    body = json.dumps({"input_path": plan["src"]}).encode()
    req = urllib.request.Request(
        api_base.rstrip("/") + "/add_job", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="import_media", description=__doc__.splitlines()[0])
    p.add_argument("src_dir")
    dest = p.add_mutually_exclusive_group(required=True)
    dest.add_argument("--watch-root", help="copy into this watch folder")
    dest.add_argument("--api", help="submit paths to this coordinator API")
    p.add_argument("--movies-subdir", default="",
                   help="subdirectory under the watch root")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    plans = plan_imports(args.src_dir)
    rc = 0
    for plan in plans:
        if "error" in plan:
            print(f"SKIP {plan['src']}: {plan['error']}")
            rc = 1
            continue
        probe = (f"[{plan['width']}x{plan['height']} {plan['codec']} "
                 f"{plan['duration_s']}s]")
        if args.dry_run:
            target = (f"-> {plan['name']}" if args.watch_root
                      else "(submitted as-is)")
            print(f"PLAN {plan['src']} {target} {probe}")
        elif args.watch_root:
            dest_path = import_to_watch(plan, args.watch_root,
                                        args.movies_subdir)
            print(f"COPIED {plan['src']} -> {dest_path} {probe}")
        else:
            # API mode submits the source path verbatim — the output
            # file is named from it; name normalization applies only to
            # watch-root drops
            job = submit_to_api(plan, args.api)
            print(f"QUEUED {plan['src']} {probe} as job {job.get('id')}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
