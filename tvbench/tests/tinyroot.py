"""A copy of the benchmark with every cell cut to a tiny size, for
driving whole runs on the CPU.

Every configuration and traffic mix in BENCHMARK.json gets a cut: the one
`TINY` or `TRAFFIC` names for it, or else the cut `tiny_config` and
`tiny_traffic` derive from its own fields. So a configuration or mix that a
later change adds runs here with no file of the benchmark edited."""

import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: (width, height, gop, kernel shapes) of each configuration's tiny cut
TINY = {
    "h264-1080p-cqp27-gop32": (64, 48, 4, {"me_search": [48, 64, 1],
                                           "intra_pair": [1, 3, 4]}),
    "h264-2160p-sfe4-cqp27-gop8": (128, 64, 8, {"me_search": [48, 128, 4],
                                                "intra_pair": [4, 1, 8]}),
}
#: the tiny live edge's arrival rate, frames a second
TINY_RATE = 40
TRAFFIC = {"films": {"frames": 12}, "clips": {"frames": 4, "clips": 2},
           "live-2160p": {"rate_fps": TINY_RATE}}
#: the mix kept for a later cell (traffic/clips.json, several short clips
#: round robin) runs as a cell of the tiny copy, so that the generator's
#: round robin stays driven
KEPT = [{"name": "tx1080-clips", "config": "h264-1080p-cqp27-gop32",
         "traffic": "clips", "chips": 1, "why": "kept mix"}]


def tiny_config(cfg: dict) -> tuple[int, int, int, dict]:
    """(width, height, gop, kernel shapes) of a configuration's tiny cut:
    64 wide and 48 high, or with split-frame bands as many 16-row MB rows
    a band as keep the height near 48; GOPs of at most 4 frames, or 8
    with bands; the shapes the kernels then run at (a band stack's planes
    are a band and a halo, capped at the band's height, on each side)."""
    s = cfg["settings"]
    bands = int(s.get("sfe_bands", 0))
    gop = int(s["gop_frames"])
    w = 64
    if not bands:
        h = 48
        return w, h, min(gop, 4), {"me_search": [h, w, 1],
                                   "intra_pair": [1, h // 16, w // 16]}
    band = 16 * max(1, round(3 / bands))
    halo = min(max(16, int(s.get("sfe_halo_rows", 32)) // 16 * 16), band)
    return w, band * bands, min(gop, 8), {
        "me_search": [band + 2 * halo, w, bands],
        "intra_pair": [bands, band // 16, w // 16]}


def tiny_traffic(mix: dict, gop: int) -> dict:
    """A mix's tiny cut: three GOPs a clip, at most two clips, the tiny
    live rate; only the keys the mix has."""
    cut = {"frames": 3 * gop, "clips": min(int(mix.get("clips", 0)), 2),
           "rate_fps": TINY_RATE}
    return {k: v for k, v in cut.items() if k in mix}


def make(tmp: Path, src: Path = ROOT) -> tuple[Path, dict]:
    """(root, benchmark) of a tiny copy under `tmp` of the benchmark at
    `src` (BENCHMARK.json and tvbench/)."""
    root = tmp / "bench"
    shutil.copytree(src / "tvbench", root / "tvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    gops = {}
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        w, h, gop, shapes = TINY.get(c["name"]) or tiny_config(cfg)
        cfg.update(width=w, height=h, kernel_shapes=shapes)
        if "frame_rate" in cfg:
            cfg["frame_rate"] = TINY_RATE
        cfg["settings"]["gop_frames"] = gop
        path.write_text(json.dumps(cfg))
        gops[c["name"]] = gop
    mixes = {w["traffic"] for w in bench["workloads"]} | set(TRAFFIC)
    for name in mixes:
        path = root / "tvbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        gop = max(gops[w["config"]] for w in bench["workloads"]
                  if w["traffic"] == name) if name not in TRAFFIC else 0
        mix.update(TRAFFIC.get(name) or tiny_traffic(mix, gop))
        path.write_text(json.dumps(mix))
    names = {w["name"] for w in bench["workloads"]}
    for cell in KEPT:
        if cell["name"] not in names:
            bench["workloads"].append(cell)
            for m in bench["end_to_end"] + bench["per_layer"]:
                if "tx1080-films" in m.get("workloads", []):
                    m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def run(root: Path, bench: dict, cell: str, seconds: float = 1.5,
        seed: int = 2 ** 31 + 11, **kw) -> dict:
    from tvbench.run import run_cell

    return run_cell(bench, cell, seed, seconds, False, "cpu", time.time(),
                    root=root, **kw)
