"""A copy of the benchmark with every cell cut to a tiny size, for
driving whole runs on the CPU."""

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
TRAFFIC = {"films": {"frames": 12}, "clips": {"frames": 4, "clips": 2},
           "live-2160p": {"rate_fps": 40}}
#: the mix kept for a later cell (traffic/clips.json, several short clips
#: round robin) runs as a cell of the tiny copy, so that the generator's
#: round robin stays driven
KEPT = [{"name": "tx1080-clips", "config": "h264-1080p-cqp27-gop32",
         "traffic": "clips", "chips": 1, "why": "kept mix"}]


def make(tmp: Path) -> tuple[Path, dict]:
    """(root, benchmark) of a tiny copy under `tmp`."""
    root = tmp / "bench"
    shutil.copytree(ROOT / "tvbench", root / "tvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        w, h, gop, shapes = TINY[c["name"]]
        cfg.update(width=w, height=h, kernel_shapes=shapes)
        if "frame_rate" in cfg:
            cfg["frame_rate"] = TRAFFIC["live-2160p"]["rate_fps"]
        cfg["settings"]["gop_frames"] = gop
        path.write_text(json.dumps(cfg))
    for name, upd in TRAFFIC.items():
        path = root / "tvbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(upd)
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
