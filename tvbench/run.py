"""Run one cell of the benchmark and print its result line.

    python3 tvbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. It measures thinvids_tpu_torch only: the cell's traffic generator runs
the port's served path for `--seconds`, the reference then holds the
outputs to the source, and the last line of standard output is one JSON
object (correct, attempted, failed, metrics, device; with --trace 1 also
breakdown). The numbers compared and their limits come last on standard
error and under the result's last key. It exits non-zero with no result
when CUDA or the cards are missing, the run fails, or a JAX module was
loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tvbench import harness  # noqa: E402


def card_power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def mean_busy_s(trace: dict, cards: int) -> float:
    """Device busy seconds averaged over the cell's cards: each card's
    own busy time, summed, over the number of cards. On one card this is
    the union of its device intervals."""
    return sum(trace["busy_s_by_device"].values()) / cards


def cpu_ms_per_frame(rec: dict) -> dict:
    """The window's CPU ms a frame of each stage (the `cpu.<stage>` keys
    of the program's stage profile)."""
    frames = rec.get("frames") or 0
    return {k[4:]: v / frames for k, v in rec["stage_delta"].items()
            if k.startswith("cpu.") and frames}


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             root: Path = harness.ROOT, program: dict | None = None,
             traffic: dict | None = None) -> dict:
    """Drive one cell on `device` and return the result object.
    `program` overrides settings the program runs with (the control:
    the reference still holds it to the configuration), `traffic`
    overrides mix parameters (the rate sweep); the benchmark's own runs
    pass neither."""
    spec = harness.cell_spec(bench, name, root)
    spec["traffic"].update(traffic or {})
    harness.set_environment(spec["config"], program or {})
    from thinvids_tpu_torch.core.config import get_settings

    get_settings(refresh=True)
    workdir = Path(tempfile.mkdtemp(prefix=f"tvbench-{name}-"))
    try:
        ctx = harness.Context(spec, seed, seconds, trace, device, workdir,
                              t_start)
        rec = harness.generator(spec["traffic"]["generator"], root).run(ctx)
        rec["info"]["check_s"] = rec.pop("check_s")
        rec["info"]["window_s"] = rec["window_s"]
        rec["info"]["cpu_ms_per_frame"] = cpu_ms_per_frame(rec)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    info = {"platform": "gpu" if device != "cpu" else "cpu",
            "kind": "cpu", "count": int(spec["cell"]["chips"]),
            "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if device != "cpu":
        import torch

        info["kind"] = torch.cuda.get_device_name(0)
    if trace and "trace" in rec:
        info["busy_s"] = mean_busy_s(rec["trace"], info["count"])
        info["window_s"] = rec["trace"]["window_s"]
    return harness.assemble(bench, ctx, rec, info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    chips = int(harness.cell_spec(bench, args.workload)["cell"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tvbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"tvbench: the run loaded {', '.join(found)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3
    out["info"]["card"] = card_power_limit()
    print(json.dumps(out), flush=True)
    for line in harness.compared_lines(out["compared"]):
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
