"""The benchmark's core: it finds a cell's configuration, traffic mix,
generator and metric readers by the names in BENCHMARK.json, runs the cell
and assembles the one result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by name:

- configs/<config>.json (the path BENCHMARK.json gives): the deployment's
  settings, sizes and source;
- traffic/<traffic>.json: the mix's parameters, naming its generator;
- traffic/<generator>.py: the code that drives the program
  (`run(ctx) -> record`);
- metrics/<metric>.py: `read(record) -> value or None` for each metric.

So a later change adds each of these as new files and entries alone:

- a configuration: its file under configs/ and its `configs` entry;
- a traffic mix: its file under traffic/, naming an existing generator or
  a new one;
- a generator: traffic/<name>.py; it may reuse another by name
  (`generator("jobs", ctx.root).run(ctx, mesh=...)`);
- a metric: metrics/<name>.py and its `end_to_end` or `per_layer` entry
  (listing its cells under `workloads`);
- a four-card cell: its `workloads` entry with `"chips": 4`. run.py
  already refuses a machine with fewer cards and reports `chips` as the
  device count; the generator reads `ctx.cell["chips"]` and builds its own
  mesh of the cards (`DeviceMesh(("cpu",) * chips)` on the CPU), and the
  device trace keeps each card's busy time (`busy_s_by_device`), whose
  mean over the cell's cards is the result's `busy_s`.

The CPU tests cut every configuration and mix to a tiny size by a rule
(`tests/tinyroot.py`: `tiny_config`, `tiny_traffic`), so a new one runs
there with no test edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run: the JAX
#: stack and the JAX package the port was made from (compared whole, so
#: `thinvids_tpu_torch` is not among them)
FORBIDDEN = ("jax", "jaxlib", "flax", "thinvids_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fp:
        return json.load(fp)


def cell_spec(bench: dict, name: str, root: Path = ROOT) -> dict:
    """{"cell", "config", "traffic"}: the workload entry, its
    configuration file and its traffic mix file, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    with open(root / entry["file"]) as fp:
        config = json.load(fp)
    with open(root / "tvbench" / "traffic" / f"{cell['traffic']}.json") as fp:
        traffic = json.load(fp)
    return {"cell": cell, "config": config, "traffic": traffic, "root": root}


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str, root: Path = ROOT):
    return load_module(root / "tvbench" / "traffic" / f"{name}.py",
                       f"tvbench_generator_{name}")


def reader(metric: str, root: Path = ROOT):
    """The `read(record)` function of one metric."""
    mod = load_module(root / "tvbench" / "metrics" / f"{metric}.py",
                      "tvbench_metric_" + metric.replace(".", "_")
                      .replace("-", "_"))
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: with trace off the end-to-end
    metrics, with trace on the per-layer ones; a metric with a
    `workloads` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def set_environment(config: dict, program: dict | None = None,
                    root: Path = ROOT) -> None:
    """Before torch or the program is imported: the process settings the
    configuration states (the deployment's TVT_* knobs; `program` replaces
    some for a control run), kernel caches at fixed paths inside the
    checkout, and no JAX pulled in by a library."""
    for key, value in dict(config["settings"], **(program or {})).items():
        if isinstance(value, bool):
            value = int(value)
        os.environ[f"TVT_{key.upper()}"] = str(value)
    cache = root / ".tvbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _read(path: str) -> str | None:
    try:
        with open(path) as fp:
            return fp.read()
    except OSError:
        return None


def host_info() -> dict:
    """The host a run shares with its card: CPU model, cores, frequency
    governor, NUMA nodes, transparent huge pages and the load average
    when the run starts. The host sets the pace of every cell."""
    cpuinfo = _read("/proc/cpuinfo") or ""
    model = next((line.split(":", 1)[1].strip()
                  for line in cpuinfo.splitlines()
                  if line.startswith("model name")), "not read")
    governor = _read("/sys/devices/system/cpu/cpu0/cpufreq/scaling_governor")
    thp = _read("/sys/kernel/mm/transparent_hugepage/enabled")
    nodes = [d for d in os.listdir("/sys/devices/system/node")
             if d.startswith("node")] \
        if os.path.isdir("/sys/devices/system/node") else []
    load = (_read("/proc/loadavg") or "").split()[:3]
    return {"cpu_model": model, "cpus": os.cpu_count(),
            "cpus_usable": len(os.sched_getaffinity(0)),
            "governor": governor.strip() if governor else "not exposed",
            "numa_nodes": len(nodes) or "not exposed",
            "thp": thp.strip() if thp else "not exposed",
            "loadavg": [float(x) for x in load]}


def host_sample() -> dict:
    """The host's CPU counters (/proc/stat, in ticks) and this process's
    CPU time and context switches, for a delta over the window."""
    import resource

    fields = (_read("/proc/stat") or "cpu 0").splitlines()[0].split()[1:]
    ticks = [int(x) for x in fields] + [0] * 10
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"ticks": ticks[:10], "cpu_s": ru.ru_utime + ru.ru_stime,
            "vcsw": ru.ru_nvcsw, "ivcsw": ru.ru_nivcsw,
            "t": time.time()}


def host_window(a: dict, b: dict) -> dict:
    """What the host did between two samples: the shares of all CPU
    time that went to steal (another guest on the host), to idle and to
    iowait, this process's CPU seconds and cores busy on average, its
    context switches, and its threads at the end."""
    d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
    total = sum(d[:8]) or 1
    wall = max(b["t"] - a["t"], 1e-9)
    cpu = b["cpu_s"] - a["cpu_s"]
    return {"steal_pct": 100.0 * d[7] / total,
            "idle_pct": 100.0 * d[3] / total,
            "iowait_pct": 100.0 * d[4] / total,
            "process_cpu_s": cpu, "process_cores": cpu / wall,
            "voluntary_switches": b["vcsw"] - a["vcsw"],
            "involuntary_switches": b["ivcsw"] - a["ivcsw"],
            "threads": len(os.listdir("/proc/self/task"))
            if os.path.isdir("/proc/self/task") else None}


def forbidden_loaded() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a generator gets: the cell's files, the run's arguments, a work
    directory, and the hooks that mark the window."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device: str, workdir: Path, t_start: float) -> None:
        self.root = spec["root"]
        self.cell = spec["cell"]
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.workdir = workdir
        self.t_start = t_start
        self.setup_s = None
        self.host = host_info()
        self._sample = None

    def open_window(self) -> float:
        """Set-up ends here: returns the window's start (time.time())."""
        self._sample = host_sample()
        now = time.time()
        self.setup_s = now - self.t_start
        return now

    def close_window(self) -> None:
        """The window's work is done: what the host did over it goes
        into the run's `info.host`."""
        self.host["window"] = host_window(self._sample, host_sample())


def compared_lines(checks: dict) -> list[str]:
    """One line for each number compared: its name, value and limit."""
    return [f"compared {k} {v['value']} limit {v['limit']}"
            for k, v in checks.items()]


def assemble(bench: dict, ctx: Context, rec: dict, device_info: dict
             ) -> dict:
    """The result line's object from a generator's record."""
    rec = dict(rec, setup_s=ctx.setup_s)
    metrics = {}
    for m in metrics_for(bench, ctx.cell["name"], ctx.trace):
        value = reader(m["name"], ctx.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_info}
    if ctx.trace and rec.get("breakdown"):
        out["breakdown"] = rec["breakdown"]
    out["info"] = dict(rec.get("info", {}), host=ctx.host)
    out["compared"] = checks
    return out
