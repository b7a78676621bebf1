"""The port's deployment units (deploy/torch/): each unit's ExecStart is
a command line of the port's CLI that parses (`--devices all` on the
coordinator and the worker) and starts with `--help` on the CPU, and the
pre-commit hook runs the port's `cli check` and its analyzer tests.
"""

import configparser
import os
import pathlib
import shlex
import subprocess
import sys

import pytest

from thinvids_tpu_torch import cli

REPO = pathlib.Path(__file__).resolve().parents[1]
UNITS = sorted((REPO / "deploy" / "torch").glob("*.service"))


def _exec_start(unit: pathlib.Path) -> list[str]:
    parser = configparser.ConfigParser(strict=False, interpolation=None)
    parser.optionxform = str
    parser.read(unit)
    return shlex.split(parser["Service"]["ExecStart"])


def test_the_three_units_exist():
    assert [u.name for u in UNITS] == [
        "thinvids-torch-agent.service", "thinvids-torch-coordinator.service",
        "thinvids-torch-worker.service"]


@pytest.mark.parametrize("unit", UNITS, ids=[u.stem for u in UNITS])
def test_unit_runs_the_port_cli(unit):
    argv = _exec_start(unit)
    assert argv[:4] == ["/usr/bin/env", "python3", "-m",
                        "thinvids_tpu_torch.cli"]
    cmd = argv[4]
    assert unit.stem == f"thinvids-torch-{cmd}"
    args = cli.build_parser().parse_args(argv[4:])
    if cmd in ("coordinator", "worker"):
        assert args.devices == "all"
    else:
        assert args.device == "cuda"
    res = subprocess.run([sys.executable] + argv[2:] + ["--help"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60, env=dict(os.environ,
                                              PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert f"usage: thinvids_tpu_torch {cmd}" in res.stdout


def test_precommit_hook_runs_the_port_check():
    hook = REPO / "deploy" / "torch" / "pre-commit"
    assert os.access(hook, os.X_OK)
    body = hook.read_text()
    assert "python -m thinvids_tpu_torch.cli check --quiet" in body
    assert "tests/test_torch_analysis.py" in body
