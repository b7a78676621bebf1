"""The port's static analyzer (thinvids_tpu_torch.analysis, `cli check`).

Four layers:

1. the reference's own analyzer cases (tests/test_analysis.py) over the
   port's analyzer: the file is read with every `thinvids_tpu` naming
   `thinvids_tpu_torch` and executed as a module of its own, and the
   classes of its generic passes are collected here;
2. (tests/test_torch_analysis_parity.py) side by side: the same fixture
   sources through both analyzers, one case per generic pass, with
   equal (code, line, key) findings;
3. the torch counterparts of the reference's sync and jit cases: the
   same violation in torch's idiom, caught with the reference's code at
   the seeded line, and the clean fixtures clean;
4. the clean-tree gates over the port: no open finding, no stale waiver,
   `cli check` with torch and jax unimportable, the device-free modules
   importable without torch.

Harness pins of the collected reference cases. Their fixtures are
written in the reference's device idiom (`import jax`, `device_get`,
`XLA_FLAGS`), so where a case builds a Manifest without naming them,
the port's Manifest gets the reference's values: `device_roots=("jax",)`
(the reference's `jax_roots`), `sync_calls` = the reference's
(`device_get`, `block_until_ready`), `foreign_env_prefixes` = the
reference's (XLA_ and JAX_ among them), and `reference_roots=()` (the
port's TVT-J003 would otherwise flag the fixtures' `import jax` a second
time). The renamed keywords (`jax_free`, `jax_roots`, `jit_modules`) are
mapped to the port's names.

Reference cases left out, by name:
- `TestSyncsPass` and `TestJitPass`: the jax idiom (`device_get`,
  `jax.jit`); layer 3 holds their torch counterparts;
- `TestCleanTree`: the reference's tree; layer 4 holds the port's;
- `TestCheckOutputs.test_precommit_hook_is_installable`: the reference's
  hook (deploy/pre-commit); tests/test_torch_deploy.py holds the port's
  (deploy/torch/pre-commit).
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

from thinvids_tpu.analysis import Manifest as RefManifest
from thinvids_tpu_torch.analysis import (Manifest, SourceTree, apply_waivers,
                                         default_manifest, run_all)
from thinvids_tpu_torch.analysis import imports, jitcheck, syncs
from thinvids_tpu_torch.analysis.astutil import matches_any

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "thinvids_tpu_torch")
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""))

#: the reference's keyword → the port's
RENAMED = {"jax_free": "device_free", "jax_roots": "device_roots",
           "jit_modules": "kernel_modules"}
_REF = RefManifest()
#: the harness pins (module docstring)
PINS = {"device_roots": ("jax",), "reference_roots": (),
        "sync_calls": _REF.sync_calls,
        "foreign_env_prefixes": _REF.foreign_env_prefixes}


def port_manifest(**kw) -> Manifest:
    """The port's Manifest from a reference case's keywords: renamed
    keywords mapped, the harness pins where the case gives none."""
    kw = {RENAMED.get(k, k): v for k, v in kw.items()}
    for key, value in PINS.items():
        kw.setdefault(key, value)
    return Manifest(**kw)


def reference_cases(name: str) -> types.ModuleType:
    """tests/<name>.py with its `thinvids_tpu` imports pointed at the
    port, executed as a module of its own (tracebacks keep the reference
    file's lines); its Manifest is `port_manifest`."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch", path.read_text())
    mod = types.ModuleType(f"{name}_over_the_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    mod.Manifest = port_manifest
    return mod


_CASES = reference_cases("test_analysis")
TestImportsPass = _CASES.TestImportsPass
TestThreadsPass = _CASES.TestThreadsPass
TestConfigPass = _CASES.TestConfigPass
TestLocksetPass = _CASES.TestLocksetPass
TestStateMachineAudit = _CASES.TestStateMachineAudit
TestBoardModel = _CASES.TestBoardModel
TestWaivers = _CASES.TestWaivers


class TestCheckOutputs(_CASES.TestCheckOutputs):
    #: the reference's hook; tests/test_torch_deploy.py checks the port's
    test_precommit_hook_is_installable = None


def make_pkg(tmp_path, files, name="fixpkg", tree_cls=SourceTree):
    root = tmp_path / name
    root.mkdir(parents=True, exist_ok=True)
    files = dict(files)
    files.setdefault("__init__.py", "")
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return tree_cls(str(root), package=name)


def codes(findings):
    return sorted(f.code for f in findings)


# ---------------------------------------------------------------------------
# torch counterparts of the reference's sync cases (TestSyncsPass)
# ---------------------------------------------------------------------------


class TestTorchSyncsPass:
    def test_cpu_outside_allowlist(self, tmp_path):
        # the reference's `return jax.device_get(x)` at line 3
        tree = make_pkg(tmp_path, {
            "hot.py": "import torch\n"
                      "def f(x):\n    return x.cpu()\n"})
        found = syncs.run(tree, Manifest(package="fixpkg",
                                         sync_allowlist=()))
        assert [(f.code, f.line) for f in found] == [("TVT-S001", 3)]

    def test_synchronize_outside_allowlist(self, tmp_path):
        tree = make_pkg(tmp_path, {
            "hot.py": "import torch\n"
                      "def f(x):\n    torch.cuda.synchronize()\n"
                      "    return x\n",
            "ev.py": "from torch.cuda import synchronize as sync\n"
                     "def g(ev):\n    ev.synchronize()\n"})
        found = syncs.run(tree, Manifest(package="fixpkg",
                                         sync_allowlist=()))
        assert sorted((f.code, f.module, f.line) for f in found) == [
            ("TVT-S001", "fixpkg.ev", 1), ("TVT-S001", "fixpkg.ev", 3),
            ("TVT-S001", "fixpkg.hot", 3)]

    def test_allowlisted_module_is_clean(self, tmp_path):
        tree = make_pkg(tmp_path, {
            "hot.py": "import torch\n"
                      "def f(x):\n    torch.cuda.synchronize()\n"
                      "    return x.cpu()\n"})
        m = Manifest(package="fixpkg", sync_allowlist=("fixpkg.hot",))
        assert syncs.run(tree, m) == []

    def test_implicit_asarray_sync(self, tmp_path):
        # the reference's `x = jnp.zeros(8); return np.asarray(x)`: line 5
        tree = make_pkg(tmp_path, {
            "hot.py": "import torch\nimport numpy as np\n"
                      "def f():\n"
                      "    x = torch.zeros(8)\n"
                      "    return np.asarray(x)\n"})
        found = syncs.run(tree, Manifest(package="fixpkg",
                                         sync_allowlist=()))
        assert [(f.code, f.line) for f in found] == [("TVT-S002", 5)]

    def test_implicit_scalar_and_method_syncs(self, tmp_path):
        tree = make_pkg(tmp_path, {
            "hot.py": "import torch\nimport numpy as np\n"
                      "def a(x):\n"
                      "    return float(torch.sum(x))\n"
                      "def b():\n"
                      "    return np.asarray(torch.zeros(4))\n"
                      "def c(x):\n"
                      "    y = torch.abs(x)\n"
                      "    z = y.sum()\n"
                      "    return z.item(), y.tolist(), y.numpy(), bool(z)\n"
                      "def d():\n"
                      "    m = torch.zeros((4, 4))\n"
                      "    m[0, 0] = 1\n"
                      "    return m\n"})
        found = syncs.run(tree, Manifest(package="fixpkg",
                                         sync_allowlist=()))
        assert sorted((f.code, f.line) for f in found) == [
            ("TVT-S002", 4), ("TVT-S002", 6), ("TVT-S002", 10),
            ("TVT-S002", 10), ("TVT-S002", 10), ("TVT-S002", 10),
            ("TVT-S002", 13)]

    def test_host_numpy_only_is_clean(self, tmp_path):
        tree = make_pkg(tmp_path, {
            "cold.py": "import numpy as np\nimport torch\n"
                       "def f(y):\n"
                       "    x = np.ones(3)\n"
                       "    n = torch.cuda.device_count()\n"
                       "    t = torch.zeros(4)\n"
                       "    t[..., 0] = 0\n"
                       "    return (np.asarray(x), float(y), x.item(),\n"
                       "            x.tolist(), int(n), int(t.size(0)),\n"
                       "            int(t.shape[0]))\n"})
        assert syncs.run(tree, Manifest(package="fixpkg",
                                        sync_allowlist=())) == []


# ---------------------------------------------------------------------------
# torch counterparts of the reference's jit cases (TestJitPass)
# ---------------------------------------------------------------------------

def _jit_manifest(hot_loops=()):
    return Manifest(package="fixpkg", kernel_modules=("fixpkg.dev",),
                    hot_loops=hot_loops)


#: the slice rule audits the modules that import torch; the import goes
#: last so every seeded line is the reference fixture's
TORCH = "import torch\n"


class TestTorchJitPass:
    @pytest.mark.parametrize("src", [
        "import torch\n@torch.compile\ndef f(x):\n    return x\n",
        "import ctypes\n_l = ctypes.CDLL('x.so')\n",
        "import triton\n@triton.jit\ndef k(p):\n    pass\n",
        "import torch\ng = torch.cuda.CUDAGraph()\n",
        "import torch\nwith torch.cuda.graph(g):\n    pass\n",
        "from torch.utils import cpp_extension\n"
        "m = cpp_extension.load_inline('m', '')\n",
        "import os\nfrom torch.utils.cpp_extension import load\n"])
    def test_kernel_build_outside_declared_modules(self, tmp_path, src):
        # the reference's stray `@jax.jit` at line 2
        tree = make_pkg(tmp_path, {"stray.py": src})
        found = jitcheck.run(tree, _jit_manifest())
        assert [(f.code, f.line) for f in found] == [("TVT-X001", 2)]

    def test_kernel_build_inside_declared_modules_is_clean(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "import ctypes\nimport torch\n"
            "_l = ctypes.CDLL('x.so')\n"
            "f = torch.compile(lambda x: x)\n")})
        assert jitcheck.run(tree, _jit_manifest()) == []

    def test_unquantized_dynamic_slice_bound(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "def fetch(payload, used):\n"
            "    a = payload[:, :used.max()]\n"
            "    n = int(used.max())\n"
            "    b = payload[:, :n]\n"
            "    return a, b\n") + TORCH})
        found = jitcheck.run(tree, _jit_manifest())
        assert [(f.code, f.line) for f in found] == [("TVT-X001", 2)]
        assert "quantizer" in found[0].message

    def test_taint_survives_unpack_and_annotated_assign(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "def a(payload, lens):\n"
            "    used, z = lens.max(), 0\n"
            "    return payload[:, :used]\n"
            "def b(payload, lens):\n"
            "    used: int = lens.max()\n"
            "    return payload[:, :used]\n") + TORCH})
        found = jitcheck.run(tree, _jit_manifest())
        assert [(f.code, f.line) for f in found] == [("TVT-X001", 3),
                                                     ("TVT-X001", 6)]

    def test_quantized_slice_is_clean(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "def fetch(payload, used, cut):\n"
            "    mu = cut(used.max())\n"
            "    return payload[:, :cut(used.max())], payload[:, :mu]\n")
            + TORCH})
        assert jitcheck.run(tree, _jit_manifest()) == []

    def test_nested_function_audited_once_with_own_taint(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "def outer(payload, lens):\n"
            "    used = lens.max()\n"
            "    def inner(payload, used):\n"
            "        return payload[:, :used]\n"
            "    return inner\n") + TORCH})
        assert jitcheck.run(tree, _jit_manifest()) == []

    def test_static_shape_slices_are_clean(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "def stage(plane, mbh):\n"
            "    rows = mbh * 16\n"
            "    return plane[:rows, : plane.shape[1] // 2]\n") + TORCH})
        assert jitcheck.run(tree, _jit_manifest()) == []

    @pytest.mark.parametrize("call,name", [
        ("staged.to('cuda')", "to"), ("staged.to(self.dev)", "to"),
        ("staged.cuda()", "cuda"), ("staged.item()", "item"),
        ("staged.cpu()", "cpu"), ("staged.tolist()", "tolist"),
        ("staged.numpy()", "numpy"),
        ("torch.cuda.synchronize()", "synchronize")])
    def test_hot_loop_blocking_transfer(self, tmp_path, call, name):
        # the reference's `return jax.device_put(staged)` at line 4
        tree = make_pkg(tmp_path, {"dev.py": (
            "import torch\n"
            "class E:\n"
            "    def dispatch_wave(self, staged):\n"
            f"        return {call}\n"
            "    def stage_waves(self, frames):\n"
            "        return frames.to('cuda')\n")})
        found = jitcheck.run(tree, _jit_manifest(
            ("fixpkg.dev:E.dispatch_wave",)))
        assert [(f.code, f.line) for f in found] == [("TVT-X002", 4)]
        assert f"`{name}`" in found[0].message
        assert "dispatch_wave" in found[0].message

    def test_async_copies_are_legal_in_hot_loops(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "import torch\n"
            "class E:\n"
            "    def dispatch_wave(self, out, dev, stream):\n"
            "        ev = torch.cuda.Event()\n"
            "        for arr in out:\n"
            "            arr.to('cpu', non_blocking=True)\n"
            "            arr.to(dev, torch.int16, non_blocking=True)\n"
            "            arr.record_stream(stream)\n"
            "            arr.to(torch.int16)\n"
            "            arr.to(dtype=torch.int32)\n"
            "        ev.record()\n"
            "        return out, ev\n")})
        assert jitcheck.run(tree, _jit_manifest(
            ("fixpkg.dev:E.dispatch_wave",))) == []

    def test_plain_variable_named_item_is_not_a_transfer(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "class E:\n"
            "    def dispatch_wave(self, staged):\n"
            "        out = []\n"
            "        for item in staged:\n"
            "            out.append(item)\n"
            "        return out\n")})
        assert jitcheck.run(tree, _jit_manifest(
            ("fixpkg.dev:E.dispatch_wave",))) == []

    def test_module_function_hot_loop(self, tmp_path):
        # `_sfe_p_step` is a module function: qualified_functions names it
        tree = make_pkg(tmp_path, {"dev.py": (
            "def _p_step(x):\n"
            "    return x.item()\n")})
        found = jitcheck.run(tree, _jit_manifest(("fixpkg.dev:_p_step",)))
        assert [(f.code, f.line) for f in found] == [("TVT-X002", 2)]

    def test_same_named_methods_get_distinct_finding_keys(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": (
            "class A:\n"
            "    def fetch(self, payload, used):\n"
            "        return payload[:, :used.max()]\n"
            "class B:\n"
            "    def fetch(self, payload, used):\n"
            "        return payload[:, :used.max()]\n") + TORCH})
        found = jitcheck.run(tree, _jit_manifest())
        assert codes(found) == ["TVT-X001", "TVT-X001"]
        assert len({f.key for f in found}) == 2

    def test_rotted_hot_loop_declaration_is_flagged(self, tmp_path):
        tree = make_pkg(tmp_path, {"dev.py": "x = 1\n"})
        found = jitcheck.run(tree, _jit_manifest(("fixpkg.dev:E.gone",)))
        assert codes(found) == ["TVT-X002"]
        assert "not found" in found[0].message


# ---------------------------------------------------------------------------
# the port's own rule: no module reaches jax or the JAX package
# ---------------------------------------------------------------------------


class TestReferenceConfinement:
    def test_reference_import_anywhere_is_a_finding(self, tmp_path):
        tree = make_pkg(tmp_path, {
            "a.py": "import numpy\nimport jax.numpy as jnp\n",
            "b.py": "from thinvids_tpu.core import types\n",
            "c.py": "def f():\n    import jax\n",
            "d.py": "from . import a\n"})
        found = imports.run(tree, Manifest(package="fixpkg",
                                           device_free=()))
        assert sorted((f.code, f.key, f.line) for f in found) == [
            ("TVT-J003", "TVT-J003:fixpkg.a:jax", 2),
            ("TVT-J003", "TVT-J003:fixpkg.b:thinvids_tpu", 1)]

    def test_the_port_reaches_no_reference_root(self):
        tree = SourceTree(PKG_DIR)
        assert imports.check_reference_confinement(
            tree, default_manifest()) == []

    def test_torch_leak_into_a_device_free_module(self, tmp_path):
        tree = make_pkg(tmp_path, {
            "io/__init__.py": "from .y4m import read\n",
            "io/y4m.py": "from ..codecs import core\n"
                         "def read():\n    pass\n",
            "codecs/__init__.py": "",
            "codecs/core.py": "import torch\n"})
        found = imports.run(tree, Manifest(package="fixpkg",
                                           device_free=("fixpkg.io",)))
        assert codes(found) == ["TVT-J001", "TVT-J001"]
        assert all("torch" in f.message for f in found)


# ---------------------------------------------------------------------------
# the clean-tree gates over the port
# ---------------------------------------------------------------------------


class TestPortTree:
    def test_run_all_clean(self):
        manifest = default_manifest()
        tree = SourceTree(PKG_DIR)
        open_, waived, stale = apply_waivers(run_all(tree, manifest),
                                             manifest)
        assert not open_, "\n".join(f.format() for f in open_)
        assert not stale, f"stale waivers: {stale}"
        assert len(manifest.waivers) <= 5
        assert len(tree.modules()) >= 81
        # every waiver matched a finding, each with its reason
        assert {f.key for f in waived} == set(manifest.waivers)

    def test_check_runs_without_torch_or_jax(self):
        code = ("import sys\n"
                "sys.modules['torch'] = sys.modules['jax'] = None\n"
                "from thinvids_tpu_torch.tools.check import run_check\n"
                "rc = run_check(quiet=True)\n"
                "assert rc == 0, 'check found open findings'\n"
                "loaded = [m for m in sys.modules if sys.modules[m] is not "
                "None and m.split('.')[0] in ('torch', 'jax', 'triton')]\n"
                "assert not loaded, loaded\n")
        subprocess.run([sys.executable, "-c", code], check=True, env=ENV,
                       timeout=120)

    def test_cli_check_prints_the_module_count(self):
        res = subprocess.run(
            [sys.executable, "-m", "thinvids_tpu_torch.cli", "check"],
            env=ENV, capture_output=True, text=True, timeout=120, cwd=REPO)
        assert res.returncode == 0, res.stdout + res.stderr
        m = re.search(r"check clean: (\d+) modules", res.stdout)
        assert m and int(m.group(1)) >= 81, res.stdout

    def test_json_and_sarif_paths_are_under_the_port(self, capsys):
        from thinvids_tpu_torch.tools.check import run_check

        assert run_check(json_out=True) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["waived"] and doc["open"] == []
        for rec in doc["waived"]:
            assert rec["path"].startswith("thinvids_tpu_torch" + os.sep)
        assert run_check(sarif_out=True) == 0
        sarif = json.loads(capsys.readouterr().out)
        for res in sarif["runs"][0]["results"]:
            uri = res["locations"][0]["physicalLocation"][
                "artifactLocation"]["uri"]
            assert uri.startswith("thinvids_tpu_torch/"), uri

    def test_device_free_modules_import_without_torch(self):
        manifest = default_manifest()
        mods = [m for m in SourceTree(PKG_DIR).modules()
                if matches_any(m, manifest.device_free)]
        assert len(mods) >= 10
        code = ("import sys\n"
                "for name in ('torch', 'triton', 'jax', 'jax.numpy'):\n"
                "    sys.modules[name] = None\n"
                + "\n".join(f"import {m}" for m in mods)
                + "\nprint('ok')\n")
        out = subprocess.run([sys.executable, "-c", code], env=ENV,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "ok" in out.stdout, out.stderr

    def test_analyzer_is_self_hosting(self):
        manifest = default_manifest()
        assert matches_any("thinvids_tpu_torch.analysis.syncs",
                           manifest.device_free)
        assert matches_any("thinvids_tpu_torch.tools.check",
                           manifest.device_free)
        tree = SourceTree(PKG_DIR)
        assert "thinvids_tpu_torch.analysis.syncs" in tree.modules()
        assert manifest.device_roots == ("torch", "triton")

    def test_every_declared_hot_loop_resolves(self):
        """The hot loops are declared at the port's names (the module
        function `_sfe_p_step` for the reference's
        SfeShardEncoder._p_step), and none is missing."""
        tree = SourceTree(PKG_DIR)
        found = jitcheck.check_hot_loops(tree, default_manifest())
        assert found == [], [f.format() for f in found]
        assert "thinvids_tpu_torch.parallel.dispatch:_sfe_p_step" in \
            default_manifest().hot_loops

    def test_p_step_chroma_dc_holds_no_scalar_store(self, tmp_path):
        """The fault the runtime audit found (ROADMAP C3): the P step's
        chroma DC placement stored a Python 1 into a one-element view of
        a card tensor, a synchronous host→device copy per chroma plane
        per P frame. The old body is an S002 finding; the port's
        torchinter is clean."""
        old = ("import torch\n"
               "def _dc_pos_expand(dcr_grid, h, wd_):\n"
               "    m4 = torch.zeros((4, 4), dtype=dcr_grid.dtype,\n"
               "                     device=dcr_grid.device)\n"
               "    m4[0, 0] = 1\n"
               "    out = dcr_grid[:, None, :, None] * m4[None, :, None, :]\n"
               "    return out.reshape(h, wd_)\n")
        tree = make_pkg(tmp_path, {"inter.py": old})
        got = syncs.run(tree, Manifest(package="fixpkg", sync_allowlist=()))
        assert [(f.code, f.line) for f in got] == [("TVT-S002", 5)]
        port = syncs.run(SourceTree(PKG_DIR), dataclasses.replace(
            default_manifest(), sync_allowlist=()))
        assert [f for f in port if f.module.endswith(".torchinter")] == []
