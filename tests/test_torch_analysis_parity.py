"""The port's analyzer side by side with the reference's: the same
fixture sources through both, one case per generic pass (imports,
threads, configcheck, the statemachine write-site audit), with equal
(code, line, key) findings; and the TVT-M002 board model explored by
both, with the same counterexamples (invariant and interleaving) for
every seeded mutation and the same exercised edges. The fixtures are
the reference's own (tests/test_analysis.py) and variants of them; the
port's Manifest gets the harness pins of tests/test_torch_analysis.py.
"""

import pytest

from thinvids_tpu.analysis import configcheck as rconfigcheck
from thinvids_tpu.analysis import imports as rimports
from thinvids_tpu.analysis import statemachine as rstatemachine
from thinvids_tpu.analysis import threads as rthreads
from thinvids_tpu.analysis import Manifest as RefManifest
from thinvids_tpu.analysis import SourceTree as RefSourceTree
from thinvids_tpu.analysis import default_manifest as ref_default_manifest
from thinvids_tpu.analysis.manifest import StateMachine as RefStateMachine
from thinvids_tpu_torch.analysis import (configcheck, default_manifest,
                                         imports, statemachine, threads)
from thinvids_tpu_torch.analysis.manifest import StateMachine
from test_torch_analysis import RENAMED, _CASES, make_pkg, port_manifest


# ---------------------------------------------------------------------------
# side by side: the generic passes give the reference's findings
# ---------------------------------------------------------------------------

_RACY = _CASES._RACY
_LOCKED = _CASES._LOCKED
_ST = _CASES._ST
_LOCK_CYCLE = (
    "import threading\n"
    "class Board:\n"
    "    def __init__(self, mgr: 'Manager'):\n"
    "        self._lock = threading.Lock()\n"
    "        self.mgr = mgr\n"
    "    def poke(self):\n"
    "        with self._lock:\n"
    "            self.mgr.note()\n"
    "    def count(self):\n"
    "        with self._lock:\n"
    "            return 1\n"
    "class Manager:\n"
    "    def __init__(self):\n"
    "        self._mgr_lock = threading.Lock()\n"
    "        self.board = Board(self)\n"
    "    def note(self):\n"
    "        with self._mgr_lock:\n"
    "            pass\n"
    "    def drain(self):\n"
    "        with self._mgr_lock:\n"
    "            self.board.count()\n")
_TWO_LOCKS = (
    "import threading, time, subprocess\n"
    "class S:\n"
    "    def __init__(self):\n"
    "        self._a_lock = threading.Lock()\n"
    "        self._b_lock = threading.Lock()\n"
    "        self.n = 0\n"
    "        self._thread = None\n"
    "    def start(self):\n"
    "        self._thread = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        with self._a_lock:\n"
    "            self.n += 1\n"
    "            time.sleep(1)\n"
    "    def bump(self, cmd):\n"
    "        with self._b_lock:\n"
    "            self.n += 1\n"
    "            with self._a_lock, subprocess.Popen(cmd) as p:\n"
    "                p.wait()\n"
    "    def back(self):\n"
    "        with self._a_lock:\n"
    "            with self._b_lock:\n"
    "                pass\n")
_STORE = (
    "import threading\n"
    "class Store:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._jobs = {}\n"
    "    def put(self, k, v):\n"
    "        with self._lock:\n"
    "            self._jobs[k] = v\n"
    "    def peek(self):\n"
    "        return len(self._jobs)\n"
    "    def swap(self, other):\n"
    "        old = self._jobs\n"
    "        self._jobs = other\n"
    "        return old\n"
    "    def _find_locked(self, k):\n"
    "        return self._jobs.get(k)\n")
_FIX_MACHINE = dict(
    name="fix", enum="St", attr="state", scope=("fixpkg",),
    states=("A", "B", "C"), initial=("A",),
    transitions=(("A", "B"), ("B", "C")), predicates={"is_open": ("A", "B")})

#: (pass, fixture files, the reference Manifest's keywords, defaults)
SIDE_BY_SIDE = {
    "imports-leak": ("imports", {
        "a.py": "from . import b\n", "b.py": "import jax\n",
        "sub/__init__.py": "import jax\n", "sub/mod.py": "x = 1\n",
        "lazy.py": "def f():\n    import jax\n    return jax\n",
        "tc.py": "from typing import TYPE_CHECKING\n"
                 "if TYPE_CHECKING:\n    import jax\n"},
        {"jax_free": ("fixpkg.a", "fixpkg.sub.mod", "fixpkg.lazy",
                      "fixpkg.tc")}, None),
    "imports-cycle": ("imports", {
        "sub/__init__.py": "from . import helper\nfrom .. import xmod\n"
                           "from .. import jmod\n",
        "sub/helper.py": "x = 1\n", "sub/mod.py": "from .. import xmod\n",
        "xmod.py": "from .sub import helper\n", "jmod.py": "import jax\n"},
        {"jax_free": ("fixpkg.sub.mod",)}, None),
    "imports-forbidden": ("imports", {
        "exec.py": "from .decode import read_video\n"
                   "def go(p):\n    return read_video(p)\n",
        "decode.py": "def read_video(p):\n    return []\n"},
        {"jax_free": (), "forbidden_symbols": {
            "fixpkg.exec": (("read_video", "stream it"),)}}, None),
    "threads-racy": ("threads", {"c.py": _RACY, "d.py": _LOCKED}, {}, None),
    "threads-locks": ("threads", {"s.py": _TWO_LOCKS, "x.py": _LOCK_CYCLE},
                      {}, None),
    "threads-guarded": ("threads", {"store.py": _STORE},
                        {"guarded_by": {"fixpkg.store:Store._jobs": "_lock"}},
                        None),
    "threads-handler": ("threads", {
        "h.py": "from http.server import BaseHTTPRequestHandler\n"
                "class H(BaseHTTPRequestHandler):\n"
                "    def do_GET(self):\n        self.count = 1\n",
        "f.py": "class Fan:\n    def __init__(self, pool):\n"
                "        self.pool = pool\n        self.done = 0\n"
                "    def go(self):\n        for _ in range(8):\n"
                "            self.pool.submit(self.work)\n"
                "    def work(self):\n        self.done += 1\n"}, {}, None),
    "config": ("configcheck", {
        "app.py": "import os\nfrom .config import DEFAULT_SETTINGS\n"
                  "def f(snap, settings):\n"
                  "    a = os.environ.get('TVT_BOGUS_KNOB')\n"
                  "    b = os.environ.get('MY_KNOB')\n"
                  "    c = os.environ.get('TVT_USED_KEY')\n"
                  "    d = os.environ['HOME']\n"
                  "    x = DEFAULT_SETTINGS['used_key']\n"
                  "    return a, b, c, d, x, snap.used_key, "
                  "settings.values['k']\n",
        "config.py": "DEFAULT_SETTINGS = {}\n"},
        {}, {"used_key": 1, "dead_key": 2}),
    "statemachine-audit": ("statemachine", {"m.py": _ST + (
        "def f(o):\n    o.state = St.C\n"
        "def g(o):\n    if o.state is not St.A:\n        return\n"
        "    o.state = St.B\n"
        "def h(o):\n    if not o.state.is_open:\n        return\n"
        "    o.state = St.C\n"
        "def i(o):\n    setattr(o, 'state', St.B)\n"
        "def j(store, oid):\n"
        "    store.update(oid, lambda o: setattr(o, 'state', St.B))\n"
        "def k(objs):\n    for o in objs:\n"
        "        if o.state is not St.B:\n            continue\n"
        "        o.state = St.C\n"
        "def l(o, field):\n    setattr(o, field, St.C)\n"
        "class Obj:\n    state: str = St.B\n"
        "class Obj2:\n    state = St.C\n")},
        {"state_machines": "FIX"}, None),
}


def _run_pass(side: str, name: str, tree, manifest, defaults):
    mods = {"ref": {"imports": rimports, "threads": rthreads,
                    "configcheck": rconfigcheck,
                    "statemachine": rstatemachine},
            "port": {"imports": imports, "threads": threads,
                     "configcheck": configcheck,
                     "statemachine": statemachine}}[side]
    if name == "configcheck":
        return mods[name].run(tree, manifest, defaults=defaults)
    if name == "statemachine":
        return mods[name].audit_transitions(tree, manifest)
    return mods[name].run(tree, manifest)


@pytest.mark.parametrize("case", sorted(SIDE_BY_SIDE))
def test_generic_pass_matches_the_reference(case, tmp_path):
    name, files, kw, defaults = SIDE_BY_SIDE[case]
    rkw, pkw = dict(kw), {RENAMED.get(k, k): v for k, v in kw.items()}
    if kw.get("state_machines") == "FIX":
        rkw["state_machines"] = (RefStateMachine(**_FIX_MACHINE),)
        pkw["state_machines"] = (StateMachine(**_FIX_MACHINE),)
    ref_tree = make_pkg(tmp_path / "ref", files, tree_cls=RefSourceTree)
    port_tree = make_pkg(tmp_path / "port", files)
    want = _run_pass("ref", name, ref_tree,
                     RefManifest(package="fixpkg", **rkw), defaults)
    got = _run_pass("port", name, port_tree,
                    port_manifest(package="fixpkg", **pkw), defaults)
    assert want, f"{case}: the fixture seeds no finding"
    assert sorted((f.code, f.line, f.key) for f in got) == \
        sorted((f.code, f.line, f.key) for f in want)


@pytest.mark.parametrize("mutation", [None] + list(rstatemachine.MUTATIONS))
def test_board_model_matches_the_reference(mutation):
    """TVT-M002: the same counterexamples (invariant and interleaving)
    and the same exercised edges on both explorers."""
    muts = () if mutation is None else (mutation,)
    rv, redges = rstatemachine.check_model(ref_default_manifest(),
                                           mutations=muts)
    pv, pedges = statemachine.check_model(default_manifest(),
                                          mutations=muts)
    assert [(v.invariant, v.trace) for v in pv] == \
        [(v.invariant, v.trace) for v in rv]
    assert pedges == redges
    assert [t.transitions for t in default_manifest().state_machines] == \
        [t.transitions for t in ref_default_manifest().state_machines]
