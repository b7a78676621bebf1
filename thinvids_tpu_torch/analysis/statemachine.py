"""Pass 5 — protocol verification for the control-plane state machines.

Two halves, both driven by the manifest's declared transition tables
(manifest.StateMachine):

TVT-M001  **write-site audit.** Every ``x.state = ShardState.X`` /
          ``j.status = Status.Y`` assignment (and the ``setattr``
          form) in the machines' declared scope must carry a LOCAL
          guard proving which source states can reach it — the pass
          narrows the possible source set from the dominating tests
          (``is/is not/in/not in`` against enum members, declared
          predicate properties like ``.is_open``) and checks every
          implied source→target edge against the declared table. An
          unguarded write implies edges from EVERY state; if any of
          them is undeclared, the site must either grow a guard
          (re-asserting under the lock is free) or the table must
          grow the edge — both are reviewable protocol changes.

TVT-M002  **bounded model checking.** A faithful, pure model of the
          ShardBoard API (claim / submit_part / report_failure /
          requeue_expired / preempt_batch / cancel_job / take_shards,
          plus worker crashes, a virtual integer clock, the QoS batch
          gate, and a token-fenced restart) is explored exhaustively —
          2 workers × 3 shards, breadth-first to a depth bound, states
          memoized — asserting the safety invariants on every
          transition:

          - ``single-assignment``: a claim only leases PENDING shards
            (no shard ASSIGNED to two hosts);
          - ``undeclared-transition``: every exercised shard edge is
            in the declared table (and, after the run, every declared
            edge was exercised — a stale table fails either way);
          - ``attempt-accounting``: Σ attempts == failure events, so
            QoS preemption burns no attempt;
          - ``done-absorbs``: a DONE shard never changes state or
            finisher (first result wins);
          - ``cross-run-part``: a part encoded under a superseded
            run's descriptor is never accepted into the new run;
          - ``token-fence``: stale-token cancel/collect are no-ops;
          - ``collect-all-done``: a successful collect implies every
            shard was DONE;
          - ``qos-gate``: no batch claim while the gate is closed;
          - ``open-shard-unreachable``: no reachable terminal state
            strands an open (PENDING/ASSIGNED) shard;
          - ``resume-reuse``: a shard whose VERIFIED part sits on the
            durable spool is never re-leased — crash-resume must
            rehydrate it DONE (cluster/partstore.py);
          - ``part-integrity``: no shard reaches DONE on a
            digest-mismatched part, and no collect stitches one —
            the two gates that keep corrupt bytes out of the output.

          Violations carry the violated invariant and the exact
          action interleaving (BFS ⇒ a shortest counterexample,
          deterministic ordering, virtual time only). `mutations`
          seed known protocol breaks so tests can prove the explorer
          catches each one.

The model is the spec the implementation is audited against: M001
pins the write sites to the table, M002 pins the table to the
protocol's safety properties.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from .astutil import (Finding, SourceTree, dotted_name, finding,
                      matches_any, qualified_functions)
from .manifest import Manifest, StateMachine

# ---------------------------------------------------------------------------
# TVT-M001: AST write-site audit
# ---------------------------------------------------------------------------


class _GuardWalker:
    """Walks one function body tracking the set of machine states the
    audited object can be in, narrowed by dominating tests; records
    the (sources, target) of every enum write site. Receiver identity
    is deliberately ignored (every ``*.state`` test narrows the same
    set): the control-plane functions each handle ONE protocol object,
    and merging keeps the analysis local and predictable."""

    def __init__(self, machine: StateMachine) -> None:
        self.m = machine
        self.all = frozenset(machine.states)
        #: (target state, sources frozenset, line)
        self.writes: list[tuple[str, frozenset, int]] = []

    # -- enum / attr recognition --------------------------------------

    def _member(self, node: ast.AST) -> str | None:
        """``ShardState.DONE`` → "DONE" when the enum matches."""
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == self.m.enum and node.attr in self.all:
            return node.attr
        return None

    def _is_state_chain(self, node: ast.AST) -> bool:
        """Does the chain end in ``.<attr>`` (``shard.state``)?"""
        return isinstance(node, ast.Attribute) and node.attr == self.m.attr

    # -- constraint evaluation ----------------------------------------

    def _satisfy(self, test: ast.AST) -> frozenset:
        """States for which `test` can be true (all = unrelated)."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._negate(test.operand)
        if isinstance(test, ast.BoolOp):
            parts = [self._satisfy(v) for v in test.values]
            if isinstance(test.op, ast.And):
                out = self.all
                for p in parts:
                    out &= p
                return out
            out = frozenset()
            for p in parts:
                if p == self.all:
                    return self.all      # one unrelated arm: no bound
                out |= p
            return out
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            return self._compare(test)
        if isinstance(test, ast.Attribute):
            # predicate property: `shard.state.is_open`
            pred = self.m.predicates.get(test.attr)
            if pred is not None and self._is_state_chain(test.value):
                return frozenset(pred)
        return self.all

    def _negate(self, test: ast.AST) -> frozenset:
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._satisfy(test.operand)
        if isinstance(test, ast.BoolOp):
            parts = [self._negate(v) for v in test.values]
            if isinstance(test.op, ast.Or):
                out = self.all           # ¬(a∨b) = ¬a ∧ ¬b
                for p in parts:
                    out &= p
                return out
            return self.all              # ¬(a∧b): no sound bound
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            members, _pos = self._compare_members(test)
            if members == self.all:
                return self.all          # unrelated: no sound bound
            return self.all - self._compare(test)
        if isinstance(test, ast.Attribute):
            pred = self.m.predicates.get(test.attr)
            if pred is not None and self._is_state_chain(test.value):
                return self.all - frozenset(pred)
        return self.all

    def _compare_members(self, test: ast.Compare
                         ) -> tuple[frozenset, bool]:
        """(member set named by the comparator, is-positive-op). The
        left side must be a ``.state`` chain, else ("all", ...)."""
        left, op, right = test.left, test.ops[0], test.comparators[0]
        if not self._is_state_chain(left):
            return self.all, True
        members: set[str] = set()
        if isinstance(op, (ast.In, ast.NotIn)) and \
                isinstance(right, (ast.Tuple, ast.List, ast.Set)):
            for el in right.elts:
                mname = self._member(el)
                if mname is None:
                    return self.all, True
                members.add(mname)
        else:
            mname = self._member(right)
            if mname is None:
                return self.all, True
            members.add(mname)
        positive = isinstance(op, (ast.Is, ast.Eq, ast.In))
        return frozenset(members), positive

    def _compare(self, test: ast.Compare) -> frozenset:
        members, positive = self._compare_members(test)
        if members == self.all:
            return self.all
        return members if positive else self.all - members

    # -- statement walk -----------------------------------------------

    def _write_target(self, stmt: ast.stmt) -> tuple[str, int] | None:
        """(target state, line) when `stmt` writes an enum member to
        the audited attribute — plain assignment or setattr form."""
        if isinstance(stmt, ast.Assign):
            mname = self._member(stmt.value)
            if mname is not None and any(
                    self._is_state_chain(t) for t in stmt.targets):
                return mname, stmt.lineno
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            mname = self._member(stmt.value)
            if mname is not None and self._is_state_chain(stmt.target):
                return mname, stmt.lineno
        if isinstance(stmt, ast.Expr):
            # walk the expression but NOT into nested lambdas/defs —
            # those are audited as their own bodies
            stack: list[ast.AST] = [stmt.value]
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name) and \
                        node.func.id == "setattr" and \
                        len(node.args) == 3:
                    mname = self._member(node.args[2])
                    attr_arg = node.args[1]
                    # a machine-enum VALUE with a non-literal attribute
                    # name is unauditable statically — treat it as a
                    # write of this machine's attr (conservative: the
                    # site must then satisfy the declared table or be
                    # rewritten with a literal attribute)
                    hits_attr = (isinstance(attr_arg, ast.Constant)
                                 and attr_arg.value == self.m.attr) or \
                        not isinstance(attr_arg, ast.Constant)
                    if mname is not None and hits_attr:
                        return mname, node.lineno
                stack.extend(ast.iter_child_nodes(node))
        return None

    def walk(self, stmts: Iterable[ast.stmt],
             src: frozenset) -> frozenset | None:
        """Process a statement list; returns the fall-through source
        set, or None when every path exits (return/raise/...)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.Return, ast.Raise, ast.Continue,
                                 ast.Break)):
                return None
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                 # audited separately
            wt = self._write_target(stmt)
            if wt is not None:
                target, line = wt
                if src:
                    self.writes.append((target, src, line))
                src = frozenset((target,))
                continue
            if isinstance(stmt, ast.If):
                body_exit = self.walk(stmt.body,
                                      src & self._satisfy(stmt.test))
                neg = src & self._negate(stmt.test)
                else_exit = self.walk(stmt.orelse, neg) \
                    if stmt.orelse else neg
                if body_exit is None and else_exit is None:
                    return None
                src = (body_exit or frozenset()) | \
                    (else_exit or frozenset())
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self.walk(stmt.body, self.all)   # conservative entry
                self.walk(stmt.orelse, self.all)
                src = self.all                   # and conservative exit
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                exit_ = self.walk(stmt.body, src)
                if exit_ is None:
                    return None
                src = exit_
            elif isinstance(stmt, ast.Try):
                self.walk(stmt.body, src)
                for h in stmt.handlers:
                    self.walk(h.body, self.all)
                self.walk(stmt.orelse, self.all)
                self.walk(stmt.finalbody, self.all)
                src = self.all
        return src


def _function_bodies(tree: ast.Module):
    """(qualname, body statements) for every function-like scope —
    nested defs, closures handed to JobStore.update, and lambdas all
    audited as independent bodies (astutil.qualified_functions)."""
    for qual, node in qualified_functions(tree):
        if isinstance(node, ast.Lambda):
            yield qual, [ast.Expr(value=node.body)]
        else:
            yield qual, node.body


def audit_transitions(tree: SourceTree, manifest: Manifest
                      ) -> list[Finding]:
    findings: list[Finding] = []
    for machine in manifest.state_machines:
        if not machine.attr:
            continue
        declared = set(machine.transitions)
        for mod in tree.modules():
            if not matches_any(mod, machine.scope):
                continue
            mtree = tree.tree(mod)
            # class-body defaults must be declared initial states —
            # both the dataclass AnnAssign form and a plain Assign
            for node in ast.walk(mtree):
                if isinstance(node, ast.ClassDef):
                    for stmt in node.body:
                        mname = None
                        if isinstance(stmt, ast.AnnAssign) and \
                                isinstance(stmt.target, ast.Name) and \
                                stmt.target.id == machine.attr and \
                                stmt.value is not None:
                            mname = _member_of(stmt.value, machine)
                        elif isinstance(stmt, ast.Assign) and any(
                                isinstance(t, ast.Name)
                                and t.id == machine.attr
                                for t in stmt.targets):
                            mname = _member_of(stmt.value, machine)
                        if mname is not None and \
                                mname not in machine.initial:
                            findings.append(finding(
                                "TVT-M001", mod, stmt.lineno,
                                f"{node.name}.{machine.attr} defaults to "
                                f"{mname}, not a declared initial state "
                                f"of the {machine.name} machine",
                                key_detail=f"{machine.name}:{mod}:"
                                           f"{node.name}:init"))
            for qual, body in _function_bodies(mtree):
                walker = _GuardWalker(machine)
                walker.walk(body, walker.all)
                for target, sources, line in walker.writes:
                    bad = sorted(s for s in sources
                                 if (s, target) not in declared)
                    if not bad:
                        continue
                    findings.append(finding(
                        "TVT-M001", mod, line,
                        f"{qual}() writes {machine.enum}.{target} "
                        f"reachable from {{{', '.join(bad)}}} — "
                        f"undeclared {machine.name} transition(s); "
                        f"guard the write or declare the edge in "
                        f"analysis/manifest.py",
                        key_detail=f"{machine.name}:{mod}:{qual}->"
                                   f"{target}"))
    return findings


def _member_of(node: ast.AST, machine: StateMachine) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id == machine.enum and node.attr in machine.states:
        return node.attr
    # dataclasses.field(default=Enum.X)
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        if name.split(".")[-1] == "field":
            for kw in node.keywords:
                if kw.arg == "default":
                    return _member_of(kw.value, machine)
    return None


# ---------------------------------------------------------------------------
# TVT-M002: bounded model checking of the board protocol
# ---------------------------------------------------------------------------

PENDING, ASSIGNED, DONE, FAILED = "PENDING", "ASSIGNED", "DONE", "FAILED"
_OPEN = (PENDING, ASSIGNED)

# worker lifecycle states (the fourth declared machine — the elastic
# farm's ACTIVE → DRAINING → SUSPENDED → WAKING loop, farm/)
ACTIVE, DRAINING, SUSPENDED, WAKING = \
    "ACTIVE", "DRAINING", "SUSPENDED", "WAKING"

#: every seedable protocol break the model understands; tests assert
#: the explorer produces a counterexample for each one
MUTATIONS = (
    "double_assign",         # claim ignores the PENDING check
    "preempt_burns_attempt",  # QoS preemption counts as a failure
    "accept_after_done",     # submit_part overwrites a DONE shard
    "no_token_fence",        # stale-token cancel drops the new run
    "collect_partial",       # take_shards skips the all-DONE check
    "shared_ids",            # shard ids not run-scoped across restarts
    "no_expiry",             # requeue_expired never fires
    "gate_ignored",          # claims ignore the closed QoS batch gate
    "claim_while_draining",  # claims ignore the worker lifecycle gate
    "suspend_with_lease",    # suspend fires while the worker holds a
                             # lease (drain strands it)
    # -- durable checkpoint / crash-resume (cluster/partstore.py) ----
    "resume_leases_done",    # crash-resume drops verified spooled
                             # parts back to PENDING (re-encodes work
                             # the spool already holds)
    "resume_burns_attempt",  # resume's requeue of unverifiable shards
                             # counts as a shard failure
    "ingest_no_verify",      # /work ingest accepts a digest-mismatched
                             # part as DONE
    "band_restart_keeps_spool",  # a band-group restart requeues a
                             # DONE shard WITHOUT retracting its
                             # spooled part (the next claim re-leases
                             # work the spool already holds)
    "stitch_no_verify",      # collect stitches a spooled part whose
                             # digest no longer verifies
)

#: per-shard durable-spool states (the ckpt component of the model
#: state): nothing spooled / a verified part on disk / a part whose
#: bytes rotted after it was accepted
CK_NONE, CK_GOOD, CK_CORRUPT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    workers: int = 2
    shards: int = 3
    max_attempts: int = 1
    timeout: int = 2        # lease length, virtual ticks
    backoff: int = 1        # requeue backoff base, virtual ticks
    t_max: int = 4          # virtual clock bound
    max_states: int = 400_000   # hard explosion backstop
    # (interleaving depth is per-Scenario — see Scenario.depth)


@dataclasses.dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str
    trace: tuple[str, ...]   # action interleaving from the initial state

    def format(self) -> str:
        steps = " ; ".join(self.trace) or "(initial state)"
        return (f"invariant `{self.invariant}` violated: {self.detail}\n"
                f"    interleaving: {steps}")


# State layout (all tuples — hashable, structurally comparable):
#   (t, run, entry_run|None, shards, workers, gate_open, fails,
#    collected, lifecycles, ckpt)
# shard: (state, attempt, host|"", deadline, not_before, finisher|"",
#         seq)
# worker: None (idle) | (shard_idx, descriptor_run, lease_seq)
# lifecycle: ACTIVE | DRAINING | SUSPENDED | WAKING per worker (the
#            farm machine; scenarios without lifecycle actions leave
#            every worker ACTIVE, which collapses to the old state
#            space)
# ckpt: per-shard durable-spool state (CK_NONE/CK_GOOD/CK_CORRUPT):
#       the partstore checkpoint that SURVIVES a coordinator crash.
#       In scenarios without crash/corrupt actions it tracks DONE
#       bijectively, adding no states.

_FRESH_SHARD = (PENDING, 0, "", 0, 0, "", 0)
#: shard tuple field order, resolved once (apply() updates fields by
#: name in the explorer's innermost loop)
_FIELD_IDX = {name: i for i, name in enumerate(
    ("state", "attempt", "host", "deadline", "not_before", "finisher",
     "seq"))}


def _initial(cfg: ModelConfig):
    return (0, 1, 1, (_FRESH_SHARD,) * cfg.shards,
            (None,) * cfg.workers, True, 0, False,
            (ACTIVE,) * cfg.workers, (CK_NONE,) * cfg.shards)


class BoardModel:
    """Pure transition function over the state tuples above. Mirrors
    ShardBoard semantics exactly; `mutations` switch in the seeded
    protocol breaks (MUTATIONS) the explorer must catch."""

    def __init__(self, cfg: ModelConfig,
                 mutations: Iterable[str] = ()) -> None:
        self.cfg = cfg
        self.mut = frozenset(mutations)
        unknown = self.mut - set(MUTATIONS)
        if unknown:
            raise ValueError(f"unknown mutations {sorted(unknown)}")

    # -- action enumeration (deterministic order) ----------------------

    def _may_claim(self, lifecycle: str) -> bool:
        """Worker-lifecycle claim gate: only ACTIVE workers claim —
        unless the `claim_while_draining` mutation disables the gate
        (the seeded break the `lifecycle-claim` invariant catches)."""
        return lifecycle == ACTIVE or (
            "claim_while_draining" in self.mut and lifecycle == DRAINING)

    def enabled(self, s, actions: tuple[str, ...]) -> list[tuple]:
        (t, run, entry, shards, workers, gate, fails, collected,
         lifecycles, ckpt) = s
        out: list[tuple] = []
        for act in actions:
            if act == "claim" and entry is not None and \
                    (gate or "gate_ignored" in self.mut):
                if self._claimable(s) is not None:
                    out.extend(("claim", w) for w in range(len(workers))
                               if workers[w] is None
                               and self._may_claim(lifecycles[w]))
            elif act in ("submit", "fail", "die", "submit_bad"):
                out.extend((act, w) for w in range(len(workers))
                           if workers[w] is not None)
            elif act == "corrupt":
                # chaos bit-flip on an already-spooled part
                out.extend(("corrupt", i) for i in range(len(ckpt))
                           if ckpt[i] == CK_GOOD)
            elif act == "crash" and run == 1 and entry is not None:
                # coordinator SIGKILL + restart-with-resume (one per
                # exploration, like restart; workers keep running)
                out.append(("crash",))
            elif act == "tick" and t < self.cfg.t_max:
                out.append(("tick",))
            elif act == "sweep" and "no_expiry" not in self.mut and \
                    entry is not None and any(
                        sh[0] == ASSIGNED and t > sh[3] for sh in shards):
                out.append(("sweep",))
            elif act == "breach" and gate and entry is not None:
                out.append(("breach",))
            elif act == "recover" and not gate:
                out.append(("recover",))
            elif act == "restart" and run == 1 and entry is not None:
                out.append(("restart",))
            elif act == "cancel" and entry is not None:
                out.append(("cancel",))
            elif act == "band_restart" and entry is not None and any(
                    sh[0] == PENDING for sh in shards) and any(
                    sh[0] in (ASSIGNED, DONE) for sh in shards):
                # a band shard fell back to PENDING while its lockstep
                # siblings hold leases / finished parts: the group
                # restarts together (ShardBoard._restart_band_group)
                out.append(("band_restart",))
            elif act in ("cancel_stale", "collect_stale") and run == 2 \
                    and entry is not None:
                out.append((act,))
            elif act == "collect" and entry is not None and (
                    all(sh[0] == DONE for sh in shards)
                    or "collect_partial" in self.mut):
                out.append(("collect",))
            # -- worker lifecycle (the farm machine's drive actions) --
            elif act == "drain":
                out.extend(("drain", w) for w in range(len(workers))
                           if lifecycles[w] == ACTIVE)
            elif act == "undrain":
                out.extend(("undrain", w) for w in range(len(workers))
                           if lifecycles[w] == DRAINING)
            elif act == "suspend":
                # the controller suspends only a DRAINED worker whose
                # lease set is empty; the `suspend_with_lease` mutation
                # drops the emptiness check (the seeded strand)
                out.extend(("suspend", w) for w in range(len(workers))
                           if lifecycles[w] == DRAINING
                           and (workers[w] is None
                                or "suspend_with_lease" in self.mut))
            elif act == "wake":
                out.extend(("wake", w) for w in range(len(workers))
                           if lifecycles[w] == SUSPENDED)
            elif act == "rejoin":
                out.extend(("rejoin", w) for w in range(len(workers))
                           if lifecycles[w] == WAKING)
            elif act == "wake_fail":
                out.extend(("wake_fail", w) for w in range(len(workers))
                           if lifecycles[w] == WAKING)
            elif act == "hb":
                out.extend(("hb", w) for w in range(len(workers))
                           if lifecycles[w] == SUSPENDED)
        return out

    def _claimable(self, s) -> int | None:
        t, _run, _entry, shards, _w, _g, _f, _c, _lc, _ck = s
        for i, sh in enumerate(shards):
            open_enough = sh[0] == PENDING or (
                "double_assign" in self.mut and sh[0] == ASSIGNED)
            if open_enough and t >= sh[4]:
                return i
        return None

    # -- transition ----------------------------------------------------

    def apply(self, s, action: tuple):
        """Returns (post_state, shard_edges, notes) where shard_edges
        is [(idx, pre, post)] for shards of the SAME entry and notes
        carries per-action facts the invariants read (including
        `wedges`, the worker-lifecycle edges this action took)."""
        (t, run, entry, shards, workers, gate, fails, collected,
         lifecycles, ckpt) = s
        cfg = self.cfg
        kind = action[0]
        notes: dict = {}
        edges: list[tuple[int, str, str]] = []
        wedges: list[tuple[int, str, str]] = []

        def upd(i, **ch):
            nonlocal shards
            sh = list(shards[i])
            pre = sh[0]
            for k, v in ch.items():
                sh[_FIELD_IDX[k]] = v
            shards = shards[:i] + (tuple(sh),) + shards[i + 1:]
            if "state" in ch:
                edges.append((i, pre, ch["state"]))

        def spool(i, val):
            nonlocal ckpt
            ckpt = ckpt[:i] + (val,) + ckpt[i + 1:]

        def move(w, to):
            nonlocal lifecycles
            wedges.append((w, lifecycles[w], to))
            lifecycles = lifecycles[:w] + (to,) + lifecycles[w + 1:]

        if kind == "claim":
            w = action[1]
            i = self._claimable(s)
            notes["claim_pre"] = shards[i][0]
            notes["gate_open"] = gate
            notes["claim_lifecycle"] = lifecycles[w]
            notes["claim_ckpt"] = ckpt[i]
            seq = shards[i][6] + 1
            upd(i, state=ASSIGNED, host=f"w{w}",
                deadline=min(t + cfg.timeout, cfg.t_max - 1), seq=seq)
            workers = workers[:w] + ((i, run, seq),) + workers[w + 1:]
        elif kind == "submit":
            w = action[1]
            i, desc_run, _seq = workers[w]
            workers = workers[:w] + (None,) + workers[w + 1:]
            resolvable = entry is not None and (
                desc_run == run or "shared_ids" in self.mut)
            if resolvable and shards[i][0] in _OPEN:
                if desc_run != run:
                    notes["cross_run_accept"] = True
                # the accept spools the (verified) part durably before
                # the shard flips DONE (partstore.commit)
                spool(i, CK_GOOD)
                upd(i, state=DONE, host="", finisher=f"w{w}")
            elif resolvable and shards[i][0] == DONE and \
                    "accept_after_done" in self.mut:
                upd(i, state=DONE, finisher=f"w{w}")
        elif kind == "submit_bad":
            # the worker's upload corrupted in transit: ingest digest
            # verification rejects it and hands the lease straight
            # back (NO attempt burned — a transfer fault). Under the
            # `ingest_no_verify` mutation the corrupt bytes land as a
            # DONE shard with a rotten spool record.
            w = action[1]
            i, desc_run, seq = workers[w]
            workers = workers[:w] + (None,) + workers[w + 1:]
            resolvable = entry is not None and desc_run == run
            if not resolvable:
                pass                  # cross-run bad part: dropped
            elif "ingest_no_verify" in self.mut and \
                    shards[i][0] in _OPEN:
                spool(i, CK_CORRUPT)
                upd(i, state=DONE, host="", finisher=f"w{w}")
            elif shards[i][0] == ASSIGNED and shards[i][6] == seq:
                upd(i, state=PENDING, host="", not_before=t)
        elif kind == "fail":
            w = action[1]
            i, desc_run, seq = workers[w]
            workers = workers[:w] + (None,) + workers[w + 1:]
            resolvable = entry is not None and (
                desc_run == run or "shared_ids" in self.mut)
            if resolvable and shards[i][0] == ASSIGNED and \
                    shards[i][6] == seq:
                shards, fails, e2 = self._burn(shards, i, t, fails)
                edges.extend(e2)
        elif kind == "die":
            w = action[1]
            workers = workers[:w] + (None,) + workers[w + 1:]
        elif kind == "tick":
            t += 1
        elif kind == "sweep":
            for i, sh in enumerate(shards):
                if sh[0] == ASSIGNED and t > sh[3]:
                    shards, fails, e2 = self._burn(shards, i, t, fails)
                    edges.extend(e2)
        elif kind == "breach":
            gate = False
            for i, sh in enumerate(shards):
                if sh[0] == ASSIGNED:
                    att = sh[1] + (1 if "preempt_burns_attempt"
                                   in self.mut else 0)
                    upd(i, state=PENDING, host="", not_before=t,
                        attempt=att)
        elif kind == "recover":
            gate = True
        elif kind == "restart":
            run, entry = 2, 2
            shards = (_FRESH_SHARD,) * cfg.shards
            fails = 0
            edges = []                   # new entry: no edges carried
            # operator restart re-anchors the checkpoint (settings may
            # have changed → signature drift → partstore.begin_job
            # resets); crash-resume is the `crash` action instead
            ckpt = (CK_NONE,) * cfg.shards
        elif kind == "corrupt":
            # chaos: a bit flips on the spool disk AFTER the part was
            # accepted — invisible until the next verification gate
            # (resume rehydration or the pre-stitch check)
            spool(action[1], CK_CORRUPT)
        elif kind == "crash":
            # coordinator SIGKILL + restart: the board's RAM state is
            # gone, the journal + spool survive, the workers keep
            # running with run-1 descriptors. recover_jobs requeues
            # under a fresh token and the executor re-plans FROM the
            # checkpoint: verified spooled parts rehydrate DONE
            # (PENDING→DONE, the declared late-part edge — no attempt
            # counted), unverifiable ones re-encode (no attempt
            # burned: storage fault, not worker fault).
            run, entry = 2, 2
            fails = 0
            edges = []                   # fresh entry: no edges carried
            shards = (_FRESH_SHARD,) * cfg.shards
            for i in range(cfg.shards):
                if ckpt[i] == CK_GOOD:
                    if "resume_leases_done" in self.mut:
                        continue         # verified part ignored: the
                                         # shard re-encodes (the break)
                    upd(i, state=DONE, host="", finisher="resume")
                elif ckpt[i] == CK_CORRUPT:
                    spool(i, CK_NONE)    # retracted + unlinked
                    if "resume_burns_attempt" in self.mut:
                        upd(i, attempt=1)
        elif kind == "band_restart":
            # lockstep band-group restart: ASSIGNED siblings requeue
            # free (preemption semantics — the evicted worker's late
            # part is still a late part), DONE siblings requeue with
            # their spooled part RETRACTED (drop_done) so neither
            # first-result-wins nor resume-reuse is violated — the
            # re-encode deterministically re-submits identical bytes.
            # `band_restart_keeps_spool` skips the retraction: the
            # seeded break the resume-reuse invariant catches at the
            # next claim.
            for i, sh in enumerate(shards):
                if sh[0] == ASSIGNED:
                    upd(i, state=PENDING, host="", not_before=t)
                elif sh[0] == DONE:
                    if "band_restart_keeps_spool" not in self.mut:
                        spool(i, CK_NONE)
                    upd(i, state=PENDING, host="", finisher="",
                        not_before=t)
        elif kind in ("cancel", "cancel_stale"):
            if kind == "cancel" or "no_token_fence" in self.mut:
                entry = None
                shards = ()
                notes["stale_cancelled"] = kind == "cancel_stale"
        elif kind == "collect_stale":
            if "no_token_fence" in self.mut:
                notes["stale_collected"] = True
                notes["open_at_collect"] = [
                    i for i, sh in enumerate(shards) if sh[0] != DONE]
                entry = None
                shards = ()
            # fenced: HaltedError, state untouched
        elif kind == "collect":
            notes["open_at_collect"] = [
                i for i, sh in enumerate(shards) if sh[0] != DONE]
            notes["corrupt_at_collect"] = [
                i for i, sh in enumerate(shards)
                if sh[0] == DONE and ckpt[i] == CK_CORRUPT]
            if notes["corrupt_at_collect"] and \
                    "stitch_no_verify" not in self.mut:
                # the pre-stitch digest gate refuses: the job FAILS
                # with attribution (no output commits) and the
                # CHECKPOINT SURVIVES — a later restart resumes the
                # verified parts and re-encodes the corrupt one.
                # Modeled as the entry closing WITHOUT the collected
                # output, ckpt retained (matching clear_job NOT
                # running on the failure path).
                entry = None
                shards = ()
            else:
                entry = None
                shards = ()
                collected = True
                ckpt = (CK_NONE,) * cfg.shards   # clear_job on DONE
        elif kind == "drain":
            move(action[1], DRAINING)
        elif kind == "undrain":
            move(action[1], ACTIVE)
        elif kind == "suspend":
            w = action[1]
            # suspend powers the host down: a lease still held (only
            # reachable under the `suspend_with_lease` mutation) dies
            # with the process and strands until the sweep — the exact
            # hole the drain-strands-lease invariant names
            notes["suspend_held_lease"] = workers[w] is not None
            workers = workers[:w] + (None,) + workers[w + 1:]
            move(w, SUSPENDED)
        elif kind == "wake":
            move(action[1], WAKING)
        elif kind == "rejoin":
            move(action[1], ACTIVE)
        elif kind == "wake_fail":
            move(action[1], SUSPENDED)
        elif kind == "hb":
            move(action[1], ACTIVE)
        else:  # pragma: no cover - enumeration and apply stay in sync
            raise AssertionError(f"unknown action {action}")
        notes["wedges"] = wedges
        return ((t, run, entry, shards, workers, gate, fails, collected,
                 lifecycles, ckpt), edges, notes)

    def _burn(self, shards, i, t, fails):
        """One failure event against shard i (worker report or lease
        expiry): burn an attempt, requeue with backoff or fail."""
        cfg = self.cfg
        sh = list(shards[i])
        pre = sh[0]
        sh[1] += 1
        fails += 1
        if sh[1] > cfg.max_attempts:
            sh[0], sh[2] = FAILED, ""
        else:
            sh[0], sh[2] = PENDING, ""
            sh[4] = min(t + cfg.backoff * (2 ** (sh[1] - 1)), cfg.t_max)
        shards = shards[:i] + (tuple(sh),) + shards[i + 1:]
        return shards, fails, [(i, pre, sh[0])]


# -- invariants --------------------------------------------------------


def _check_transition(pre, action, post, edges, notes,
                      declared: frozenset,
                      wdeclared: frozenset | None = None
                      ) -> tuple[str, str] | None:
    """(invariant, detail) for the first violated safety property of
    one (pre --action--> post) transition, else None. `wdeclared` is
    the worker-lifecycle machine's table (None = not declared; the
    lifecycle checks then stay dormant)."""
    kind = action[0]
    if kind == "claim" and notes.get("claim_pre") != PENDING:
        return ("single-assignment",
                f"claim leased shard in state {notes['claim_pre']} "
                f"(already assigned to another host)")
    if kind == "claim" and not notes.get("gate_open", True):
        return ("qos-gate",
                "batch shard claimed while the QoS gate was closed")
    if kind == "claim" and notes.get("claim_lifecycle", ACTIVE) != ACTIVE:
        return ("lifecycle-claim",
                f"shard leased to a {notes['claim_lifecycle']} worker "
                f"(only ACTIVE workers may claim)")
    if kind == "claim" and notes.get("claim_ckpt", CK_NONE) == CK_GOOD:
        return ("resume-reuse",
                "shard re-leased although a VERIFIED spooled part "
                "exists for it — crash-resume must rehydrate it DONE, "
                "never re-encode finished work")
    if kind == "suspend" and notes.get("suspend_held_lease"):
        return ("drain-strands-lease",
                "suspend fired while the worker still held an open "
                "lease — drain must wait for (or requeue) the lease "
                "set first")
    if wdeclared is not None:
        for w, a, b in notes.get("wedges", ()):
            if (a, b) not in wdeclared:
                return ("undeclared-transition",
                        f"worker w{w}: {a}→{b} via "
                        f"{_fmt_action(action)} is not in the declared "
                        f"worker-lifecycle table")
    # part-integrity: no shard may reach DONE on a corrupt part, and
    # no collect may succeed while a DONE shard's spool record fails
    # verification — the two gates (ingest digests, pre-stitch
    # re-verify) that keep corrupt bytes out of the output tree
    post_ckpt = post[9]
    for i, _a, b in edges:
        if b == DONE and post_ckpt[i] == CK_CORRUPT:
            return ("part-integrity",
                    f"shard {i} accepted as DONE via "
                    f"{_fmt_action(action)} although its part fails "
                    f"digest verification")
    if kind == "collect" and post[7] and notes.get("corrupt_at_collect"):
        return ("part-integrity",
                f"collect stitched shard(s) "
                f"{notes['corrupt_at_collect']} whose spooled parts "
                f"fail digest verification — corrupt bytes reached "
                f"the output tree")
    # done-absorbs BEFORE the generic edge check: overwriting a DONE
    # shard must be named as the first-result-wins break it is, not as
    # a generic undeclared DONE→DONE edge. band_restart is exempt BY
    # DESIGN: it retracts the spooled part as it requeues (DONE is
    # un-finished, not overwritten — the declared DONE→PENDING edge),
    # and the resume-reuse claim check still catches a restart that
    # forgets the retraction.
    if kind not in ("restart", "crash", "cancel", "collect",
                    "cancel_stale", "collect_stale", "band_restart"):
        pre_shards, post_shards = pre[3], post[3]
        for i, sh in enumerate(pre_shards):
            if sh[0] == DONE and (post_shards[i][0] != DONE
                                  or post_shards[i][5] != sh[5]):
                return ("done-absorbs",
                        f"shard {i} left DONE (or its first-result "
                        f"finisher changed) via {_fmt_action(action)}")
    for i, a, b in edges:
        if (a, b) not in declared:
            return ("undeclared-transition",
                    f"shard {i}: {a}→{b} via {_fmt_action(action)} is "
                    f"not in the declared table")
    if notes.get("cross_run_accept"):
        return ("cross-run-part",
                "part encoded under a superseded run's descriptor was "
                "accepted into the new run's board entry")
    if kind in ("cancel_stale", "collect_stale"):
        if post != pre:
            return ("token-fence",
                    f"stale-token {kind.replace('_stale', '')} mutated "
                    f"the newer run's board entry")
    if kind == "collect" and notes.get("open_at_collect"):
        open_ = notes["open_at_collect"]
        return ("collect-all-done",
                f"collect succeeded with shard(s) {open_} not DONE")
    # attempt-accounting: attempts only move with failure events
    if post[2] is not None and kind != "restart":
        att = sum(sh[1] for sh in post[3])
        if att != post[6]:
            return ("attempt-accounting",
                    f"Σ attempts = {att} but failure events = "
                    f"{post[6]} — {_fmt_action(action)} burned an "
                    f"attempt without a failure")
    return None


def _check_terminal(state) -> tuple[str, str] | None:
    (t, run, entry, shards, workers, gate, fails, collected,
     _lifecycles, _ckpt) = state
    if entry is None:
        return None
    open_ = [i for i, sh in enumerate(shards) if sh[0] in _OPEN]
    if open_:
        return ("open-shard-unreachable",
                f"terminal state strands open shard(s) {open_}: no "
                f"enabled action can ever drive them to DONE/FAILED")
    return None


def _fmt_action(action: tuple) -> str:
    if len(action) == 2:
        return f"{action[0]}(w{action[1]})"
    return action[0]


# -- explorer ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One bounded exploration: which actions interleave, how deep.
    `cfg` (when set) overrides the ModelConfig for this scenario —
    the drain scenario trades shard count for worker-lifecycle
    breadth so the state space stays ~1s."""

    name: str
    actions: tuple[str, ...]
    depth: int
    cfg: ModelConfig | None = None


SCENARIOS: tuple[Scenario, ...] = (
    # lease protocol: claims, results, failures, crashes, expiry
    Scenario("lease", ("claim", "submit", "fail", "die", "tick",
                       "sweep"), depth=12),
    # QoS: the batch gate closing/opening around preemption
    Scenario("qos", ("claim", "submit", "breach", "recover", "tick",
                     "sweep"), depth=10),
    # run fencing: restart, stale cancel/collect, clean collect
    Scenario("fence", ("claim", "submit", "fail", "restart", "cancel",
                       "cancel_stale", "collect_stale", "collect",
                       "tick"), depth=9),
    # elastic farm: the worker lifecycle driven against the lease
    # protocol — drain/undrain/suspend/wake/rejoin interleaved with
    # claims, results and the expiry sweep. Proves no shard is ever
    # leased to a DRAINING/SUSPENDED worker and a drain never strands
    # a lease (suspend only with an empty lease set).
    Scenario("drain", ("claim", "submit", "tick", "sweep", "drain",
                       "undrain", "suspend", "wake", "wake_fail",
                       "rejoin", "hb"), depth=8,
             cfg=ModelConfig(shards=2, t_max=3)),
    # band-group lockstep restart (farm SFE): one band shard's
    # requeue drags its ASSIGNED/DONE siblings back to PENDING with
    # parts retracted — proves the DONE→PENDING edge burns no
    # attempts, never strands first-result-wins, and never re-leases
    # a shard whose verified part is still spooled
    Scenario("band", ("claim", "submit", "fail", "band_restart",
                      "tick", "sweep", "collect"), depth=8,
             cfg=ModelConfig(shards=2, t_max=3)),
    # durable checkpointing: coordinator SIGKILL + resume driven
    # against spool corruption and corrupt in-flight uploads. Proves a
    # verified spooled part is never re-leased (rehydrates DONE), an
    # unverifiable one re-encodes with no attempt burned, a
    # digest-mismatched upload takes only the declared
    # ASSIGNED→PENDING edge, and corrupt bytes can never be collected.
    Scenario("crash", ("claim", "submit", "submit_bad", "corrupt",
                       "crash", "tick", "sweep", "collect"), depth=8,
             cfg=ModelConfig(shards=2, t_max=3)),
)


@dataclasses.dataclass
class ExploreResult:
    scenario: str
    states: int
    violations: list[Violation]
    edges: set  # exercised (src, dst) shard edges
    wedges: set = dataclasses.field(default_factory=set)
    #: exercised (src, dst) worker-lifecycle edges


def explore(scenario: Scenario, declared, cfg: ModelConfig | None = None,
            mutations: Iterable[str] = (),
            stop_at_first: bool = True,
            wdeclared=None) -> ExploreResult:
    """Deterministic BFS over the model under one scenario's action
    set. Checks every transition invariant and flags terminal states
    that strand open shards; BFS order makes the first counterexample
    a shortest one. `wdeclared` is the worker-lifecycle table (None =
    machine not declared; its checks stay dormant)."""
    cfg = cfg if cfg is not None else (scenario.cfg or ModelConfig())
    model = BoardModel(cfg, mutations)
    declared = frozenset(declared)
    wdeclared = frozenset(wdeclared) if wdeclared is not None else None
    init = _initial(cfg)
    parent: dict = {init: None}
    frontier = [init]
    depth = 0
    edges_seen: set = set()
    wedges_seen: set = set()
    violations: list[Violation] = []

    def trace_of(state, action=None) -> tuple[str, ...]:
        steps = [_fmt_action(action)] if action is not None else []
        cur = state
        while parent[cur] is not None:
            prev, act = parent[cur]
            steps.append(_fmt_action(act))
            cur = prev
        return tuple(reversed(steps))

    while frontier and depth < scenario.depth:
        depth += 1
        nxt: list = []
        for state in frontier:
            acts = model.enabled(state, scenario.actions)
            if not acts:
                term = _check_terminal(state)
                if term is not None:
                    inv, detail = term
                    violations.append(Violation(inv, detail,
                                                trace_of(state)))
                    if stop_at_first:
                        return ExploreResult(scenario.name, len(parent),
                                             violations, edges_seen,
                                             wedges_seen)
                continue
            for action in acts:
                post, edges, notes = model.apply(state, action)
                edges_seen.update((a, b) for _i, a, b in edges)
                wedges_seen.update(
                    (a, b) for _w, a, b in notes.get("wedges", ()))
                bad = _check_transition(state, action, post, edges,
                                        notes, declared,
                                        wdeclared=wdeclared)
                if bad is not None:
                    violations.append(Violation(
                        bad[0], bad[1], trace_of(state, action)))
                    if stop_at_first:
                        return ExploreResult(scenario.name, len(parent),
                                             violations, edges_seen,
                                             wedges_seen)
                    continue
                if post not in parent:
                    if len(parent) >= cfg.max_states:
                        raise RuntimeError(
                            f"model scenario {scenario.name} exceeded "
                            f"{cfg.max_states} states")
                    parent[post] = (state, action)
                    nxt.append(post)
        frontier = nxt
    # terminal check also applies to interior states that have no
    # successors at the depth horizon ONLY when genuinely actionless —
    # handled above; frontier states at max depth are not terminal.
    return ExploreResult(scenario.name, len(parent), violations,
                         edges_seen, wedges_seen)


def _shard_machine(manifest: Manifest) -> StateMachine | None:
    return next((m for m in manifest.state_machines
                 if m.name == "shard"), None)


def _worker_machine(manifest: Manifest) -> StateMachine | None:
    return next((m for m in manifest.state_machines
                 if m.name == "worker"), None)


def _explore_all(manifest: Manifest, cfg: ModelConfig | None,
                 mutations: Iterable[str],
                 scenarios: tuple[Scenario, ...]
                 ) -> tuple[list[Violation], set, set]:
    """Run every scenario; returns (violations, exercised shard edges,
    exercised worker-lifecycle edges)."""
    shard = _shard_machine(manifest)
    if shard is None:
        return [], set(), set()
    worker = _worker_machine(manifest)
    declared = frozenset(shard.transitions)
    wdeclared = frozenset(worker.transitions) \
        if worker is not None else None
    all_violations: list[Violation] = []
    exercised: set = set()
    wexercised: set = set()
    for sc in scenarios:
        res = explore(sc, declared, cfg=cfg, mutations=mutations,
                      wdeclared=wdeclared)
        all_violations.extend(res.violations)
        exercised |= res.edges
        wexercised |= res.wedges
        if all_violations:
            break
    return all_violations, exercised, wexercised


def check_model(manifest: Manifest, cfg: ModelConfig | None = None,
                mutations: Iterable[str] = (),
                scenarios: tuple[Scenario, ...] = SCENARIOS
                ) -> tuple[list[Violation], set]:
    """Run every scenario; returns (violations, union of exercised
    shard edges). The shipped tree must come back ([], exactly the
    declared table)."""
    violations, exercised, _w = _explore_all(manifest, cfg, mutations,
                                             scenarios)
    return violations, exercised


def model_findings(manifest: Manifest,
                   cfg: ModelConfig | None = None) -> list[Finding]:
    shard = _shard_machine(manifest)
    if shard is None:
        return []
    violations, exercised, wexercised = _explore_all(
        manifest, cfg, (), SCENARIOS)
    findings = [
        finding("TVT-M002", "", 0,
                f"board model: {v.format()}",
                key_detail=f"model:{v.invariant}")
        for v in violations]
    if not violations:
        declared = set(shard.transitions)
        missing = sorted(declared - exercised)
        extra = sorted(exercised - declared)
        if missing or extra:
            findings.append(finding(
                "TVT-M002", "", 0,
                f"shard transition table is stale: declared-but-never-"
                f"exercised {missing}, exercised-but-undeclared {extra}",
                key_detail="model:table-coverage"))
        worker = _worker_machine(manifest)
        if worker is not None:
            wdeclared = set(worker.transitions)
            wmissing = sorted(wdeclared - wexercised)
            wextra = sorted(wexercised - wdeclared)
            if wmissing or wextra:
                findings.append(finding(
                    "TVT-M002", "", 0,
                    f"worker-lifecycle transition table is stale: "
                    f"declared-but-never-exercised {wmissing}, "
                    f"exercised-but-undeclared {wextra}",
                    key_detail="model:worker-table-coverage"))
    return findings


def run(tree: SourceTree, manifest: Manifest) -> list[Finding]:
    return audit_transitions(tree, manifest) + model_findings(manifest)
