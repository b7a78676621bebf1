"""The machine-checked architecture manifest of the PyTorch/CUDA port.

This file IS the port's correctness contract: which modules must stay
importable without torch, that no module reaches JAX or the JAX package,
where the host may wait on the card, which modules may build or load
device code, which thread entrypoints exist beyond what the AST can
discover, which lock guards which field, the control-plane state
machines as explicit transition tables (audited at every write site AND
model-checked — analysis/statemachine.py), which hot loops must never
block on a transfer, which process-level env knobs are registered, and
the (short) waiver list for findings that are understood and accepted.

The layout and field names are the reference package's
(thinvids_tpu/analysis/manifest.py) wherever the meaning carries over;
only the device-specific fields are renamed: `jax_free` →
`device_free`, `jax_roots` → `device_roots`, `jit_modules` →
`kernel_modules`. ``cli.py check`` enforces it over the whole package.

Editing rules:

- adding a module to `device_free` is free; removing one is an
  architecture change (the pack sidecars, the control plane and the
  analyzer itself run in processes that must not start a CUDA context);
- every waiver needs a one-line reason and should name a stable
  finding key (no line numbers) — stale waivers are reported by the
  checker so the list cannot silently rot.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class StateMachine:
    """One declared control-plane state machine.

    `attr` names the instance attribute whose enum writes the TVT-M001
    audit checks inside `scope` (every ``x.<attr> = <Enum>.<MEMBER>``
    write site must carry a local guard proving its source states, and
    every implied source→target edge must be in `transitions`). An
    empty `attr` declares a machine that is model-checked only (the
    QoS gate keeps its state implicitly)."""

    name: str
    enum: str                       # enum simple name ("ShardState")
    attr: str                       # audited instance attribute, "" = none
    scope: tuple[str, ...]          # module prefixes the audit scans
    states: tuple[str, ...]
    initial: tuple[str, ...]        # legal construction-time states
    transitions: tuple[tuple[str, str], ...]
    #: boolean predicate properties on the enum → the states they admit
    #: (``shard.state.is_open`` narrows to PENDING|ASSIGNED)
    predicates: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict)


#: the ShardBoard lease machine (cluster/remote.py). PENDING→DONE is
#: real: a late part from an expired-then-requeued lease is accepted
#: while the shard is open (first result wins, deterministic encode).
#: DONE and FAILED absorb. The TVT-M002 explorer must exercise EXACTLY
#: these edges — a stale table fails the check in either direction.
SHARD_MACHINE = StateMachine(
    name="shard",
    enum="ShardState",
    attr="state",
    scope=("thinvids_tpu_torch.cluster",),
    states=("PENDING", "ASSIGNED", "DONE", "FAILED"),
    initial=("PENDING",),
    transitions=(
        ("PENDING", "ASSIGNED"),    # claim (lease)
        ("ASSIGNED", "DONE"),       # submit_part
        ("PENDING", "DONE"),        # late part after requeue (open wins)
        ("ASSIGNED", "PENDING"),    # failure/expiry requeue, preemption
        ("ASSIGNED", "FAILED"),     # attempt budget exhausted
        # band-group restart (farm SFE): band shards encode in
        # LOCKSTEP, so when one falls back to PENDING its DONE siblings
        # requeue too — their spooled parts are RETRACTED first
        # (drop_done), so first-result-wins and resume-reuse stay
        # intact (the re-encode deterministically re-submits the same
        # bytes)
        ("DONE", "PENDING"),
    ),
    predicates={"is_open": ("PENDING", "ASSIGNED")},
)

#: the Job status machine (cluster/jobs.py + coordinator.py). READY is
#: the registration state; WAITING↔ the queue; STARTING/RUNNING/
#: STAMPING are the active set; STOPPED/FAILED/DONE re-queue through
#: queue_job or wipe through restart_job; REJECTED absorbs (re-running
#: an admission-rejected job must go back through policy, so neither
#: queue nor restart may resurrect it).
JOB_MACHINE = StateMachine(
    name="job",
    enum="Status",
    attr="status",
    scope=("thinvids_tpu_torch.cluster",),
    states=("READY", "WAITING", "STARTING", "RUNNING", "STAMPING",
            "STOPPED", "FAILED", "REJECTED", "DONE"),
    initial=("READY",),
    transitions=(
        ("READY", "REJECTED"),      # admission policy at registration
        # queue_job: (re-)queue from any non-active, non-rejected state
        ("READY", "WAITING"), ("WAITING", "WAITING"),
        ("STOPPED", "WAITING"), ("FAILED", "WAITING"),
        ("DONE", "WAITING"),
        ("WAITING", "STARTING"),    # scheduler reserve (run token mint)
        # mark_running is idempotent within a run
        ("STARTING", "RUNNING"), ("RUNNING", "RUNNING"),
        # completion / failure only from the active set
        ("STARTING", "DONE"), ("RUNNING", "DONE"), ("STAMPING", "DONE"),
        ("STARTING", "FAILED"), ("RUNNING", "FAILED"),
        ("STAMPING", "FAILED"),
        # operator stop: non-terminal states only (terminal absorbs)
        ("READY", "STOPPED"), ("WAITING", "STOPPED"),
        ("STARTING", "STOPPED"), ("RUNNING", "STOPPED"),
        ("STAMPING", "STOPPED"),
        # the api stamp flow (api/server.py _h_stamp_job — OUTSIDE the
        # cluster/ audit scope, declared here so the table stays the
        # whole protocol's spec): any non-active, non-rejected job may
        # enter STAMPING and is restored to its prior status after
        ("READY", "STAMPING"), ("WAITING", "STAMPING"),
        ("STOPPED", "STAMPING"), ("FAILED", "STAMPING"),
        ("DONE", "STAMPING"),
        ("STAMPING", "READY"), ("STAMPING", "WAITING"),
        ("STAMPING", "STOPPED"),
        # restart wipe: everything except REJECTED
        ("READY", "READY"), ("WAITING", "READY"), ("STARTING", "READY"),
        ("RUNNING", "READY"), ("STAMPING", "READY"),
        ("STOPPED", "READY"), ("FAILED", "READY"), ("DONE", "READY"),
    ),
    predicates={
        "is_active": ("STARTING", "RUNNING", "STAMPING"),
        "is_terminal": ("STOPPED", "FAILED", "REJECTED", "DONE"),
    },
)

#: the elastic-farm worker lifecycle (farm/lifecycle.py, driven by
#: farm/controller.py): ACTIVE workers claim; DRAINING workers finish
#: in-flight shards but stop claiming; SUSPENDED workers are powered
#: down; WAKING workers have a wake in flight. Every `lifecycle` write
#: site in farm/ is audited (TVT-M001), and the TVT-M002 explorer's
#: `drain` scenario drives this machine against the shard board:
#: no shard is ever leased to a DRAINING/SUSPENDED worker, and a
#: suspend never fires while the worker still holds a lease.
#: WAKING is a legal construction-time state: a freshly PROVISIONED
#: host's first record is born with its wake already in flight.
WORKER_MACHINE = StateMachine(
    name="worker",
    enum="WorkerState",
    attr="lifecycle",
    scope=("thinvids_tpu_torch.farm",),
    states=("ACTIVE", "DRAINING", "SUSPENDED", "WAKING"),
    initial=("ACTIVE", "WAKING"),
    transitions=(
        ("ACTIVE", "DRAINING"),      # scale-down / crashed-host drain
        ("DRAINING", "ACTIVE"),      # demand returned: cancel the drain
        ("DRAINING", "SUSPENDED"),   # lease set empty: suspend fired
        ("SUSPENDED", "WAKING"),     # scale-up: wake fired
        ("WAKING", "ACTIVE"),        # first heartbeat / first claim
        ("WAKING", "SUSPENDED"),     # wake never landed: retry later
        ("SUSPENDED", "ACTIVE"),     # operator-started host rejoined
    ),
)

#: the QoS batch gate (cluster/qos.py): OPEN admits batch claims,
#: PREEMPTING withholds them. No AST-audited attribute (the controller
#: keeps the state as an Event + breached set); the TVT-M002 board
#: model drives breach/recover and validates against this table.
QOS_GATE_MACHINE = StateMachine(
    name="qos-gate",
    enum="",
    attr="",
    scope=(),
    states=("OPEN", "PREEMPTING"),
    initial=("OPEN",),
    transitions=(
        ("OPEN", "PREEMPTING"),     # live part deadline breach
        ("PREEMPTING", "OPEN"),     # recovery / live job terminal
    ),
)


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Declarative inputs to the analysis passes. Defaults are the
    thinvids_tpu_torch contract; tests build custom instances around
    fixture packages."""

    package: str = "thinvids_tpu_torch"

    # -- pass 1: device confinement (TVT-J001) ------------------------
    #: modules (or package prefixes) whose TRANSITIVE module-scope
    #: import closure must never reach `device_roots`. These run in
    #: torch-free worker/sidecar/control-plane processes where starting
    #: a CUDA context is wrong (a spawned pack sidecar) or wasteful (the
    #: coordinator's API threads, the analyzer).
    device_free: tuple[str, ...] = (
        "thinvids_tpu_torch.abr.hls",
        "thinvids_tpu_torch.abr.ladder",
        "thinvids_tpu_torch.live.packager",
        "thinvids_tpu_torch.parallel.packproc",
        "thinvids_tpu_torch.codecs.h264.layout",
        "thinvids_tpu_torch.io",            # whole package
        "thinvids_tpu_torch.ingest.tail",
        # the origin serving layer and its load harness run on the
        # coordinator's API threads / a client box — never on a card
        "thinvids_tpu_torch.origin",        # whole package
        "thinvids_tpu_torch.tools.loadgen",
        "thinvids_tpu_torch.cluster.qos",
        # the durable part spool + board checkpoint runs on coordinator
        # control-plane threads (API handlers, the drain loop)
        "thinvids_tpu_torch.cluster.partstore",
        # the cross-host halo relay/transport (farm SFE) runs on
        # coordinator API threads and worker control flow; the device
        # math it feeds lives in parallel/sfefarm
        "thinvids_tpu_torch.cluster.halo",
        # the observability layer (metrics registry, trace store,
        # flight recorder) runs on control-plane threads and inside
        # torch-free sidecars
        "thinvids_tpu_torch.obs",           # whole package
        # the elastic farm (capacity controller, lifecycle, provider
        # seam, tenancy) is pure control plane: it spawns and kills
        # worker PROCESSES but never touches a device itself
        "thinvids_tpu_torch.farm",          # whole package
        # self-hosting: the analyzer itself runs as a fast torch-free
        # subprocess
        "thinvids_tpu_torch.analysis",
        "thinvids_tpu_torch.tools.check",
    )
    #: forbidden external import roots for `device_free` modules
    device_roots: tuple[str, ...] = ("torch", "triton")

    # -- pass 1c: reference confinement (TVT-J003) --------------------
    #: external roots NO module of the package may import at module
    #: scope: the port stands alone, beside the JAX package it is held
    #: against (tests/test_torch_import.py checks the same at runtime)
    reference_roots: tuple[str, ...] = ("jax", "jaxlib", "thinvids_tpu")

    # -- pass 1b: forbidden symbols (TVT-J002) ------------------------
    #: module → (symbol, reason): referencing the symbol ANYWHERE in
    #: the module (import, call, attribute) is a finding. The
    #: read_video rule keeps the blocking whole-clip decode prologue
    #: out of the streaming executors.
    forbidden_symbols: Mapping[str, tuple[tuple[str, str], ...]] = \
        dataclasses.field(default_factory=lambda: {
            "thinvids_tpu_torch.cluster.executor": (
                ("read_video", "executors stream via ingest.open_video; "
                 "read_video materializes the whole clip"),),
            "thinvids_tpu_torch.cluster.remote": (
                ("read_video", "workers range-decode their shard via "
                 "open_video's lazy slices"),),
        })

    # -- pass 2: host-sync confinement (TVT-S001/S002) ----------------
    #: modules (or prefixes) allowed to make the host wait on the card:
    #: the wave dispatcher owns the device→host boundary (_to_host,
    #: the done-event waits), tools/ is offline utilities, and the two
    #: codec entries are single-frame/single-GOP paths (torchcore's
    #: encode_intra, encoder.encode_gop) that never sit on the wave
    #: hot path.
    sync_allowlist: tuple[str, ...] = (
        "thinvids_tpu_torch.parallel.dispatch",
        # the farm-SFE band executor owns the same device→host
        # boundary as dispatch: per-frame tiny-count barriers, halo
        # edge-row fetches, and the probe/histogram partial reads that
        # MUST leave the card between lockstep exchanges
        "thinvids_tpu_torch.parallel.sfefarm",
        # two-pass VBR's complexity pass fetches each wave's per-GOP
        # statistics to the host to allocate the GOP QPs (one small
        # fetch per wave, off the encode pass) — the reference's
        # np.asarray(local) at thinvids_tpu/parallel/rc.py:88
        "thinvids_tpu_torch.parallel.rc",
        "thinvids_tpu_torch.codecs.h264.torchcore",
        "thinvids_tpu_torch.codecs.h264.encoder",
        "thinvids_tpu_torch.tools",
    )
    #: names whose reference blocks the host on the card: the CUDA
    #: synchronize family (torch.cuda / Event / Stream) and the
    #: tensor → host method `.cpu()`
    sync_calls: tuple[str, ...] = ("synchronize", "cpu")

    # -- pass 3: thread-safety audit (TVT-T001/T002/T003) -------------
    #: entrypoints the AST cannot discover (generators handed to a
    #: staging thread, loops driven by an external daemon), declared as
    #: "module:Class.method" → kind ("thread" = one extra thread,
    #: "concurrent" = many instances may run at once).
    thread_entrypoints: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: {
            # stage_waves generators execute ON the tvt-stage thread
            # (background_stage wraps them); the dispatch loop runs on
            # the caller thread concurrently.
            "thinvids_tpu_torch.parallel.dispatch:"
            "GopShardEncoder.stage_waves": "thread",
            "thinvids_tpu_torch.parallel.dispatch:"
            "GopShardEncoder.stage_luma_waves": "thread",
            # the SFE encoder's per-GOP staging generator runs on the
            # same tvt-stage thread via background_stage
            "thinvids_tpu_torch.parallel.dispatch:"
            "SfeShardEncoder.stage_waves": "thread",
        })
    #: classes instantiated per request/connection — their `self` is
    #: never shared across threads, so attribute writes are local
    per_request_bases: tuple[str, ...] = (
        "BaseHTTPRequestHandler", "StreamRequestHandler",
        "BaseRequestHandler",
    )
    #: attribute-name pattern that marks a `with self.<attr>:` block as
    #: lock-protected
    lock_attr_pattern: str = r"lock|cond|mutex"
    #: calls considered blocking when made while a lock is held
    blocking_calls: tuple[str, ...] = (
        "time.sleep", "sleep", "urlopen", "subprocess.run",
        "subprocess.check_call", "subprocess.check_output",
        "subprocess.Popen",
    )

    # -- pass 3b: guarded-by inference (TVT-T004) ---------------------
    #: "module:Class.attr" → lock attribute: the field is part of the
    #: class's lock-protected state, so EVERY read/write site outside
    #: __init__ must hold that lock (lexical `with self.<lock>:` or the
    #: *_locked caller-holds convention). Beyond this declared set the
    #: pass still infers: a field written under two DIFFERENT locks
    #: (empty lockset intersection) from multi-threaded code is a
    #: finding without any declaration.
    guarded_by: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: {
            "thinvids_tpu_torch.cluster.remote:ShardBoard._jobs": "_lock",
            "thinvids_tpu_torch.cluster.remote:ShardBoard._order": "_lock",
            "thinvids_tpu_torch.cluster.remote:ShardBoard._parts": "_lock",
            # claim-affinity scoring map: read+written inside claim's
            # locked section only
            "thinvids_tpu_torch.cluster.remote:ShardBoard._affinity":
                "_lock",
            # halo relay rendezvous store: API handler threads post,
            # long-polls park on the same condition's lock
            "thinvids_tpu_torch.cluster.halo:HaloRelay._jobs": "_cond",
            "thinvids_tpu_torch.cluster.jobs:JobStore._jobs": "_lock",
            "thinvids_tpu_torch.cluster.partstore:PartStore._journals":
                "_lock",
            "thinvids_tpu_torch.cluster.partstore:PartStore._spool_bytes":
                "_lock",
            "thinvids_tpu_torch.cluster.coordinator:"
            "WorkerRegistry._workers": "_lock",
            "thinvids_tpu_torch.cluster.coordinator:"
            "Coordinator._active_ids": "_sched_lock",
            "thinvids_tpu_torch.cluster.qos:QosController._breached":
                "_lock",
            "thinvids_tpu_torch.farm.controller:CapacityController._recs":
                "_lock",
        })

    # -- pass 5: protocol state machines (TVT-M001/M002) --------------
    #: declared control-plane machines: transition tables the AST audit
    #: checks write sites against, and the bounded explorer validates
    #: the board model against (see analysis/statemachine.py).
    state_machines: tuple[StateMachine, ...] = (
        SHARD_MACHINE, JOB_MACHINE, QOS_GATE_MACHINE, WORKER_MACHINE)

    # -- pass 6: kernel and hot-loop discipline (TVT-X001/X002) -------
    #: modules allowed to BUILD or LOAD device code (nvcc / g++ +
    #: ctypes, cpp_extension loaders, torch.compile, triton.jit, CUDA
    #: graphs): a kernel library built or loaded elsewhere escapes
    #: chip_smoke.py's build into the git-ignored _build/ directories
    #: and its launch counts.
    kernel_modules: tuple[str, ...] = (
        "thinvids_tpu_torch.codecs.h264.torchme",   # csrc/me_search.cu
        "thinvids_tpu_torch.native",                # native/cavlc_pack.cpp
    )
    #: helper names whose RESULT is a pinned/quantized shape bound (the
    #: used-prefix quantizer in GopShardEncoder._fetch_payload_rows):
    #: in every module that imports torch, a data-dependent slice bound
    #: (`.max()` / `.item()` on a tensor) is a host sync and a fresh
    #: shape for every wave unless it routes through one of these
    shape_quantizers: tuple[str, ...] = ("cut",)
    #: wave/frame hot-loop functions ("module:Qual.name"): code that
    #: runs once per dispatched wave or per SFE frame step. Blocking
    #: transfers (`synchronize`, `.cpu()`, `.item()`, `.tolist()`,
    #: `.numpy()`, a `.to()`/`.cuda()` without non_blocking=True) are
    #: banned here — staging (stage_waves) and collect (collect_wave,
    #: _fetch_*) are the allowlisted transfer sites and are
    #: deliberately NOT in this set. `_sfe_p_step` is the module
    #: function that stands in for the reference's
    #: SfeShardEncoder._p_step; `_run_wave` and `_walk` are the bodies
    #: the two dispatch_wave methods delegate to (the GOP wave's launch
    #: on each entry, the split-frame GOP's per-frame loop).
    hot_loops: tuple[str, ...] = (
        "thinvids_tpu_torch.parallel.dispatch:GopShardEncoder.dispatch_wave",
        "thinvids_tpu_torch.parallel.dispatch:GopShardEncoder.encode_waves",
        "thinvids_tpu_torch.parallel.dispatch:GopShardEncoder._run_wave",
        "thinvids_tpu_torch.parallel.dispatch:SfeShardEncoder.dispatch_wave",
        "thinvids_tpu_torch.parallel.dispatch:SfeShardEncoder.encode_waves",
        "thinvids_tpu_torch.parallel.dispatch:SfeShardEncoder._intra_step",
        "thinvids_tpu_torch.parallel.dispatch:SfeShardEncoder._walk",
        "thinvids_tpu_torch.parallel.dispatch:_sfe_p_step",
    )

    # -- pass 4: config discipline (TVT-C001/C002/C003) ---------------
    #: process-level env knobs that are NOT live settings (read once at
    #: process start, no clamp tier) — registered here so the TVT_*
    #: namespace stays inventoried.
    process_env: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: {
            "TVT_API_PORT": "coordinator HTTP port (cli.py)",
            "TVT_STATE_DIR": "durable journal directory (cli.py)",
            "TVT_WATCH_DIR": "watch-folder ingest root (cli.py)",
            "TVT_OUTPUT_DIR": "encode output root (cli.py)",
            "TVT_COORDINATOR_URL": "agent/worker coordinator URL (cli.py)",
            "TVT_LOG_LEVEL": "root log level (core/log.py)",
            "TVT_LOG_FORMAT": "log line format: json = one structured "
                              "object per line with trace/job ids "
                              "(core/log.py)",
            "TVT_NATIVE_SANITIZE": "asan|ubsan native build mode "
                                   "(native/__init__.py)",
        })
    #: foreign platform envs the package may read/write without being
    #: TVT_-namespaced (sanitizer runtimes, linkers, the interpreter)
    foreign_env_prefixes: tuple[str, ...] = (
        "LD_", "ASAN_", "UBSAN_", "PYTHON", "PATH", "HOME", "TMPDIR",
    )
    #: files whose settings-key mentions do NOT count as readers
    #: (the config module itself defines the keys)
    config_module: str = "thinvids_tpu_torch.core.config"

    # -- waivers ------------------------------------------------------
    #: finding key → one-line reason. Keys are the stable `Finding.key`
    #: (code:detail, no line numbers). Keep this SHORT: a waiver is a
    #: debt record, not an off switch. `cli.py check` reports stale
    #: waivers (matching no current finding) so the list cannot rot.
    waivers: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: dict(_WAIVERS))


#: the port's current waiver list (kept module-level so tests can
#: assert on its size without building a Manifest)
_WAIVERS: dict[str, str] = {
    # core/log.py reads LOG_LEVEL as a fallback after TVT_LOG_LEVEL:
    # reference-compat (the reference's common.py used LOG_LEVEL) and
    # existing deployments keep working.
    "TVT-C002:LOG_LEVEL": "legacy fallback env for TVT_LOG_LEVEL "
                          "(reference compat)",
    # cluster/executor.py _profiled: the profiler waits for the card's
    # queue before it stops, so the trace holds the job's last kernels;
    # it runs only when a job asks for a profile (profile_dir)
    "TVT-S001:thinvids_tpu_torch.cluster.executor:synchronize":
        "profiler stop waits for the card (profiled jobs only)",
    # codecs/h264/torchme.py me_search_ref: the kernel's plain version
    # reads its three centres on the host to drive Python-int shifts;
    # the tests and chip_smoke.py's comparisons call it, never the
    # CUDA main path (me_search_cuda)
    "TVT-S001:thinvids_tpu_torch.codecs.h264.torchme:cpu":
        "me_search_ref, the kernel's plain version, reads its centres "
        "on the host (tests and comparisons only)",
    # tools/oracle.py loads the libavcodec that opencv bundles, a host
    # decoder (the tests' conformance oracle), not device code
    "TVT-X001:thinvids_tpu_torch.tools.oracle:kernel":
        "ctypes loads opencv's host libavcodec for the decode oracle, "
        "no device code",
}


def default_manifest() -> Manifest:
    return Manifest()
