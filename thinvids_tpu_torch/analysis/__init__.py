"""Repo-native static analysis of the port: machine-checked
architecture invariants.

Six passes over the package's ASTs, driven by the declarative
manifest (analysis/manifest.py) and runnable in seconds without torch
or jax (the reference package's analyzer, with the port's contract):

1. imports      — device confinement (TVT-J001) + forbidden symbols
                  (TVT-J002) + reference confinement (TVT-J003):
                  declared device-free modules never reach `torch`
                  through any module-scope import chain, and no module
                  imports `jax` or the JAX package.
2. syncs        — host-sync confinement (TVT-S001/S002): `synchronize`
                  / `.cpu()` and the implicit syncs on torch values
                  (`.item()`, `float(t)`, `np.asarray(t)`) stay inside
                  the dispatch boundary.
3. threads      — thread-safety audit (TVT-T001..T005): unlocked
                  cross-entrypoint writes, blocking calls under locks,
                  lock-order inversions, guarded-by/lockset
                  violations, cross-object lock-order cycles.
4. configcheck  — config discipline (TVT-C001/C002/C003): no dead
                  settings keys, a registered TVT_* env namespace, no
                  raw settings subscripts around the clamp tier.
5. statemachine — protocol verification (TVT-M001/M002): every
                  ShardState/Status/WorkerState write site in cluster/
                  and farm/ is audited against the declared transition
                  tables, and a bounded exhaustive explorer over a
                  faithful ShardBoard model proves the lease protocol's
                  safety invariants.
6. jitcheck     — kernel and hot-loop discipline (TVT-X001/X002): device
                  code is built and loaded only in the declared kernel
                  modules, slice bounds are shape-quantized, and the
                  wave/frame hot loops never block on a transfer.

Run via ``python -m thinvids_tpu_torch.cli check`` (tools/check.py).
``--json`` and ``--sarif`` emit machine-readable findings for CI and
editors.

Device-free by contract — and self-hosted: this package is in its own
manifest's `device_free` list, so the analyzer analyzes itself.
"""

from __future__ import annotations

from .astutil import Finding, SourceTree
from .manifest import Manifest, default_manifest


def run_all(tree: SourceTree, manifest: Manifest,
            defaults: dict | None = None) -> list[Finding]:
    """Every pass over one source tree; findings in pass order
    (waivers NOT applied — see apply_waivers)."""
    from . import (configcheck, imports, jitcheck, statemachine, syncs,
                   threads)

    findings: list[Finding] = []
    findings += imports.run(tree, manifest)
    findings += syncs.run(tree, manifest)
    findings += threads.run(tree, manifest)
    findings += configcheck.run(tree, manifest, defaults)
    findings += statemachine.run(tree, manifest)
    findings += jitcheck.run(tree, manifest)
    return findings


def apply_waivers(findings: list[Finding], manifest: Manifest
                  ) -> tuple[list[Finding], list[Finding], list[str]]:
    """(open findings, waived findings, stale waiver keys)."""
    waived = [f for f in findings if f.key in manifest.waivers]
    open_ = [f for f in findings if f.key not in manifest.waivers]
    hit = {f.key for f in waived}
    stale = sorted(k for k in manifest.waivers if k not in hit)
    return open_, waived, stale


__all__ = ["Finding", "SourceTree", "Manifest", "default_manifest",
           "run_all", "apply_waivers"]
