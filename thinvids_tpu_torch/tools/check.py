"""`cli.py check` — run the static-analysis passes over the port.

Fast (one AST parse per file, no torch or jax import; the TVT-M002
model check is pure compute): tests/test_torch_analysis.py runs it and
fails when the tree violates the manifest, and deploy/torch/pre-commit
runs it before every commit. It scans the package alone
(thinvids_tpu_torch/): bench.py belongs to the reference, and
chip_smoke.py is a harness that synchronizes on purpose to time things.

Exit codes: 0 clean (waived findings print as warnings), 1 open
findings OR stale waivers (a waiver matching no finding is dead debt
bookkeeping — it must be removed, so CI fails on it), 2 internal
error.

Output modes:
    (default)   human text, one finding per line
    --json      machine-readable: stable rule ids, path:line, waiver
                status — stdout is a single JSON object
    --sarif     SARIF 2.1.0 for CI annotation / editor ingestion
                (waived findings ride along as suppressed results)

Usage:
    python -m thinvids_tpu_torch.cli check [--json|--sarif] [--quiet]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="thinvids_tpu_torch check",
        description="static analysis: device/sync confinement, thread "
                    "safety, config discipline, protocol model check, "
                    "kernel and hot-loop discipline")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--sarif", action="store_true",
                   help="SARIF 2.1.0 findings on stdout")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the clean-run summary")
    return p


def _finding_path(tree, f) -> str:
    """Repo-relative path for a finding ("" for repo-global ones) —
    anchored at the REPO root (the package dir's parent), not the
    process cwd, so CI invoking the check from elsewhere still gets
    paths SARIF ingestion can match against the checkout."""
    if not f.module:
        return ""
    try:
        path = tree.path(f.module)
    except KeyError:
        return f.module
    repo_root = os.path.dirname(tree.package_dir)
    return os.path.relpath(path, repo_root)


def _json_doc(tree, manifest, open_, waived, stale) -> dict:
    def rec(f, waiver_reason=None):
        d = dict(f.__dict__)
        d["path"] = _finding_path(tree, f)
        d["waived"] = waiver_reason is not None
        if waiver_reason is not None:
            d["reason"] = waiver_reason
        return d

    return {
        "open": [rec(f) for f in open_],
        "waived": [rec(f, manifest.waivers[f.key]) for f in waived],
        "stale_waivers": stale,
        "modules_scanned": len(tree.modules()),
    }


def _sarif_doc(tree, manifest, open_, waived, stale) -> dict:
    """Minimal SARIF 2.1.0: one run, rule ids = TVT codes, waived
    findings as suppressed results, stale waivers as tool notes."""
    rules = sorted({f.code for f in open_} | {f.code for f in waived})

    def result(f, suppressed: bool):
        # repo-global findings (model check) anchor at the manifest —
        # repo-root-relative like every other emitted path
        path = _finding_path(tree, f) or \
            "thinvids_tpu_torch/analysis/manifest.py"
        rec = {
            "ruleId": f.code,
            "level": "error" if not suppressed else "note",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": path.replace(os.sep, "/")},
                    "region": {"startLine": max(1, f.line)},
                },
            }],
            "partialFingerprints": {"tvtKey": f.key},
        }
        if suppressed:
            rec["suppressions"] = [{
                "kind": "inSource",
                "justification": manifest.waivers[f.key],
            }]
        return rec

    invocation = {"executionSuccessful": True,
                  "toolExecutionNotifications": [
                      {"level": "warning",
                       "message": {"text": f"stale waiver `{k}` matches "
                                           f"no finding"}}
                      for k in stale]}
    return {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "tvt-check",
                "rules": [{"id": r} for r in rules],
            }},
            "invocations": [invocation],
            "results": [result(f, False) for f in open_]
            + [result(f, True) for f in waived],
        }],
    }


def run_check(json_out: bool = False, sarif_out: bool = False,
              quiet: bool = False) -> int:
    from ..analysis import (SourceTree, apply_waivers, default_manifest,
                            run_all)

    package_dir = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    tree = SourceTree(package_dir)
    manifest = default_manifest()
    findings = run_all(tree, manifest)
    open_, waived, stale = apply_waivers(findings, manifest)
    open_.sort(key=lambda f: (f.code, f.module, f.line))
    rc = 1 if (open_ or stale) else 0

    if json_out:
        print(json.dumps(_json_doc(tree, manifest, open_, waived, stale),
                         indent=2))
        return rc
    if sarif_out:
        print(json.dumps(_sarif_doc(tree, manifest, open_, waived,
                                    stale), indent=2))
        return rc

    for f in open_:
        print(f.format())
    for f in waived:
        print(f"waived  {f.format()}  [{manifest.waivers[f.key]}]")
    for key in stale:
        print(f"error: stale waiver `{key}` matches no finding — "
              f"remove it from analysis/manifest.py")
    if open_:
        print(f"\n{len(open_)} open finding(s) over "
              f"{len(tree.modules())} modules — fix them or add a "
              f"waiver with a reason to analysis/manifest.py")
        return rc
    if stale:
        return rc
    if not quiet:
        print(f"check clean: {len(tree.modules())} modules, "
              f"{len(waived)} waived finding(s), "
              f"0 stale waiver(s)")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.json and args.sarif:
        print("--json and --sarif are mutually exclusive",
              file=sys.stderr)
        return 2
    try:
        return run_check(json_out=args.json, sarif_out=args.sarif,
                         quiet=args.quiet)
    except Exception as exc:    # noqa: BLE001 - tooling must not traceback
        print(f"check failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    raise SystemExit(main())
