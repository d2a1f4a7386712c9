#!/usr/bin/env python
"""raylint driver: run the AST static-analysis suite over the port
(``ray_tpu_torch/``, with ``tests/`` loaded for the cross-reference rules).

Modes (``python -m ray_tpu_torch.scripts.lint`` takes the same arguments):

  python ray_tpu_torch/scripts/lint.py              # full run, gate on new
                                                    # findings
  python ray_tpu_torch/scripts/lint.py --changed    # only report findings
                                                    # in files changed vs
                                                    # git HEAD (pre-commit)
  python ray_tpu_torch/scripts/lint.py --baseline-rewrite  # re-record debt
  python ray_tpu_torch/scripts/lint.py --rules async-blocking,hot-path
  python ray_tpu_torch/scripts/lint.py ray_tpu_torch/cluster  # restrict
                                                    # reported paths

Exit status: 0 iff no non-baselined findings (and, on --baseline-rewrite,
always 0 after writing). The committed baseline is
.raylint_torch_baseline.json; tests/test_torch_lint.py asserts it stays
small.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def changed_paths(repo: str):
    """Repo-relative paths changed vs HEAD (staged + unstaged + untracked)."""
    try:
        out = subprocess.run(
            ["git", "-C", repo, "status", "--porcelain", "-uall"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    paths = []
    for line in out.splitlines():
        if len(line) < 4:
            continue
        path = line[3:].strip()
        if " -> " in path:  # rename: lint the new name
            path = path.split(" -> ", 1)[1]
        if path.endswith(".py"):
            paths.append(path.strip('"'))
    return paths


def main() -> int:
    from ray_tpu_torch.devtools.lint import (RULE_IDS, rewrite_baseline,
                                            run_lint)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("paths", nargs="*",
                        help="restrict REPORTED findings to these "
                             "repo-relative path prefixes")
    parser.add_argument("--changed", action="store_true",
                        help="report only findings in files changed vs git "
                             "HEAD (cross-file rules still see everything)")
    parser.add_argument("--baseline-rewrite", action="store_true",
                        help="record the current finding set as the new "
                             "baseline and exit 0")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             f"(default: all of {', '.join(RULE_IDS)})")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the committed baseline (report "
                             "everything)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="summary line only")
    args = parser.parse_args()

    if args.list_rules:
        from ray_tpu_torch.devtools.lint import ALL_CHECKERS

        for cls in ALL_CHECKERS:
            print(f"{cls.rule_id:20s} {cls.description}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULE_IDS]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}; "
                  f"known: {', '.join(RULE_IDS)}", file=sys.stderr)
            return 2

    if args.baseline_rewrite:
        path = rewrite_baseline(REPO, rules=rules)
        import json

        with open(path, "r", encoding="utf-8") as fh:
            n = len(json.load(fh).get("suppressions", []))
        print(f"# baseline rewritten: {n} suppression(s) -> {path}")
        return 0

    paths = args.paths or None
    if args.changed:
        changed = changed_paths(REPO)
        if changed is None:
            print("# --changed: git unavailable, falling back to full run",
                  file=sys.stderr)
        else:
            if not changed:
                print("# raylint: no changed python files")
                return 0
            paths = (paths or []) + changed

    t0 = time.monotonic()
    result = run_lint(REPO, rules=rules, paths=paths,
                      use_baseline=not args.no_baseline)
    dt = time.monotonic() - t0

    if not args.quiet:
        for f in result.findings:
            print(f.format())
        for err in result.parse_errors:
            print(f"# parse error: {err}")
        for fp in result.stale_baseline:
            print(f"# stale baseline entry (fixed? rewrite the baseline): "
                  f"{fp[0]} {fp[1]} :: {fp[3]}")
    status = "CLEAN" if result.ok else "FAIL"
    print(f"# raylint {status}: {len(result.findings)} new, "
          f"{len(result.baselined)} baselined, {result.suppressed} "
          f"annotated-off, {len(result.stale_baseline)} stale baseline "
          f"entr{'y' if len(result.stale_baseline) == 1 else 'ies'} "
          f"({result.files_scanned} files, {dt:.2f}s)")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
