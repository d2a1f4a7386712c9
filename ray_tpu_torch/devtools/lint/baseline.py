"""Committed baseline suppression file (``.raylint_torch_baseline.json``,
the port's own).

The baseline is the escape hatch for findings that are real debt but out
of scope for the change at hand: ``ray_tpu_torch/scripts/lint.py
--baseline-rewrite``
records the current finding set; subsequent runs exit 0 as long as no NEW
finding appears. Entries are line-independent fingerprints
(rule, path, enclosing symbol, message) so edits elsewhere in a file do
not invalidate them; an entry whose finding disappears is reported as
stale so the file shrinks over time instead of fossilizing.

``tests/test_torch_lint.py`` asserts a ceiling on the baseline size — the
baseline is a ratchet, not a dumping ground.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Set, Tuple

from .model import Finding

BASELINE_NAME = ".raylint_torch_baseline.json"

Fingerprint = Tuple[str, str, str, str]


def baseline_path(root: str) -> str:
    return os.path.join(root, BASELINE_NAME)


def load(root: str) -> List[Fingerprint]:
    path = baseline_path(root)
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: List[Fingerprint] = []
    for ent in data.get("suppressions", []):
        out.append((ent["rule"], ent["path"], ent.get("symbol", ""),
                    ent["message"]))
    return out


def save(root: str, findings: List[Finding]) -> str:
    path = baseline_path(root)
    entries = []
    seen: Set[Fingerprint] = set()
    for f in sorted(findings, key=lambda f: (f.rule, f.path, f.symbol,
                                             f.message)):
        fp = f.fingerprint()
        if fp in seen:
            continue
        seen.add(fp)
        entries.append({"rule": f.rule, "path": f.path, "symbol": f.symbol,
                        "message": f.message})
    payload = {
        "comment": ("raylint baseline: known findings suppressed from the "
                    "gate. Shrink me; never grow me without a review. "
                    "Rewrite with ray_tpu_torch/scripts/lint.py "
                    "--baseline-rewrite."),
        "suppressions": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return path


def split(findings: List[Finding], baseline: List[Fingerprint]
          ) -> Tuple[List[Finding], List[Finding], List[Fingerprint]]:
    """Partition into (new, baselined, stale-baseline-entries)."""
    index: Dict[Fingerprint, int] = {}
    for fp in baseline:
        index[fp] = index.get(fp, 0) + 1
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if index.get(fp, 0) > 0:
            index[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = [fp for fp, n in index.items() for _ in range(n) if n > 0]
    return new, old, stale
