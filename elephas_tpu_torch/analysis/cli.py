"""Driver for the analysis subsystem: registry, report, CLI
(counterpart of ``elephas_tpu/analysis/cli.py``).

``python -m elephas_tpu_torch.analysis`` runs every registered rule over
the port's tree and exits non-zero on any unsuppressed violation: the
eight legacy lint domains, the concurrency analyzers and the
dead-pragma audit.

``--json`` emits the full machine-readable report; ``--write
ANALYSIS_TORCH.json`` persists it. The committed ``ANALYSIS_TORCH.json``
carries a ``rows`` table (one row per rule: violations + suppression
counts, plus a ``total`` row with the lock-graph shape) that
``scripts/bench_gate.compare(..., "analysis")`` diffs against a fresh
run — so a new violation, a silently vanished suppression, or a fresh
lock-order cycle each fail mechanically — and a ``lock_graph`` that
seeds the runtime sanitizer (``utils.locksan.enable(analysis_path=...)``).
The report's ``root`` is ``"."`` for the repo this package sits in.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from elephas_tpu_torch.analysis.core import (Finding, Repo, Rule,
                                             suppressions, violations)
from elephas_tpu_torch.analysis.legacy import LEGACY_RULES
from elephas_tpu_torch.analysis.locks import (BlockingUnderLockRule,
                                              LockAnalysis, LockOrderRule,
                                              get_analysis)
from elephas_tpu_torch.analysis.pragmas import DeadPragmaRule


def default_root() -> Path:
    return Path(__file__).resolve().parents[2]


def build_rules() -> Tuple[Rule, ...]:
    """The full registry, dead-pragma last (it audits the others)."""
    base: Tuple[Rule, ...] = LEGACY_RULES + (
        LockOrderRule(), BlockingUnderLockRule())
    return base + (DeadPragmaRule(base),)


def run_rules(repo: Repo, rules: Optional[Sequence[Rule]] = None
              ) -> Dict[str, List[Finding]]:
    """Run every rule once; the dead-pragma rule consumes the others'
    findings instead of re-running them."""
    rules = list(rules) if rules is not None else list(build_rules())
    out: Dict[str, List[Finding]] = {}
    shared: List[Finding] = []
    for rule in rules:
        if isinstance(rule, DeadPragmaRule):
            found = rule.run(repo, findings=shared)
        else:
            found = rule.run(repo)
        out[rule.name] = found
        shared.extend(found)
    return out


def build_report(root: Optional[Path] = None) -> dict:
    root = Path(root) if root is not None else default_root()
    repo = Repo(root)
    rules = build_rules()
    by_rule = run_rules(repo, rules)
    la: LockAnalysis = get_analysis(repo)

    rows: List[dict] = []
    all_viol: List[Finding] = []
    all_supp: List[Finding] = []
    for rule in rules:
        found = by_rule[rule.name]
        v, s = violations(found), suppressions(found)
        all_viol.extend(v)
        all_supp.extend(s)
        rows.append({
            "section": rule.name,
            "violations": len(v),
            "suppressions": len(s),
        })
    graph = la.export()
    rows.append({
        "section": "total",
        "violations": len(all_viol),
        "suppressions": len(all_supp),
        "lock_cycles": len(la.cycles()),
        "locks": len(graph["locks"]),
        "lock_edges": len(graph["edges"]),
    })
    return {
        "root": "." if root.resolve() == default_root() else str(root),
        "rules": [
            {"name": r.name, "pragma": r.pragma, "describe": r.describe}
            for r in rules
        ],
        "rows": rows,
        "violations": [f.as_json() for f in all_viol],
        "suppressions": [f.as_json() for f in all_supp],
        "lock_graph": graph,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="elephas-torch-analyze",
        description=("Static analysis over the elephas_tpu_torch package: "
                     "legacy lint domains + lock-order, "
                     "blocking-under-lock, and dead-pragma audits."))
    ap.add_argument("--root", default=None,
                    help="repo root (default: derived from the package)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--write", metavar="PATH", default=None,
                    help="write the report (e.g. ANALYSIS_TORCH.json)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list registered rules and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in build_rules():
            esc = f"# {r.pragma}" if r.pragma else "(not escapable)"
            print(f"{r.name:18s} {esc:16s} {r.describe}")
        return 0

    root = Path(args.root) if args.root else default_root()
    report = build_report(root)
    text = json.dumps(report, indent=1)
    if args.write:
        with open(args.write, "w") as f:
            f.write(text + "\n")
    if args.json:
        print(text)
    else:
        viol = report["violations"]
        for v in sorted(viol, key=lambda f: (f["path"], f["lineno"])):
            print(f"{v['path']}:{v['lineno']}: [{v['rule']}] "
                  f"{v['message']}")
            for step in v.get("chain", []):
                print(f"    -> {step}")
        total = report["rows"][-1]
        if not viol:
            print(f"analysis: {root} clean "
                  f"({len(report['rules'])} rules, "
                  f"{total['suppressions']} suppressions, "
                  f"{total['locks']} locks, "
                  f"{total['lock_edges']} order edges, "
                  f"{total['lock_cycles']} cycles)")
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
