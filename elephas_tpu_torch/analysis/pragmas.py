"""Dead-pragma audit: an escape comment must still be escaping something
(counterpart of ``elephas_tpu/analysis/pragmas.py``).

Every ``# host-ok`` / ``# clock-ok`` / ``# lock-ok`` … pragma was
written to silence a specific finding on that line. Code drifts: the
offending call gets refactored away, the line gets split, the rule gets
smarter — and the pragma stays behind, silently pre-authorizing
whatever lands on that line next. That rot is exactly the failure mode
escape hatches are criticized for, so this rule closes it: a pragma on
a line where no rule honoring that pragma reports a (suppressed)
finding is itself a violation.

Mechanics: the other rules report their pragma-escaped hits as
``suppressed=True`` findings; this rule tokenizes each in-scope file
for REAL comment pragmas (string-literal mentions — e.g. a lint message
template naming its own pragma — are invisible, see
:meth:`SourceFile.comment_pragmas`) and cross-references. A pragma only
counts as live if a suppressed finding from a rule honoring it sits on
the same line of the same file. Scope: a pragma is only audited in
files some honoring rule actually scans — a ``# host-ok`` in a test
file no rule reads is commentary, not an escape.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from elephas_tpu_torch.analysis.core import Finding, Repo, Rule


class DeadPragmaRule(Rule):
    name = "dead-pragma"
    pragma = ""          # not escapable — delete the pragma instead
    describe = ("package: every escape pragma must still suppress a "
                "finding on its line (no silent rot)")

    def __init__(self, rules: Sequence[Rule]):
        #: the rules whose suppressions this audit cross-references
        self.rules = [r for r in rules if r.pragma]

    def scope(self, repo: Repo):
        seen = {}
        for r in self.rules:
            for sf in r.scope(repo):
                seen[sf.path] = sf
        return [seen[k] for k in sorted(seen)]

    def run(self, repo: Repo,
            findings: Optional[Iterable[Finding]] = None) -> List[Finding]:
        """``findings``: pre-computed output of ``self.rules`` (the CLI
        runs each rule once and shares); when omitted the rules run
        here — same result, twice the AST walks."""
        if findings is None:
            findings = [f for r in self.rules for f in r.run(repo)]
        pragma_rules: Dict[str, List[Rule]] = {}
        for r in self.rules:
            pragma_rules.setdefault(r.pragma, []).append(r)
        rule_pragma = {r.name: r.pragma for r in self.rules}
        # (path, lineno, pragma) triples where a suppression proves the
        # pragma live
        live: Set[Tuple[str, int, str]] = set()
        for f in findings:
            if f.suppressed and f.rule in rule_pragma:
                live.add((f.path, f.lineno, rule_pragma[f.rule]))
        # which files each pragma is audited in
        pragma_scope: Dict[str, Set[str]] = {}
        for pragma, rules in pragma_rules.items():
            scoped: Set[str] = set()
            for r in rules:
                scoped.update(sf.rel for sf in r.scope(repo))
            pragma_scope[pragma] = scoped
        out: List[Finding] = []
        for sf in self.scope(repo):
            for lineno, pragmas in sorted(sf.comment_pragmas().items()):
                for pragma in pragmas:
                    if pragma not in pragma_rules:
                        continue
                    if sf.rel not in pragma_scope[pragma]:
                        continue
                    if (sf.rel, lineno, pragma) in live:
                        continue
                    rules = ", ".join(r.name
                                      for r in pragma_rules[pragma])
                    out.append(Finding(
                        rule=self.name, path=sf.rel, lineno=lineno,
                        ident=pragma, line=sf.line(lineno),
                        message=(f"dead pragma `# {pragma}` — no rule "
                                 f"({rules}) reports anything on this "
                                 f"line; delete it or re-justify it"),
                    ))
        return out
