"""Shared machinery for the static-analysis subsystem (counterpart of
``elephas_tpu_torch/analysis/core.py``).

Every analyzer in ``elephas_tpu_torch/analysis/`` is a :class:`Rule` over a
:class:`Repo`: the repo parses each source file ONCE into a
:class:`SourceFile` (source + line table + AST) and hands the same
object to every rule, so adding a rule costs one AST walk, not one
parse. Rules report :class:`Finding`\\ s — including findings a pragma
SUPPRESSED (``suppressed=True``), which is what lets the dead-pragma
rule prove an escape comment still earns its keep.

Pragma machinery: each rule names the escape pragma that silences it
(``# host-ok``, ``# lock-ok``, …). The legacy rules match the pragma
substring anywhere on the flagged line (historical contract, kept);
:func:`comment_pragmas` tokenizes a file and returns only REAL comment
pragmas, which is what the dead-pragma rule audits — a pragma mentioned
inside a string literal is documentation, not an escape.

The package never imports torch (rules read source, they don't run it),
so the CLI stays usable on hosts without an accelerator stack.

Scope: the port's package ``elephas_tpu_torch/`` and the port's own
harness — ``scripts/torch_*.py`` (not recursive; the JAX package's
scripts are the JAX analyzer's business) and ``chip_smoke.py``.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Every escape pragma any rule honors — the vocabulary the dead-pragma
#: rule audits. Grow this WITH the rule that honors the new pragma.
PRAGMAS: Tuple[str, ...] = (
    "host-ok",
    "clock-ok",
    "pickle-ok",
    "metric-ok",
    "kind-ok",
    "route-ok",
    "pool-ok",
    "lock-ok",
)


@dataclass
class Finding:
    """One analyzer hit: fired (``suppressed=False``) or pragma-escaped."""

    rule: str
    path: str
    lineno: int
    ident: str            # short identifier of what fired (call, lock, …)
    line: str             # the source line, verbatim
    message: str          # fully rendered human message
    suppressed: bool = False
    chain: Tuple[str, ...] = ()   # witness path (interprocedural rules)

    def render(self) -> str:
        head = f"{self.path}:{self.lineno}: [{self.rule}] {self.message}"
        body = f"\n    {self.line.strip()}" if self.line.strip() else ""
        steps = "".join(f"\n    -> {s}" for s in self.chain)
        return head + body + steps

    def as_json(self) -> dict:
        out = {
            "rule": self.rule,
            "path": self.path,
            "lineno": self.lineno,
            "ident": self.ident,
            "message": self.message,
            "suppressed": self.suppressed,
        }
        if self.chain:
            out["chain"] = list(self.chain)
        return out


class SourceFile:
    """Parse-once view of one module, shared by every rule."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel                     # repo-relative, for messages
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self._tree: Optional[ast.Module] = None
        self._comment_pragmas: Optional[Dict[int, List[str]]] = None

    @property
    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.source, filename=str(self.path))
        return self._tree

    def line(self, lineno: int) -> str:
        return self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""

    def has_pragma(self, lineno: int, pragma: str) -> bool:
        """Legacy contract: the pragma substring anywhere on the line."""
        return pragma in self.line(lineno)

    def comment_pragmas(self) -> Dict[int, List[str]]:
        """``{lineno: [pragmas]}`` for REAL comment tokens only.

        Tokenized, not substring-matched, so a pragma named inside a
        string literal (e.g. a lint message template) is invisible here.
        Tokenize errors fall back to empty — an unparsable file already
        fails every AST rule loudly.
        """
        if self._comment_pragmas is None:
            found: Dict[int, List[str]] = {}
            try:
                toks = tokenize.generate_tokens(
                    io.StringIO(self.source).readline)
                for tok in toks:
                    if tok.type != tokenize.COMMENT:
                        continue
                    for pragma in PRAGMAS:
                        # anchored at the comment's start: an escape is
                        # written `# pragma: reason`; a pragma named
                        # mid-comment (docs discussing the pragma) is
                        # commentary, not an escape.
                        if re.match(rf"#+\s*{re.escape(pragma)}\b",
                                    tok.string):
                            found.setdefault(tok.start[0], []).append(pragma)
            except (tokenize.TokenError, IndentationError, SyntaxError):
                pass
            self._comment_pragmas = found
        return self._comment_pragmas


PACKAGE = "elephas_tpu_torch"
#: The port's harness: ``scripts/<SCRIPTS_PREFIX>*.py`` and these
#: repo-root files.
SCRIPTS_PREFIX = "torch_"
ROOT_SCRIPTS = ("chip_smoke.py",)


class Repo:
    """Root paths + the shared :class:`SourceFile` cache."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.pkg = self.root / PACKAGE
        self.scripts = self.root / "scripts"
        self._cache: Dict[Path, SourceFile] = {}

    def file(self, path: Path) -> SourceFile:
        path = Path(path)
        sf = self._cache.get(path)
        if sf is None:
            try:
                rel = str(path.relative_to(self.root))
            except ValueError:
                rel = str(path)
            sf = SourceFile(path, rel)
            self._cache[path] = sf
        return sf

    def walk(self, base: Path, recursive: bool = True,
             exclude: Sequence[str] = ()) -> List[SourceFile]:
        if not base.is_dir():
            return []
        pattern = "*.py"
        paths = base.rglob(pattern) if recursive else base.glob(pattern)
        return [self.file(p) for p in sorted(paths)
                if p.name not in exclude and "__pycache__" not in p.parts]

    def package_files(self) -> List[SourceFile]:
        return self.walk(self.pkg)

    def scripts_files(self) -> List[SourceFile]:
        return ([sf for sf in self.walk(self.scripts, recursive=False)
                 if sf.path.name.startswith(SCRIPTS_PREFIX)]
                + [self.file(self.root / name) for name in ROOT_SCRIPTS
                   if (self.root / name).is_file()])


class Rule:
    """One analyzer. Subclasses set ``name``/``pragma``/``describe`` and
    implement :meth:`run` returning every finding, suppressed included
    (the CLI separates violations from escapes)."""

    #: registry identity, kebab-case
    name: str = ""
    #: escape pragma this rule honors ("" = not escapable)
    pragma: str = ""
    #: one-line description for --list-rules / README
    describe: str = ""

    def run(self, repo: Repo) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def scope(self, repo: Repo) -> List[SourceFile]:
        """Files this rule scans — the dead-pragma rule audits a
        pragma only inside the scopes of the rules honoring it."""
        return []


def violations(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]


def suppressions(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.suppressed]
