"""Rule-plugin lint engine: file walker, suppressions, findings, registry.

The engine is deliberately small and dependency-free (stdlib ``ast``
only).  A *rule* is a class registered with :func:`register`; it
declares an id (``EDK001``-style), a severity, a one-line summary, and
an optional path scope, and implements either or both of

* ``check(ctx)``       — per-file pass over one :class:`FileContext`;
* ``finalize(ctxs)``   — project pass over every in-scope file (for
  cross-file invariants like outcome reachability).

Findings carry (rule, severity, path, line, col, message) and serialize
to JSON for machine consumption (``python -m repro_torch.analysis
--json``).

Suppressions: a trailing comment ``# lint: ignore[EDK002]`` silences the
named rule(s) on that line; a comma list silences several; bare
``# lint: ignore`` silences every rule.  A suppression on a line of its
own applies to the next line of code.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Type

SEVERITIES = ("error", "warning")

#: Fixture trees are in scope for every rule regardless of its declared
#: path scope, so golden true-positive/near-miss files can live under
#: ``tests/fixtures/lint/`` instead of shadowing the real package layout.
FIXTURE_MARKER = "fixtures/lint"

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, stable under sorting and JSON-serializable."""
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class FileContext:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: Path, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        # line -> None (suppress all rules) | set of rule ids
        self.suppressions: Dict[int, Optional[Set[str]]] = {}
        self._parse_suppressions()

    def _parse_suppressions(self) -> None:
        for lineno, line in enumerate(self.source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules: Optional[Set[str]] = None
            if m.group("rules"):
                rules = {r.strip().upper()
                         for r in m.group("rules").split(",") if r.strip()}
            targets = [lineno]
            if line.lstrip().startswith("#"):
                targets.append(lineno + 1)  # standalone comment: next line
            for t in targets:
                prev = self.suppressions.get(t, set())
                if prev is None or rules is None:
                    self.suppressions[t] = None
                else:
                    self.suppressions[t] = set(prev) | rules

    def suppressed(self, rule: str, line: int) -> bool:
        entry = self.suppressions.get(line, set())
        return entry is None or rule in (entry or set())

    def finding(self, rule: "Rule", node: ast.AST, message: str,
                *, severity: Optional[str] = None) -> Finding:
        return Finding(rule.id, severity or rule.severity,
                       self.path.as_posix(),
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


class Rule:
    """Base rule plugin.  Subclasses set the class attributes and
    override :meth:`check` (per file) and/or :meth:`finalize`
    (project-wide, after every in-scope file was parsed)."""

    id: str = "EDK000"
    severity: str = "error"
    summary: str = ""
    #: path substrings this rule applies to (POSIX form); None = all files
    scopes: Optional[Sequence[str]] = None

    def in_scope(self, path: Path) -> bool:
        posix = path.as_posix()
        if FIXTURE_MARKER in posix:
            return True
        if self.scopes is None:
            return True
        return any(s in posix for s in self.scopes)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def finalize(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        return ()


RULES: Dict[str, Rule] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator adding a rule (one shared instance) to the
    registry; the engine runs every registered rule by default."""
    if not cls.id or cls.id in RULES:
        raise ValueError(f"duplicate or empty rule id {cls.id!r}")
    if cls.severity not in SEVERITIES:
        raise ValueError(f"{cls.id}: unknown severity {cls.severity!r}")
    RULES[cls.id] = cls()
    return cls


def iter_py_files(paths: Sequence[Path]) -> Iterator[Path]:
    """Explicit files are always yielded; directories are walked for
    ``*.py`` (skipping ``__pycache__``), sorted for stable output."""
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        else:
            yield p


def _load(path: Path) -> FileContext:
    source = path.read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(path))
    return FileContext(path, source, tree)


def analyze_paths(paths: Sequence[Path],
                  select: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the selected rules (default: all registered) over ``paths``
    and return unsuppressed findings sorted by (path, line, rule)."""
    wanted = sorted(select) if select is not None else sorted(RULES)
    unknown = [r for r in wanted if r not in RULES]
    if unknown:
        raise KeyError(f"unknown rule id(s): {', '.join(unknown)}")
    rules = [RULES[r] for r in wanted]

    ctxs: List[FileContext] = []
    findings: List[Finding] = []
    for path in iter_py_files([Path(p) for p in paths]):
        try:
            ctxs.append(_load(path))
        except (SyntaxError, UnicodeDecodeError) as exc:
            findings.append(Finding(
                "EDK000", "error", Path(path).as_posix(),
                getattr(exc, "lineno", 1) or 1, 0,
                f"file does not parse: {exc.__class__.__name__}: {exc}"))

    for rule in rules:
        in_scope = [c for c in ctxs if rule.in_scope(c.path)]
        for ctx in in_scope:
            findings.extend(rule.check(ctx))
        findings.extend(rule.finalize(in_scope))

    by_path = {c.path.as_posix(): c for c in ctxs}
    kept = [f for f in findings
            if f.path not in by_path
            or not by_path[f.path].suppressed(f.rule, f.line)]
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept
